"""Per-client persistent state of the port (from
``repro/core/client_state.py``): a home for the statistic that SCAFFOLD's
control variates and FedEP's sites keep per client, across rounds.

Two interchangeable stores (``FedConfig.client_state_placement``), both
subclasses of :class:`BaseClientStateStore`, with one write-stamp
compare-and-swap (CAS) contract:

  * :class:`ClientStateStore` (``"host"``) — dense numpy buffers with a
    leading ``num_clients`` axis and int64 write stamps. ``gather`` slices
    one cohort's states and snapshots their stamps; ``scatter`` writes the
    cohort's ``ClientResult.state_update`` back only where a client's
    stamp has not moved since that gather. It pulls the updates to the
    host: the one blocking sync a stateful round pays.
  * :class:`DeviceClientStateStore` (``"device"``) — the same buffers and
    stamps as tensors on the device. The round gathers with
    :func:`device_gather` (``index_select``) and writes back with
    :func:`device_scatter` (``torch.where`` against the current rows,
    ``index_copy_``, the stamps bumped with ``index_add_``), with the drop
    count left a device scalar: nothing syncs with the host per round.
    The buffers are updated in place, so the reference's
    ``jit_donating_store`` (donation keeps XLA from holding two copies of
    the store) has no counterpart here.

Both stores refuse a cohort that names a client twice: numpy's fancy
indexing and ``index_copy_`` alike would let an arbitrary write win. Both
give the same ``state_dict()`` (numpy buffers, int64 stamps), so a
checkpoint of one restores into the other (``checkpoint/io.py``).

Population sharding: given a mesh (``launch.mesh.ProcessMesh``) the
device store shards its population over the mesh's client axes (``("pod",
"data")`` by default, or ``population_spec``'s), padded up to a multiple of
their extent (:func:`population_layout`): rank ``r`` holds only rows ``[r R,
(r + 1) R)`` of the padded population, ``R = padded_num_clients /
extent``, on its own device. Padding rows are dead: their stamps are -1 and
range-checked ids cannot reach them. ``prepare_ids`` turns a cohort into a
:class:`CohortRoute`, and ``device_gather`` / ``device_scatter`` then move
each cohort row between the rank that owns it and the rank that runs it
(``core.collective.exchange_rows``): the gather hands each rank its own
cohort rows, ``[r C / W, (r + 1) C / W)``, and the CAS scatter writes each
updated row back on its owner only, with the gather-time stamps and the
write mask, the drop count summed over the ranks. ``local_state_dict`` /
``load_local_state_dict`` checkpoint the rows a rank owns; ``state_dict``
refuses on a multi-process mesh.

Element sharding (the ``sequential`` placement's FSDP, ``core/fsdp.py``):
a store made for an FSDP layout (``fsdp=layout``) holds every client's
row of this rank's ``n`` elements, ``(N, n)`` buffers from the layout's
shard template (``alg.init_client_state(sharded_state.params)``). Every
rank runs every client with the same ids and stamps, so the population
does not split, every rank takes the same CAS decisions, and the gather
and scatter are the unsharded ones. Its state dict holds the rows, ``(N,
n)`` a leaf, marked as the flat layout's (``fsdp.mark_flat``), so
``checkpoint.io.save_checkpoint`` refuses them and
``save_checkpoint_fsdp`` writes each rank's; ``load_state_dict`` takes
rows of this layout's ``n`` (``restore_checkpoint_fsdp`` re-cuts another
layout's), and either store restores the other's rows bit for bit.
"""
from __future__ import annotations

import abc
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import _not_ported
from repro_torch.core import collective
from repro_torch.core import tree_math as tm
from repro_torch.core.fsdp import mark_flat
from repro_torch.launch.mesh import rank_device

#: Mesh axis names that may carry the population / client dimension, in
#: precedence order (the reference's ``CLIENT_AXES``).
CLIENT_AXES = ("pod", "data")

#: ROADMAP.md queue-1 item that computes over the ``model`` axis: a
#: population split over a mesh whose other axes are wider than 1 would
#: replicate each shard over them (the ``parallel`` placement has no
#: tensor parallelism yet; the ``sequential`` one's came with part 4a).
MODEL_AXIS_ITEM = "10 part 4c"


def _require_unique_ids(client_ids: np.ndarray, op: str) -> None:
    """Raise if a cohort names the same client twice (one client's update
    would be silently lost to the other's)."""
    ids, counts = np.unique(client_ids, return_counts=True)
    if ids.shape[0] != np.asarray(client_ids).shape[0]:
        dups = ids[counts > 1]
        raise ValueError(
            f"{op} got duplicate client ids {dups.tolist()}: a cohort may "
            f"name each client at most once (duplicate writes would "
            f"silently drop all but one update)")


def _host(x) -> np.ndarray:
    """A tensor (any device) or array-like -> a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _np_dtype(x) -> np.dtype:
    """The numpy dtype of a tensor or array leaf, without copying it."""
    if isinstance(x, torch.Tensor):
        return torch.empty((), dtype=x.dtype).numpy().dtype
    return np.asarray(x).dtype


class PopulationLayout(NamedTuple):
    """How a population of ``num_clients`` lays out over a mesh:
    ``padded_num_clients`` is ``num_clients`` rounded up to a multiple of
    ``extent`` (the product of the sharded axes' sizes), ``spec`` the mesh
    axes the leading axis shards over (``()`` when unsharded)."""

    num_clients: int
    padded_num_clients: int
    spec: tuple
    extent: int

    @property
    def padding(self) -> int:
        """Number of dead tail rows added to make N divisible."""
        return self.padded_num_clients - self.num_clients

    @property
    def rows_per_shard(self) -> int:
        """Rows each shard holds, padding included."""
        return self.padded_num_clients // self.extent


def _spec_axes(population_spec) -> tuple:
    """The mesh axes a leading-axis spec names: ``("data",)``, ``"data"``
    or ``(("pod", "data"),)`` (a ``PartitionSpec``'s first entry)."""
    if population_spec is None:
        return ()
    parts = ((population_spec,) if isinstance(population_spec, str)
             else tuple(population_spec))
    if not parts or parts[0] is None:
        return ()
    head = parts[0]
    return tuple(head) if isinstance(head, (tuple, list)) else (head,)


def population_layout(mesh, num_clients: int,
                      population_spec=None) -> PopulationLayout:
    """The padded population layout for ``num_clients`` over ``mesh``, the
    reference's arithmetic: the leading axis shards over the mesh's
    ``CLIENT_AXES`` (or ``population_spec``'s axes). Only ``mesh.shape``
    (``{axis: size}``) and ``mesh.axis_names`` are read; ``mesh=None`` or
    an extent of 1 is the unsharded layout."""
    if num_clients <= 0:
        raise ValueError(f"num_clients must be >= 1, got {num_clients}")
    if mesh is None:
        return PopulationLayout(num_clients, num_clients, (), 1)
    if population_spec is None:
        axes = tuple(a for a in CLIENT_AXES if a in mesh.axis_names)
    else:
        axes = _spec_axes(population_spec)
        missing = [a for a in axes if a not in mesh.axis_names]
        if missing:
            raise ValueError(
                f"population_spec names mesh axes {missing} not in mesh "
                f"{tuple(mesh.axis_names)}")
    extent = 1
    for a in axes:
        extent *= mesh.shape[a]
    if extent <= 1:
        return PopulationLayout(num_clients, num_clients, (), 1)
    padded = -(-num_clients // extent) * extent
    return PopulationLayout(num_clients, padded, axes, extent)


def shard_index(mesh, axes, rank: Optional[int] = None) -> int:
    """Row-major index of ``rank``'s coordinates over ``axes`` (0 for no
    axes): the shard of the population, or of the cohort, it holds."""
    coords = mesh.coords(rank)
    idx = 0
    for a in axes:
        idx = idx * mesh.shape[a] + coords[a]
    return idx


def rank_of_shard(mesh, axes) -> list:
    """``rank_of_shard[s]``: the rank holding shard ``s`` over ``axes``,
    which must span every rank (each rank one shard); a mesh with other
    axes wider than 1 would replicate shards across them (compute over the
    model axis, item 10 part 4c; under FSDP the store is element-sharded
    instead and splits no population)."""
    extent = math.prod(mesh.shape[a] for a in axes)
    if extent != mesh.size:
        raise _not_ported(
            f"a mesh {mesh.shape} whose axes {tuple(axes)} cover {extent} of "
            f"its {mesh.size} ranks", MODEL_AXIS_ITEM)
    out = [0] * extent
    for r in range(mesh.size):
        out[shard_index(mesh, axes, r)] = r
    return out


def cohort_ranks(mesh, axes=None) -> list:
    """``cohort_ranks(mesh)[s]``: the rank that runs shard ``s`` of a
    cohort split over the mesh's client axes (those of ``axes``, in
    ``CLIENT_AXES`` order, when given)."""
    names = mesh.axis_names if axes is None else (
        (axes,) if isinstance(axes, str) else tuple(axes))
    return rank_of_shard(mesh, tuple(a for a in CLIENT_AXES if a in names))


def cohort_rows(mesh, num_rows: int, axes=None) -> tuple:
    """The ``[lo, hi)`` cohort rows this rank runs when ``num_rows`` split
    evenly over the ranks (``ValueError`` when they do not divide, as the
    reference's ``NamedSharding`` refuses)."""
    ranks = cohort_ranks(mesh, axes)
    if num_rows % len(ranks):
        raise ValueError(
            f"a cohort of {num_rows} rows does not split evenly over "
            f"{len(ranks)} ranks")
    n = num_rows // len(ranks)
    lo = ranks.index(mesh.rank) * n
    return lo, lo + n


class CohortRoute(NamedTuple):
    """Where one cohort's rows live on a population-sharded store, as seen
    by this rank (built by ``DeviceClientStateStore.prepare_ids``).

    This rank runs cohort rows ``[lo, hi)``. It owns ``own_rows`` (local
    row indices, at cohort positions ``own_pos``, in increasing position)
    and sends ``send_counts[q]`` of them to rank ``q`` at the gather; it
    receives ``recv_counts[p]`` rows from rank ``p``, at positions
    ``lo + recv_pos`` in the order received, and ``order`` puts them back
    in cohort order. The scatter runs the same plan backwards."""

    mesh: object
    lo: int
    hi: int
    own_rows: torch.Tensor
    own_pos: torch.Tensor
    send_counts: tuple
    recv_counts: tuple
    recv_pos: torch.Tensor
    order: torch.Tensor


class BaseClientStateStore(abc.ABC):
    """Shared contract of the host and device stores: population
    validation, lazy ``ensure`` allocation from one client's state
    template, the ``initialized`` guard and the checkpoint population
    check. Subclasses place the buffers and implement gather, scatter,
    reset and the state dict under the CAS contract."""

    #: Whether the class takes a ``mesh`` (population sharding).
    shardable = False

    def __init__(self, num_clients: int, fsdp=None):
        """Create an empty store for a population of ``num_clients``; with
        ``fsdp`` (a ``core.fsdp.FlatShard``) its rows are this rank's
        ``(n,)`` shards of each client's state."""
        if num_clients <= 0:
            raise ValueError(f"num_clients must be >= 1, got {num_clients}")
        self.num_clients = num_clients
        self.fsdp = fsdp
        self._buffers = None              # tree of (N, ...) arrays

    @property
    def initialized(self) -> bool:
        """Whether the dense buffers have been allocated."""
        return self._buffers is not None

    def ensure(self, template):
        """Allocate the zeroed ``(num_clients, ...)`` buffers from one
        client's state template (idempotent; the leaves' dtypes kept). A
        store made for an FSDP layout takes the shard template: every
        leaf ``(n,)``."""
        if self.fsdp is not None:
            bad = [tuple(np.shape(x)) for x in tm.tleaves(template)
                   if tuple(np.shape(x)) != (self.fsdp.n,)]
            if bad:
                raise ValueError(
                    f"a store for an FSDP layout takes this rank's shard "
                    f"template, leaves ({self.fsdp.n},); got {bad}")
        if self._buffers is None:
            self._buffers = self._allocate(template)
        return self

    def _flat_rows(self, buffers):
        """A state dict's buffers: marked as the flat layout's under an
        FSDP layout (whose rows they are)."""
        return buffers if self.fsdp is None else mark_flat(buffers)

    def _check_rows(self, buffers) -> None:
        """``ValueError`` unless a restored store's rows are this FSDP
        layout's ``(N, n)`` (nothing to check without a layout)."""
        if self.fsdp is None:
            return
        bad = [tuple(np.shape(b)) for b in tm.tleaves(buffers)
               if np.ndim(b) != 2 or np.shape(b)[-1] != self.fsdp.n]
        if bad:
            raise ValueError(
                f"rows of shape {bad} are not this FSDP layout's (N, "
                f"{self.fsdp.n}): another layout's rows are re-cut by "
                f"checkpoint.io.restore_checkpoint_fsdp")

    @property
    def nbytes(self) -> int:
        """The bytes of the buffers (0 before ``ensure``), stamps aside."""
        if self._buffers is None:
            return 0
        return sum(b.nbytes if isinstance(b, np.ndarray)
                   else b.numel() * b.element_size()
                   for b in tm.tleaves(self._buffers))

    def _require_initialized(self):
        if self._buffers is None:
            raise RuntimeError(
                f"{type(self).__name__} is uninitialized; call "
                f"ensure(template) with one client's state tree first")

    def _check_restore_stamps(self, state) -> np.ndarray:
        """A state dict's stamps as int64, checked against the population."""
        stamps = _host(state["stamps"]).astype(np.int64)
        if stamps.shape != (self.num_clients,):
            raise ValueError(
                f"stamps shape {stamps.shape} != ({self.num_clients},) — "
                f"checkpoint was written for a different population size")
        return stamps

    @abc.abstractmethod
    def _allocate(self, template):
        """Allocate and return the zeroed ``(N, ...)`` buffer tree."""

    @abc.abstractmethod
    def reset(self):
        """Zero every client's state and write stamp (keeps the buffers)."""

    @abc.abstractmethod
    def gather(self, client_ids):
        """One cohort's state slice: ``(stacked_states, stamps)``."""

    @abc.abstractmethod
    def scatter(self, client_ids, updates, stamps=None, write_mask=None):
        """CAS write-back of a cohort's updates; returns #clients dropped."""

    @abc.abstractmethod
    def state_dict(self):
        """Checkpointable tree: ``{"buffers", "stamps"}`` as numpy."""

    @abc.abstractmethod
    def load_state_dict(self, state):
        """Restore from :meth:`state_dict` output (either store's)."""


class ClientStateStore(BaseClientStateStore):
    """Per-client persistent state: dense host buffers + write stamps."""

    def __init__(self, num_clients: int, fsdp=None):
        """Create an empty host store for ``num_clients`` clients (rows of
        FSDP shards with ``fsdp``)."""
        super().__init__(num_clients, fsdp)
        self._stamps = np.zeros(num_clients, np.int64)

    def _allocate(self, template):
        n = self.num_clients
        return tm.tmap(lambda x: np.zeros((n,) + tuple(np.shape(x)),
                                          _np_dtype(x)), template)

    def reset(self) -> "ClientStateStore":
        """Zero every client's state and write stamp (keeps the buffers)."""
        if self._buffers is not None:
            tm.tmap(lambda b: b.fill(0), self._buffers)
        self._stamps[:] = 0
        return self

    def gather(self, client_ids):
        """``(stacked_states, stamps)``: numpy ``(C, ...)`` slices for the
        round (moved to its device there) and each client's write stamp,
        to hand back to :meth:`scatter`."""
        self._require_initialized()
        ids = np.asarray(client_ids, np.int64)
        states = tm.tmap(lambda b: b[ids], self._buffers)
        return states, self._stamps[ids].copy()

    def scatter(self, client_ids, updates, stamps=None,
                write_mask=None) -> int:
        """Write a cohort's state updates back; returns #clients dropped.

        ``updates`` (the stacked ``state_update``, on any device) are pulled
        to the host here. With ``stamps`` (from the matching
        :meth:`gather`) a client updated since that gather keeps its newer
        value and this write is dropped; ``stamps=None`` writes
        unconditionally. ``write_mask`` ((C,) 0/1) suppresses the writes
        and stamp bumps of masked-out clients (mid-round dropouts), which
        do not count as drops.
        """
        self._require_initialized()
        ids = np.asarray(client_ids, np.int64)
        _require_unique_ids(ids, "ClientStateStore.scatter")
        updates = tm.tmap(_host, updates)
        if stamps is None:
            write = np.ones(ids.shape[0], bool)
        else:
            write = self._stamps[ids] == _host(stamps)
        if write_mask is None:
            wanted = ids.shape[0]
        else:
            wm = _host(write_mask).astype(bool)
            write &= wm
            wanted = int(wm.sum())
        rows = ids[write]
        tm.tmap(lambda b, u: b.__setitem__(rows, u[write]), self._buffers,
                updates)
        self._stamps[rows] += 1
        return int(wanted - rows.shape[0])

    def state_dict(self):
        """The dense buffers + int64 write stamps (the store's own arrays)."""
        self._require_initialized()
        return {"buffers": self._flat_rows(self._buffers),
                "stamps": self._stamps}

    def load_state_dict(self, state) -> "ClientStateStore":
        """Restore from either store's :meth:`state_dict` (copied)."""
        stamps = self._check_restore_stamps(state)
        self._check_rows(state["buffers"])
        self._buffers = tm.tmap(lambda b: np.array(_host(b)),
                                state["buffers"])
        self._stamps = stamps.copy()
        return self


def device_gather(store_state, client_ids: torch.Tensor):
    """The cohort's ``(stacked_states, stamps_snapshot)`` on the device.

    ``store_state`` is :meth:`DeviceClientStateStore.device_state` and
    ``client_ids`` the ``(C,)`` int64 ids on the same device
    (:meth:`DeviceClientStateStore.prepare_ids`): two ``index_select``
    calls per leaf, no host sync. On a population-sharded store
    ``client_ids`` is a :class:`CohortRoute`, and the result is this
    rank's cohort rows, each pulled from the rank that owns it.
    """
    if isinstance(client_ids, CohortRoute):
        return _routed_gather(store_state, client_ids)
    states = tm.tmap(lambda b: b.index_select(0, client_ids),
                     store_state["buffers"])
    return states, store_state["stamps"].index_select(0, client_ids)


def device_scatter(store_state, client_ids: torch.Tensor, updates,
                   stamps: Optional[torch.Tensor] = None, write_mask=None):
    """CAS write-back in place on the device: ``(store_state, drops)``.

    A client whose stamp moved since the matching :func:`device_gather`
    keeps its row (``torch.where`` writes the current row back), applied
    stamps are bumped with ``index_add_``, and ``drops`` (the writes
    dropped) stays a device scalar: the caller decides when, if ever, to
    read it. ``stamps=None`` writes unconditionally. ``write_mask`` ((C,)
    0/1) suppresses masked-out clients' writes and stamp bumps without
    counting them as drops; it syncs only when given on the host.
    ``client_ids`` must be unique (``prepare_ids`` checks on the host). On
    a population-sharded store ``client_ids`` is a :class:`CohortRoute`,
    ``updates`` and ``stamps`` this rank's cohort rows and ``write_mask``
    the whole cohort's; each row is written on the rank that owns it and
    ``drops`` is the count over every rank.
    """
    if isinstance(client_ids, CohortRoute):
        return _routed_scatter(store_state, client_ids, updates, stamps,
                               write_mask)
    buffers, all_stamps = store_state["buffers"], store_state["stamps"]
    current = all_stamps.index_select(0, client_ids)
    ok = (torch.ones_like(current, dtype=torch.bool) if stamps is None
          else current == stamps)
    if write_mask is None:
        wanted = client_ids.shape[0]
    else:
        wm = torch.as_tensor(write_mask, device=client_ids.device) > 0
        ok = ok & wm
        wanted = wm.sum()

    def write(b, u):
        mask = ok.reshape(-1, *(1,) * (u.dim() - 1))
        b.index_copy_(0, client_ids, torch.where(
            mask, u.to(b.dtype), b.index_select(0, client_ids)))

    tm.tmap(write, buffers, updates)
    all_stamps.index_add_(0, client_ids, ok.to(all_stamps.dtype))
    return store_state, wanted - ok.sum()


def _routed_gather(store_state, route: CohortRoute):
    """:func:`device_gather` on a sharded store: each owner sends its
    cohort rows to the ranks that run them."""
    def pull(b):
        got = collective.exchange_rows(route.mesh,
                                       b.index_select(0, route.own_rows),
                                       route.send_counts, route.recv_counts)
        return got.index_select(0, route.order)

    return (tm.tmap(pull, store_state["buffers"]),
            pull(store_state["stamps"]))


def _routed_scatter(store_state, route: CohortRoute, updates, stamps,
                    write_mask):
    """:func:`device_scatter` on a sharded store: the runners send the
    updated rows (and their gather-time stamps) back to the owners, which
    apply the CAS to their own rows."""
    buffers, all_stamps = store_state["buffers"], store_state["stamps"]

    def push(x):
        return collective.exchange_rows(route.mesh,
                                        x.index_select(0, route.recv_pos),
                                        route.recv_counts, route.send_counts)

    current = all_stamps.index_select(0, route.own_rows)
    ok = (torch.ones_like(current, dtype=torch.bool) if stamps is None
          else current == push(stamps))
    if write_mask is None:
        wanted = torch.tensor(route.own_rows.shape[0], device=current.device)
    else:
        wm = torch.as_tensor(write_mask, device=current.device).index_select(
            0, route.own_pos) > 0
        ok = ok & wm
        wanted = wm.sum()

    def write(b, u):
        u = push(u)
        mask = ok.reshape(-1, *(1,) * (u.dim() - 1))
        b.index_copy_(0, route.own_rows, torch.where(
            mask, u.to(b.dtype), b.index_select(0, route.own_rows)))

    tm.tmap(write, buffers, updates)
    all_stamps.index_add_(0, route.own_rows, ok.to(all_stamps.dtype))
    drops = (wanted - ok.sum()).reshape(1)
    return store_state, collective.all_gather_rows(route.mesh, drops).sum()


class DeviceClientStateStore(BaseClientStateStore):
    """Per-client persistent state as tensors on one device.

    Same API and CAS contract as :class:`ClientStateStore`; the engine
    hands :meth:`device_state` and the cohort's :meth:`prepare_ids` to the
    round program, which gathers and scatters on the device, and adopts
    the result with :meth:`set_device_state`. ``gather`` / ``scatter``
    remain for tests and interactive use (``scatter`` reads the drop
    count, one sync). The state crosses to the host only in
    :meth:`state_dict` (checkpoints). ``device`` defaults to ``cuda`` and
    raises without a GPU.

    With a ``mesh`` the population is sharded over its client axes (or
    ``population_spec``'s): this rank's buffers hold rows ``[row_offset,
    row_offset + rows)`` of the padded population on the mesh's device,
    ``gather`` / ``scatter`` take and give this rank's cohort rows, and
    checkpoints go through :meth:`local_state_dict`. With ``fsdp`` instead
    every client's row of this rank's FSDP shard sits on the layout's
    mesh device (the module's docstring).
    """

    shardable = True

    def __init__(self, num_clients: int, *, device=None, mesh=None,
                 population_spec=None, fsdp=None):
        """Create an empty store for ``num_clients`` clients on ``device``
        (with a ``mesh``: its device), population-sharded over ``mesh``
        per ``population_spec`` (default: the mesh's client axes), or
        element-sharded for the FSDP layout ``fsdp`` (on its mesh's
        device)."""
        # core.round builds its engine from this module: import late
        from repro_torch.core.round import resolve_device  # noqa: PLC0415
        super().__init__(num_clients, fsdp)
        if mesh is None and population_spec is not None:
            raise ValueError("population_spec requires a mesh")
        if fsdp is not None and mesh is not None:
            raise ValueError("an FSDP store splits no population: pass "
                             "fsdp or mesh, not both")
        self.mesh = mesh
        self.layout = population_layout(mesh, num_clients, population_spec)
        if mesh is None:
            if device is None and fsdp is not None and fsdp.mesh is not None:
                device = fsdp.mesh.device
            self.device = resolve_device(device)
            self.rows, self.row_offset = num_clients, 0
        else:
            if (device is not None
                    and rank_device(device, mesh.rank) != mesh.device):
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{mesh.device}")
            self.device = mesh.device
            self._owners = rank_of_shard(mesh, self.layout.spec)
            self.rows = self.layout.rows_per_shard
            self.row_offset = self.rows * shard_index(mesh,
                                                      self.layout.spec)
        self._stamps = self._fresh_stamps()

    @property
    def padded_num_clients(self) -> int:
        """The population's extent across the shards (N + padding)."""
        return self.layout.padded_num_clients

    def _fresh_stamps(self) -> torch.Tensor:
        """0 for this rank's live rows, -1 for its padding rows."""
        idx = torch.arange(self.row_offset, self.row_offset + self.rows,
                           device=self.device)
        return torch.where(idx < self.num_clients, 0, -1).to(torch.int64)

    def _allocate(self, template):
        return tm.tmap(lambda x: torch.zeros(
            (self.rows,) + tuple(np.shape(x)),
            dtype=torch.as_tensor(x).dtype, device=self.device), template)

    def reset(self) -> "DeviceClientStateStore":
        """Zero every client's state and write stamp, in place."""
        if self._buffers is not None:
            tm.tmap(lambda b: b.zero_(), self._buffers)
        self._stamps = self._fresh_stamps()
        return self

    def _check_range(self, ids: np.ndarray) -> np.ndarray:
        if ids.size and (ids.min() < 0 or ids.max() >= self.num_clients):
            raise ValueError(
                f"client ids {ids.tolist()} out of range for population "
                f"{self.num_clients}")
        return ids

    def _ids_on_device(self, ids: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.array(ids, np.int64))
        if self.device.type == "cuda":
            # a pinned source copies without blocking the host
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _route(self, ids: np.ndarray) -> CohortRoute:
        """The cohort's :class:`CohortRoute` on this rank (every rank
        builds the same plan from the same ids)."""
        mesh, me = self.mesh, self.mesh.rank
        runners = cohort_ranks(mesh)
        lo, hi = cohort_rows(mesh, ids.shape[0])
        owner = np.asarray(self._owners)[ids // self.rows]
        runner = np.asarray(runners)[np.arange(ids.shape[0]) // (hi - lo)]
        W = mesh.size
        own_pos = np.flatnonzero(owner == me)
        mine = np.arange(lo, hi)
        recv_pos = np.concatenate([mine[owner[lo:hi] == p]
                                   for p in range(W)]) - lo
        return CohortRoute(
            mesh, lo, hi,
            own_rows=self._ids_on_device(ids[own_pos] - self.row_offset),
            own_pos=self._ids_on_device(own_pos),
            send_counts=tuple(int((runner[own_pos] == q).sum())
                              for q in range(W)),
            recv_counts=tuple(int((owner[lo:hi] == p).sum())
                              for p in range(W)),
            recv_pos=self._ids_on_device(recv_pos),
            order=self._ids_on_device(np.argsort(recv_pos, kind="stable")))

    def prepare_ids(self, client_ids):
        """Cohort ids -> the ``(C,)`` int64 ids on the device (a
        :class:`CohortRoute` on a sharded store), checked on the host for
        duplicates and range first (``index_select`` would raise on the
        device, ``index_copy_`` would let a duplicate win)."""
        ids = np.asarray(client_ids, np.int64)
        _require_unique_ids(ids, "DeviceClientStateStore")
        self._check_range(ids)
        return self._ids_on_device(ids) if self.mesh is None \
            else self._route(ids)

    def device_state(self):
        """The store as ``{"buffers", "stamps"}`` for the round program
        (this rank's rows on a sharded store)."""
        self._require_initialized()
        return {"buffers": self._buffers, "stamps": self._stamps}

    def set_device_state(self, store_state) -> "DeviceClientStateStore":
        """Adopt the ``{"buffers", "stamps"}`` a round returned (the same
        tensors, updated in place; nothing syncs)."""
        self._buffers = store_state["buffers"]
        self._stamps = store_state["stamps"]
        return self

    def gather(self, client_ids):
        """``(stacked_states, stamps)`` on the device, ids range-checked
        (on a sharded store: this rank's cohort rows)."""
        self._require_initialized()
        ids = self._check_range(np.asarray(client_ids, np.int64))
        return device_gather(self.device_state(), self._ids_on_device(ids)
                             if self.mesh is None else self._route(ids))

    def scatter(self, client_ids, updates, stamps=None,
                write_mask=None) -> int:
        """CAS write-back; returns #clients dropped (reads the count). On a
        sharded store ``updates`` and ``stamps`` are this rank's cohort
        rows and the count is over every rank."""
        ids = self.prepare_ids(client_ids)
        updates = tm.tmap(lambda u: torch.as_tensor(u, device=self.device),
                          updates)
        if stamps is not None:
            stamps = torch.as_tensor(stamps, device=self.device)
        new_state, drops = device_scatter(self.device_state(), ids, updates,
                                          stamps, write_mask)
        self.set_device_state(new_state)
        return int(drops)

    def _live(self) -> int:
        """How many of this rank's rows are live clients (not padding)."""
        return max(0, min(self.rows, self.num_clients - self.row_offset))

    def state_dict(self):
        """A host copy: numpy buffers and int64 stamps of the live rows, as
        the host store's, so a checkpoint restores into either placement
        and any layout. On a multi-process mesh no rank holds every row:
        use :meth:`local_state_dict` there."""
        self._require_initialized()
        if self.mesh is not None and self.mesh.size > 1:
            raise RuntimeError(
                "state_dict() needs every row addressable; on a "
                "multi-process mesh checkpoint shard-locally with "
                "local_state_dict() instead")
        return self.local_state_dict()[0]

    def load_state_dict(self, state) -> "DeviceClientStateStore":
        """Restore from either store's :meth:`state_dict` (the whole
        population; each rank keeps its own rows, re-padded)."""
        stamps = self._check_restore_stamps(state)
        self._check_rows(state["buffers"])
        return self._load_rows(state["buffers"], stamps, 0)

    def local_state_dict(self):
        """This rank's live rows: ``(state, row_offset)``, ``state`` as
        :meth:`state_dict` gives it (padding clipped, int64 stamps) and
        ``row_offset`` its position in the population; feed both to
        ``checkpoint.save_checkpoint_shard``."""
        self._require_initialized()
        live = self._live()
        state = {"buffers": self._flat_rows(tm.tmap(
                     lambda b: b[:live].detach().to("cpu", copy=True).numpy(),
                     self._buffers)),
                 "stamps": self._stamps[:live].to("cpu", copy=True).numpy()}
        return state, min(self.row_offset, self.num_clients)

    def load_local_state_dict(self, state, row_offset: int
                              ) -> "DeviceClientStateStore":
        """Restore from one rank's :meth:`local_state_dict` (or one shard
        file): the rows of ``[row_offset, row_offset + rows)`` that this
        rank owns are loaded, its other rows zeroed (stamps 0, -1 on
        padding). An unsharded store needs the whole population."""
        self._check_rows(state["buffers"])
        stamps = _host(state["stamps"]).astype(np.int64)
        rows = stamps.shape[0]
        if row_offset < 0 or row_offset + rows > self.num_clients:
            raise ValueError(
                f"shard rows [{row_offset}, {row_offset + rows}) out of "
                f"range for population {self.num_clients}")
        if self.mesh is None and (row_offset != 0
                                  or rows != self.num_clients):
            raise ValueError(
                "unsharded store restore needs the full population "
                "(offset 0); got a partial shard")
        return self._load_rows(state["buffers"], stamps, row_offset)

    def _load_rows(self, buffers, stamps: np.ndarray, offset: int):
        """Load host rows that start at population row ``offset`` into the
        rows this rank owns (the rest: zeros, fresh stamps)."""
        lo = max(offset, self.row_offset)
        hi = min(offset + stamps.shape[0], self.row_offset + self.rows)

        def rows_of(src: np.ndarray, fresh: torch.Tensor) -> torch.Tensor:
            if hi > lo:
                fresh[lo - self.row_offset:hi - self.row_offset] = \
                    torch.from_numpy(np.ascontiguousarray(
                        src[lo - offset:hi - offset]))
            return fresh

        def buffer(b) -> torch.Tensor:
            b = _host(b)
            return rows_of(b, torch.zeros(
                (self.rows,) + b.shape[1:], device=self.device,
                dtype=torch.as_tensor(b[:0]).dtype))

        self._buffers = tm.tmap(buffer, buffers)
        self._stamps = rows_of(stamps, self._fresh_stamps())
        return self


#: Store classes by ``FedConfig.client_state_placement`` value.
STORES = {}


def register_store(name: str, cls, *, override: bool = False):
    """Register a store class under a placement ``name``; re-registering a
    name raises unless ``override=True``. Returns ``cls``."""
    if not issubclass(cls, BaseClientStateStore):
        raise TypeError(f"{cls!r} must subclass BaseClientStateStore")
    if not override and name in STORES and STORES[name] is not cls:
        raise ValueError(
            f"client-state store {name!r} is already registered to "
            f"{STORES[name]!r}; pass override=True to replace it")
    STORES[name] = cls
    return cls


register_store("host", ClientStateStore)
register_store("device", DeviceClientStateStore)


def make_client_store(placement: str, num_clients: int, *, device=None,
                      mesh=None, population_spec=None, fsdp=None
                      ) -> BaseClientStateStore:
    """The store for a ``client_state_placement`` value; ``device`` places
    the device store (default ``cuda``, or the FSDP layout's device).
    ``mesh`` / ``population_spec`` shard the population; only a store
    class that is ``shardable`` (the device store) takes them. ``fsdp`` (a
    ``core.fsdp.FlatShard``) makes either store hold this rank's FSDP
    shard of every client's state."""
    try:
        cls = STORES[placement]
    except KeyError:
        raise ValueError(
            f"unknown client_state_placement {placement!r}; "
            f"known: {tuple(STORES)}") from None
    if fsdp is not None:
        if mesh is not None:
            raise ValueError("an FSDP store splits no population: pass "
                             "fsdp or mesh, not both")
        if cls.shardable:
            return cls(num_clients, device=device, fsdp=fsdp)
        return cls(num_clients, fsdp=fsdp)
    if mesh is not None:
        if not cls.shardable:
            raise ValueError(
                f"client_state_placement={placement!r} does not support "
                f"population sharding (mesh given); use \"device\"")
        return cls(num_clients, device=device, mesh=mesh,
                   population_spec=population_spec)
    if cls.shardable:
        return cls(num_clients, device=device)
    return cls(num_clients)
