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

Population sharding — the reference's ``mesh`` / ``population_spec``
arguments, ``population_layout``, the ``CLIENT_AXES`` placement and the
shard-local ``local_state_dict`` / ``load_local_state_dict`` — waits for
ROADMAP.md queue 1, item 10, and raises ``NotImplementedError`` naming it.
"""
from __future__ import annotations

import abc
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import _not_ported
from repro_torch.core import tree_math as tm

#: ROADMAP.md queue-1 item that ports population sharding.
SHARDING_ITEM = 10


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


def population_layout(*args, **kwargs):
    """The padded population layout over a mesh: not ported (item 10)."""
    del args, kwargs
    raise _not_ported("population_layout (population sharding)",
                      SHARDING_ITEM)


class BaseClientStateStore(abc.ABC):
    """Shared contract of the host and device stores: population
    validation, lazy ``ensure`` allocation from one client's state
    template, the ``initialized`` guard and the checkpoint population
    check. Subclasses place the buffers and implement gather, scatter,
    reset and the state dict under the CAS contract."""

    def __init__(self, num_clients: int):
        """Create an empty store for a population of ``num_clients``."""
        if num_clients <= 0:
            raise ValueError(f"num_clients must be >= 1, got {num_clients}")
        self.num_clients = num_clients
        self._buffers = None              # tree of (N, ...) arrays

    @property
    def initialized(self) -> bool:
        """Whether the dense buffers have been allocated."""
        return self._buffers is not None

    def ensure(self, template):
        """Allocate the zeroed ``(num_clients, ...)`` buffers from one
        client's state template (idempotent; the leaves' dtypes kept)."""
        if self._buffers is None:
            self._buffers = self._allocate(template)
        return self

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

    def __init__(self, num_clients: int):
        """Create an empty host store for ``num_clients`` clients."""
        super().__init__(num_clients)
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
        return {"buffers": self._buffers, "stamps": self._stamps}

    def load_state_dict(self, state) -> "ClientStateStore":
        """Restore from either store's :meth:`state_dict` (copied)."""
        stamps = self._check_restore_stamps(state)
        self._buffers = tm.tmap(lambda b: np.array(_host(b)),
                                state["buffers"])
        self._stamps = stamps.copy()
        return self


def device_gather(store_state, client_ids: torch.Tensor):
    """The cohort's ``(stacked_states, stamps_snapshot)`` on the device.

    ``store_state`` is :meth:`DeviceClientStateStore.device_state` and
    ``client_ids`` the ``(C,)`` int64 ids on the same device
    (:meth:`DeviceClientStateStore.prepare_ids`): two ``index_select``
    calls per leaf, no host sync.
    """
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
    ``client_ids`` must be unique (``prepare_ids`` checks on the host).
    """
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
    """

    def __init__(self, num_clients: int, *, device=None):
        """Create an empty store for ``num_clients`` clients on ``device``."""
        # core.round builds its engine from this module: import late
        from repro_torch.core.round import resolve_device  # noqa: PLC0415
        super().__init__(num_clients)
        self.device = resolve_device(device)
        self._stamps = torch.zeros(num_clients, dtype=torch.int64,
                                   device=self.device)

    def _allocate(self, template):
        n = self.num_clients
        return tm.tmap(lambda x: torch.zeros(
            (n,) + tuple(np.shape(x)), dtype=torch.as_tensor(x).dtype,
            device=self.device), template)

    def reset(self) -> "DeviceClientStateStore":
        """Zero every client's state and write stamp, in place."""
        if self._buffers is not None:
            tm.tmap(lambda b: b.zero_(), self._buffers)
        self._stamps.zero_()
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

    def prepare_ids(self, client_ids) -> torch.Tensor:
        """Cohort ids -> the ``(C,)`` int64 ids on the device, checked on
        the host for duplicates and range first (``index_select`` would
        raise on the device, ``index_copy_`` would let a duplicate win)."""
        ids = np.asarray(client_ids, np.int64)
        _require_unique_ids(ids, "DeviceClientStateStore")
        return self._ids_on_device(self._check_range(ids))

    def device_state(self):
        """The store as ``{"buffers", "stamps"}`` for the round program."""
        self._require_initialized()
        return {"buffers": self._buffers, "stamps": self._stamps}

    def set_device_state(self, store_state) -> "DeviceClientStateStore":
        """Adopt the ``{"buffers", "stamps"}`` a round returned (the same
        tensors, updated in place; nothing syncs)."""
        self._buffers = store_state["buffers"]
        self._stamps = store_state["stamps"]
        return self

    def gather(self, client_ids):
        """``(stacked_states, stamps)`` on the device, ids range-checked."""
        self._require_initialized()
        ids = self._check_range(np.asarray(client_ids, np.int64))
        return device_gather(self.device_state(), self._ids_on_device(ids))

    def scatter(self, client_ids, updates, stamps=None,
                write_mask=None) -> int:
        """CAS write-back; returns #clients dropped (reads the count)."""
        ids = self.prepare_ids(client_ids)
        updates = tm.tmap(lambda u: torch.as_tensor(u, device=self.device),
                          updates)
        if stamps is not None:
            stamps = torch.as_tensor(stamps, device=self.device)
        new_state, drops = device_scatter(self.device_state(), ids, updates,
                                          stamps, write_mask)
        self.set_device_state(new_state)
        return int(drops)

    def state_dict(self):
        """A host copy: numpy buffers and int64 stamps, as the host
        store's, so a checkpoint restores into either placement."""
        self._require_initialized()
        return {"buffers": tm.tmap(
                    lambda b: b.detach().to("cpu", copy=True).numpy(),
                    self._buffers),
                "stamps": self._stamps.to("cpu", copy=True).numpy()}

    def load_state_dict(self, state) -> "DeviceClientStateStore":
        """Restore from either store's :meth:`state_dict` (copied to the
        device; population checked)."""
        stamps = self._check_restore_stamps(state)
        self._buffers = tm.tmap(
            lambda b: torch.tensor(_host(b), device=self.device),
            state["buffers"])
        self._stamps = torch.tensor(stamps, device=self.device)
        return self

    def local_state_dict(self):
        """Shard-local checkpoint rows: not ported (item 10)."""
        raise _not_ported("local_state_dict (shard-local checkpoints)",
                          SHARDING_ITEM)

    def load_local_state_dict(self, state, row_offset: int):
        """Shard-local restore: not ported (item 10)."""
        del state, row_offset
        raise _not_ported("load_local_state_dict (shard-local checkpoints)",
                          SHARDING_ITEM)


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
                      mesh=None, population_spec=None
                      ) -> BaseClientStateStore:
    """The store for a ``client_state_placement`` value; ``device`` places
    the device store (default ``cuda``). A ``mesh`` or ``population_spec``
    (population sharding) raises ``NotImplementedError`` (item 10)."""
    try:
        cls = STORES[placement]
    except KeyError:
        raise ValueError(
            f"unknown client_state_placement {placement!r}; "
            f"known: {tuple(STORES)}") from None
    if mesh is not None or population_spec is not None:
        raise _not_ported("a population-sharded client store (mesh=)",
                          SHARDING_ITEM)
    if cls is DeviceClientStateStore:
        return cls(num_clients, device=device)
    return cls(num_clients)
