"""FSDP over the ranks of a mesh for the ``sequential`` placement: the
port's counterpart of the reference's sharding hooks (``fsdp_constrain``,
``tp_constrain``, ``prepare_params``, ``finalize_params``,
``constrain_accum``; ``repro/sharding/rules.py:174-229``,
``repro/core/sharded_round.py:68-95``).

The reference lays every parameter-shaped tensor of the sequential round
(the fp32 master, the server optimizer state, the accumulator, the client
iterate and its moments, the IASG samples, the DP vectors) over data x
model with XLA shardings and all-gathers the compute params at each local
step. Here the layout is one flat partition, FSDP's flat-parameter idiom:
the params tree is ravelled in the template's leaf order (``tree_math
.flatten``'s) into d elements, padded with zeros to ``W n`` where ``n =
ceil(d / W)`` over the W ranks, and rank r holds elements ``[r n, (r + 1)
n)``. Every parameter-shaped state is then one ``(n,)`` tensor (``(1, n)``
under the sequential placement's client axis of 1), so the elementwise
steps (client and server optimizers, the accumulator, FedAvg's delta,
IASG's averages) run on the shard unchanged.

A local step (``wrap_grad``): ``gather_tree`` all-gathers the iterate's
shard, in its dtype (the compute dtype), into the whole params tree; the
cohort-batched ``grad_fn`` runs on this rank's rows of the client's batch
(``local_rows``); ``reduce_grads`` sums the flat fp32 gradient over every
rank, divides by W and keeps this rank's shard. The rows split over the
client axes ("pod", "data") only, so the ranks along "model" compute the
same rows: the sum over the W ranks is "model" times the sum over the
data ranks, and dividing by W gives the mean over the client's batch. The
losses are averaged the same way, so every rank holds the whole batch's
loss. The DP's dot products are sums over the shards
(``kernels.ops.dp_step_sharded``). Every collective runs outside
``torch.func``: the wrapper sits around the cohort-batched ``grad_fn``.

Every algorithm runs on the shards. The stateful ones keep their state
in the same layout: SCAFFOLD's server control variate is one more ``(n,)``
shard of the ``ServerState`` (``shard_state``), and a client store built
for the layout (``core.client_state.make_client_store(..., fsdp=)``) holds
every client's row of this rank's ``n`` elements, ``(N, n)``: every rank
runs every client, so the population does not split. The broadcast extras
(MIME's frozen server momentum, SCAFFOLD's ``c``), the payloads and the
accumulator are shards as well, and every map on them is elementwise. The
one reduction over the whole parameter vector, ``fedpa_precision``'s mean
precision under a staleness discount, goes through ``param_total``: the
sum of this rank's real elements (the zero padding past ``d`` is not
neutral there: a padded coordinate's precision is ``1 / rho_l``),
all-reduced over the ranks, over a count of ``d``.

FedLoRA's payload codecs work leaf by leaf, and a shard cuts leaves at any
element (mid-row too). ``leaf_pieces`` says which elements ``[a, b)`` of
each template leaf lie in this rank's shard and where; ``split`` cuts a
shard into those pieces and ``join`` puts pieces back (the padding belongs
to no piece). The ``lowrank`` sketch ``x @ V`` is a sum over a matrix
leaf's columns, so each rank multiplies the rows its pieces touch and the
partial factors are summed over the ranks (``sum_over_ranks``); the
``int8`` scale is one client's ``max |x|`` over one leaf, so a piece's
scale is the max over the ranks of each rank's piece max
(``max_over_ranks``). Each is one call for all of a client's leaves
(``compression.base.CodecChain``).

Leaves are matched by their key paths, so a tree built in another key
order (the JAX package's sorted one) shards to the same elements. Without
a mesh, or on a mesh of one rank, the layout is the identity (``n = d``)
and a collective moves no data to another rank (a one-rank group still
makes its calls). A server state or a store in the flat layout is not a
tree of whole leaves: ``checkpoint.io.save_checkpoint`` refuses it, and
``checkpoint.io.save_checkpoint_fsdp`` writes each rank's shards, which
``restore_checkpoint_fsdp`` reads back into a layout of any W.
"""
from __future__ import annotations

import weakref
from typing import Callable, List, NamedTuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.compression.base import jax_leaf_index
from repro_torch.core import collective
from repro_torch.kernels import ops

#: The algorithms an FSDP round runs: all of the port's, with every
#: payload codec.
ALGORITHMS = ("fedavg", "fedpa", "fedpa_precision", "fedprox", "mime",
              "scaffold", "fedep", "fedlora")

#: ``id -> weakref`` of every tensor (or numpy array) held in the flat
#: layout: a server state's (``shard_state``'s, and each server step's
#: under a layout) and a store's rows (its state dict): what
#: ``in_flat_layout`` recognises.
_FLAT: dict = {}


class LeafPiece(NamedTuple):
    """The part of one template leaf that lies in a rank's shard: the
    leaf's key ``path`` and ``shape``, its ``index`` in JAX's flatten
    order (what a codec keys the leaf's sketch by), its elements ``[a,
    b)`` in the leaf's ravel (``a == b``: none on this rank) and where
    they start in the shard (``at``)."""

    path: str
    shape: tuple
    index: int
    a: int
    b: int
    at: int

    @property
    def size(self) -> int:
        """How many of the leaf's elements lie in the shard."""
        return self.b - self.a


def _paths(tree) -> list:
    """``(key path, leaf)`` pairs in the tree's flatten order."""
    return [(pytree.keystr(k), x)
            for k, x in pytree.tree_flatten_with_path(tree)[0]]


def mark_flat(tree):
    """Record every tensor (and numpy array) of ``tree`` as held in the
    flat layout (until it is freed); returns ``tree``."""
    for x in pytree.tree_leaves(tree):
        if isinstance(x, (torch.Tensor, np.ndarray)):
            k = id(x)

            def forget(ref, k=k):
                if _FLAT.get(k) is ref:
                    del _FLAT[k]

            _FLAT[k] = weakref.ref(x, forget)
    return tree


def in_flat_layout(x) -> bool:
    """Whether ``x`` is a tensor (or array) held in the flat layout."""
    ref = _FLAT.get(id(x))
    return ref is not None and ref() is x


class FlatShard:
    """The flat partition of a params tree over the ranks of ``mesh``:
    ``d`` elements, ``W`` ranks, ``n = ceil(d / W)`` a rank, this rank's
    elements ``[lo, lo + n)`` (the last rank's tail is zero padding), the
    ``template`` tree (shapes; meta tensors do) and this rank's part of a
    client's batch rows (``data_extent``, ``data_index``)."""

    def __init__(self, template, mesh=None):
        pairs = _paths(template)
        self.template = template
        self.mesh = mesh
        self.paths = [p for p, _ in pairs]
        self.shapes = [tuple(x.shape) for _, x in pairs]
        self.sizes = [x.numel() for _, x in pairs]
        self.d = sum(self.sizes)
        self.W = 1 if mesh is None else mesh.size
        self.rank = 0 if mesh is None else mesh.rank
        self.n = -(-self.d // self.W)
        self.lo = self.rank * self.n
        self.data_extent, self.data_index = ((1, 0) if mesh is None
                                             else mesh.data_slot())
        self._pieces = None

    # -- layout ---------------------------------------------------------------
    def _leaves(self, tree) -> list:
        """``tree``'s leaves in the template's order, matched by key path
        (``ValueError`` when the paths differ)."""
        got = dict(_paths(tree))
        if set(got) != set(self.paths):
            raise ValueError(f"a tree with leaves {sorted(got)} is not "
                             f"shaped like the layout's {sorted(self.paths)}")
        return [got[p] for p in self.paths]

    def _pack(self, tree, lo: int, hi: int, lead_dims: int, dtype):
        """Elements ``[lo, hi)`` of the flat ravel of ``tree`` (padding past
        ``d`` is zero), keeping each leaf's first ``lead_dims`` axes:
        ``(*lead, hi - lo)`` in ``dtype``."""
        leaves = [torch.as_tensor(x) for x in self._leaves(tree)]
        lead = tuple(leaves[0].shape[:lead_dims])
        out = torch.zeros(*lead, hi - lo, dtype=dtype,
                          device=leaves[0].device)
        off = 0
        for x, k in zip(leaves, self.sizes):
            a, b = max(off, lo), min(off + k, hi)
            if a < b:
                out[..., a - lo:b - lo] = x.reshape(*lead, k)[..., a - off:
                                                               b - off]
            off += k
        return out

    def shard_tree(self, tree, dtype=torch.float32) -> torch.Tensor:
        """This rank's ``(n,)`` elements of a whole params-shaped tree."""
        return self._pack(tree, self.lo, self.lo + self.n, 0, dtype)

    def gather_tree(self, shard: torch.Tensor, dtype=None):
        """The whole tree from every rank's ``shard`` (``(n,)``, or ``(1,
        n)`` with the sequential client axis, kept on every leaf), in
        ``dtype`` (default the shard's): one all-gather of the shard in
        that dtype."""
        lead = tuple(shard.shape[:-1])
        if shard.shape[-1] != self.n or any(s != 1 for s in lead):
            raise ValueError(f"a shard of shape {tuple(shard.shape)} is not "
                             f"(n,) or (1, n) with n = {self.n}")
        dtype = dtype or shard.dtype
        flat = collective.all_gather_flat(self.mesh,
                                          shard.to(dtype).reshape(-1))
        return self._unravel(flat.reshape(*lead, -1))

    def _unravel(self, rows: torch.Tensor):
        """The params tree of a ``(*lead, W n)`` ravel, ``lead`` kept on
        every leaf (the padding dropped)."""
        lead = tuple(rows.shape[:-1])
        out, off = [], 0
        for k, shape in zip(self.sizes, self.shapes):
            out.append(rows[..., off:off + k].reshape(*lead, *shape))
            off += k
        return pytree.tree_unflatten(out, pytree.tree_structure(
            self.template))

    def reduce_grads(self, flat_grads: torch.Tensor) -> torch.Tensor:
        """This rank's shard of the mean over ranks of ``flat_grads``
        (``(W n,)`` or ``(1, W n)`` fp32, the padded ravel of one rank's
        gradient; overwritten): summed in fp32 over every rank, divided by
        W. Keeps the leading axes."""
        lead = tuple(flat_grads.shape[:-1])
        out = collective.reduce_scatter_flat(
            self.mesh, flat_grads.to(torch.float32).reshape(-1))
        return (out / self.W).reshape(*lead, self.n)

    def mean_over_ranks(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over ranks of a small tensor (the losses)."""
        return collective.all_reduce_small(self.mesh, x) / self.W

    def sum_over_ranks(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over ranks of a codec's partials (the ``lowrank``
        factors of a client's leaves), in ``x``'s dtype."""
        return collective.all_reduce_codec(self.mesh, x, "sum")

    def max_over_ranks(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max over ranks of a codec's partials (the
        ``int8`` per-leaf maxima of a client's pieces)."""
        return collective.all_reduce_codec(self.mesh, x, "max")

    # -- the leaves' pieces (the payload codecs) ------------------------------
    def leaf_pieces(self) -> List[LeafPiece]:
        """For each template leaf, in the layout's order, the
        :class:`LeafPiece` of this rank's shard (an empty one when the
        leaf has no element here; the padding past ``d`` is no piece)."""
        if self._pieces is None:
            index = jax_leaf_index(self.template)
            out, off, hi = [], 0, self.lo + self.n
            for i, (path, shape, k) in enumerate(zip(self.paths, self.shapes,
                                                     self.sizes)):
                a = min(max(self.lo - off, 0), k)
                b = max(min(hi - off, k), a)
                out.append(LeafPiece(path, shape, index[i], a, b,
                                     max(off + a - self.lo, 0)))
                off += k
            self._pieces = out
        return self._pieces

    def split(self, shard: torch.Tensor) -> list:
        """A ``(*lead, n)`` shard -> its pieces, one ``(*lead, b - a)``
        view per template leaf (``leaf_pieces``' order)."""
        return [shard[..., p.at:p.at + p.size] for p in self.leaf_pieces()]

    def join(self, pieces: list) -> torch.Tensor:
        """``split``'s inverse: the ``(*lead, n)`` shard of one piece per
        leaf, in the first piece's dtype, zero on the padding."""
        x0 = pieces[0]
        out = torch.zeros(*x0.shape[:-1], self.n, dtype=x0.dtype,
                          device=x0.device)
        for p, x in zip(self.leaf_pieces(), pieces):
            out[..., p.at:p.at + p.size] = x
        return out

    @property
    def real(self) -> int:
        """How many of this rank's ``n`` elements are parameters: ``n``,
        but fewer on the last rank when ``W`` does not divide ``d`` (the
        rest is padding), none past it."""
        return max(0, min(self.n, self.d - self.lo))

    def param_total(self, shard: torch.Tensor):
        """``(fp32 sum, count)`` over every parameter of a params-shaped
        ``shard`` (``(..., n)``): this rank's real elements summed, the
        padding left out, the partial sums all-reduced over the ranks; the
        count covers exactly the ``d`` parameters of each leading row."""
        part = shard[..., :self.real].to(torch.float32).sum()
        lead = shard.numel() // self.n
        return (collective.all_reduce_small(self.mesh, part.reshape(1))[0],
                lead * self.d)

    # -- the round's hooks ----------------------------------------------------
    def wrap_grad(self, grad_fn: Callable) -> Callable:
        """``grad_fn(params, batch) -> (loss (1,), grads)`` (cohort-batched,
        a client axis of 1) as a step on this rank's shard: ``fn(shard (1,
        n), rows) -> (loss (1,) over the client's whole batch, this rank's
        shard of the batch-mean gradient (1, n) in the shard's dtype)``."""
        def fsdp_grad_fn(shard, batch):
            loss, grads = grad_fn(self.gather_tree(shard), batch)
            flat = self._pack(grads, 0, self.W * self.n, 1, torch.float32)
            return (self.mean_over_ranks(loss),
                    self.reduce_grads(flat).to(shard.dtype))

        return fsdp_grad_fn

    def dp_step(self, u, delta, V, c_hist, t: int, rho: float):
        """One DP step on this rank's shards (``ops.dp_step_sharded``), its
        dot products summed over the ranks."""
        return ops.dp_step_sharded(
            u, delta, V, c_hist, t, rho,
            all_reduce=lambda x: collective.all_reduce_small(self.mesh, x))

    def local_rows(self, batches):
        """This rank's rows of every client's batch: each ``(C, K, B,
        ...)`` leaf split on ``B`` over the client axes (the step mask
        ``"_active"`` is per client and stays whole). ``ValueError`` when
        ``B`` does not divide, as the reference's ``NamedSharding``
        refuses."""
        E, i = self.data_extent, self.data_index

        def take(x):
            B = x.shape[2]
            if B % E:
                raise ValueError(
                    f"a client's {B} batch rows do not split evenly over the "
                    f"mesh's data extent {E}")
            m = B // E
            return x[:, :, i * m:(i + 1) * m]

        if isinstance(batches, dict):
            return {k: v if k == "_active" else take(v)
                    for k, v in batches.items()}
        return take(batches)

    # -- server state and client states --------------------------------------
    def _is_full(self, x, lead_dims: int = 0) -> bool:
        """Whether ``x`` is a whole params-shaped tree (with ``lead_dims``
        leading axes on every leaf; tensors or numpy arrays)."""
        pairs = _paths(x)
        return (len(pairs) == len(self.paths)
                and all(hasattr(v, "shape") for _, v in pairs)
                and dict((p, tuple(v.shape[lead_dims:])) for p, v in pairs)
                == dict(zip(self.paths, self.shapes)))

    def _is_shard(self, x) -> bool:
        return isinstance(x, torch.Tensor) and tuple(x.shape) == (self.n,)

    def _is_rows(self, x) -> bool:
        return (isinstance(x, torch.Tensor) and x.dim() == 2
                and x.shape[-1] == self.n)

    def _map(self, obj, pred, fn):
        """``fn`` on every part of ``obj`` (nested dicts, tuples, lists)
        that ``pred`` holds for; the rest (step counters) unchanged."""
        if pred(obj):
            return fn(obj)
        if isinstance(obj, dict):
            return {k: self._map(v, pred, fn) for k, v in obj.items()}
        if isinstance(obj, (tuple, list)) and not hasattr(obj, "_fields"):
            return type(obj)(self._map(v, pred, fn) for v in obj)
        return obj

    def shard_state(self, state):
        """A whole ``ServerState`` -> this rank's sharded one: the params
        and every params-shaped part of the optimizer state and of
        ``algo_state`` (SCAFFOLD's server control variate) as ``(n,)``
        fp32 shards, matched by key path."""
        return mark_flat(state._replace(**{
            k: self._map(getattr(state, k), self._is_full, self.shard_tree)
            for k in ("params", "opt_state", "algo_state")}))

    def gather_state(self, state):
        """The sharded ``ServerState`` -> the whole one on every rank (one
        all-gather per params-shaped part)."""
        return state._replace(**{
            k: self._map(getattr(state, k), self._is_shard, self.gather_tree)
            for k in ("params", "opt_state", "algo_state")})

    def shard_rows(self, tree):
        """This rank's ``(C, n)`` rows of every stacked ``(C, ...)``
        params-shaped part of ``tree`` (a store slice, or a dict of them
        such as FedEP's sites; tensors or numpy), each in its own dtype."""
        def rows(x):
            x0 = torch.as_tensor(self._leaves(x)[0])
            return self._pack(x, self.lo, self.lo + self.n, 1, x0.dtype)

        return self._map(tree, lambda x: self._is_full(x, 1), rows)

    def gather_rows(self, tree):
        """``shard_rows``'s inverse on every rank: each ``(C, n)`` part of
        ``tree`` -> the stacked whole ``(C, ...)`` tree (one all-gather
        each)."""
        def whole(x):
            C = x.shape[0]
            flat = collective.all_gather_flat(self.mesh, x.reshape(-1))
            return self._unravel(flat.reshape(self.W, C, self.n)
                                 .transpose(0, 1).reshape(C, -1))

        return self._map(tree, self._is_rows, whole)

    def check_rows(self, cstates) -> None:
        """``ValueError`` unless every leaf of a cohort's client states is
        a ``(C, n)`` row of this layout (a store made for whole trees
        hands whole rows)."""
        for x in pytree.tree_leaves(cstates):
            if not self._is_rows(x):
                raise ValueError(
                    f"a client state of shape {tuple(x.shape)} under an "
                    f"FSDP round: the store's rows must be this rank's "
                    f"(C, {self.n}) shards (make_client_store(..., "
                    f"fsdp=layout))")
