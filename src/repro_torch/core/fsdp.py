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

Leaves are matched by their key paths, so a tree built in another key
order (the JAX package's sorted one) shards to the same elements. Without
a mesh, or on a mesh of one rank, the layout is the identity (``n = d``)
and a collective moves no data to another rank (a one-rank group still
makes its calls).
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils import _pytree as pytree

from repro_torch.core import collective
from repro_torch.kernels import ops

#: The algorithms an FSDP round runs; the rest are ROADMAP.md queue 1,
#: ``NEXT_ITEM``.
ALGORITHMS = ("fedavg", "fedpa")
#: The item that ports the other algorithms and the client store under
#: FSDP (``fedpa_precision``, ``fedprox``, ``mime``, ``scaffold``,
#: ``fedep``, ``fedlora``).
NEXT_ITEM = "10 part 3"


def _paths(tree) -> list:
    """``(key path, leaf)`` pairs in the tree's flatten order."""
    return [(pytree.keystr(k), x)
            for k, x in pytree.tree_flatten_with_path(tree)[0]]


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
        leaves = self._leaves(tree)
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
        out, off = [], 0
        for k, shape in zip(self.sizes, self.shapes):
            out.append(flat[off:off + k].reshape(*lead, *shape))
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

    # -- server state ---------------------------------------------------------
    def _is_full(self, x) -> bool:
        pairs = _paths(x)
        return (len(pairs) == len(self.paths)
                and all(isinstance(v, torch.Tensor) for _, v in pairs)
                and dict((p, tuple(v.shape)) for p, v in pairs)
                == dict(zip(self.paths, self.shapes)))

    def _is_shard(self, x) -> bool:
        return isinstance(x, torch.Tensor) and tuple(x.shape) == (self.n,)

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
        and every params-shaped part of the optimizer state as ``(n,)``
        fp32 shards. ``algo_state`` must be empty (FedAvg, FedPA)."""
        if state.algo_state not in ((), None):
            raise ValueError("an FSDP round's state has no algo_state")
        return state._replace(
            params=self.shard_tree(state.params),
            opt_state=self._map(state.opt_state, self._is_full,
                                self.shard_tree))

    def gather_state(self, state):
        """The sharded ``ServerState`` -> the whole one on every rank (one
        all-gather per params-shaped part)."""
        return state._replace(
            params=self.gather_tree(state.params),
            opt_state=self._map(state.opt_state, self._is_shard,
                                self.gather_tree))
