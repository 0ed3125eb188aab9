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
client axes ("pod", "data") only, and not for an arch with MoE layers
(``split_rows``): the router's capacity drops and its aux loss are taken
over the client's whole batch, so every data rank computes all of it. Without tensor parallelism (no
``"model"`` axis, a model extent of 1, a plan that splits nothing, or
the rule override ``{"tp": (), "vocab": (), "experts": ()}``) the ranks
along "model" compute the same rows on the same params: the sum over the
W ranks is "model" times the sum over the data ranks, and dividing by W
gives the mean over the client's batch. The losses are averaged over every rank, so every rank
holds the whole batch's loss. The DP's dot products are sums over the
shards (``kernels.ops.dp_step_sharded``). Every collective of the layout
runs outside ``torch.func``: the wrapper sits around the cohort-batched
``grad_fn``.

Tensor parallelism over "model" (a ``sharding.rules.TPPlan``, ``tp=``):
the flat layout stays as it is, element for element; a local step changes
in which elements each rank gathers, how the gradient returns to their
owners, and the compute between. Model rank ``g`` of a data slot gathers
exactly its compute elements (the replicated leaves whole, its columns,
rows, experts or vocabulary rows of each split block: ``TPPlan.runs(g)``)
from whichever ranks hold them, with one all-to-all in the compute dtype
(``collective.exchange_flat``), into a compute tree of local shapes; the
model code computes on its heads, FFN columns, experts and vocabulary
rows under the active ``sharding.tensor_parallel.ModelGroup`` (the
conjugate pair's all-reduces over the model ranks of its data slot run
inside ``torch.func``, through their ``vmap`` rules). The fp32 gradient
goes back by the reverse exchange, and the owner of each element sums its
contributions in rank order: a split element's from its model column's D
data ranks, a replicated element's from the ranks with model index 0 only
(the model ranks' replicated gradients are equal bit for bit, so the
other ranks return their split leaves' elements alone), each divided by
D. The vocabulary-parallel cross entropy sums its partials over the model
ranks, so the losses are the same on the model ranks of a data slot and
``mean_over_ranks`` stays the loss's mean.

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
from repro_torch.sharding import tensor_parallel

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


def _below(starts: np.ndarray, lens: np.ndarray,
           bounds: np.ndarray) -> np.ndarray:
    """For each of ``bounds``, how many elements of the sorted, disjoint
    runs ``[starts[i], starts[i] + lens[i])`` lie below it."""
    ends = np.cumsum(lens)
    i = np.searchsorted(starts, bounds, side="right") - 1
    j = np.maximum(i, 0)
    inside = np.minimum(bounds - starts[j], lens[j])
    return np.where(i < 0, 0, ends[j] - lens[j] + inside)


def _expand(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """The indices of the runs ``[starts[i], starts[i] + lens[i])``,
    concatenated (int64)."""
    if not lens.sum():
        return np.zeros(0, np.int64)
    before = np.concatenate([[0], np.cumsum(lens)[:-1]])
    return (np.arange(lens.sum(), dtype=np.int64)
            + np.repeat(starts - before, lens))


class FlatShard:
    """The flat partition of a params tree over the ranks of ``mesh``:
    ``d`` elements, ``W`` ranks, ``n = ceil(d / W)`` a rank, this rank's
    elements ``[lo, lo + n)`` (the last rank's tail is zero padding), the
    ``template`` tree (shapes; meta tensors do) and this rank's part of a
    client's batch rows (``data_extent``, ``data_index``). With ``tp`` (a
    ``sharding.rules.TPPlan`` over the mesh's ``"model"`` extent) the local
    steps compute tensor-parallel (``model``: this rank's
    ``tensor_parallel.ModelGroup``); the layout itself is the same. With
    ``split_rows=False`` every data rank computes all of a client's rows
    (``local_rows`` is the identity): an MoE's capacity drops and aux
    loss are over the client's whole batch, as the reference's, and the
    mean over the data ranks of the whole-batch gradient is that
    gradient."""

    def __init__(self, template, mesh=None, tp=None, split_rows=True):
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
        self.split_rows = split_rows
        self._pieces = None
        self.tp, self.model = tp, None
        if tp is not None:
            self._init_tp(tp)

    def _init_tp(self, tp) -> None:
        """The model group of this rank's data slot (made on every rank)
        and the two exchanges of the tensor-parallel local step. The
        gather sends each rank the elements of this shard its model rank
        computes on, in ravel order. The gradient comes back from model
        index 0's ranks on all of them, from the other ranks on their
        split leaves' elements only (the replicated leaves' gradients are
        the same on every model rank, and the owner keeps model index
        0's): ``_tp_back[g]``, the positions in this shard that model
        rank g's ranks return; the split sizes of each all-to-all; the
        ranks of each model column."""
        mesh = self.mesh
        if mesh is None or mesh.shape.get("model") != tp.M:
            raise ValueError(f"a tensor-parallel plan over {tp.M} model "
                             f"ranks needs a mesh with a 'model' axis of "
                             f"{tp.M}; got {mesh and mesh.shape}")
        W, n, M = self.W, self.n, tp.M
        col = [mesh.coords(q)["model"] for q in range(W)]
        slots: dict = {}
        for q in range(W):
            slots.setdefault(mesh.data_slot(q)[1], []).append(q)
        group = tensor_parallel.model_group(mesh, [slots[k] for k in
                                                   sorted(slots)])
        self.model = tensor_parallel.ModelGroup.of(group, col[self.rank], tp)
        def cut(g, split_only):
            """How many of model rank g's elements each rank's shard
            holds, and their positions in this rank's shard."""
            st, ln = tp.runs(g, split_only)
            a = np.clip(st, self.lo, self.lo + n)
            b = np.clip(st + ln, self.lo, self.lo + n)
            keep = b > a
            # int32 positions (n < 2**31): half the index bytes
            return (np.diff(_below(st, ln, np.arange(W + 1) * n)),
                    torch.from_numpy(_expand(a[keep] - self.lo, b[keep]
                                             - a[keep]).astype(np.int32)
                                     ).to(mesh.device))

        full = [cut(g, False) for g in range(M)]
        back = [full[0]] + [cut(g, True) for g in range(1, M)]
        me = col[self.rank]
        self._tp_send_idx = torch.cat([full[col[q]][1] for q in range(W)])
        self._tp_send = [int(full[col[q]][0][self.rank]) for q in range(W)]
        self._tp_recv = [int(full[me][0][p]) for p in range(W)]
        self._tp_back = [i for _, i in back]
        self._tp_grad_send = [int(back[me][0][q]) for q in range(W)]
        self._tp_grad_recv = [int(back[col[p]][0][self.rank])
                              for p in range(W)]
        self._tp_returned = [me == 0 or s.dim is not None
                             for s in tp.leaves]
        self._tp_cols = [[q for q in range(W) if col[q] == g]
                         for g in range(M)]
        self._tp_shapes = tp.local_shapes()
        self._tp_sizes = [int(np.prod(s)) for s in self._tp_shapes]

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

    def gather_compute(self, shard: torch.Tensor):
        """The compute tree of this rank's model rank (the leaves' local
        shapes, ``sharding.rules.TPPlan``) from every rank's ``shard``
        (``(n,)`` or ``(1, n)``, the lead kept on every leaf), in the
        shard's dtype: one all-to-all that moves this rank exactly its
        compute elements."""
        lead = tuple(shard.shape[:-1])
        got = collective.exchange_flat(
            self.mesh, shard.reshape(-1).index_select(0, self._tp_send_idx),
            self._tp_send, self._tp_recv, "params")
        rows = got.reshape(*lead, -1)
        out, off = [], 0
        for k, shape in zip(self._tp_sizes, self._tp_shapes):
            out.append(rows[..., off:off + k].reshape(*lead, *shape))
            off += k
        return pytree.tree_unflatten(out, pytree.tree_structure(
            self.template))

    def reduce_compute(self, grads) -> torch.Tensor:
        """This rank's ``(1, n)`` shard of the batch-mean fp32 gradient
        from every rank's compute-tree ``grads`` (local shapes, a lead of
        1): the reverse exchange (model index 0's ranks return every
        element, the others their split leaves' only), then per element
        the contributions of its model column's data ranks (model index
        0's for a replicated element) summed in rank order and divided by
        D."""
        flat = torch.cat([x.reshape(-1).to(torch.float32) for x, keep in
                          zip(self._leaves(grads), self._tp_returned)
                          if keep])
        got = collective.exchange_flat(self.mesh, flat, self._tp_grad_send,
                                       self._tp_grad_recv, "grads")
        parts = got.split(self._tp_grad_recv)
        out = torch.zeros(self.n, dtype=torch.float32, device=got.device)
        for g in range(self.model.size):
            total = None
            for q in self._tp_cols[g]:
                total = parts[q] if total is None else total + parts[q]
            out.index_put_((self._tp_back[g],), total)
        return (out / (self.W // self.model.size)).reshape(1, self.n)

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
            if self.model is None:
                loss, grads = grad_fn(self.gather_tree(shard), batch)
                flat = self._pack(grads, 0, self.W * self.n, 1,
                                  torch.float32)
                return (self.mean_over_ranks(loss),
                        self.reduce_grads(flat).to(shard.dtype))
            with tensor_parallel.model_parallel(self.model):
                loss, grads = grad_fn(self.gather_compute(shard), batch)
            return (self.mean_over_ranks(loss),
                    self.reduce_compute(grads).to(shard.dtype))

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
        ``"_active"`` is per client and stays whole); all of them when the
        layout does not split rows. ``ValueError`` when ``B`` does not
        divide, as the reference's ``NamedSharding`` refuses."""
        if not self.split_rows:
            return batches
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
