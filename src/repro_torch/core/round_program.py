"""The round program of the port (from ``repro/core/round_program.py``):
one synchronous federated round — the cohort's client updates, weighted
fp32 aggregation, one server-optimizer step — as Python functions.

The round factors into two stages, as in the reference:

  * ``make_cohort_program`` — clients -> aggregated payload (+ losses);
  * ``make_server_program`` — the server-optimizer step on the aggregate;

and ``make_round_program`` composes them. The reference ``vmap``s a
per-client update; here the client axis is written out: the user's
per-client ``grad_fn`` is batched once with ``torch.func.vmap`` and the
algorithm's update runs on a stack of clients, so each DP step is one
launch of each CUDA kernel for the stack. Three placements decide the
stack:

  * ``parallel``   — the whole cohort at once;
  * ``sequential`` — one client at a time (C = 1), folded into the fp32
    accumulator with ``accumulate``;
  * ``chunked``    — ``chunk_size`` clients at a time; a cohort that does
    not divide is padded with zero-weight duplicates of client 0, whose
    metrics are sliced off before the cohort means.

Each folds the cohort's clients onto the fp32 accumulator in cohort order
(``FedAlgorithm.reduce_stacked`` / ``accumulate``), so the three sum the
same terms in the same order; a client's own update may differ in its
last bits between stacks of different sizes. The cohort
stage also applies the fault annotations of ``data.cohort_source``: the
survivor mask zeroes dropped clients' weights before normalisation (an
all-dropped round is a zero aggregate with 0.0 losses), and the
``"_active"`` budget mask freezes a client's steps past its budget. q-FFL
(``fed.qffl_q > 0``) tilts the weights by ``max(loss_first, 0) ** q`` and
renormalises the aggregate.

A stateful algorithm (SCAFFOLD, FedEP) threads the cohort's per-client
state slice through every placement: whole at ``parallel``, one row per
client at ``sequential``, and at ``chunked`` padded with copies of client
0's state as the batches are, its updates sliced back to the cohort. The
state's placement (``core/client_state.py``) decides the signatures: the
host store's slice comes in and the new states go out; the device store's
whole state comes in with the cohort's ids, and the cohort gathers on the
device (the round, or the engine at apply time, CAS-scatters there).

With a ``mesh`` (``launch.mesh.ProcessMesh``) of W ranks the cohort's rows
split over the ranks: rank r is handed only its rows ``[r C / W, (r + 1) C
/ W)`` of the batches (and of a sharded store's states) and runs them
through the resolved placement, while the weights, the survivor mask and
the ids stay the whole cohort's, so the normalised weights are the
one-process ones. Every placement folds its clients onto the accumulator
in cohort order (``FedAlgorithm.reduce_stacked``); split over ranks, each
rank folds its rows onto the sum of the ranks before it and hands it on,
the last rank broadcasting the total (``core.collective``), so every rank
holds the one-process aggregate bit for bit. The per-client metrics are
gathered, so q-FFL's ``z``, the survivor normalisation and the loss means
are computed over the whole cohort as in one process.
``finish_cohort`` runs after the sum, and the server step on every rank on
the same aggregate keeps the replicas equal.

With ``fsdp`` (a ``core.fsdp.FlatShard``; ``core.sharded_round`` passes it
for the ``sequential`` placement on a mesh) the cohort does not split:
every rank runs every client in cohort order, each client on the whole
mesh. Every parameter-shaped thing the round handles is this rank's flat
shard, ``(n,)`` or ``(C, n)``: the server state (SCAFFOLD's ``c``
included), the broadcast extras (MIME's frozen server momentum, SCAFFOLD's
``c``), a stateful algorithm's client states (the host store's slice and
the device store's rows, both made for the layout), the payloads and the
accumulator. The client update steps on the shard of its iterate (the
grads gathered and reduced around the batched ``grad_fn``,
``FlatShard.wrap_grad``; the DP's dots summed over the ranks), and each
rank is handed the whole cohort's batches and runs its rows of every
client (``FlatShard.local_rows``). The weights, the mask, the ids and the
losses are the whole cohort's on every rank, so every rank takes the same
CAS decisions, and no accumulator is handed on. The server stage takes
the layout too: its one reduction over all of d (``fedpa_precision``'s
mean precision) sums over the ranks (``FedAlgorithm.param_total``).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.algorithms import resolve_algorithm
from repro_torch.core import collective
from repro_torch.core import tree_math as tm
from repro_torch.core.client_state import (cohort_ranks, device_gather,
                                           device_scatter)
from repro_torch.core.fsdp import mark_flat
from repro_torch.core.server import ServerState, normalized_weights
from repro_torch.optim import Optimizer, get_optimizer

#: Client placements understood by the round program.
PLACEMENTS = ("parallel", "sequential", "chunked")


def to_device(tree, device):
    """Move a host batch tree (numpy or tensor leaves) onto ``device``."""
    def move(x):
        if isinstance(x, np.ndarray):
            return torch.from_numpy(np.ascontiguousarray(x)).to(device)
        return x.to(device)

    return tm.tmap(move, tree)


def batched_grad(grad_fn: Callable) -> Callable:
    """Batch a per-client ``grad_fn(params, batch) -> (loss, grads)`` over a
    leading client axis of both arguments. ``grad_fn`` must be written
    with ``torch.func`` transforms (e.g. ``torch.func.grad_and_value``)."""
    return torch.func.vmap(grad_fn)


def resolve_placement(fed, placement: Optional[str] = None) -> str:
    """Explicit argument wins; otherwise the ``FedConfig`` knob."""
    p = placement or fed.round_placement
    if p not in PLACEMENTS:
        raise ValueError(f"unknown placement {p!r}; known: {PLACEMENTS}")
    return p


def _resolve_chunk(fed, chunk_size: Optional[int], num_clients: int) -> int:
    c = chunk_size if chunk_size is not None else fed.round_chunk_size
    if c <= 0:
        # auto: the biggest power-of-two chunk <= 8 that isn't larger than
        # the cohort
        c = 1
        while c * 2 <= min(8, num_clients):
            c *= 2
    return min(c, num_clients)


class _CohortCtx(NamedTuple):
    """Everything the placement runners need, resolved once at build time."""

    alg: object
    client_update: Callable
    stateful: bool
    fed: object
    place: str
    chunk_size: Optional[int]
    server_opt: Optimizer
    mesh: object = None
    #: (W, this rank's shard of the cohort, the rank of the shard before
    #: it or None, the rank of the shard after it or None, the rank of the
    #: last shard); None without a mesh
    split: Optional[tuple] = None
    #: the FSDP layout (``core.fsdp.FlatShard``) of a sequential round
    #: sharded over ranks; None otherwise
    fsdp: object = None


def _budget_masked(grad_fn: Callable) -> Callable:
    """Wrap the cohort-batched ``grad_fn`` with the local-step budget mask.

    A client past its budget runs idle steps: its gradients are zeroed, so
    plain-SGD params freeze (``FedConfig`` holds budgets to
    ``client_opt="sgd"``). The mask rides in the batch dict as the
    ``"_active"`` leaf (``data/cohort_source.py``), ``(C,)`` at one step;
    it is split off before the batched ``grad_fn`` sees the batch and
    multiplied into each ``(C, ...)`` gradient.
    """
    def masked_grad_fn(params, batch):
        if not isinstance(batch, dict) or "_active" not in batch:
            raise ValueError(
                "min_local_steps > 0 needs dict batches carrying the "
                "'_active' per-step budget mask "
                "(data/cohort_source.py injects it)")
        active = batch["_active"].to(torch.float32)
        data = {k: v for k, v in batch.items() if k != "_active"}
        loss, grads = grad_fn(params, data)
        return loss, tm.tmap(
            lambda g: g * active.reshape(-1, *(1,) * (g.dim() - 1))
            .to(g.dtype), grads)

    return masked_grad_fn


def _qffl_weights(ctx: _CohortCtx, weights, metrics):
    """q-FFL effective weights ``w_k * max(loss_first_k, 0) ** q``; the
    weights untouched when ``fed.qffl_q == 0``. Zero-weight entries
    (dropped clients, chunk padding) stay zero for any q."""
    if not ctx.fed.qffl_q:
        return weights
    lam = torch.clamp(metrics["loss_first"], min=0.0) ** ctx.fed.qffl_q
    return weights * lam.to(weights.dtype)


def _rows(tree, lo: int, hi: int):
    """Clients ``[lo, hi)`` of a tree with a leading client axis."""
    return tm.tmap(lambda x: x[lo:hi], tree)


def _cat_metrics(parts, n: int):
    """Concatenate per-stack metrics along the client axis, first ``n``."""
    return {k: torch.cat([m[k] for m in parts])[:n] for k in parts[0]}


def _cat_states(parts, n: int):
    """Concatenate per-stack state updates along the client axis, first
    ``n`` (None for a stateless algorithm)."""
    if parts[0] is None:
        return None
    return tm.tmap(lambda *xs: torch.cat(xs)[:n], *parts)


def _state_arg(ctx, cstates, lo: int, hi: int) -> tuple:
    """The stack's state slice as the update's argument (none when
    stateless)."""
    return (_rows(cstates, lo, hi),) if ctx.stateful else ()


def _run_parallel(ctx, params, batches, weights, extras, cstates, start):
    res = ctx.client_update(params, batches,
                            *((cstates,) if ctx.stateful else ()), *extras)
    w = _qffl_weights(ctx, weights, res.metrics)
    return (ctx.alg.reduce_stacked(res.payload, w, start()), res.metrics,
            res.state_update)


def _run_sequential(ctx, params, batches, weights, extras, cstates, start):
    acc = None
    parts, states = [], []
    for c in range(weights.shape[0]):
        res = ctx.client_update(params, _rows(batches, c, c + 1),
                                *_state_arg(ctx, cstates, c, c + 1), *extras)
        w = _qffl_weights(ctx, weights[c:c + 1], res.metrics)
        acc = ctx.alg.accumulate(start() if acc is None else acc,
                                 tm.tmap(lambda x: x[0], res.payload), w[0])
        parts.append(res.metrics)
        states.append(res.state_update)
    C = weights.shape[0]
    return acc, _cat_metrics(parts, C), _cat_states(states, C)


def _run_chunked(ctx, params, batches, weights, extras, cstates, start,
                 chunk: int):
    C = weights.shape[0]
    pad = -(-C // chunk) * chunk - C

    def pad_lead(x):
        return torch.cat([x, x[:1].expand(pad, *x.shape[1:])])

    if pad:
        # zero-weight duplicates of client 0 square off the last chunk;
        # their state updates are sliced off below and never written
        batches = tm.tmap(pad_lead, batches)
        weights = torch.cat([weights, weights.new_zeros(pad)])
        if ctx.stateful:
            cstates = tm.tmap(pad_lead, cstates)
    acc = None
    parts, states = [], []
    for lo in range(0, C + pad, chunk):
        res = ctx.client_update(params, _rows(batches, lo, lo + chunk),
                                *_state_arg(ctx, cstates, lo, lo + chunk),
                                *extras)
        acc = ctx.alg.reduce_stacked(
            res.payload,
            _qffl_weights(ctx, weights[lo:lo + chunk], res.metrics),
            start() if acc is None else acc)
        parts.append(res.metrics)
        states.append(res.state_update)
    return acc, _cat_metrics(parts, C), _cat_states(states, C)


# torch.func.grad inside grad_fn ignores the outer no_grad: only the
# local steps differentiate, nothing else records a graph
@torch.no_grad()
def _run_cohort(ctx: _CohortCtx, state: ServerState, client_batches,
                client_weights, client_states=None, survivor_mask=None):
    """One cohort pass through the resolved placement; returns
    ``(agg, losses, new_client_states)`` (the last None when
    stateless)."""
    params = state.params
    device = tm.tleaves(params)[0].device
    if ctx.fsdp is not None:
        client_batches = ctx.fsdp.local_rows(client_batches)
    batches = to_device(client_batches, device)
    cstates = (to_device(client_states, device) if ctx.stateful else None)
    if ctx.fsdp is not None and ctx.stateful:
        ctx.fsdp.check_rows(cstates)
    n = tm.tleaves(batches)[0].shape[0]     # this rank's rows
    W, shard, prev, after, last = ctx.split or (1, 0, None, None, None)
    C = n * W
    if client_weights is not None and len(client_weights) != C:
        raise ValueError(
            f"{len(client_weights)} client weights for {n} rows of "
            f"batches on each of {W} ranks: with a mesh the batches are "
            f"this rank's rows, the weights the whole cohort's")
    extras = ctx.alg.broadcast(state, ctx.server_opt)
    if survivor_mask is None:
        weights = normalized_weights(client_weights, C, device)
    else:
        mask = np.asarray(survivor_mask, np.float32)
        base = (np.ones((C,), np.float32) if client_weights is None
                else np.asarray(client_weights, np.float32))
        weights = normalized_weights(base * mask, C, device, masked=True)
    mine = weights[shard * n:(shard + 1) * n]

    def start():
        """The accumulator this rank folds its rows onto: zeros, or the
        sum of the shards before it (awaited at the first fold)."""
        acc = ctx.alg.init_accum(params)
        return acc if prev is None else collective.recv_tree(ctx.mesh, acc,
                                                             prev)

    if ctx.place == "parallel":
        agg, metrics, new_states = _run_parallel(ctx, params, batches,
                                                 mine, extras, cstates, start)
    elif ctx.place == "sequential":
        agg, metrics, new_states = _run_sequential(
            ctx, params, batches, mine, extras, cstates, start)
    else:
        agg, metrics, new_states = _run_chunked(
            ctx, params, batches, mine, extras, cstates, start,
            _resolve_chunk(ctx.fed, ctx.chunk_size, n))
    if ctx.split is not None:
        agg = collective.hand_on(ctx.mesh, agg, after, last)
        metrics = {k: collective.all_gather_rows(ctx.mesh, v)
                   for k, v in metrics.items()}

    if ctx.fed.qffl_q:
        # the placements folded with the tilted weights w_k * lam_k;
        # dividing by z = sum_k w_k * lam_k makes them a normalized
        # weighting again (z = 0, an all-dropped or all-zero-loss cohort,
        # keeps the zero aggregate)
        lam = torch.clamp(metrics["loss_first"], min=0.0) ** ctx.fed.qffl_q
        z = torch.clamp((weights * lam.to(weights.dtype)).sum(), min=1e-12)
        agg = ctx.alg.map_components(
            lambda a: tm.tmap(lambda x: x / z.to(x.dtype), a), agg)
    agg = ctx.alg.finish_cohort(state, agg)

    if survivor_mask is None:
        losses = {"loss_first": metrics["loss_first"].mean(),
                  "loss_last": metrics["loss_last"].mean()}
    else:
        # survivor-only means; an all-dropped round reports 0.0 losses
        m = torch.as_tensor(mask, device=device)
        n = torch.clamp(m.sum(), min=1.0)
        losses = {"loss_first": (metrics["loss_first"] * m).sum() / n,
                  "loss_last": (metrics["loss_last"] * m).sum() / n}
    return agg, losses, new_states


def make_cohort_program(grad_fn: Callable, fed, *,
                        placement: Optional[str] = None,
                        chunk_size: Optional[int] = None,
                        use_sampling: bool = True,
                        client_opt: Optional[Optimizer] = None,
                        server_opt: Optional[Optimizer] = None,
                        wrap_client: Optional[Callable] = None,
                        mesh=None, spmd_axes=None, fsdp=None) -> Callable:
    """Build ``cohort_fn(state, client_batches, client_weights=None,
    survivor_mask=None) -> (agg, {"loss_first", "loss_last"})``.

    ``client_batches``: a tree whose leaves carry ``(C, K, ...)`` (host
    numpy or tensors; moved once to the params' device). ``client_weights``
    (host, ``(C,)``) are normalized in fp32; None means uniform.
    ``survivor_mask`` (host ``(C,)`` 0/1) zeroes dropped clients' weights
    before normalisation and leaves their losses out of the means. ``agg``
    is the algorithm's fp32 accumulator, which the server stage finalizes.
    ``use_sampling=False`` builds the algorithm's burn-in regime. Only
    ``state.params`` and the server-optimizer state (MIME's broadcast)
    are read. ``wrap_client(update) -> update'`` wraps the algorithm's
    client update (``core.sharded_round``'s compute-dtype boundary).

    A stateful algorithm's signature follows
    ``fed.client_state_placement``:

    * ``"host"`` — ``cohort_fn(state, client_batches, client_weights,
      client_states, survivor_mask) -> (agg, losses, new_client_states)``:
      ``client_states`` is ``ClientStateStore.gather``'s ``(C, ...)`` slice
      (host numpy, moved to the device here) and ``new_client_states`` the
      stacked ``state_update`` to scatter back.
    * ``"device"`` — ``cohort_fn(state, client_batches, client_weights,
      store_state, client_ids, survivor_mask) -> (agg, losses,
      new_client_states, stamps)``: the slice is gathered on the device
      from ``DeviceClientStateStore.device_state()`` at the ids of
      ``prepare_ids``; the updates and gather-time stamps feed
      ``device_scatter``.

    ``state.algo_state`` (SCAFFOLD's server control variate) reaches the
    clients through the algorithm's ``broadcast``.

    ``mesh`` splits the cohort's rows over its ranks (over the client axes
    of ``spmd_axes`` when given): ``client_batches`` (and a device store's
    gathered states) are this rank's rows, ``client_weights`` and
    ``survivor_mask`` the whole cohort's, and every rank returns the same
    aggregate and losses. A host store's slice cannot split over more than
    one rank (``ValueError``).

    ``fsdp`` (a ``core.fsdp.FlatShard``, at ``sequential`` only, without
    ``mesh``) runs the round sharded over the layout's ranks: ``state``,
    the client states (a store made for the layout) and ``agg`` are this
    rank's flat shards, ``client_batches``, the weights and the ids the
    whole cohort's (each rank takes its rows of every client).
    """
    alg = resolve_algorithm(fed, use_sampling)
    place = resolve_placement(fed, placement)
    if fsdp is not None and (place != "sequential" or mesh is not None):
        raise ValueError(
            f"fsdp shards a sequential round over its own ranks; got "
            f"placement {place!r}, mesh {mesh}")
    eff = alg.fed
    client_opt = client_opt or get_optimizer(eff.client_opt, eff.client_lr,
                                             eff.client_momentum)
    server_opt = server_opt or get_optimizer(fed.server_opt, fed.server_lr,
                                             fed.server_momentum)
    grad = batched_grad(grad_fn)
    if eff.min_local_steps:
        grad = _budget_masked(grad)
    if fsdp is not None:
        grad = fsdp.wrap_grad(grad)
        alg.layout = fsdp
    client_update = alg.make_client_update(grad, client_opt)
    if wrap_client is not None:
        client_update = wrap_client(client_update)
    split = None
    if mesh is not None:
        ranks = cohort_ranks(mesh, spmd_axes)
        shard = ranks.index(mesh.rank)
        split = (len(ranks), shard, ranks[shard - 1] if shard else None,
                 ranks[shard + 1] if shard + 1 < len(ranks) else None,
                 ranks[-1])
        if (split[0] > 1 and alg.stateful
                and fed.client_state_placement != "device"):
            raise ValueError(
                f"a cohort split over {split[0]} ranks needs "
                f"client_state_placement='device' for the stateful "
                f"{alg.name!r}: the host store's slice is one process's")
    ctx = _CohortCtx(alg=alg, client_update=client_update,
                     stateful=alg.stateful, fed=fed, place=place,
                     chunk_size=chunk_size, server_opt=server_opt,
                     mesh=mesh, split=split, fsdp=fsdp)

    if ctx.stateful and fed.client_state_placement == "device":
        def cohort_fn(state: ServerState, client_batches,
                      client_weights=None, store_state=None,
                      client_ids=None, survivor_mask=None):
            if store_state is None or client_ids is None:
                raise ValueError(
                    f"algorithm {alg.name!r} is stateful with the device "
                    f"store: cohort_fn needs store_state "
                    f"(DeviceClientStateStore.device_state()) and the "
                    f"cohort's client_ids (prepare_ids)")
            cstates, stamps = device_gather(store_state, client_ids)
            agg, losses, new_states = _run_cohort(
                ctx, state, client_batches, client_weights, cstates,
                survivor_mask)
            return agg, losses, new_states, stamps
    elif ctx.stateful:
        def cohort_fn(state: ServerState, client_batches,
                      client_weights=None, client_states=None,
                      survivor_mask=None):
            if client_states is None:
                raise ValueError(
                    f"algorithm {alg.name!r} is stateful: cohort_fn needs "
                    f"the gathered client_states slice "
                    f"(ClientStateStore.gather)")
            return _run_cohort(ctx, state, client_batches, client_weights,
                               client_states, survivor_mask)
    else:
        def cohort_fn(state: ServerState, client_batches,
                      client_weights=None, survivor_mask=None):
            agg, losses, _ = _run_cohort(ctx, state, client_batches,
                                         client_weights, None, survivor_mask)
            return agg, losses

    return cohort_fn


def make_server_program(fed, *, server_opt: Optional[Optimizer] = None,
                        use_sampling: bool = True, fsdp=None) -> Callable:
    """Build ``server_fn(state, agg, discount=None) -> new_state``: finalize
    the cohort aggregate into the pseudo-gradient and take one
    server-optimizer step (the algorithm's ``server_update``).
    ``discount`` is the async engine's staleness discount; the
    synchronous round passes None. Under ``fsdp`` (the cohort stage's
    layout) ``state`` and ``agg`` are this rank's shards, a reduction over
    all of d sums over the ranks, and the new state is in the layout."""
    alg = resolve_algorithm(fed, use_sampling)
    alg.layout = fsdp
    server_opt = server_opt or get_optimizer(fed.server_opt, fed.server_lr,
                                             fed.server_momentum)

    @torch.no_grad()
    def server_fn(state: ServerState, agg, discount=None):
        new_state = alg.server_update(state, agg, server_opt, discount)
        return new_state if fsdp is None else mark_flat(new_state)

    return server_fn


def make_round_program(grad_fn: Callable, fed, *,
                       placement: Optional[str] = None,
                       chunk_size: Optional[int] = None,
                       use_sampling: bool = True,
                       client_opt: Optional[Optimizer] = None,
                       server_opt: Optional[Optimizer] = None,
                       wrap_client: Optional[Callable] = None,
                       mesh=None, spmd_axes=None, fsdp=None) -> Callable:
    """Build ``round_fn(state, client_batches, client_weights=None,
    survivor_mask=None) -> (new_state, {"loss_first", "loss_last"})``: the
    cohort stage then the server stage (see ``make_cohort_program``). The
    losses are unweighted cohort (or survivor) means, left on the device.

    A stateful algorithm with the host store takes the gathered
    ``client_states`` before ``survivor_mask`` and returns ``(new_state,
    losses, new_client_states)``; with the device store it takes
    ``(store_state, client_ids)`` instead and returns ``(new_state, losses,
    new_store_state)``: gather, clients, CAS scatter (in place, with the
    survivor mask as its write mask, so a dropped client's state does not
    land) and server step, with no host sync. ``mesh`` / ``spmd_axes``
    split the cohort over ranks, and ``fsdp`` shards a sequential round's
    state over ranks, as in ``make_cohort_program``.
    """
    cohort_fn = make_cohort_program(
        grad_fn, fed, placement=placement, chunk_size=chunk_size,
        use_sampling=use_sampling, client_opt=client_opt,
        server_opt=server_opt, wrap_client=wrap_client, mesh=mesh,
        spmd_axes=spmd_axes, fsdp=fsdp)
    server_fn = make_server_program(fed, server_opt=server_opt,
                                    use_sampling=use_sampling, fsdp=fsdp)
    stateful = resolve_algorithm(fed, use_sampling).stateful

    if stateful and fed.client_state_placement == "device":
        def round_fn(state: ServerState, client_batches, client_weights=None,
                     store_state=None, client_ids=None, survivor_mask=None):
            agg, metrics, new_states, stamps = cohort_fn(
                state, client_batches, client_weights, store_state,
                client_ids, survivor_mask)
            # nothing writes between this round's gather and its scatter,
            # so the CAS drops nothing (the count is discarded)
            new_store, _ = device_scatter(store_state, client_ids,
                                          new_states, stamps,
                                          write_mask=survivor_mask)
            return server_fn(state, agg), metrics, new_store
    elif stateful:
        def round_fn(state: ServerState, client_batches, client_weights=None,
                     client_states=None, survivor_mask=None):
            agg, metrics, new_states = cohort_fn(
                state, client_batches, client_weights, client_states,
                survivor_mask)
            return server_fn(state, agg), metrics, new_states
    else:
        def round_fn(state: ServerState, client_batches, client_weights=None,
                     survivor_mask=None):
            agg, metrics = cohort_fn(state, client_batches, client_weights,
                                     survivor_mask)
            return server_fn(state, agg), metrics

    return round_fn
