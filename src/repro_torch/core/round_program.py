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

They give the same round math up to the order of fp32 sums. The cohort
stage also applies the fault annotations of ``data.cohort_source``: the
survivor mask zeroes dropped clients' weights before normalisation (an
all-dropped round is a zero aggregate with 0.0 losses), and the
``"_active"`` budget mask freezes a client's steps past its budget. q-FFL
(``fed.qffl_q > 0``) tilts the weights by ``max(loss_first, 0) ** q`` and
renormalises the aggregate.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.algorithms import resolve_algorithm
from repro_torch.core import tree_math as tm
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
    fed: object
    place: str
    chunk_size: Optional[int]
    server_opt: Optimizer


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


def _run_parallel(ctx, params, batches, weights, extras):
    res = ctx.client_update(params, batches, *extras)
    w = _qffl_weights(ctx, weights, res.metrics)
    return ctx.alg.reduce_stacked(res.payload, w), res.metrics


def _run_sequential(ctx, params, batches, weights, extras):
    acc = ctx.alg.init_accum(params)
    parts = []
    for c in range(weights.shape[0]):
        res = ctx.client_update(params, _rows(batches, c, c + 1), *extras)
        w = _qffl_weights(ctx, weights[c:c + 1], res.metrics)
        acc = ctx.alg.accumulate(acc, tm.tmap(lambda x: x[0], res.payload),
                                 w[0])
        parts.append(res.metrics)
    return acc, _cat_metrics(parts, weights.shape[0])


def _run_chunked(ctx, params, batches, weights, extras, chunk: int):
    C = weights.shape[0]
    pad = -(-C // chunk) * chunk - C
    if pad:
        # zero-weight duplicates of client 0 square off the last chunk
        batches = tm.tmap(
            lambda x: torch.cat([x, x[:1].expand(pad, *x.shape[1:])]),
            batches)
        weights = torch.cat([weights, weights.new_zeros(pad)])
    acc = ctx.alg.init_accum(params)
    parts = []
    for lo in range(0, C + pad, chunk):
        res = ctx.client_update(params, _rows(batches, lo, lo + chunk),
                                *extras)
        part = ctx.alg.reduce_stacked(
            res.payload,
            _qffl_weights(ctx, weights[lo:lo + chunk], res.metrics))
        acc = tm.tmap(lambda a, p: a + p.to(a.dtype), acc, part)
        parts.append(res.metrics)
    return acc, _cat_metrics(parts, C)


def _run_cohort(ctx: _CohortCtx, state: ServerState, client_batches,
                client_weights, survivor_mask=None):
    """One cohort pass through the resolved placement; returns
    ``(agg, losses)``."""
    params = state.params
    device = tm.tleaves(params)[0].device
    batches = to_device(client_batches, device)
    C = tm.tleaves(batches)[0].shape[0]
    extras = ctx.alg.broadcast(state, ctx.server_opt)
    if survivor_mask is None:
        weights = normalized_weights(client_weights, C, device)
    else:
        mask = np.asarray(survivor_mask, np.float32)
        base = (np.ones((C,), np.float32) if client_weights is None
                else np.asarray(client_weights, np.float32))
        weights = normalized_weights(base * mask, C, device, masked=True)

    if ctx.place == "parallel":
        agg, metrics = _run_parallel(ctx, params, batches, weights, extras)
    elif ctx.place == "sequential":
        agg, metrics = _run_sequential(ctx, params, batches, weights, extras)
    else:
        agg, metrics = _run_chunked(ctx, params, batches, weights, extras,
                                    _resolve_chunk(ctx.fed, ctx.chunk_size,
                                                   C))

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
    return agg, losses


def make_cohort_program(grad_fn: Callable, fed, *,
                        placement: Optional[str] = None,
                        chunk_size: Optional[int] = None,
                        use_sampling: bool = True,
                        client_opt: Optional[Optimizer] = None,
                        server_opt: Optional[Optimizer] = None,
                        wrap_client: Optional[Callable] = None) -> Callable:
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
    """
    alg = resolve_algorithm(fed, use_sampling)
    eff = alg.fed
    client_opt = client_opt or get_optimizer(eff.client_opt, eff.client_lr,
                                             eff.client_momentum)
    server_opt = server_opt or get_optimizer(fed.server_opt, fed.server_lr,
                                             fed.server_momentum)
    grad = batched_grad(grad_fn)
    if eff.min_local_steps:
        grad = _budget_masked(grad)
    client_update = alg.make_client_update(grad, client_opt)
    if wrap_client is not None:
        client_update = wrap_client(client_update)
    ctx = _CohortCtx(alg=alg, client_update=client_update, fed=fed,
                     place=resolve_placement(fed, placement),
                     chunk_size=chunk_size, server_opt=server_opt)

    # torch.func.grad inside grad_fn ignores the outer no_grad: only the
    # local steps differentiate, nothing else records a graph
    @torch.no_grad()
    def cohort_fn(state: ServerState, client_batches, client_weights=None,
                  survivor_mask=None):
        return _run_cohort(ctx, state, client_batches, client_weights,
                           survivor_mask)

    return cohort_fn


def make_server_program(fed, *, server_opt: Optional[Optimizer] = None,
                        use_sampling: bool = True) -> Callable:
    """Build ``server_fn(state, agg, discount=None) -> new_state``: finalize
    the cohort aggregate into the pseudo-gradient and take one
    server-optimizer step (the algorithm's ``server_update``).
    ``discount`` is the async engine's staleness discount; the
    synchronous round passes None."""
    alg = resolve_algorithm(fed, use_sampling)
    server_opt = server_opt or get_optimizer(fed.server_opt, fed.server_lr,
                                             fed.server_momentum)

    @torch.no_grad()
    def server_fn(state: ServerState, agg, discount=None):
        return alg.server_update(state, agg, server_opt, discount)

    return server_fn


def make_round_program(grad_fn: Callable, fed, *,
                       placement: Optional[str] = None,
                       chunk_size: Optional[int] = None,
                       use_sampling: bool = True,
                       client_opt: Optional[Optimizer] = None,
                       server_opt: Optional[Optimizer] = None,
                       wrap_client: Optional[Callable] = None) -> Callable:
    """Build ``round_fn(state, client_batches, client_weights=None,
    survivor_mask=None) -> (new_state, {"loss_first", "loss_last"})``: the
    cohort stage then the server stage (see ``make_cohort_program``). The
    losses are unweighted cohort (or survivor) means, left on the device.
    """
    cohort_fn = make_cohort_program(
        grad_fn, fed, placement=placement, chunk_size=chunk_size,
        use_sampling=use_sampling, client_opt=client_opt,
        server_opt=server_opt, wrap_client=wrap_client)
    server_fn = make_server_program(fed, server_opt=server_opt,
                                    use_sampling=use_sampling)

    def round_fn(state: ServerState, client_batches, client_weights=None,
                 survivor_mask=None):
        agg, metrics = cohort_fn(state, client_batches, client_weights,
                                 survivor_mask)
        return server_fn(state, agg), metrics

    return round_fn
