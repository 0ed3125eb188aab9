"""The round program of the port (from ``repro/core/round_program.py``):
one synchronous federated round — the cohort's client updates, weighted
fp32 aggregation, one server-optimizer step — as one Python function.

Ported: the stateless ``parallel`` placement without a survivor mask
(``round_program.py:225-286`` and ``:545-549`` of the reference). The
reference ``vmap``s a per-client update; here the client axis is written
out: the user's per-client ``grad_fn`` is batched once with
``torch.func.vmap`` and the algorithm's update runs on the stacked cohort,
so each DP step is one kernel launch for all clients. The sequential and
chunked placements, q-FFL, masks and the split stages wait (ROADMAP.md
queue 1, items 4, 6 and 8).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.algorithms import resolve_algorithm
from repro_torch.core import tree_math as tm
from repro_torch.core.server import ServerState, normalized_weights
from repro_torch.optim import Optimizer, get_optimizer


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


def make_round_program(grad_fn: Callable, fed, *,
                       use_sampling: bool = True,
                       client_opt: Optional[Optimizer] = None,
                       server_opt: Optional[Optimizer] = None) -> Callable:
    """Build ``round_fn(state, client_batches, client_weights=None) ->
    (new_state, {"loss_first", "loss_last"})``.

    ``client_batches``: a tree whose leaves carry ``(C, K, ...)`` (host
    numpy or tensors; moved once to the params' device). ``client_weights``
    (host, ``(C,)``) are normalized in fp32; None means uniform. The losses
    are unweighted cohort means, left on the device.
    ``use_sampling=False`` builds the burn-in regime of the algorithm. The
    placement is ``parallel`` (``FedConfig`` refuses the others).
    """
    alg = resolve_algorithm(fed, use_sampling)
    eff = alg.fed
    client_opt = client_opt or get_optimizer(eff.client_opt, eff.client_lr,
                                             eff.client_momentum)
    server_opt = server_opt or get_optimizer(fed.server_opt, fed.server_lr,
                                             fed.server_momentum)
    client_update = alg.make_client_update(batched_grad(grad_fn), client_opt)

    # torch.func.grad inside grad_fn ignores the outer no_grad: only the
    # local steps differentiate, nothing else records a graph
    @torch.no_grad()
    def round_fn(state: ServerState, client_batches, client_weights=None):
        device = tm.tleaves(state.params)[0].device
        batches = to_device(client_batches, device)
        C = tm.tleaves(batches)[0].shape[0]
        weights = normalized_weights(client_weights, C, device)
        res = client_update(state.params, batches)
        agg = alg.reduce_stacked(res.payload, weights)
        losses = {"loss_first": res.metrics["loss_first"].mean(),
                  "loss_last": res.metrics["loss_last"].mean()}
        return alg.server_update(state, agg, server_opt), losses

    return round_fn
