"""MIME-lite as a registered algorithm (Karimireddy et al. 2020), port of
``repro/algorithms/mime.py``.

Clients mix a FROZEN server momentum into every local step plus an
SVRG-style control variate. The server ships its momentum buffer with the
params (the ``broadcast`` hook), read through the optimizer's ``momentum``
accessor (zeros for momentum-free server optimizers).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.algorithms.base import (ClientResult, FedAlgorithm,
                                         register_algorithm)
from repro_torch.core import tree_math as tm
from repro_torch.core.dp_delta import fedavg_delta
from repro_torch.core.iasg import step_batch
from repro_torch.optim import Optimizer


@register_algorithm("mime")
class Mime(FedAlgorithm):
    """MIME-lite: frozen server momentum + SVRG control variate."""

    def validate(self) -> None:
        """Reject MIME configs with a momentum mix outside [0, 1]."""
        super().validate()
        beta = self.fed.mime_beta
        if not 0.0 <= beta <= 1.0:
            raise ValueError(
                f"mime_beta must lie in [0, 1] (it convexly mixes the local "
                f"gradient with the frozen server momentum); got {beta}")

    def broadcast(self, state, server_opt: Optimizer) -> tuple:
        """Frozen server momentum shipped to MIME clients (Section 6)."""
        return (server_opt.momentum(state.opt_state, state.params),)

    def abstract_broadcast_extras(self, params):
        """Downlink extra: the params-shaped frozen server momentum."""
        return (tm.tmap(lambda p: torch.empty(p.shape, dtype=p.dtype,
                                              device="meta"), params),)

    def make_client_update(self, grad_fn: Callable,
                           client_opt: Optimizer) -> Callable:
        """``update(params, batches, server_m) -> ClientResult``.

        theta <- theta - lr[(1-beta) g + beta m_server] with the control
        variate g(theta_k) - g(theta_0) + g_full(theta_0), the full-batch
        gradient at theta_0 estimated from the round's batches.
        ``client_opt`` is unused: MIME prescribes its own local step.
        """
        del client_opt
        beta = self.fed.mime_beta
        lr = self.fed.client_lr
        delta_dtype = self.delta_dtype

        def update(params, batches, server_m):
            C, K = tm.tleaves(batches)[0].shape[:2]
            start = tm.tbroadcast(params, C)
            # control-variate anchor: mean gradient at theta_0 over the
            # round, accumulated in fp32 (a bf16 sum of more than 256
            # batches would drop whole gradient increments)
            gsum = tm.tzeros_like(start, torch.float32)
            for i in range(K):
                _, g = grad_fn(start, step_batch(batches, i))
                gsum = tm.tmap(lambda c, gi: c + gi.to(c.dtype), gsum, g)
            g_anchor = tm.tmap(lambda a, p: ((1.0 / K) * a).to(p.dtype),
                               gsum, start)

            p, losses = start, []
            for i in range(K):
                batch = step_batch(batches, i)
                loss, g = grad_fn(p, batch)
                _, g0 = grad_fn(start, batch)   # same minibatch at theta_0
                g_corr = tm.tmap(lambda a, b, c: a - b + c, g, g0, g_anchor)
                d = tm.tmap(lambda gi, mi: (1.0 - beta) * gi + beta * mi,
                            g_corr, server_m)
                p = tm.tmap(lambda pi, di: pi - lr * di.to(pi.dtype), p, d)
                losses.append(loss)
            delta = tm.tcast(fedavg_delta(start, p), delta_dtype)
            return ClientResult(delta, {"loss_first": losses[0],
                                        "loss_last": losses[-1]})

        return update
