"""SCAFFOLD as a registered algorithm (Karimireddy et al. 2020), port of
``repro/algorithms/scaffold.py``.

Every client keeps a control variate ``c_i`` (its running estimate of its
own drift) in the per-client store, and the server keeps the population
mean ``c`` in ``ServerState.algo_state``, broadcast to the cohort; each
local step follows the corrected gradient ``g + c - c_i``. Clients use
option II: after K corrected SGD steps, ``c_i+ = c_i - c + (theta_0 -
theta_K) / (K * lr)``. The payload is ``{"delta", "dc": c_i+ - c_i}``; the
server steps on the mean delta and moves ``c += scaffold_c_scale *
mean_i(dc_i)``.

The correction is applied to the cohort-batched gradient of
``round_program.batched_grad`` (``(C, ...)`` gradients and ``c_i``, ``c``
unstacked), not inside a per-client ``vmap`` as the reference does. SCAFFOLD
runs no DP: its path has no kernel of its own.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.algorithms.base import (ClientResult, FedAlgorithm,
                                         register_algorithm)
from repro_torch.core import server as server_lib
from repro_torch.core import tree_math as tm
from repro_torch.core.iasg import sgd_steps
from repro_torch.optim import Optimizer


def _meta(params, dtype):
    """Params-shaped meta-device tensors of ``dtype`` (no allocation)."""
    return tm.tmap(lambda p: torch.empty(p.shape, dtype=dtype,
                                         device="meta"), params)


@register_algorithm("scaffold")
class Scaffold(FedAlgorithm):
    """SCAFFOLD: client + server control variates, option II correction."""

    stateful = True

    def validate(self) -> None:
        """Option II's closed form assumes plain SGD local steps."""
        super().validate()
        if self.fed.client_opt != "sgd":
            raise ValueError(
                f"scaffold requires client_opt='sgd': the option II control "
                f"variate c_i+ = c_i - c + delta/(K*lr) is the mean local "
                f"gradient only for vanilla SGD steps, got "
                f"{self.fed.client_opt!r}")
        if not 0.0 < self.fed.scaffold_c_scale <= 1.0:
            raise ValueError(
                f"scaffold_c_scale must be in (0, 1] (it is |S|/N of the "
                f"exact rule), got {self.fed.scaffold_c_scale}")

    # -- persistent state ----------------------------------------------------
    def init_client_state(self, params):
        """Client control variate ``c_i`` (zeros), fp32 whatever
        ``delta_dtype`` is: a running sum re-rounded to bf16 every
        participation would stall once its increments fall below an ulp."""
        return tm.tzeros_like(params, torch.float32)

    def init_algo_state(self, params):
        """Server control variate ``c = mean_i c_i`` (zeros, fp32)."""
        return tm.tzeros_like(params, torch.float32)

    def broadcast(self, state, server_opt: Optimizer) -> tuple:
        """Ship the server control variate ``c`` to the cohort."""
        del server_opt
        return (state.algo_state,)

    # -- client --------------------------------------------------------------
    def make_client_update(self, grad_fn: Callable,
                           client_opt: Optimizer) -> Callable:
        """``update(params, batches, c_i, c) -> ClientResult`` for a stack:
        K SGD steps on ``g + c - c_i``; payload ``{"delta": theta_0 -
        theta_K, "dc": c_i+ - c_i}``, state update ``c_i+``."""
        lr = self.fed.client_lr
        K = self.fed.local_steps
        delta_dtype = self.delta_dtype

        def update(params, batches, c_i, c):
            def corrected_grad(p, batch):
                loss, g = grad_fn(p, batch)
                return loss, tm.tmap(
                    lambda gi, cs, ci: gi + (cs - ci).to(gi.dtype), g, c, c_i)

            C = tm.tleaves(batches)[0].shape[0]
            start = tm.tbroadcast(params, C)
            final, _, losses = sgd_steps(start, client_opt,
                                         client_opt.init(start),
                                         corrected_grad, batches)
            # the control variate folds the fp32 delta (c_i and c are fp32
            # persistent state); only the shipped delta gets the wire dtype
            delta32 = tm.tmap(
                lambda a, b: a.to(torch.float32) - b.to(torch.float32),
                start, final)
            c_new = tm.tmap(lambda ci, cs, d: ci - cs + d / (K * lr),
                            c_i, c, delta32)
            payload = {"delta": tm.tcast(delta32, delta_dtype),
                       "dc": tm.tsub(c_new, c_i)}
            return ClientResult(payload, {"loss_first": losses[:, 0],
                                          "loss_last": losses[:, -1]},
                                state_update=c_new)

        return update

    # -- aggregation ---------------------------------------------------------
    def init_accum(self, params):
        """fp32 accumulator over both payload halves (delta and dc)."""
        return {"delta": tm.tzeros_like(params, torch.float32),
                "dc": tm.tzeros_like(params, torch.float32)}

    def finalize(self, agg):
        """Pseudo-gradient = the mean-delta half, cast once."""
        return tm.tcast(agg["delta"], self.delta_dtype)

    def map_components(self, fn: Callable, obj):
        """Payloads/accumulators are dicts of parameter-shaped trees."""
        return {k: fn(v) for k, v in obj.items()}

    def abstract_payload(self, params):
        """Uplink = wire-dtype delta + fp32 control-variate update."""
        return {"delta": _meta(params, self.delta_dtype),
                "dc": _meta(params, torch.float32)}

    def abstract_broadcast_extras(self, params):
        """Downlink extra: the fp32 server control variate ``c``."""
        return (_meta(params, torch.float32),)

    # -- server --------------------------------------------------------------
    def server_update(self, state, agg, server_opt: Optimizer,
                      discount=None):
        """Server step on the mean delta, and ``c += scaffold_c_scale *
        mean_i(dc_i)``; a staleness ``discount`` scales both halves."""
        pseudo_grad = self.finalize(agg)
        dc = agg["dc"]
        if discount is not None:
            d = float(discount)
            pseudo_grad = tm.tmap(
                lambda x: (d * x.to(torch.float32)).to(x.dtype), pseudo_grad)
            dc = tm.tmap(lambda x: d * x, dc)
        scale = self.fed.scaffold_c_scale
        # c is fp32 persistent state, dc an fp32 accumulator: no rounding
        c = tm.tmap(lambda cs, dci: cs + scale * dci, state.algo_state, dc)
        new_state = server_lib.server_update(state, pseudo_grad, server_opt)
        return new_state._replace(algo_state=c)
