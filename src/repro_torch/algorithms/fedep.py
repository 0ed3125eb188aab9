"""FedEP: stateful expectation propagation with damped site updates (Guo
et al. 2023), port of ``repro/algorithms/fedep.py``.

Every client keeps a *site*, a diagonal-Gaussian approximation of its own
likelihood factor in natural parameters ``{num: P * delta, den: P}``, in
the per-client store; the global posterior is the product of sites. Each
participation moves the site part-way:

    site_new = (1 - alpha) * site_old + alpha * (P * delta, P)

with ``P`` the diagonal shrinkage precision of this round's IASG samples
and ``delta`` the shrinkage-DP mean shift: FedPA's own IASG + DP core, so
on the card each DP step runs the CUDA kernels ``dp_reduce`` / ``dp_map``
for the stack. The payload IS the damped site, aggregated by
``fedpa_precision``'s precision-weighted mean ``num / den``; with ``alpha
= 1`` and no history the two coincide. Burn-in rounds run the stateless
FedAvg regime and leave the sites untouched.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.algorithms.base import ClientResult, register_algorithm
from repro_torch.algorithms.fedpa_precision import FedPAPrecision
from repro_torch.core import tree_math as tm
from repro_torch.optim import Optimizer


@register_algorithm("fedep")
class FedEP(FedPAPrecision):
    """Damped per-client natural-parameter sites (stateful fedpa_precision)."""

    stateful = True

    def validate(self) -> None:
        """Damping must be a usable convex-combination weight."""
        super().validate()
        if not 0.0 < self.fed.fedep_damping <= 1.0:
            raise ValueError(
                f"fedep_damping must be in (0, 1], got "
                f"{self.fed.fedep_damping}")

    # -- persistent state ----------------------------------------------------
    def init_client_state(self, params):
        """Site natural parameters ``{num, den}`` (zeros), fp32 whatever
        ``delta_dtype`` is: the damped average re-rounded to bf16 every
        participation would lose corrections below an ulp of the site."""
        return {"num": tm.tzeros_like(params, torch.float32),
                "den": tm.tzeros_like(params, torch.float32)}

    # -- client --------------------------------------------------------------
    def make_client_update(self, grad_fn: Callable,
                           client_opt: Optimizer) -> Callable:
        """``update(params, batches, sites) -> ClientResult`` for a stack:
        one IASG pass and its DP, this round's natural parameters, and the
        damped site as both the payload (in the wire dtype) and the state
        update (fp32)."""
        alpha = self.fed.fedep_damping
        delta_dtype = self.delta_dtype
        run = self._iasg_delta(grad_fn, client_opt)   # shared FedPA core

        def update(params, batches, sites):
            delta, res, metrics = run(params, batches)
            prec = self._diag_precision(res.samples, params)
            fresh = {"num": tm.tmap(torch.mul, prec, delta), "den": prec}
            damped = tm.tmap(
                lambda old, new: (1.0 - alpha) * old
                + alpha * new.to(torch.float32),
                sites, fresh)
            return ClientResult(tm.tcast(damped, delta_dtype), metrics,
                                state_update=damped)

        return update

    # -- aggregation ---------------------------------------------------------
    def payload_accum(self, payload):
        """Sites are already natural parameters: the identity."""
        return payload

    def abstract_payload(self, params):
        """Uplink = the damped site ``{num, den}``: 2x dense, wire dtype."""
        d = tm.tmap(lambda p: torch.empty(p.shape, dtype=self.delta_dtype,
                                          device="meta"), params)
        return {"num": d, "den": d}
