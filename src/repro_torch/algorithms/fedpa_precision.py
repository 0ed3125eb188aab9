"""Precision-weighted FedPA (FedEP-flavored, Guo et al. 2023), port of
``repro/algorithms/fedpa_precision.py``.

Clients ship approximate *natural parameters*: the shrinkage-DP delta
(through the DP kernels on CUDA, as FedPA's) and the diagonal of the
shrinkage precision 1 / diag(Sigma_hat_l). The server aggregates by
precision-weighted averaging, delta = sum_i w_i P_i delta_i / sum_i w_i
P_i, in the linear ``{num, den}`` accumulator; the ratio is taken once in
``finalize``. With a staleness discount, sharply determined coordinates
are discounted harder: ``discount ** clip(P / mean(P))`` per parameter.

Under FSDP (``core/fsdp.py``) every map here is elementwise on the
shard; the mean precision is the one reduction over all d parameters
(``FedAlgorithm.param_total``: the padding past d, whose precision is
``1 / rho_l`` and not 0, left out, the partial sums added over the
ranks).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.algorithms.base import ClientResult, register_algorithm
from repro_torch.algorithms.fedpa import FedPA
from repro_torch.core import server as server_lib
from repro_torch.core import tree_math as tm
from repro_torch.core.shrinkage import rho_l
from repro_torch.optim import Optimizer

#: Keeps the precision-weighted mean defined for an all-zero weight vector
#: (an all-dropped round).
_EPS = 1e-8
#: Per-parameter staleness exponents are clipped to this band.
_REL_PREC_MIN, _REL_PREC_MAX = 0.25, 4.0


@register_algorithm("fedpa_precision")
class FedPAPrecision(FedPA):
    """FedPA with diagonal-precision payloads and EP-style aggregation."""

    supports_streaming_dp = False

    def _diag_precision(self, samples, params):
        """``1 / diag(Sigma_hat_l)`` of the cohort's flat ``(C, l, d)``
        samples, as a ``(C, ...)`` tree in ``delta_dtype``.

        ``diag(Sigma_hat_l) = rho_l + (1 - rho_l) * diag(S_l)``, the
        per-coordinate sample variance of the IASG samples; with one sample
        ``rho_l = 1`` and the precision is one (the plain FedPA delta).
        """
        ell = self.num_samples
        r = float(rho_l(ell, self.fed.shrinkage_rho))
        s32 = samples.to(torch.float32)
        if ell > 1:
            # jnp.var's two passes: squared deviations from the mean, summed,
            # over l - 1 (torch's var over this leading axis is ~20x slower
            # on the CPU)
            centered = s32 - s32.mean(dim=1, keepdim=True)
            var = centered.square().sum(dim=1) / (ell - 1)
        else:
            var = torch.zeros_like(s32[:, 0])
        return tm.unflatten(1.0 / (r + (1.0 - r) * var), params,
                            self.delta_dtype)

    def make_client_update(self, grad_fn: Callable,
                           client_opt: Optimizer) -> Callable:
        """IASG + shrinkage-DP delta, plus the diagonal shrinkage precision:
        payload ``{"delta": Delta_hat_l, "prec": 1 / diag(Sigma_hat_l)}``."""
        run = self._iasg_delta(grad_fn, client_opt)  # shared FedPA core

        def update(params, batches):
            delta, res, metrics = run(params, batches)
            payload = {"delta": delta,
                       "prec": self._diag_precision(res.samples, params)}
            return ClientResult(payload, metrics)

        return update

    # -- aggregation: precision-weighted averaging ---------------------------
    def init_accum(self, params):
        """Accumulator: precision-weighted delta sum + precision sum (fp32)."""
        return {"num": tm.tzeros_like(params, torch.float32),
                "den": tm.tzeros_like(params, torch.float32)}

    def payload_accum(self, payload):
        """Natural-parameter form: ``{num: P * delta, den: P}`` (linear)."""
        return {"num": tm.tmap(torch.mul, payload["prec"], payload["delta"]),
                "den": payload["prec"]}

    def finalize(self, agg):
        """Precision-weighted mean ``num / den`` (fp32, cast back once)."""
        return tm.tmap(
            lambda n, d: (n.to(torch.float32) / (d.to(torch.float32) + _EPS))
            .to(self.delta_dtype),
            agg["num"], agg["den"])

    def map_components(self, fn: Callable, obj):
        """Payloads/accumulators are dicts of parameter-shaped trees."""
        return {k: fn(v) for k, v in obj.items()}

    def abstract_payload(self, params):
        """Uplink = delta + diagonal precision: 2x dense, both wire dtype."""
        d = super().abstract_payload(params)
        return {"delta": d, "prec": d}

    # -- server: per-parameter staleness discount ----------------------------
    def server_update(self, state, agg, server_opt: Optimizer,
                      discount=None):
        """Finalize, then discount a stale update per parameter: the scalar
        ``discount`` raised to the clipped precision-to-mean ratio of each
        coordinate. None (the synchronous round) leaves it undiscounted."""
        pseudo_grad = self.finalize(agg)
        if discount is not None:
            # over exactly the d parameters: under FSDP the padding's
            # precision is 1 / rho_l, not 0 (``param_total`` leaves it out)
            total, count = self.param_total(agg["den"])
            mean_prec = torch.clamp(total / count, min=_EPS)
            d = torch.as_tensor(discount, dtype=torch.float32,
                                device=mean_prec.device)
            pseudo_grad = tm.tmap(
                lambda x, p: (torch.pow(d, torch.clamp(
                    p.to(torch.float32) / mean_prec, _REL_PREC_MIN,
                    _REL_PREC_MAX)) * x.to(torch.float32)).to(x.dtype),
                pseudo_grad, agg["den"])
        return server_lib.server_update(state, pseudo_grad, server_opt)
