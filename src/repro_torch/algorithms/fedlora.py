"""Federated LoRA: precision-weighted FedPA over compressed payloads (port of
``repro/algorithms/fedlora.py``).

``fedlora`` runs ``fedpa_precision``'s client update (IASG, then the
shrinkage DP through the DP kernels on CUDA, and the diagonal precision)
and ships it through the ``fed.payload_codec`` chain
(``repro_torch.compression``): matrices projected onto rank-``lora_rank``
factors against a per-(round, leaf) sketch both sides rebuild, optionally
quantized to int8/int16.

Aggregation happens in the encoded space: the round accumulator is the
codec's linear image, so the sequential and chunked placements fold rank-r
factors, and the cohort stage decodes once per round
(:meth:`finish_cohort`) with the dispatch-time ``state.round``, the index
the cohort encoded against (the async engine may apply the result to a
newer state). The staleness discount is applied by the server stage on
the dense decoded pseudo-gradient.

Error feedback: each client keeps ``corrected - decode(encode(corrected))``
as an fp32 residual in the client-state store and adds it back at its
next participation; ``fed.error_feedback=False`` drops the state. The
client update runs on a stack of clients, so the residuals in and out are
the stack's ``(C, ...)`` slice and the codec reads each client's shape
from the unstacked params (``compression.base``).

Under FSDP (``self.layout``, a ``core.fsdp.FlatShard``) every codec runs
on this rank's shard of the payload: the codec chain takes the layout
(``compression.base``), so the ``lowrank`` factors are summed over the
ranks from each rank's rows of a leaf, and each leaf's ``int8`` scale,
one per leaf and per client, is the max over the ranks of each rank's
piece max. The error-feedback residual stays this rank's ``(n,)`` store
row, ``corrected - decode(encode(corrected))`` on the shard, and
``finish_cohort`` decodes the mean to a flat shard against the layout's
template (``state.params`` is a shard there).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.algorithms.base import (ClientResult, FedAlgorithm,
                                         get_algorithm_class,
                                         register_algorithm)
from repro_torch.algorithms.fedpa_precision import _EPS, FedPAPrecision
from repro_torch.compression import build_codec
from repro_torch.core import tree_math as tm
from repro_torch.optim import Optimizer


@register_algorithm("fedlora")
class FedLoRA(FedPAPrecision):
    """Low-rank (+ quantized) precision-weighted FedPA with error feedback."""

    supports_codec = True

    def __init__(self, fed):
        """Bind the config and build the codec chain once. ``stateful`` is
        per instance: the residual is per-client state only with
        ``fed.error_feedback``."""
        super().__init__(fed)
        self.codec = build_codec(fed)
        self.stateful = bool(fed.error_feedback)

    def burn_algorithm(self) -> FedAlgorithm:
        """FedAvg burn-in with dense payloads: the codec knobs are reset
        (fedavg rejects a codec) and burn rounds leave the residuals."""
        return get_algorithm_class("fedavg")(dataclasses.replace(
            self.fed, algorithm="fedavg", streaming_dp=False,
            payload_codec="none", error_feedback=False))

    # -- persistent state ----------------------------------------------------
    def init_client_state(self, params):
        """The error-feedback residual (zeros), fp32 whatever
        ``delta_dtype`` is: it collects sub-ulp compression errors."""
        return tm.tzeros_like(params, torch.float32)

    # -- round template hooks ------------------------------------------------
    def broadcast(self, state, server_opt: Optimizer) -> tuple:
        """Ship the round index: clients build this round's sketch."""
        del server_opt
        return (state.round,)

    def make_client_update(self, grad_fn: Callable,
                           client_opt: Optimizer) -> Callable:
        """IASG + precision, encoded through the codec chain:
        ``update(params, batches, [residuals,] round_idx) -> ClientResult``
        with payload ``{"delta": encode(delta + residual), "prec":
        suffix(project(prec))}`` and, with error feedback, the new
        residuals (what the round trip lost) as ``state_update``."""
        run = self._iasg_delta(grad_fn, client_opt)   # shared FedPA core
        codec, layout = self.codec, self.layout
        delta_dtype = self.delta_dtype

        def encode_pair(params, delta, prec, round_idx, residual):
            corrected = (tm.tcast(delta, torch.float32) if residual is None
                         else tm.tmap(lambda d, r: d.to(torch.float32) + r,
                                      delta, residual))
            wire, prec_wire = codec.encode_payload(
                tm.tcast(corrected, delta_dtype), prec, round_idx, params,
                layout)
            payload = {"delta": wire, "prec": prec_wire}
            if residual is None:
                return payload, None
            decoded = codec.decode(wire, round_idx, params, layout)
            return payload, tm.tmap(lambda c, d: c - d.to(torch.float32),
                                    corrected, decoded)

        def client(params, batches, residual, round_idx):
            delta, res, metrics = run(params, batches)
            prec = self._diag_precision(res.samples, params)
            payload, new_residual = encode_pair(params, delta, prec,
                                                round_idx, residual)
            return ClientResult(payload, metrics, state_update=new_residual)

        if self.stateful:
            return client
        return lambda params, batches, round_idx: client(
            params, batches, None, round_idx)

    # -- aggregation: encoded space ------------------------------------------
    def init_accum(self, params):
        """fp32 ``{num, den}`` zeros in the codec's accumulator space (the
        linear-prefix image: rank-r factors, not dense deltas)."""
        return {"num": self.codec.accum_zeros(params, self.layout),
                "den": self.codec.accum_zeros(params, self.layout)}

    def payload_accum(self, payload):
        """Dequantize (undo the nonlinear suffix), then natural-parameter
        form ``{num: P_enc * delta_enc, den: P_enc}``: linear, so the
        sequential and chunked folds stay exact in the encoded space."""
        d = self.codec.to_accum(payload["delta"])
        p = self.codec.to_accum(payload["prec"])
        return {"num": tm.tmap(torch.mul, p, d), "den": p}

    def finish_cohort(self, state, agg):
        """Precision-weighted mean in the encoded space, then one decode to
        parameter space with the dispatch-time ``state.round``."""
        mean = tm.tmap(
            lambda n, d: n.to(torch.float32) / (d.to(torch.float32) + _EPS),
            agg["num"], agg["den"])
        dense = self.codec.decode_accum(mean, state.round, state.params,
                                        self.layout)
        return {"delta": dense}

    def finalize(self, agg):
        """Cast the decoded mean (``finish_cohort``'s) once."""
        return tm.tcast(agg["delta"], self.delta_dtype)

    def map_components(self, fn: Callable, obj):
        """Non-identity codecs skip the per-component map (q-FFL's
        renormalisation): encoded leaves are not parameter-shaped, and the
        ``num / den`` ratio of ``finish_cohort`` cancels the factor
        anyway."""
        if self.codec.is_identity:
            return super().map_components(fn, obj)
        return obj

    # -- server ---------------------------------------------------------------
    def server_update(self, state, agg, server_opt: Optimizer,
                      discount=None):
        """Scalar staleness discount on the dense decoded pseudo-gradient:
        ``finish_cohort`` already collapsed ``{num, den}``, so the
        per-parameter discount of ``fedpa_precision`` has no ``den``."""
        return FedAlgorithm.server_update(self, state, agg, server_opt,
                                          discount)

    # -- communicated-bytes accounting ---------------------------------------
    def abstract_payload(self, params):
        """Exact wire spec on the meta device: the encoded delta and the
        suffix-quantized projected precision, scales included."""
        wire = tm.tmap(lambda p: torch.empty(p.shape, dtype=self.delta_dtype,
                                             device="meta"), params)
        return {"delta": self.codec.encode(wire, 0),
                "prec": self.codec.encode_aux(
                    self.codec.project_precision(wire, 0), 0)}

    def abstract_broadcast_extras(self, params):
        """Downlink extra: the i32 round index (sketch synchronisation)."""
        del params
        return (torch.empty((), dtype=torch.int32, device="meta"),)
