"""FedPA as a registered algorithm (Algorithms 3 and 4, Appendix C), port
of ``repro/algorithms/fedpa.py``.

IASG posterior sampling on the cohort, then the shrinkage Sherman-Morrison
DP on the flat ``(C, d)`` fp32 samples: each DP step is one launch of each
CUDA kernel for the whole cohort (``kernels/ops.dp_step``).
``fed.streaming_dp=True`` absorbs each window's sample into the online DP
state as the window closes, so the ``(C, l, d)`` sample buffer never
exists. Burn-in rounds run the FedAvg regime (Section 5.2). Under FSDP
(``core/fsdp.py``) the params the update gets are this rank's flat shard,
so the samples and the DP state are shards too and each DP step is the
sharded one (``FedAlgorithm.dp_step``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.algorithms.base import (ClientResult, FedAlgorithm,
                                         get_algorithm_class,
                                         register_algorithm)
from repro_torch.core import tree_math as tm
from repro_torch.core.dp_delta import (dp_delta, online_dp_delta,
                                       online_dp_init, online_dp_update)
from repro_torch.core.iasg import iasg_sample, iasg_window, sgd_steps
from repro_torch.optim import Optimizer


@register_algorithm("fedpa")
class FedPA(FedAlgorithm):
    """Posterior averaging with the shrinkage-DP delta."""

    supports_streaming_dp = True
    has_burn_regime = True
    supports_step_budgets = True

    @property
    def num_samples(self) -> int:
        """l: posterior samples per client per round (one per IASG window)."""
        fed = self.fed
        return (fed.local_steps - fed.burn_in_steps) // fed.steps_per_sample

    def validate(self) -> None:
        """Reject configs whose local steps don't form whole IASG windows."""
        super().validate()
        if self.num_samples < 1:
            # equality IS valid: local_steps == burn_in_steps +
            # steps_per_sample gives exactly one IASG window (l = 1)
            raise ValueError(
                "fedpa needs local_steps >= burn_in_steps + steps_per_sample"
            )
        fed = self.fed
        sampling_steps = fed.local_steps - fed.burn_in_steps
        if sampling_steps % fed.steps_per_sample != 0:
            raise ValueError(
                f"fedpa sampling steps must divide into whole IASG "
                f"windows: local_steps - burn_in_steps = "
                f"{fed.local_steps} - {fed.burn_in_steps} = "
                f"{sampling_steps} is not a multiple of "
                f"steps_per_sample = {fed.steps_per_sample} "
                f"({sampling_steps % fed.steps_per_sample} leftover "
                f"batches)")

    def burn_algorithm(self) -> FedAlgorithm:
        """FedAvg on the same client/server knobs (the burn-in regime)."""
        return get_algorithm_class("fedavg")(dataclasses.replace(
            self.fed, algorithm="fedavg", streaming_dp=False))

    def make_client_update(self, grad_fn: Callable,
                           client_opt: Optimizer) -> Callable:
        """IASG sampling + shrinkage-DP delta (batch or streaming DP)."""
        if self.fed.streaming_dp:
            return self._make_streaming_update(grad_fn, client_opt)
        return self._make_batch_update(grad_fn, client_opt)

    def _x0(self, params):
        """The flat (d,) fp32 anchor of the DP: params in ``delta_dtype``."""
        return tm.flatten(tm.tcast(params, self.delta_dtype), lead_dims=0)

    def _iasg_delta(self, grad_fn, client_opt):
        """Build ``run(params, batches) -> (delta, iasg_result, metrics)``:
        one IASG pass and the shrinkage-DP delta, the core shared with
        ``fedpa_precision``. The samples are stacked first as (C, l, d)."""
        fed = self.fed

        def run(params, batches):
            C = tm.tleaves(batches)[0].shape[0]
            start = tm.tbroadcast(params, C)
            res = iasg_sample(
                start, client_opt, client_opt.init(start), grad_fn, batches,
                burn_in_steps=fed.burn_in_steps,
                steps_per_sample=fed.steps_per_sample,
                num_samples=self.num_samples, sample_dtype=self.delta_dtype)
            delta = dp_delta(self._x0(params), res.samples,
                             fed.shrinkage_rho, self.dp_step)
            first = (res.burn_in_losses[:, 0] if fed.burn_in_steps
                     else res.sample_losses[:, 0, 0])
            return (tm.unflatten(delta, params, self.delta_dtype), res,
                    {"loss_first": first,
                     "loss_last": res.sample_losses[:, -1, -1]})

        return run

    def _make_batch_update(self, grad_fn, client_opt):
        """IASG samples stacked first, then the DP over them."""
        run = self._iasg_delta(grad_fn, client_opt)

        def update(params, batches):
            delta, _, metrics = run(params, batches)
            return ClientResult(delta, metrics)

        return update

    def _make_streaming_update(self, grad_fn, client_opt):
        """Each window's sample is absorbed into the DP state as soon as
        the window closes; same result as the batch DP."""
        fed = self.fed
        ell = self.num_samples

        def update(params, batches):
            C = tm.tleaves(batches)[0].shape[0]
            p = tm.tbroadcast(params, C)
            s = client_opt.init(p)
            loss_first = None
            if fed.burn_in_steps:
                p, s, burn = sgd_steps(p, client_opt, s, grad_fn, batches, 0,
                                       fed.burn_in_steps)
                loss_first = burn[:, 0]
            dp = online_dp_init(self._x0(params).expand(C, -1), ell)
            for j in range(ell):
                p, s, sample, losses = iasg_window(
                    p, client_opt, s, grad_fn, batches,
                    fed.burn_in_steps + j * fed.steps_per_sample,
                    fed.steps_per_sample, self.delta_dtype)
                dp = online_dp_update(dp, sample, fed.shrinkage_rho,
                                      self.dp_step)
                if loss_first is None:
                    loss_first = losses[:, 0]
            delta = online_dp_delta(dp, fed.shrinkage_rho)
            return ClientResult(
                tm.unflatten(delta, params, self.delta_dtype),
                {"loss_first": loss_first, "loss_last": losses[:, -1]})

        return update
