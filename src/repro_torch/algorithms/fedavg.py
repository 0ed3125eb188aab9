"""FedAvg as a registered algorithm (Algorithm 2), port of
``repro/algorithms/fedavg.py``: K local SGD steps per client,
delta = theta_0 - theta_K."""
from __future__ import annotations

from typing import Callable

from repro_torch.algorithms.base import (ClientResult, FedAlgorithm,
                                         register_algorithm)
from repro_torch.core import tree_math as tm
from repro_torch.core.dp_delta import fedavg_delta
from repro_torch.core.iasg import sgd_steps
from repro_torch.optim import Optimizer


@register_algorithm("fedavg")
class FedAvg(FedAlgorithm):
    """Weighted-mean-delta FedAvg; the template's defaults unchanged."""

    supports_step_budgets = True

    def make_client_update(self, grad_fn: Callable,
                           client_opt: Optimizer) -> Callable:
        """``update(params, batches) -> ClientResult`` — K local steps."""
        delta_dtype = self.delta_dtype

        def update(params, batches):
            C = tm.tleaves(batches)[0].shape[0]
            start = tm.tbroadcast(params, C)
            final, _, losses = sgd_steps(start, client_opt,
                                         client_opt.init(start), grad_fn,
                                         batches)
            delta = tm.tcast(fedavg_delta(start, final), delta_dtype)
            return ClientResult(delta, {"loss_first": losses[:, 0],
                                        "loss_last": losses[:, -1]})

        return update
