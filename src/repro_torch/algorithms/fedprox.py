"""FedProx as a registered algorithm (Li et al. 2020), port of
``repro/algorithms/fedprox.py``.

Each client minimizes f_i(theta) + (mu/2) ||theta - theta_0||^2: MAP
inference against an isotropic Gaussian prior centred at the server
iterate, a pure client-side override of the FedAvg template. Under FSDP
the round wraps ``grad_fn`` first (``FlatShard.wrap_grad``: the gathered
params' gradient, reduced onto this rank's shard), and the proximal term
is added to that shard: elementwise, as on a whole tree.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.algorithms.base import (ClientResult, FedAlgorithm,
                                         register_algorithm)
from repro_torch.core import tree_math as tm
from repro_torch.core.dp_delta import fedavg_delta
from repro_torch.core.iasg import sgd_steps
from repro_torch.optim import Optimizer


@register_algorithm("fedprox")
class FedProx(FedAlgorithm):
    """FedAvg with a proximal term in the local step (``fed.fedprox_mu``)."""

    def validate(self) -> None:
        """Proximal strength must be non-negative (0 reduces to FedAvg)."""
        super().validate()
        if self.fed.fedprox_mu < 0.0:
            raise ValueError(
                f"fedprox_mu must be >= 0, got {self.fed.fedprox_mu}")

    def make_client_update(self, grad_fn: Callable,
                           client_opt: Optimizer) -> Callable:
        """K local steps on the proximally-regularized objective."""
        mu = self.fed.fedprox_mu
        delta_dtype = self.delta_dtype

        def update(params, batches):
            def prox_grad_fn(p, batch):
                loss, grads = grad_fn(p, batch)
                # params (unstacked) broadcast over the client axis of p
                grads = tm.tmap(
                    lambda g, pi, p0: g + (mu * (pi - p0)).to(g.dtype),
                    grads, p, params)
                return loss, grads

            C = tm.tleaves(batches)[0].shape[0]
            start = tm.tbroadcast(params, C)
            final, _, losses = sgd_steps(start, client_opt,
                                         client_opt.init(start),
                                         prox_grad_fn, batches)
            delta = tm.tcast(fedavg_delta(start, final), delta_dtype)
            return ClientResult(delta, {"loss_first": losses[:, 0],
                                        "loss_last": losses[:, -1]})

        return update
