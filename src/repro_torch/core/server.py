"""Server side of generalized federated optimization (Algorithm 1), port of
``repro/core/server.py``: the aggregated client delta is a pseudo-gradient
fed to a server optimizer."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import tree_math as tm
from repro_torch.optim import Optimizer


class ServerState(NamedTuple):
    """Everything the server carries across rounds. ``round`` is a Python
    int (checkpoints write it as an int32 scalar, as the reference's).
    ``algo_state`` is the algorithm's persistent server-side statistic
    (``FedAlgorithm.init_algo_state``): ``()`` for most algorithms,
    SCAFFOLD's server control variate."""

    params: object
    opt_state: object
    round: int
    algo_state: object = ()


def init_server_state(params, server_opt: Optimizer,
                      algorithm=None) -> ServerState:
    """Fresh server state; ``algorithm`` (a ``FedAlgorithm``) seeds its
    ``algo_state``, which is ``()`` when it is omitted."""
    algo_state = () if algorithm is None else algorithm.init_algo_state(params)
    return ServerState(params, server_opt.init(params), 0, algo_state)


def check_weight_total(total: float, shape=None, context: str = "") -> None:
    """Raise on a non-positive cohort weight sum, before the NaN it would
    produce can poison the server state."""
    if not total > 0.0:
        raise ValueError(
            f"{context}cohort weights must sum to a positive total, got "
            f"sum={total}"
            + (f" for weights of shape {shape}" if shape is not None else ""))


def normalized_weights(client_weights, num_clients: int, device=None,
                       *, masked: bool = False) -> torch.Tensor:
    """Host cohort weights (None = uniform) -> fp32 simplex weights on
    ``device``.

    A user's weights with a non-positive sum raise. ``masked=True`` is the
    survivor-masked path (the mask is already folded into the weights):
    an all-zero vector degrades to zero weights, so an all-dropped round
    is a zero aggregate, as the reference's traced weights are.
    """
    if client_weights is None:
        return torch.full((num_clients,), 1.0 / num_clients,
                          dtype=torch.float32, device=device)
    w = np.asarray(client_weights, np.float32)
    total = w.sum(dtype=np.float32)
    if not masked:
        check_weight_total(float(total), w.shape)
    elif not total > 0:
        return torch.zeros(w.shape, dtype=torch.float32, device=device)
    return torch.as_tensor(w / total, device=device)


def server_update(state: ServerState, mean_delta,
                  server_opt: Optimizer) -> ServerState:
    """theta <- SERVEROPT(theta, Delta); ``algo_state`` is carried through
    (an algorithm that updates it does so in its ``server_update``)."""
    updates, opt_state = server_opt.update(mean_delta, state.opt_state,
                                           state.params)
    params = tm.tmap(lambda p, u: p + u.to(p.dtype), state.params, updates)
    return state._replace(params=params, opt_state=opt_state,
                          round=state.round + 1)
