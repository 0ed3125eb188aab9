"""Client updates (Algorithms 2 and 3), port of ``repro/core/client.py``:
the historical ``make_client_update(grad_fn, fed, client_opt)`` entry
point over the ``repro_torch.algorithms`` strategy API."""
from __future__ import annotations

from typing import Callable

from repro_torch.algorithms import get_algorithm
from repro_torch.optim import Optimizer


def make_client_update(grad_fn: Callable, fed,
                       client_opt: Optimizer) -> Callable:
    """Returns ``update(params, batches, *extras) -> ClientResult`` for a
    stack of clients.

    ``grad_fn`` is batched over a leading client axis
    (``round_program.batched_grad`` of a per-client one); ``batches`` carry
    ``(C, K, ...)``; the payload and metrics come back with the client
    axis. For the mean-delta algorithms the payload is the delta, a
    pseudo-gradient of the global objective (Proposition 2).
    """
    return get_algorithm(fed).make_client_update(grad_fn, client_opt)
