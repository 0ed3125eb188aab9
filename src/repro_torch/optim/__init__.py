"""Functional optimizers (``sgd``, ``sgdm``, ``adam``, ``adagrad``, ``yogi``)
and learning-rate schedules (``optim.schedules``)."""
from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer,
    adagrad,
    adam,
    get_optimizer,
    sgd,
    sgdm,
    yogi,
)
