"""Functional optimizers (``sgd``, ``sgdm``, ``adam``, ``adagrad``, ``yogi``)."""
from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer,
    adagrad,
    adam,
    get_optimizer,
    sgd,
    sgdm,
    yogi,
)
