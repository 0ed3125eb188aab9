"""Learning-rate schedules (port of ``repro/optim/schedules.py``): each
maps a step (a Python int or a tensor) to an fp32 0-d tensor, so an
optimizer's ``lr`` may be one of these (``optimizers._lr_at``).

The server O(1/t) decay is what the paper's Appendix A convergence
discussion assumes; AFO baselines use exponential client decay.
"""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    """Flat schedule: lr at every step."""
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def inverse_time_decay(lr: float, decay: float = 1.0):
    """lr / (1 + decay * t) — the O(t^{-1}) schedule of Appendix A.1."""
    return lambda step: lr / (1.0 + decay * _step(step))


def exponential_decay(lr: float, rate: float, every: int):
    """lr * rate^(t/every) — the AFO-style exponential client decay."""
    return lambda step: lr * rate ** (_step(step) / every)


def cosine_decay(lr: float, total_steps: int, floor: float = 0.0):
    """Cosine anneal from lr to floor over total_steps."""
    def fn(step):
        frac = torch.clamp(_step(step) / total_steps, 0.0, 1.0)
        return floor + (lr - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
    return fn


def warmup_cosine(lr: float, warmup: int, total_steps: int,
                  floor: float = 0.0):
    """Linear warmup for ``warmup`` steps, then cosine decay to floor."""
    cos = cosine_decay(lr, max(total_steps - warmup, 1), floor)

    def fn(step):
        s = _step(step)
        return torch.where(s < warmup, lr * (s + 1) / warmup, cos(s - warmup))
    return fn
