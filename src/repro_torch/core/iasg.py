"""IASG — Iterate-Averaged Stochastic Gradient MCMC (Algorithm 4), on a
cohort (port of ``repro/core/iasg.py``).

Params carry a leading client axis ``C``; batches carry ``(C, K, ...)``
(client, then step); ``grad_fn(params, batch) -> (loss (C,), grads)`` is
already batched over clients (the round program ``vmap``s the user's
per-client ``grad_fn`` once). ``lax.scan`` over steps becomes a Python
loop.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core import tree_math as tm
from repro_torch.optim import Optimizer


class IASGResult(NamedTuple):
    """One IASG sampling pass of a cohort."""

    samples: torch.Tensor         # (C, num_samples, d) fp32, flat
    params: object                # final iterate (C, ...) tree
    opt_state: object
    burn_in_losses: torch.Tensor  # (C, burn_in_steps)
    sample_losses: torch.Tensor   # (C, num_samples, steps_per_sample)


def step_batch(batches, i: int):
    """Step ``i`` of every client: ``(C, K, ...)`` leaves -> ``(C, ...)``."""
    return tm.tmap(lambda x: x[:, i], batches)


def _local_step(params, opt: Optimizer, opt_state, grad_fn: Callable, batch):
    loss, grads = grad_fn(params, batch)
    updates, opt_state = opt.update(grads, opt_state, params)
    return tm.tmap(lambda p, u: p + u.to(p.dtype), params, updates), \
        opt_state, loss


def sgd_steps(params, opt: Optimizer, opt_state, grad_fn: Callable, batches,
              start: int = 0, stop: int = None):
    """Local SGD over steps ``[start, stop)`` of ``batches`` (the FedAvg
    client; default: every step). Returns (params, opt_state, losses
    (C, steps))."""
    stop = tm.tleaves(batches)[0].shape[1] if stop is None else stop
    losses = []
    for i in range(start, stop):
        params, opt_state, loss = _local_step(params, opt, opt_state,
                                              grad_fn, step_batch(batches, i))
        losses.append(loss)
    return params, opt_state, torch.stack(losses, dim=1)


def iasg_window(params, opt: Optimizer, opt_state, grad_fn: Callable,
                batches, start: int, steps: int, sample_dtype):
    """One IASG window: ``steps`` SGD steps from step ``start``; the sample
    is the Polyak average of the window's iterates (accumulated in
    ``sample_dtype``), returned flat as ``(C, d)`` fp32.

    Returns (params, opt_state, sample, losses (C, steps)).
    """
    acc = tm.tzeros_like(params, sample_dtype)
    losses = []
    for i in range(start, start + steps):
        params, opt_state, loss = _local_step(params, opt, opt_state,
                                              grad_fn, step_batch(batches, i))
        acc = tm.tmap(lambda a, p: a + p.to(sample_dtype), acc, params)
        losses.append(loss)
    sample = tm.flatten(tm.tscale(1.0 / steps, acc))
    return params, opt_state, sample, torch.stack(losses, dim=1)


def iasg_sample(params, opt: Optimizer, opt_state, grad_fn: Callable,
                batches, burn_in_steps: int, steps_per_sample: int,
                num_samples: int,
                sample_dtype=torch.float32) -> IASGResult:
    """Algorithm 4 on a cohort. ``batches`` must have ``burn_in_steps +
    num_samples * steps_per_sample`` steps on axis 1."""
    total = burn_in_steps + num_samples * steps_per_sample
    lead = tm.tleaves(batches)[0].shape[1]
    if lead != total:
        raise ValueError(f"need {total} batches, got {lead}")
    first = tm.tleaves(params)[0]
    burn_losses = torch.zeros(first.shape[0], 0, device=first.device)
    if burn_in_steps:
        params, opt_state, burn_losses = sgd_steps(
            params, opt, opt_state, grad_fn, batches, 0, burn_in_steps)
    samples, sample_losses = [], []
    for j in range(num_samples):
        params, opt_state, sample, losses = iasg_window(
            params, opt, opt_state, grad_fn, batches,
            burn_in_steps + j * steps_per_sample, steps_per_sample,
            sample_dtype)
        samples.append(sample)
        sample_losses.append(losses)
    return IASGResult(torch.stack(samples, dim=1), params, opt_state,
                      burn_losses, torch.stack(sample_losses, dim=1))
