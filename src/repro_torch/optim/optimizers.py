"""Functional optimizers on parameter trees (port of
``repro/optim/optimizers.py``).

``update`` returns additive updates (params_new = params + updates). Every
rule is elementwise, so the same optimizer steps one model or a cohort
stacked on a leading client axis; the step counter is a Python int shared
by the cohort (all clients step in lockstep). The learning rate may be a
scalar or a schedule ``fn(step) -> lr``.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Union

import torch

from repro_torch.core import tree_math as tm

Schedule = Union[float, Callable[[int], float]]


def _zero_momentum(state, params):
    """Momentum accessor for momentum-free optimizers: a zeros tree."""
    del state
    return tm.tzeros_like(params)


def _state_momentum(state, params):
    """Momentum accessor for optimizers carrying an ``m`` buffer."""
    del params
    return state["m"]


class Optimizer(NamedTuple):
    """A stateless optimizer triple: init, update, and a momentum accessor."""

    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]   # (grads, state, params) -> (updates, state)
    momentum: Callable[[Any, Any], Any] = _zero_momentum


def _lr_at(lr: Schedule, step: int):
    return lr(step) if callable(lr) else lr


def sgd(lr: Schedule) -> Optimizer:
    """Plain SGD: update = -lr * grad."""
    def init(params):
        return {"step": 0}

    def update(grads, state, params=None):
        a = _lr_at(lr, state["step"])
        return tm.tscale(-a, grads), {"step": state["step"] + 1}

    return Optimizer(init, update)


def sgdm(lr: Schedule, momentum: float = 0.9,
         nesterov: bool = False) -> Optimizer:
    """SGD with (optionally Nesterov) momentum."""
    def init(params):
        return {"step": 0, "m": tm.tzeros_like(params)}

    def update(grads, state, params=None):
        m = tm.tmap(lambda mi, g: momentum * mi + g, state["m"], grads)
        d = (tm.tmap(lambda mi, g: momentum * mi + g, m, grads) if nesterov
             else m)
        a = _lr_at(lr, state["step"])
        return tm.tscale(-a, d), {"step": state["step"] + 1, "m": m}

    return Optimizer(init, update, momentum=_state_momentum)


def adam(lr: Schedule, b1: float = 0.9, b2: float = 0.99,
         eps: float = 1e-3) -> Optimizer:
    """Adam with the FL-style large epsilon default (Reddi et al. 2020)."""
    def init(params):
        return {"step": 0, "m": tm.tzeros_like(params, torch.float32),
                "v": tm.tzeros_like(params, torch.float32)}

    def update(grads, state, params=None):
        t = state["step"] + 1
        m = tm.tmap(lambda mi, g: b1 * mi + (1 - b1) * g, state["m"], grads)
        v = tm.tmap(lambda vi, g: b2 * vi + (1 - b2) * g * g, state["v"],
                    grads)
        mhat = tm.tscale(1.0 / (1 - b1 ** t), m)
        vhat = tm.tscale(1.0 / (1 - b2 ** t), v)
        a = _lr_at(lr, state["step"])
        upd = tm.tmap(lambda mi, vi: -a * mi / (torch.sqrt(vi) + eps),
                      mhat, vhat)
        return upd, {"step": t, "m": m, "v": v}

    return Optimizer(init, update, momentum=_state_momentum)


def adagrad(lr: Schedule, eps: float = 1e-5) -> Optimizer:
    """Adagrad: per-parameter lr scaled by accumulated squared grads."""
    def init(params):
        return {"step": 0, "v": tm.tzeros_like(params, torch.float32)}

    def update(grads, state, params=None):
        v = tm.tmap(lambda vi, g: vi + g * g, state["v"], grads)
        a = _lr_at(lr, state["step"])
        upd = tm.tmap(lambda g, vi: -a * g / (torch.sqrt(vi) + eps), grads, v)
        return upd, {"step": state["step"] + 1, "v": v}

    return Optimizer(init, update)


def yogi(lr: Schedule, b1: float = 0.9, b2: float = 0.99,
         eps: float = 1e-3) -> Optimizer:
    """Yogi (Zaheer et al. 2018): Adam with sign-controlled v updates."""
    def init(params):
        return {"step": 0, "m": tm.tzeros_like(params, torch.float32),
                "v": tm.tzeros_like(params, torch.float32)}

    def update(grads, state, params=None):
        m = tm.tmap(lambda mi, g: b1 * mi + (1 - b1) * g, state["m"], grads)
        v = tm.tmap(
            lambda vi, g: vi - (1 - b2) * torch.sign(vi - g * g) * g * g,
            state["v"], grads)
        a = _lr_at(lr, state["step"])
        upd = tm.tmap(
            lambda mi, vi: -a * mi / (torch.sqrt(torch.abs(vi)) + eps), m, v)
        return upd, {"step": state["step"] + 1, "m": m, "v": v}

    return Optimizer(init, update, momentum=_state_momentum)


_REGISTRY = {"sgd": sgd, "sgdm": sgdm, "adam": adam, "adagrad": adagrad,
             "yogi": yogi}


def get_optimizer(name: str, lr: Schedule,
                  momentum: float = 0.9) -> Optimizer:
    """Look up an optimizer by registry name (momentum only used by sgdm)."""
    if name == "sgdm":
        return sgdm(lr, momentum)
    if name not in _REGISTRY:
        raise KeyError(f"unknown optimizer {name!r}; known: {list(_REGISTRY)}")
    return _REGISTRY[name](lr)
