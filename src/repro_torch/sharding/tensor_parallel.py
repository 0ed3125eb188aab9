"""Megatron's conjugate pair over the ``model`` ranks of a data slot, for
the model code of a tensor-parallel local step (``core/fsdp.py``'s
``wrap_grad`` makes a ``ModelGroup`` active around the cohort-batched
``grad_fn``; ``sharding/rules.py`` says which blocks split).

  * ``copy_to_model`` — identity forward, the gradient all-reduced over
    the model group in the backward pass. On each split block's
    normalized input (every model rank feeds the same activations into
    its columns, heads, experts or vocabulary rows, and each holds a
    partial input gradient), on the MoE gate values that weight the
    combine (each rank combines its own experts' outputs), and on
    ``q_scale`` / ``k_scale`` (replicated leaves each model rank applies
    to its own heads only, so its gradient for them is a partial sum);
  * ``reduce_from_model`` — the forward all-reduced over the model group,
    identity backward. On the outputs of ``wo``, ``w_down`` and the MoE
    layer (each model rank's rows or experts give a partial sum of the
    block's output), on the embedding lookup (each rank finds the tokens
    of its vocabulary rows), and on the vocabulary-parallel cross
    entropy's partial sums (``models/layers.py``).

Each is a ``torch.autograd.Function`` with ``setup_context`` and a
``vmap`` staticmethod that all-reduces the batched tensor whole and keeps
its batch dimension, so the pair composes with the round's
``vmap(grad)`` and with ``models/model.py``'s ``_Recompute``, whose
backward replays the forward's all-reduces (under the forward's model
group, which ``_Recompute`` keeps: autograd runs a CUDA backward on its
own device thread, where this thread's ``active()`` is None): every model
rank runs the same layers in the same order, so they issue the same
collectives in the same order. ``max_over_model`` (the cross entropy's
shift) is the same all-reduce with ``MAX``, detached: no gradient flows
through it. The all-reduce itself is ``core.collective.all_reduce_model``
(staged through pinned host memory on gloo with CUDA tensors).

With no ``ModelGroup`` active, ``active()`` is None and the model code
runs none of this.
"""
from __future__ import annotations

import contextlib
import threading
from typing import List, NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch.core import collective


class ModelGroup(NamedTuple):
    """The model ranks of this rank's data slot: their process ``group``,
    their number ``size`` (M), this rank's ``index`` (g) among them, and
    which blocks split (``attn``, ``ffn``, ``vocab``, ``experts``,
    ``shared``; ``sharding.rules.TPPlan``)."""

    group: object
    size: int
    index: int
    attn: bool
    ffn: bool
    vocab: bool = False
    experts: bool = False
    shared: bool = False

    @classmethod
    def of(cls, group, index: int, plan) -> "ModelGroup":
        """The group of model rank ``index`` under ``plan``'s blocks."""
        return cls(group, plan.M, index, plan.attn, plan.ffn, plan.vocab,
                   plan.experts, plan.shared)


#: The active model groups of this thread, innermost last.
_STATE = threading.local()


def _stack() -> List[ModelGroup]:
    if not hasattr(_STATE, "stack"):
        _STATE.stack = []
    return _STATE.stack


def active() -> Optional[ModelGroup]:
    """The model group of the local step running now in this thread (None
    outside one)."""
    stack = _stack()
    return stack[-1] if stack else None


@contextlib.contextmanager
def model_parallel(mg: Optional[ModelGroup]):
    """Make ``mg`` the active model group inside the block (None: no
    tensor parallelism)."""
    if mg is None:
        yield
        return
    _stack().append(mg)
    try:
        yield
    finally:
        _stack().pop()


def model_group(mesh, slots: List[List[int]]):
    """The process group of this rank's data slot, out of ``slots`` (the
    ranks of every data slot, each list the slot's model ranks in order):
    every rank of ``mesh`` calls ``dist.new_group`` for every slot, in the
    same order."""
    mine = None
    for ranks in slots:
        group = dist.new_group(ranks)
        if mesh.rank in ranks:
            mine = group
    return mine


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    return collective.all_reduce_model(group, x)


class _MaxOverModel(torch.autograd.Function):
    """All-reduce max forward; no gradient (its input is detached)."""

    @staticmethod
    def forward(x, group):
        return collective.all_reduce_model(group, x, op="max")

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def backward(ctx, grad):
        return None, None

    @staticmethod
    def vmap(info, in_dims, x, group):
        return collective.all_reduce_model(group, x, op="max"), in_dims[0]


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce forward, identity backward."""

    @staticmethod
    def forward(x, group):
        return _sum(x, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, grad):
        return grad, None

    @staticmethod
    def vmap(info, in_dims, x, group):
        return _sum(x, group), in_dims[0]


class _CopyToModel(torch.autograd.Function):
    """Identity forward, all-reduce backward."""

    @staticmethod
    def forward(x, group):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        return _ReduceFromModel.apply(grad, ctx.group), None

    @staticmethod
    def vmap(info, in_dims, x, group):
        return x.view_as(x), in_dims[0]


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """``x`` into the split compute of the active model group: the
    gradient is summed over its ranks."""
    return _CopyToModel.apply(x, active().group)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """The sum over the active model group's ranks of their partial
    ``x``."""
    return _ReduceFromModel.apply(x, active().group)


def max_over_model(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max over the active model group's ranks of ``x``,
    detached (a shift that no gradient goes through)."""
    return _MaxOverModel.apply(x.detach(), active().group)
