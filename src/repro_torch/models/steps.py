"""Loss, training and serving steps (port of ``repro/models/steps.py``):
``lm_loss``, ``lm_grad_fn`` (the federated round's per-client gradient),
``centralized_train_step`` (plain autograd), ``serve_step`` and
``prefill_step``."""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_lib
from repro_torch.models.layers import (softmax_cross_entropy,
                                      vocab_parallel_cross_entropy)
from repro_torch.sharding import tensor_parallel


def lm_loss(params, batch, cfg: ModelConfig, *, compute_dtype=torch.bfloat16,
            q_chunk: int = 1024, remat: str = "full"):
    """batch: {"tokens": (B, S_text+1) int, ["frontend": (B, F, d)]}.
    Returns (loss, metrics): the mean next-token cross entropy over the
    valid vocab of the text positions (past a frontend's ``F``), plus
    ``router_aux_weight`` times the MoE aux loss for an MoE config, in
    fp32; metrics ``{"xent", "moe_aux"}``. Under a model group whose
    vocabulary splits the logits are this rank's columns and the cross
    entropy is the vocabulary-parallel one (the same on every rank)."""
    tokens = batch["tokens"]
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    logits, aux = model_lib.forward(params, inputs, cfg,
                                    frontend=batch.get("frontend"),
                                    compute_dtype=compute_dtype,
                                    q_chunk=q_chunk, remat=remat)
    if cfg.frontend:
        logits = logits[:, cfg.frontend_tokens:]
    tp = tensor_parallel.active()
    if tp is not None and tp.vocab:
        xent = vocab_parallel_cross_entropy(
            logits, targets, tp.index * logits.shape[-1],
            valid_vocab=cfg.vocab_size)
    else:
        xent = softmax_cross_entropy(logits, targets,
                                     valid_vocab=cfg.vocab_size)
    total = xent + cfg.moe.router_aux_weight * aux if cfg.moe.enabled \
        else xent
    return total, {"xent": xent, "moe_aux": aux}


def lm_grad_fn(cfg: ModelConfig, *, compute_dtype=torch.bfloat16,
               q_chunk: int = 1024, remat: str = "full"):
    """The per-client ``grad_fn(params, batch) -> (loss, grads)`` that
    FedAvg/FedPA step with, written with ``torch.func.grad_and_value`` so
    that the round program can ``vmap`` it over the cohort. Compute runs
    in ``compute_dtype`` on the fp32 master params; grads come back fp32.

    ``remat="full"`` (the default, as the reference's) recomputes each
    pattern repeat in the backward pass (``model.recompute``, which
    composes with ``vmap(grad)``): only the repeats' inputs are kept;
    ``"none"`` keeps every activation. ``remat="dots"`` raises
    ``NotImplementedError`` when called (ROADMAP.md queue 1, item 13).
    """
    def loss(params, batch):
        return lm_loss(params, batch, cfg, compute_dtype=compute_dtype,
                       q_chunk=q_chunk, remat=remat)[0]

    grad_and_value = torch.func.grad_and_value(loss)

    def fn(params, batch):
        grads, value = grad_and_value(params, batch)
        return value, grads

    return fn


def centralized_train_step(params, opt_state, batch, cfg: ModelConfig, opt,
                           **kw):
    """Plain (non-federated) step with autograd, the MB-SGD baseline at LM
    scale; ``kw`` goes to ``lm_loss`` (remat applies here). Returns
    ``(params, opt_state, loss, metrics)``, nothing attached to a graph."""
    flat, spec = pytree.tree_flatten(params)
    with torch.enable_grad():
        leaves = [p.detach().requires_grad_(True) for p in flat]
        loss, metrics = lm_loss(pytree.tree_unflatten(leaves, spec), batch,
                                cfg, **kw)
        grads = pytree.tree_unflatten(
            list(torch.autograd.grad(loss, leaves)), spec)
    with torch.no_grad():
        updates, opt_state = opt.update(grads, opt_state, params)
        params = pytree.tree_map(lambda p, u: p + u.to(p.dtype), params,
                                 updates)
    return (params, opt_state, loss.detach(),
            {k: v.detach() for k, v in metrics.items()})


def serve_step(params, token, state, cfg: ModelConfig, *,
               compute_dtype=torch.bfloat16, sample: bool = False,
               generator: Optional[torch.Generator] = None,
               temperature: float = 1.0, use_kernel: bool = False):
    """One decode step for a batch of requests. token: (B,) int.
    Returns (next_token (B,) int32, fp32 logits (B, V), new_state).

    Greedy unless ``sample``; then one categorical draw per request from
    ``generator`` (its numbers differ from ``jax.random``'s)."""
    logits, state = model_lib.decode_step(params, token, state, cfg,
                                          compute_dtype=compute_dtype,
                                          use_kernel=use_kernel)
    # padded vocab rows must never be sampled
    logits = logits.float()
    logits[:, cfg.vocab_size:] = -1e30
    if sample:
        probs = torch.softmax(logits / temperature, dim=-1)
        nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
    else:
        nxt = torch.argmax(logits, dim=-1)
    return nxt.to(torch.int32), logits, state


def prefill_step(params, tokens, cfg: ModelConfig, max_len: int, *,
                 frontend=None, compute_dtype=torch.bfloat16,
                 q_chunk: int = 1024, cache_dtype=torch.bfloat16):
    """Prompt ingestion (after ``frontend``'s embeddings for a frontend
    arch): returns (last-token logits, decode state)."""
    return model_lib.prefill(params, tokens, cfg, max_len, frontend=frontend,
                             compute_dtype=compute_dtype, q_chunk=q_chunk,
                             cache_dtype=cache_dtype)
