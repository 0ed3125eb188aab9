"""Common layers (port of ``repro/models/layers.py``): RMSNorm and its
per-head form, RoPE, SwiGLU FFN, the depthwise causal conv, the LM's cross
entropy and its vocabulary-parallel form."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.sharding import tensor_parallel


def rms_norm(x, scale, eps: float = 1e-6):
    """RMSNorm with (1 + scale) weighting (gemma convention; scale init 0),
    computed in fp32 and returned in x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def group_norm_heads(x, scale, eps: float = 1e-6):
    """Per-head RMS normalization of (..., H, dh) tensors (xLSTM blocks),
    with (1 + scale) weighting, in fp32, returned in x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    out = out * (1.0 + scale.float())
    return out.to(x.dtype)


def rope(x, positions, theta: float = 10_000.0):
    """Rotary embeddings, split-halves form. x: (..., S, H, dh), positions:
    (S,) or (..., S)."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., None].float() * freq      # (..., S, half)
    angles = angles[..., None, :]                     # broadcast over heads
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sigmoid(x):
    """``jax.nn.sigmoid``'s op sequence, 1 / (1 + exp(-x)), each op
    rounded to x's dtype: in bf16 it gives JAX's bits, where
    ``torch.sigmoid`` (one rounding) differs in about a third of them."""
    return 1.0 / (1.0 + torch.exp(-x))


def silu(x):
    """``jax.nn.silu``: x * sigmoid(x), with ``sigmoid``'s op sequence."""
    return x * sigmoid(x)


def gelu_tanh(x):
    """``jax.nn.gelu`` (the tanh approximation), op by op in x's dtype
    with its constants rounded to it, as JAX computes it."""
    c = lambda v: torch.tensor(v, dtype=x.dtype, device=x.device)
    cdf = 0.5 * (1.0 + torch.tanh(c(math.sqrt(2 / math.pi))
                                  * (x + c(0.044715) * (x * (x * x)))))
    return x * cdf


def swiglu(x, w_gate, w_up, w_down):
    """SwiGLU FFN: silu(x Wg) * (x Wu) Wd."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def causal_conv1d(x, kernel, state=None):
    """Depthwise causal conv along the sequence axis.

    x: (B, S, C), kernel: (W, C). With ``state`` (B, W-1, C), the
    streaming update (decode, S = 1) continues from it; without, the input
    is left-padded with zeros (train/prefill). Returns (y in x's dtype,
    the last W-1 inputs as the new state).
    """
    w = kernel.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], w - 1, *x.shape[2:]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                   # (B, S+W-1, C)
    S = x.shape[1]
    y = sum(xp[:, i:i + S] * kernel[i] for i in range(w))
    new_state = xp[:, -(w - 1):] if w > 1 else torch.zeros_like(pad)
    return y.to(x.dtype), new_state


def softmax_cross_entropy(logits, targets, valid_vocab: int | None = None,
                          mask=None):
    """Mean token-level cross entropy. logits (B, S, V), taken in fp32;
    targets int (B, S). ``valid_vocab`` masks out padded vocab rows;
    ``mask`` (B, S) weights the tokens (the mean over its sum, at least
    1)."""
    logits = logits.float()
    if valid_vocab is not None and valid_vocab < logits.shape[-1]:
        pad = torch.arange(logits.shape[-1], device=logits.device) \
            >= valid_vocab
        logits = logits.masked_fill(pad, -1e30)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def vocab_parallel_cross_entropy(logits, targets, start: int,
                                 valid_vocab: int | None = None):
    """``softmax_cross_entropy`` over the vocabulary split across the
    active model group: ``logits`` (B, S, V/M) are this rank's columns
    ``[start, start + V/M)``, ``targets`` (B, S) global ids. The padded
    columns are masked by their global index; the shift is the detached
    max over the ranks; the sum of the exponentials and the gold logit
    (0 from a rank whose range misses the target) are each summed over
    the ranks. Every rank returns the same mean."""
    logits = logits.float()
    n = logits.shape[-1]
    if valid_vocab is not None:
        col = start + torch.arange(n, device=logits.device)
        logits = logits.masked_fill(col >= valid_vocab, -1e30)
    shift = tensor_parallel.max_over_model(logits.amax(dim=-1))
    total = tensor_parallel.reduce_from_model(
        torch.exp(logits - shift[..., None]).sum(dim=-1))
    local = targets.long() - start
    inside = (local >= 0) & (local < n)
    gold = torch.gather(logits, -1, torch.where(inside, local, 0)[..., None])
    gold = tensor_parallel.reduce_from_model(
        torch.where(inside, gold[..., 0], 0.0))
    return (torch.log(total) + shift - gold).mean()
