"""Common layers (port of ``repro/models/layers.py``): RMSNorm, RoPE,
SwiGLU FFN, the LM's cross entropy."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x, scale, eps: float = 1e-6):
    """RMSNorm with (1 + scale) weighting (gemma convention; scale init 0),
    computed in fp32 and returned in x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
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


def swiglu(x, w_gate, w_up, w_down):
    """SwiGLU FFN: silu(x Wg) * (x Wu) Wd."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


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
