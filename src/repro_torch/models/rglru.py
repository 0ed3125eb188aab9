"""RG-LRU recurrent block (Griffin / RecurrentGemma; port of
``repro/models/rglru.py``). [arXiv:2402.19427]

The Real-Gated Linear Recurrent Unit is a diagonal linear recurrence

    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t),
    a_t = exp(-c * softplus(Lambda) * r_t),
    r_t = sigmoid(blockdiag(W_a) x_t + b_a),  i_t = sigmoid(blockdiag(W_x) x_t + b_x)

so the whole sequence reduces with a log-depth parallel prefix (the JAX
package's ``lax.associative_scan``): here ``_linear_scan``, log2(S) steps
of plain torch ops over the whole sequence, not a loop of S steps. Decode
is the single recurrence step with streaming conv state. The gate's gelu
is the tanh approximation (``jax.nn.gelu``'s default), op by op as JAX
computes it (``layers.gelu_tanh``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import causal_conv1d, gelu_tanh

_C = 8.0          # Griffin's fixed decay sharpness
_NB = 8           # gate projection block-diagonal blocks


class RGLRUState(NamedTuple):
    """RG-LRU decode state: recurrent vector + streaming-conv tail."""

    h: torch.Tensor      # (B, e) recurrent state, fp32
    conv: torch.Tensor   # (B, cw-1, e) streaming conv state


def _e(cfg: ModelConfig) -> int:
    return int(cfg.expansion * (cfg.lru_d or cfg.d_model))


def init_rglru_params(init, cfg: ModelConfig, lead=()):
    """The Griffin RG-LRU block (gates, block-diag recurrences, conv), each
    tensor with the leading dims ``lead``."""
    d, e = cfg.d_model, _e(cfg)
    eb = e // _NB
    cw = cfg.conv_width
    return {
        "w_gate": init.normal((*lead, d, e), d),
        "w_x": init.normal((*lead, d, e), d),
        "conv": init.normal((*lead, cw, e), cw),
        "rg_a": init.normal((*lead, _NB, eb, eb), eb),
        "b_a": init.zeros((*lead, e)),
        "rg_x": init.normal((*lead, _NB, eb, eb), eb),
        "b_x": init.zeros((*lead, e)),
        # Lambda init so a^c in ~(0.9, 0.999) at r=1 (Griffin appendix)
        "lam": init.linspace((*lead, e), 0.5, 4.0),
        "w_down": init.normal((*lead, e, d), e),
    }


def init_rglru_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None, lead=()) -> RGLRUState:
    """Zero RG-LRU decode state, with leading dims ``lead``."""
    e = _e(cfg)
    return RGLRUState(
        h=torch.zeros((*lead, batch, e), dtype=dtype, device=device),
        conv=torch.zeros((*lead, batch, cfg.conv_width - 1, e), dtype=dtype,
                         device=device),
    )


def _blockdiag(x, w):
    """x: (..., e) @ block-diagonal w: (nb, e/nb, e/nb) -> (..., e)."""
    nb, eb, _ = w.shape
    xs = x.reshape(*x.shape[:-1], nb, eb)
    ys = torch.einsum("...ne,nef->...nf", xs, w)
    return ys.reshape(x.shape)


def _rglru_gates(p, xc):
    """Per-step decay a_t and gated input. xc: (..., e) fp32."""
    r = torch.sigmoid(_blockdiag(xc, p["rg_a"].to(xc.dtype)) + p["b_a"])
    i = torch.sigmoid(_blockdiag(xc, p["rg_x"].to(xc.dtype)) + p["b_x"])
    log_a = -_C * F.softplus(p["lam"].to(xc.dtype)) * r
    multiplier = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                        min=1e-12))
    return torch.exp(log_a), multiplier * i * xc


def _linear_scan(a, b):
    """All prefixes of h_t = a_t h_{t-1} + b_t (h_{-1} = 0) along axis 1:
    Hillis-Steele doubling, log2(S) steps. After the step of offset o,
    (a_t, b_t) compose the (up to) 2o inputs ending at t."""
    S = a.shape[1]
    off = 1
    while off < S:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]],
                      dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return b


def rglru_forward(p, x, cfg: ModelConfig, return_cache: bool = False):
    """Full-sequence Griffin recurrent block. x: (B, S, d) -> (y (B, S, d),
    the state after the last token if ``return_cache``)."""
    gate = gelu_tanh(x @ p["w_gate"])
    xi = x @ p["w_x"]
    xc, conv_state = causal_conv1d(xi, p["conv"])
    a, b = _rglru_gates(p, xc.float())
    h = _linear_scan(a, b)
    y = (h.to(x.dtype) * gate) @ p["w_down"]
    state = RGLRUState(h[:, -1].to(x.dtype).float(), conv_state) \
        if return_cache else None
    return y, state


def rglru_decode(p, x, state: RGLRUState, cfg: ModelConfig):
    """One-token step. x: (B, 1, d). Returns (y, the new state)."""
    gate = gelu_tanh(x @ p["w_gate"])
    xi = x @ p["w_x"]
    xc, conv_state = causal_conv1d(xi, p["conv"], state.conv)
    a, b = _rglru_gates(p, xc[:, 0].float())
    h = a * state.h.float() + b
    y = (h[:, None, :].to(x.dtype) * gate) @ p["w_down"]
    return y, RGLRUState(h, conv_state)
