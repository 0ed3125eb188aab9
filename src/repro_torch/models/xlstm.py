"""xLSTM blocks (port of ``repro/models/xlstm.py``): mLSTM (matrix memory)
and sLSTM (scalar memory with exponential gating). [arXiv:2405.04517]

The mLSTM runs in chunkwise recurrent form: a loop over sequence chunks
carrying the (C, n, m) state, the intra-chunk part a decay-masked quadratic
attention block, the log-decay sums chunk-local. Masked entries are -inf
before the ``exp`` (giving 0) and the stabilizer is floored at -1e30, so a
row with nothing visible gives no NaN. The sLSTM is a loop over time steps
(its recurrence is nonlinear); its state is kept, and rounded every step,
in the input dtype, as in the JAX package. The silu and the gelu (the
tanh approximation, as ``jax.nn.gelu``'s default) follow JAX's op
sequence (``layers.silu``, ``layers.gelu_tanh``), so a bf16 run rounds
where JAX's does.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (causal_conv1d, gelu_tanh,
                                      group_norm_heads, rms_norm, silu)


def _e(cfg: ModelConfig) -> int:
    return int(cfg.expansion * cfg.d_model)


def _slstm_ff(cfg: ModelConfig) -> int:
    f = (4 * cfg.d_model) // 3
    return ((f + 127) // 128) * 128


# ===========================================================================
# mLSTM
# ===========================================================================

class MLSTMState(NamedTuple):
    """mLSTM decode state: matrix memory, normalizer, stabilizer, conv tail."""

    C: torch.Tensor      # (B, H, dh, dh) matrix memory (k-major)
    n: torch.Tensor      # (B, H, dh) normalizer state
    m: torch.Tensor      # (B, H) log stabilizer
    conv: torch.Tensor   # (B, cw-1, e) streaming conv state


def init_mlstm_params(init, cfg: ModelConfig, lead=()):
    """The mLSTM block (up-proj, conv, q/k/v, gates, down-proj), each
    tensor with the leading dims ``lead``."""
    d, e, H = cfg.d_model, _e(cfg), cfg.num_heads
    cw = cfg.conv_width
    return {
        "w_up": init.normal((*lead, d, 2 * e), d),
        "conv": init.normal((*lead, cw, e), cw),
        "wq": init.normal((*lead, e, e), e),
        "wk": init.normal((*lead, e, e), e),
        "wv": init.normal((*lead, e, e), e),
        "w_gates": init.normal((*lead, e, 2 * H), e),
        # forget-gate bias init positive => long memory at init (xLSTM paper)
        "b_gates": torch.cat([init.full((*lead, H), -3.0),
                              init.full((*lead, H), 3.0)], dim=-1),
        "gn_scale": init.zeros((*lead, e)),
        "w_down": init.normal((*lead, e, d), e),
    }


def init_mlstm_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None, lead=()) -> MLSTMState:
    """Zero mLSTM decode state (stabilizer at -1e30), with leading dims
    ``lead``."""
    e, H = _e(cfg), cfg.num_heads
    dh = e // H
    kw = dict(dtype=dtype, device=device)
    return MLSTMState(
        C=torch.zeros((*lead, batch, H, dh, dh), **kw),
        n=torch.zeros((*lead, batch, H, dh), **kw),
        m=torch.full((*lead, batch, H), -1e30, **kw),
        conv=torch.zeros((*lead, batch, cfg.conv_width - 1, e), **kw),
    )


def _mlstm_qkv_gates(p, x, cfg: ModelConfig, conv_state=None):
    """Shared projection path. x: (B, S, d). Returns q, k, v (B, S, H, dh),
    i_pre/f_pre (B, S, H) fp32, z (B, S, e), the new conv state."""
    B, S, _ = x.shape
    e, H = _e(cfg), cfg.num_heads
    dh = e // H
    up = x @ p["w_up"]
    xi, z = up[..., :e], up[..., e:]
    xc, conv_state = causal_conv1d(xi, p["conv"], conv_state)
    xc = silu(xc)
    q = (xc @ p["wq"]).reshape(B, S, H, dh)
    # the JAX package divides by sqrt(dh) rounded to x's dtype
    scale = torch.tensor(math.sqrt(dh), dtype=torch.float32).to(x.dtype)
    k = (xc @ p["wk"]).reshape(B, S, H, dh) / scale.to(x.device)
    v = (xi @ p["wv"]).reshape(B, S, H, dh)
    gates = (xc @ p["w_gates"] + p["b_gates"]).float()
    i_pre, f_pre = gates[..., :H], gates[..., H:]
    return q, k, v, i_pre, f_pre, z, conv_state


def _mlstm_chunk(q, k, v, i_pre, f_pre, C, n, m):
    """One chunk of the stabilized chunkwise recurrence.

    q, k, v: (B, T, H, dh); i_pre, f_pre: (B, T, H) fp32; state (C, n, m).
    Returns (h (B, T, H, dh), C', n', m').
    """
    T = q.shape[1]
    lf = F.logsigmoid(f_pre)                            # (B, T, H)
    Fc = torch.cumsum(lf, dim=1)                        # inclusive
    # log weight of sample s surviving to t (s <= t): F[t] - F[s] + i[s]
    Dt = Fc[:, :, None, :] - Fc[:, None, :, :] + i_pre[:, None, :, :]
    causal = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                   device=q.device))
    Dt = Dt.masked_fill(~causal[None, :, :, None], -math.inf)
    b = Fc + m[:, None, :]                              # inter log-scale
    m_t = torch.maximum(Dt.amax(dim=2), b)
    m_t = torch.clamp(m_t, min=-1e30)                   # guard all--inf rows
    w_intra = torch.exp(Dt - m_t[:, :, None, :])        # (B, t, s, H)
    w_inter = torch.exp(b - m_t)                        # (B, T, H)

    qf, kf, vf = q.float(), k.float(), v.float()
    scores = torch.einsum("bthd,bshd->btsh", qf, kf) * w_intra
    num = torch.einsum("btsh,bshd->bthd", scores, vf)
    num = num + w_inter[..., None] * torch.einsum("bthd,bhde->bthe", qf,
                                                  C.float())
    den = scores.sum(dim=2)                             # (B, T, H)
    den = den + w_inter * torch.einsum("bthd,bhd->bth", qf, n.float())
    den = torch.maximum(den.abs(), torch.exp(-m_t))
    h = (num / den[..., None]).to(q.dtype)

    # ---- carry update to the chunk end ----
    FT = Fc[:, -1, :]                                   # (B, H)
    ws = FT[:, None, :] - Fc + i_pre                    # log w of s into state
    m_next = torch.maximum(m + FT, ws.amax(dim=1))
    m_next = torch.clamp(m_next, min=-1e30)
    decay = torch.exp(m + FT - m_next)                  # (B, H)
    w_in = torch.exp(ws - m_next[:, None, :])           # (B, T, H)
    C_new = decay[..., None, None] * C.float() + torch.einsum(
        "bsh,bshd,bshe->bhde", w_in, kf, vf)
    n_new = decay[..., None] * n.float() + torch.einsum(
        "bsh,bshd->bhd", w_in, kf)
    return h, C_new.to(C.dtype), n_new.to(n.dtype), m_next.to(m.dtype)


def mlstm_forward(p, x, cfg: ModelConfig, chunk: int = 256,
                  return_cache: bool = False):
    """Full-sequence mLSTM block. x: (B, S, d) -> (y (B, S, d), the state
    after the last token if ``return_cache``). S must be a multiple of
    ``min(chunk, S)``."""
    B, S, d = x.shape
    e, H = _e(cfg), cfg.num_heads
    dh = e // H
    q, k, v, i_pre, f_pre, z, conv_state = _mlstm_qkv_gates(p, x, cfg)
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"mlstm_forward: sequence length {S} is not a "
                         f"multiple of the chunk {chunk}")
    st = init_mlstm_state(cfg, B, device=x.device)
    C, n, m = st.C, st.n, st.m
    hs = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        h, C, n, m = _mlstm_chunk(q[:, sl], k[:, sl], v[:, sl],
                                  i_pre[:, sl], f_pre[:, sl], C, n, m)
        hs.append(h)
    h = torch.cat(hs, dim=1)
    h = group_norm_heads(h, p["gn_scale"].reshape(H, dh), cfg.norm_eps)
    y = (h.reshape(B, S, e) * silu(z)) @ p["w_down"]
    state = MLSTMState(C, n, m, conv_state) if return_cache else None
    return y, state


def mlstm_decode(p, x, state: MLSTMState, cfg: ModelConfig):
    """One-token recurrent step. x: (B, 1, d). Returns (y, the new
    state)."""
    B = x.shape[0]
    e, H = _e(cfg), cfg.num_heads
    dh = e // H
    q, k, v, i_pre, f_pre, z, conv_state = _mlstm_qkv_gates(
        p, x, cfg, conv_state=state.conv)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]                 # (B, H, dh)
    i_pre, f_pre = i_pre[:, 0], f_pre[:, 0]             # (B, H)
    lf = F.logsigmoid(f_pre)
    m_new = torch.maximum(lf + state.m, i_pre)
    decay = torch.exp(lf + state.m - m_new)
    inp = torch.exp(i_pre - m_new)
    kf, vf, qf = k.float(), v.float(), q.float()
    C = decay[..., None, None] * state.C.float() + \
        inp[..., None, None] * torch.einsum("bhd,bhe->bhde", kf, vf)
    n = decay[..., None] * state.n.float() + inp[..., None] * kf
    num = torch.einsum("bhd,bhde->bhe", qf, C)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", qf, n).abs(),
                        torch.exp(-m_new))
    h = (num / den[..., None]).to(x.dtype)
    h = group_norm_heads(h, p["gn_scale"].reshape(H, dh), cfg.norm_eps)
    y = (h.reshape(B, 1, e) * silu(z)) @ p["w_down"]
    return y, MLSTMState(C.to(state.C.dtype), n.to(state.n.dtype),
                         m_new.to(state.m.dtype), conv_state)


# ===========================================================================
# sLSTM
# ===========================================================================

class SLSTMState(NamedTuple):
    """sLSTM decode state: cell, normalizer, hidden, stabilizer, conv tail."""

    c: torch.Tensor      # (B, d)
    n: torch.Tensor      # (B, d)
    h: torch.Tensor      # (B, d)
    m: torch.Tensor      # (B, d)
    conv: torch.Tensor   # (B, cw-1, d)


def init_slstm_params(init, cfg: ModelConfig, lead=()):
    """The sLSTM block (conv, input/recurrent gate stacks, MLP), each
    tensor with the leading dims ``lead``."""
    d, H = cfg.d_model, cfg.num_heads
    dh = d // H
    ff = _slstm_ff(cfg)
    cw = cfg.conv_width
    return {
        "conv": init.normal((*lead, cw, d), cw),
        "w": init.normal((*lead, d, 4 * d), d),
        "r": init.normal((*lead, H, dh, 4 * dh), dh),
        # gate order (z, i, f, o); forget bias positive
        "b": torch.cat([init.zeros((*lead, d)), init.full((*lead, d), -3.0),
                        init.full((*lead, d), 3.0), init.zeros((*lead, d))],
                       dim=-1),
        "gn_scale": init.zeros((*lead, d)),
        "mlp_norm": init.zeros((*lead, d)),
        "w_mlp_up": init.normal((*lead, d, ff), d),
        "w_mlp_down": init.normal((*lead, ff, d), ff),
    }


def init_slstm_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None, lead=()) -> SLSTMState:
    """Zero sLSTM decode state (stabilizer at -1e30), with leading dims
    ``lead``."""
    d = cfg.d_model
    kw = dict(dtype=dtype, device=device)
    z = lambda: torch.zeros((*lead, batch, d), **kw)
    return SLSTMState(c=z(), n=z(), h=z(),
                      m=torch.full((*lead, batch, d), -1e30, **kw),
                      conv=torch.zeros((*lead, batch, cfg.conv_width - 1, d),
                                       **kw))


def _slstm_cell(p, wx_t, st: SLSTMState, cfg: ModelConfig):
    """One recurrence step. wx_t: (B, 4d) precomputed input contribution.
    The new state is rounded to the state's dtype."""
    B, d = st.h.shape
    H = cfg.num_heads
    dh = d // H
    rec = torch.einsum("bhd,hde->bhe", st.h.reshape(B, H, dh).float(),
                       p["r"].float()).reshape(B, 4 * d)
    g = wx_t.float() + rec
    z_, i_, f_, o_ = g.chunk(4, dim=-1)
    lf = F.logsigmoid(f_)
    m_new = torch.maximum(lf + st.m, i_)
    ig = torch.exp(i_ - m_new)
    fg = torch.exp(lf + st.m - m_new)
    c = fg * st.c.float() + ig * torch.tanh(z_)
    n = fg * st.n.float() + ig
    h = torch.sigmoid(o_) * c / torch.maximum(n, torch.exp(-m_new))
    dt = st.h.dtype
    return SLSTMState(c.to(dt), n.to(dt), h.to(dt), m_new.to(dt), st.conv)


def _slstm_out(p, h, cfg: ModelConfig):
    """GroupNorm + post-MLP (the sLSTM block's internal FFN)."""
    B, S, d = h.shape
    H = cfg.num_heads
    hn = group_norm_heads(h.reshape(B, S, H, d // H),
                          p["gn_scale"].reshape(H, d // H),
                          cfg.norm_eps).reshape(B, S, d)
    u = rms_norm(hn, p["mlp_norm"], cfg.norm_eps)
    return hn + gelu_tanh(u @ p["w_mlp_up"]) \
        @ p["w_mlp_down"]


def slstm_forward(p, x, cfg: ModelConfig, return_cache: bool = False):
    """The sLSTM over a full sequence, a loop over time steps. x: (B, S, d)
    -> (y, the state after the last token if ``return_cache``)."""
    B, S, d = x.shape
    xc, conv_state = causal_conv1d(x, p["conv"])
    xc = silu(xc)
    wx = xc @ p["w"] + p["b"]
    st = init_slstm_state(cfg, B, dtype=x.dtype, device=x.device)
    hs = []
    for t in range(S):
        st = _slstm_cell(p, wx[:, t], st, cfg)
        hs.append(st.h)
    y = _slstm_out(p, torch.stack(hs, dim=1), cfg)
    state = st._replace(conv=conv_state) if return_cache else None
    return y, state


def slstm_decode(p, x, state: SLSTMState, cfg: ModelConfig):
    """Advance the sLSTM one token from cached state. x: (B, 1, d)."""
    xc, conv_state = causal_conv1d(x, p["conv"], state.conv)
    xc = silu(xc)
    wx = (xc @ p["w"] + p["b"])[:, 0]
    st = _slstm_cell(p, wx, state, cfg)
    y = _slstm_out(p, st.h[:, None, :], cfg)
    return y, st._replace(conv=conv_state)
