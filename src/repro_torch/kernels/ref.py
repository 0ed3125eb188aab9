"""Plain PyTorch twins of the kernels (port of ``repro/kernels/ref.py``).

The DP twins take the cohort with a leading client axis ``C``: ``u`` and
``delta`` are ``(C, d)``, the history ``V`` is ``(C, lp, d)``, ``w`` is
``(C, lp)`` and ``s`` is ``(C,)``. Math in fp32. The wrappers in
``fedpa_dp.py`` call these for CPU tensors; ``chip_smoke.py`` holds the CUDA
kernels against them on the card. ``swa_decode_ref`` is the twin of the
decode-attention kernel (``swa_decode.py``).
"""
from __future__ import annotations

import math

import torch

#: The masked score of the TPU kernel: finite, so a row masked everywhere
#: softmaxes to uniform weights instead of NaN.
NEG_INF = -2.0e38


def dp_reduce_ref(u, delta, V):
    """dots[c, k] = <V[c, k], u[c]>, uu[c] = <u[c], u[c]>,
    ud[c] = <u[c], delta[c]>, all fp32."""
    uf, df, Vf = u.float(), delta.float(), V.float()
    return ((Vf * uf[:, None, :]).sum(-1), (uf * uf).sum(-1),
            (uf * df).sum(-1))


def dp_map_ref(w, s, u, delta, V):
    """v = u - sum_k w_k V[k];  delta' = delta - s v (per client).

    ``v`` is returned in ``u``'s dtype and ``delta'`` in ``delta``'s.
    """
    uf, df, Vf = u.float(), delta.float(), V.float()
    v = uf - (w.float()[:, :, None] * Vf).sum(1)
    return v.to(u.dtype), (df - s.float()[:, None] * v).to(delta.dtype)


def dp_step_with(reduce_fn, map_fn, u, delta, V, c_hist, t: int,
                 rho: float):
    """One DP step (paper eqs. 22-23) over a given reduce/map pair: the
    kernels (``ops.dp_step``) or the twins (``dp_step_ref``).

    ``a`` comes by conjugacy, ``a = <u,u> - sum_k w_k dots_k``; history rows
    ``k >= t-1`` are masked out of the combine weights ``w``.
    """
    dots, uu, ud = reduce_fn(u, delta, V)
    lp = c_hist.shape[-1]
    mask = torch.arange(lp, device=c_hist.device) < (t - 1)
    w = torch.where(mask, c_hist * dots, torch.zeros_like(dots))
    g = (t - 1.0) * rho / t
    a = uu - (w * dots).sum(-1)
    scale = (1.0 + g * (t * ud - a) / (1.0 + g * a)) / t
    v, delta_new = map_fn(w, scale, u, delta, V)
    c_new = g / (1.0 + g * a)
    return v, delta_new, a, c_new


def dp_step_ref(u, delta, V, c_hist, t: int, rho: float):
    """One full DP step on the twins — see ``ops.dp_step``."""
    return dp_step_with(dp_reduce_ref, dp_map_ref, u, delta, V, c_hist, t,
                        rho)


def swa_decode_ref(q, k, v, slot_pos, pos: int, *, window: int = 0):
    """Masked-softmax decode attention in fp32; shapes as in
    ``swa_decode.swa_decode_attention``: q (B, KV, G, dh), k/v
    (B, L, KV, dh), slot_pos (L,). Returns q's dtype."""
    qf = q.float()
    kf = k.float().transpose(1, 2)                     # (B, KV, L, dh)
    vf = v.float().transpose(1, 2)
    scores = torch.einsum("bhgd,bhld->bhgl", qf, kf) / math.sqrt(q.shape[-1])
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    if window > 0:
        valid = valid & (slot_pos > pos - window)
    scores = scores.masked_fill(~valid, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhgl,bhld->bhgd", p, vf).to(q.dtype)
