"""The glue around the kernels (port of ``repro/kernels/ops.py``): the
Sherman-Morrison DP step and the flat DP on the cohort (``dp_step``,
``dp_delta_flat``), and decode attention on ``(B, H, dh)`` query heads
(``swa_decode``).

``dp_step`` on the card is two kernel launches and nothing between them:
the reduce pass gives every dot the step needs and, in its epilogue, the
step's coefficients (``ref.dp_coeffs``); the map pass reads them where the
reduce left them and writes ``v_t`` and ``Delta~_t``. CPU tensors go to the
plain twins (``fedpa_dp.dp_step`` dispatches on the device).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import fedpa_dp, swa_decode as swa


def dp_step(u, delta, V, c_hist, t: int, rho: float):
    """One fused Sherman-Morrison DP step (paper eqs. 22-23) per client.

    u: (C, d) = x_t - xbar_{t-1}; delta: (C, d) = Delta~_{t-1};
    V: (C, lp, d) history v_2..v_{t-1} (rows >= t-1 hold zeros and are
    masked); c_hist: (C, lp) fp32 combine coefficients; t: sample index
    (>= 2).

    Returns (v_t, Delta~_t, a_t, c_t): two passes over the live history
    rows (one launch of each kernel on CUDA) for the whole cohort.
    """
    return fedpa_dp.dp_step(u, delta, V, c_hist, t, rho)


def dp_delta_flat(x0, samples, *, rho: float):
    """Delta_hat_l from stacked ``(C, l, d)`` samples through ``dp_step``.

    ``x0`` is ``(C, d)`` (or ``(d,)``, broadcast over clients). Returns
    ``(C, d)`` fp32. ``V`` is written in place, one row per step.
    """
    C, ell, d = samples.shape
    x0 = x0.float().expand(C, d)
    xbar = samples[:, 0].float()
    delta = x0 - xbar
    lp = max(ell - 1, 1)
    V = torch.zeros(C, lp, d, dtype=torch.float32, device=samples.device)
    c_hist = torch.zeros(C, lp, dtype=torch.float32, device=samples.device)
    for t in range(2, ell + 1):
        u = samples[:, t - 1].float() - xbar
        v, delta, _, c_new = dp_step(u, delta, V, c_hist, t, rho)
        V[:, t - 2] = v
        c_hist[:, t - 2] = c_new
        xbar = xbar + u / t
    rho_l = 1.0 / (1.0 + (ell - 1.0) * rho)
    return delta / rho_l


def swa_decode(q, cache_k, cache_v, slot_pos, pos: int, *, window: int = 0):
    """Decode attention of one token's query heads over a KV cache.

    q: (B, H, dh); cache_k/v: (B, L, KV, dh); slot_pos: (L,) int32; pos:
    host int. The H heads are grouped G = H / KV per KV head for the kernel
    and ungrouped after. Returns (B, H, dh).
    """
    B, H, dh = q.shape
    KV = cache_k.shape[2]
    out = swa.swa_decode_attention(q.reshape(B, KV, H // KV, dh), cache_k,
                                   cache_v, slot_pos, pos, window=window)
    return out.reshape(B, H, dh)
