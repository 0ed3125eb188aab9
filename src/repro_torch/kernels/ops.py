"""The glue around the kernels (port of ``repro/kernels/ops.py``): the
Sherman-Morrison DP step and the flat DP on the cohort (``dp_step``,
``dp_delta_flat``), and decode attention on ``(B, H, dh)`` query heads
(``swa_decode``).

``dp_step`` on the card is two kernel launches and nothing between them:
the reduce pass gives every dot the step needs and, in its epilogue, the
step's coefficients (``ref.dp_coeffs``); the map pass reads them where the
reduce left them and writes ``v_t`` and ``Delta~_t``. CPU tensors go to the
plain twins (``fedpa_dp.dp_step`` dispatches on the device).

``dp_step_sharded`` is the step of a vector sharded over ranks (the FSDP
round, ``core/fsdp.py``): each dot is a sum over the ranks' shards, so the
reduce kernel gives this shard's partial dots, they are summed across the
ranks, and the coefficients (``dp_coeffs``, the glue of the reference's
``kernels/ops.py::dp_step``) come from the sums before the map kernel runs
on the shard.
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


def dp_coeffs(dots, uu, ud, c_hist, t: int, rho: float):
    """The scalars of one DP step from its dots, per client: the combine
    weights ``w`` (``(C, lp)``, rows ``k >= t-1`` masked to 0), the map's
    ``scale``, ``a = <u,u> - sum_k w_k dots_k`` (``<u, v>`` by conjugacy)
    and the new history coefficient ``c_new``, each ``(C,)`` (fp32, the
    formulas of the fused step's epilogue)."""
    lp = c_hist.shape[-1]
    live = torch.arange(lp, device=c_hist.device) < (t - 1)
    w = torch.where(live, c_hist * dots, torch.zeros_like(dots))
    g = (t - 1.0) * rho / t
    a = uu - (w * dots).sum(-1)
    den = 1.0 + g * a
    return w, (1.0 + g * (t * ud - a) / den) / t, a, g / den


def dp_partials(u, delta, V, rows=None):
    """This shard's reduce pass packed for one all-reduce: ``(C, lp + 2)``
    fp32 rows ``[dots | <u,u> | <u,delta>]`` (one ``dp_reduce`` launch
    over the first ``rows`` history rows on the card)."""
    dots, uu, ud = fedpa_dp.dp_reduce(u, delta, V, rows)
    return torch.cat([dots, uu[:, None], ud[:, None]], dim=1)


def dp_step_sharded(u, delta, V, c_hist, t: int, rho: float, *,
                    all_reduce):
    """One DP step on this rank's shard of every vector: ``u``, ``delta``
    ``(C, n)`` and ``V`` ``(C, lp, n)`` hold elements ``[r n, (r+1) n)``
    of the whole vectors (zero padding included). The partial dots of
    ``dp_partials`` go through ``all_reduce`` (a sum over the ranks), the
    coefficients come from the sums (``dp_coeffs``) and ``dp_map`` writes
    this shard of ``v_t`` and ``Delta~_t``: one launch of each kernel on
    the card, reading only the live history rows. Shapes and returns as
    ``dp_step``; ``a`` and ``c_new`` are the same on every rank."""
    if not isinstance(t, int) or t < 2:
        raise ValueError(f"t must be a host int >= 2, got {t!r}")
    lp = V.shape[1]
    rows = min(lp, t - 1)
    part = all_reduce(dp_partials(u, delta, V, rows))
    w, scale, a, c_new = dp_coeffs(part[:, :lp], part[:, lp],
                                   part[:, lp + 1], c_hist, t, rho)
    v, delta_new = fedpa_dp.dp_map(w, scale, u, delta, V, rows)
    return v, delta_new, a, c_new


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
