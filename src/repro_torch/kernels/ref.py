"""Plain PyTorch twins of the kernels (port of ``repro/kernels/ref.py``).

The DP twins take the cohort with a leading client axis ``C``: ``u`` and
``delta`` are ``(C, d)``, the history ``V`` is ``(C, lp, d)``, ``w`` is
``(C, lp)`` and ``s`` is ``(C,)``. Math in fp32. The wrappers in
``fedpa_dp.py`` call these for CPU tensors; ``chip_smoke.py`` holds the CUDA
kernels against them on the card; ``dp_coeffs`` holds the step's scalar
formulas, which the CUDA step computes in its reduce kernel, and
``dp_reduce_split_ref`` models how that kernel splits the sums (for the
tests). ``swa_decode_ref`` is the twin of the decode-attention kernel
(``swa_decode.py``); ``swa_decode_split_ref`` models how that kernel splits
the work (for the tests).
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


def dp_coeffs(dots, uu, ud, c_hist, t: int, rho: float):
    """The scalars of one DP step from its reduce pass, per client: the
    combine weights ``w`` (``(C, lp)``; history rows ``k >= t-1`` masked to
    0), the map's ``scale``, ``a = <u,u> - sum_k w_k dots_k`` (``<u, v>`` by
    conjugacy) and the new history coefficient ``c_new``, each ``(C,)``.
    The CUDA step computes the same in the reduce kernel's epilogue."""
    lp = c_hist.shape[-1]
    mask = torch.arange(lp, device=c_hist.device) < (t - 1)
    w = torch.where(mask, c_hist * dots, torch.zeros_like(dots))
    g = (t - 1.0) * rho / t
    a = uu - (w * dots).sum(-1)
    scale = (1.0 + g * (t * ud - a) / (1.0 + g * a)) / t
    c_new = g / (1.0 + g * a)
    return w, scale, a, c_new


def dp_step_with(reduce_fn, map_fn, u, delta, V, c_hist, t: int,
                 rho: float):
    """One DP step (paper eqs. 22-23) over a given reduce/map pair (the
    twins in ``dp_step_ref``; library calls in ``chip_smoke.py``), with the
    coefficients of ``dp_coeffs`` between them."""
    dots, uu, ud = reduce_fn(u, delta, V)
    w, scale, a, c_new = dp_coeffs(dots, uu, ud, c_hist, t, rho)
    v, delta_new = map_fn(w, scale, u, delta, V)
    return v, delta_new, a, c_new


def dp_step_ref(u, delta, V, c_hist, t: int, rho: float):
    """One full DP step on the twins — see ``ops.dp_step``."""
    return dp_step_with(dp_reduce_ref, dp_map_ref, u, delta, V, c_hist, t,
                        rho)


def _warp_tree(x):
    """The kernels' ``warp_sum`` on the last axis (32 lanes): the shuffle-
    down tree whose lane 0 ends with ((x0 + x16) + (x8 + x24)) + ..."""
    o = 16
    while o:
        x = x[..., :o] + x[..., o:2 * o]
        o //= 2
    return x[..., 0]


def _block_sum(x, threads: int):
    """The kernels' ``block_sum`` on the last axis (``threads`` values): a
    warp tree per warp, then the warps' sums in order from 0."""
    warps = _warp_tree(x.reshape(*x.shape[:-1], threads // 32, 32))
    tot = torch.zeros(x.shape[:-1])
    for w in range(threads // 32):
        tot = tot + warps[..., w]
    return tot


#: The reduce kernel's CTA size and bytes of a row per thread per tile
#: (``kThreads``, ``kReduceBytes`` in ``csrc/fedpa_dp.cu``; a GPU test holds
#: the tile they give against the kernel's ``fedpa_dp_tile``).
REDUCE_THREADS = 256
REDUCE_BYTES_PER_THREAD = 32


def reduce_tile(esize: int) -> int:
    """Elements of one reduce tile for inputs of ``esize`` bytes."""
    return REDUCE_THREADS * REDUCE_BYTES_PER_THREAD // esize


def dp_reduce_split_ref(u, delta, V, *, vec_bytes: int):
    """The CUDA kernel's split of ``dp_reduce_ref``'s work, in plain fp32
    PyTorch, so that its sum order can be checked without a card (only tests
    use it).

    Each row is cut into tiles of ``reduce_tile(esize)`` elements (2048
    fp32 or 4096 bf16; the last tile padded with zeros). In a tile, thread
    j of ``REDUCE_THREADS`` holds vectors ``i * threads + j`` of ``vec_bytes`` bytes (the
    load width, ``fedpa_dp.vector_bytes``) and sums
    its products in order (vector by vector, element by element); the
    block's threads are summed by ``_block_sum`` into one partial per tile.
    A client's tiles are then combined the same way: thread j sums tiles j,
    j + threads, ... in order, then ``_block_sum``. The card fuses each
    multiply-add, so it agrees with this model to rounding, not bit for bit.
    """
    threads = REDUCE_THREADS
    uf, df, Vf = u.float(), delta.float(), V.float()
    C, d = uf.shape
    esize = u.element_size()
    n = vec_bytes // esize
    per_thread = REDUCE_BYTES_PER_THREAD // vec_bytes
    tile = reduce_tile(esize)
    n_tiles = -(-d // tile)
    prods = torch.cat([Vf * uf[:, None], (uf * uf)[:, None],
                       (uf * df)[:, None]], dim=1)            # (C, W, d)
    prods = torch.nn.functional.pad(prods, (0, n_tiles * tile - d))
    prods = prods.reshape(C, -1, n_tiles, per_thread, threads, n)
    acc = torch.zeros(prods.shape[:3] + (threads,))
    for i in range(per_thread):
        for e in range(n):
            acc = acc + prods[..., i, :, e]
    partials = _block_sum(acc, threads)                   # (C, W, n_tiles)
    rounds = -(-n_tiles // threads)
    partials = torch.nn.functional.pad(partials,
                                       (0, rounds * threads - n_tiles))
    per = partials.reshape(C, -1, rounds, threads)
    acc = torch.zeros(per.shape[:2] + (threads,))
    for r in range(rounds):
        acc = acc + per[..., r, :]
    sums = _block_sum(acc, threads)                       # (C, W)
    lp = V.shape[1]
    return sums[:, :lp], sums[:, lp], sums[:, lp + 1]


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


def swa_decode_split_ref(q, k, v, slot_pos, pos: int, *, window: int = 0,
                         cluster: int = 8, tile: int = 32):
    """The CUDA kernel's split of ``swa_decode_ref``'s work, in plain fp32
    PyTorch, so that its arithmetic can be checked without a card (only
    tests use it).

    The L slots go to ``cluster`` contiguous ranges of ceil(L / cluster)
    slots (the last ones short or empty). Each range runs an online
    softmax (m, s, acc) over tiles of ``tile`` slots; an empty range keeps
    m = -FLT_MAX, s = acc = 0 and weighs 0. The ranges' partials are then
    combined in rank order: M = max m_r, out = sum w_r acc_r / sum w_r s_r
    with w_r = exp(m_r - M).
    """
    B, KV, G, dh = q.shape
    L = k.shape[1]
    qf = q.float()
    kf = k.float().transpose(1, 2)                     # (B, KV, L, dh)
    vf = v.float().transpose(1, 2)
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    if window > 0:
        valid = valid & (slot_pos > pos - window)
    empty = torch.finfo(torch.float32).min
    per = -(-L // cluster)
    parts = []
    for r in range(cluster):
        r0, r1 = min(L, r * per), min(L, r * per + per)
        m = torch.full((B, KV, G), empty, dtype=torch.float32)
        s = torch.zeros(B, KV, G)
        acc = torch.zeros(B, KV, G, dh)
        for t0 in range(r0, r1, tile):
            t1 = min(r1, t0 + tile)
            sc = torch.einsum("bhgd,bhld->bhgl", qf, kf[:, :, t0:t1]) \
                / math.sqrt(dh)
            sc = sc.masked_fill(~valid[t0:t1], NEG_INF)
            m_new = torch.maximum(m, sc.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(sc - m_new[..., None])
            s = s * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgl,bhld->bhgd", p, vf[:, :, t0:t1])
            m = m_new
        parts.append((m, s, acc))
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    S, A = torch.zeros(B, KV, G), torch.zeros(B, KV, G, dh)
    for m, s, acc in parts:
        w = torch.exp(m - M)
        S = S + w * s
        A = A + w[..., None] * acc
    return (A / S.clamp_min(1e-30)[..., None]).to(q.dtype)
