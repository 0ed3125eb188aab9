"""GQA attention: q-chunked full/sliding-window forward + cached decode
(port of ``repro/models/attention.py``).

Prefill is chunked over query blocks so the score matrix never exceeds
(B, KV, G, q_chunk, S_k); sliding-window layers slice a (window + q_chunk)
key window per chunk. It is plain torch (einsum, softmax), as the JAX
package leaves it to XLA. Decode keeps a ring cache for windowed layers and
a linear cache for full layers, with per-slot positions so one mask rule
covers both; its attention goes through the ``swa_decode`` kernel
(``use_kernel=True``) or the plain einsum path it is checked against.

Unlike the JAX package, ``attn_decode`` writes the new token into the cache
in place (the cache is the device's largest mutable state); the position is
a host int, so no step reads a value back from the device.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.layers import rms_norm, rope
from repro_torch.sharding import tensor_parallel


class AttnCache(NamedTuple):
    """Per-layer KV decode cache plus the token position held by each slot."""

    k: torch.Tensor          # (B, L, KV, dh)
    v: torch.Tensor          # (B, L, KV, dh)
    slot_pos: torch.Tensor   # (L,) int32 token position per slot (-1 empty)


def init_attn_params(init, cfg: ModelConfig, lead=()):
    """q/k/v/o projections (plus qk-norm scales when enabled), each with the
    leading dims ``lead``. ``init.normal(shape, fan_in)`` draws N(0,
    1/fan_in) weights, ``init.zeros(shape)`` the norm scales
    (``models.model.Init``)."""
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    p = {
        "wq": init.normal((*lead, d, qd), d),
        "wk": init.normal((*lead, d, kvd), d),
        "wv": init.normal((*lead, d, kvd), d),
        "wo": init.normal((*lead, qd, d), qd),
    }
    if cfg.qk_norm:
        p["q_scale"] = init.zeros((*lead, cfg.head_dim))
        p["k_scale"] = init.zeros((*lead, cfg.head_dim))
    return p


def _project_qkv(p, x, cfg: ModelConfig, positions):
    """q (B, S, H, dh), k and v (B, S, KV, dh) with rope (and qk-norm).
    The head counts are the projections' columns over ``head_dim``: the
    config's, or a model rank's ``H / M`` and ``KV / M`` under tensor
    parallelism (``sharding/rules.py``), whose partial gradients of the
    replicated qk-norm scales are summed over the model group
    (``tensor_parallel.copy_to_model``)."""
    B, S, _ = x.shape
    dh = cfg.head_dim
    H, KV = p["wq"].shape[-1] // dh, p["wk"].shape[-1] // dh
    q = (x @ p["wq"]).reshape(B, S, H, dh)
    k = (x @ p["wk"]).reshape(B, S, KV, dh)
    v = (x @ p["wv"]).reshape(B, S, KV, dh)
    if cfg.qk_norm:
        q_scale, k_scale = p["q_scale"], p["k_scale"]
        tp = tensor_parallel.active()
        if tp is not None and tp.attn:
            q_scale = tensor_parallel.copy_to_model(q_scale)
            k_scale = tensor_parallel.copy_to_model(k_scale)
        q = rms_norm(q, q_scale, cfg.norm_eps)
        k = rms_norm(k, k_scale, cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _scores_softmax_v(q, k, v, qpos, kpos, window: int, dh: int):
    """q: (B,Sq,H,dh) grouped against k/v: (B,Sk,KV,dh). Returns (B,Sq,H*dh)."""
    B, Sq, H, _ = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float()
    scores = scores / math.sqrt(dh)
    mask = (kpos[None, :] <= qpos[:, None]) & (kpos[None, :] >= 0)
    if window:
        mask = mask & (kpos[None, :] > qpos[:, None] - window)
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(B, Sq, H * dh)


def attn_forward(p, x, cfg: ModelConfig, spec: LayerSpec, pos0: int = 0,
                 q_chunk: int = 1024, return_cache: bool = False):
    """Full-sequence attention (prefill). Returns (y, kv) where kv is the
    raw (k, v) if ``return_cache`` else None."""
    B, S, _ = x.shape
    window = spec.window if spec.mixer == "swa" else 0
    dev = x.device
    positions = pos0 + torch.arange(S, device=dev)
    q, k, v = _project_qkv(p, x, cfg, positions)

    q_chunk = min(q_chunk, S)
    # ragged tails: pad queries up to a whole number of chunks; the padded
    # rows attend causally to nothing new and are sliced off below
    S_pad = -(-S // q_chunk) * q_chunk
    if S_pad != S:
        q = F.pad(q, (0, 0, 0, 0, 0, S_pad - S))
    outs = []
    if window and window < S:
        # local layer: each q chunk only sees a (window + chunk) key slice
        W = window
        kp = F.pad(k, (0, 0, 0, 0, W, S_pad - S))
        vp = F.pad(v, (0, 0, 0, 0, W, S_pad - S))
        for qs in range(0, S_pad, q_chunk):
            qpos = pos0 + qs + torch.arange(q_chunk, device=dev)
            kpos = pos0 + qs - W + torch.arange(W + q_chunk, device=dev)
            outs.append(_scores_softmax_v(
                q[:, qs:qs + q_chunk], kp[:, qs:qs + W + q_chunk],
                vp[:, qs:qs + W + q_chunk], qpos, kpos, W, cfg.head_dim))
    else:
        kpos = pos0 + torch.arange(S, device=dev)
        for qs in range(0, S_pad, q_chunk):
            qpos = pos0 + qs + torch.arange(q_chunk, device=dev)
            outs.append(_scores_softmax_v(q[:, qs:qs + q_chunk], k, v, qpos,
                                          kpos, window, cfg.head_dim))
    out = torch.cat(outs, dim=1)[:, :S]
    y = out @ p["wo"]
    return y, ((k, v) if return_cache else None)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def attn_cache_len(cfg: ModelConfig, spec: LayerSpec, max_len: int) -> int:
    """Cache slots a layer needs: its window if sliding, else ``max_len``."""
    if spec.mixer == "swa" and spec.window < max_len:
        return spec.window
    return max_len


def init_attn_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                    max_len: int, dtype=torch.bfloat16, device=None,
                    lead=()) -> AttnCache:
    """An empty KV cache (slot positions start at -1), with leading dims
    ``lead`` (the repeats of a pattern position)."""
    L = attn_cache_len(cfg, spec, max_len)
    shape = (*lead, batch, L, cfg.num_kv_heads, cfg.head_dim)
    return AttnCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        slot_pos=torch.full((*lead, L), -1, dtype=torch.int32, device=device),
    )


def cache_from_prefill(cfg: ModelConfig, spec: LayerSpec, kv, max_len: int,
                       dtype=torch.bfloat16) -> AttnCache:
    """Build a decode cache from prefill's raw (k, v) of S tokens."""
    k, v = kv
    B, S = k.shape[:2]
    L = attn_cache_len(cfg, spec, max_len)
    cache = init_attn_cache(cfg, spec, B, max_len, dtype, device=k.device)
    take = min(S, L)
    src = torch.arange(S - take, S, device=k.device)
    if L == spec.window and spec.mixer == "swa":
        slots = src % L        # ring layout: token position p in slot p % L
    else:
        slots = src
    cache.k[:, slots] = k[:, S - take:].to(dtype)
    cache.v[:, slots] = v[:, S - take:].to(dtype)
    cache.slot_pos[slots] = src.to(torch.int32)
    return cache


def attn_decode(p, x, cache: AttnCache, cfg: ModelConfig, spec: LayerSpec,
                pos: int, use_kernel: bool = False):
    """One-token decode. x: (B, 1, d); pos: host int, the new token's
    position. Writes the token into ``cache`` in place; returns
    (y, cache).

    ``use_kernel=True`` routes the attention itself through
    ``kernels.ops.swa_decode`` (the CUDA kernel on a CUDA tensor, its plain
    twin on a CPU one); ``False`` takes the einsum path of prefill.
    """
    B = x.shape[0]
    L = cache.k.shape[1]
    window = spec.window if spec.mixer == "swa" else 0
    positions = torch.full((1,), pos, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions)

    # token position p lives in slot p % L (identity for linear caches, ring
    # layout for window caches where L == window)
    slot = pos % L
    cache.k[:, slot] = k[:, 0].to(cache.k.dtype)
    cache.v[:, slot] = v[:, 0].to(cache.v.dtype)
    cache.slot_pos[slot:slot + 1].fill_(pos)
    ck, cv = cache.k.to(q.dtype), cache.v.to(q.dtype)   # no copy if equal

    if use_kernel:
        out = kernel_ops.swa_decode(q[:, 0], ck, cv, cache.slot_pos, pos,
                                    window=window).reshape(B, 1, cfg.q_dim)
    else:
        out = _scores_softmax_v(q, ck, cv, positions, cache.slot_pos, window,
                                cfg.head_dim)
    return out @ p["wo"], cache
