"""Wrapper of the decode-attention CUDA kernel (``csrc/swa_decode.cu``), the
Hopper port of the Pallas kernel ``repro/kernels/swa_decode.py``.

One query token per request attends, with grouped-query heads, to a linear
or ring KV cache. K and V are read in place in their ``(B, L, KV, dh)``
cache layout (no transpose, no cast); any L is taken. A CUDA tensor goes to
the kernel, a CPU tensor to the plain twin ``ref.swa_decode_ref``; a mix
raises. ``launches`` counts the calls that launched the kernel; a call is
one launch (a cluster of CTAs per request and KV head, no second pass).

The checks of shapes, dtypes and layout, and the kernel's shared-memory
and occupancy set-up, run once per (shapes, dtypes, device) and are
remembered; a call then costs the output's allocation and one ctypes call.
"""
from __future__ import annotations

import ctypes
import functools
import numbers

import torch

from repro_torch.kernels import build, ref

#: Calls of the wrapper that launched the CUDA kernel (one launch each).
launches = {"swa_decode": 0}

_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    """Set the launch count to 0."""
    launches["swa_decode"] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("swa_decode")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.swa_decode_smem_limit.argtypes = []
    lib.swa_decode_smem_limit.restype = i32
    lib.swa_decode_smem_bytes.argtypes = [i32, i32, i32]
    lib.swa_decode_smem_bytes.restype = ctypes.c_longlong
    lib.swa_decode_prepare.argtypes = [i32, i32, i32]
    lib.swa_decode_prepare.restype = i32
    lib.swa_decode.argtypes = [ptr] * 5 + [i32] * 8 + [ptr]
    lib.swa_decode.restype = i32
    lib.swa_decode_error_string.argtypes = [i32]
    lib.swa_decode_error_string.restype = ctypes.c_char_p
    return lib


def _error(lib, err: int) -> str:
    return f"CUDA error {err} ({lib.swa_decode_error_string(err).decode()})"


@functools.lru_cache(maxsize=None)
def _plan(q_shape, k_shape, v_shape, sp_shape, dtypes, contiguous, device):
    """The checks that depend only on shapes, dtypes, layout and device,
    once per key; returns (B, L, KV, G, dh, bf16, clusters), ``clusters``
    being how many of the kernel's clusters fit on the card at once (None
    on the CPU)."""
    if len(q_shape) != 4 or len(k_shape) != 4:
        raise ValueError(f"need q (B, KV, G, dh) and k, v (B, L, KV, dh); got "
                         f"{tuple(q_shape)}, {tuple(k_shape)}")
    B, KV, G, dh = q_shape
    L = k_shape[1]
    if tuple(k_shape) != (B, L, KV, dh) or v_shape != k_shape or \
            tuple(sp_shape) != (L,):
        raise ValueError(f"shape mismatch: q {tuple(q_shape)}, k "
                         f"{tuple(k_shape)}, v {tuple(v_shape)}, slot_pos "
                         f"{tuple(sp_shape)}")
    if dh % 32 or not 32 <= dh <= 256:
        raise ValueError(f"head_dim must be a multiple of 32 in [32, 256], "
                         f"got {dh}")
    if min(B, L, KV, G) < 1 or max(B, KV) > 65535:
        raise ValueError(f"need B, KV in [1, 65535] and L, G >= 1; got B={B}, "
                         f"L={L}, KV={KV}, G={G}")
    q_dt, k_dt, v_dt, sp_dt = dtypes
    if q_dt not in _DTYPES or k_dt != q_dt or v_dt != q_dt:
        raise TypeError(f"q, k, v must share one dtype in {_DTYPES}; got "
                        f"{q_dt}, {k_dt}, {v_dt}")
    if sp_dt != torch.int32:
        raise TypeError(f"slot_pos must be int32, got {sp_dt}")
    for name, ok in zip(("k", "v", "slot_pos"), contiguous):
        if not ok:
            raise ValueError(f"{name} must be contiguous")
    bf16 = int(q_dt == torch.bfloat16)
    if device.type != "cuda":
        return B, L, KV, G, dh, bf16, None
    lib = _lib()
    if lib.swa_decode_smem_bytes(G, dh, bf16) > lib.swa_decode_smem_limit():
        raise ValueError(f"G={G} query heads per KV head at head_dim {dh} "
                         f"need more shared memory than a block has")
    with torch.cuda.device(device):
        clusters = lib.swa_decode_prepare(G, dh, bf16)
    if clusters < 0:
        raise RuntimeError(f"swa_decode set-up failed: {_error(lib, -clusters)}")
    if clusters == 0:
        raise RuntimeError(
            f"swa_decode: no cluster of its CTAs fits on {device} at G={G}, "
            f"head_dim {dh}, {q_dt} ({lib.swa_decode_smem_bytes(G, dh, bf16)} "
            f"bytes of shared memory per CTA)")
    return B, L, KV, G, dh, bf16, clusters


def _check(q, k, v, slot_pos, pos, window):
    """Shapes, dtypes, layout and scalars the kernel takes; returns the plan
    (B, L, KV, G, dh, bf16, clusters)."""
    for name, x in (("pos", pos), ("window", window)):
        if type(x) is not int and not isinstance(x, numbers.Integral) or \
                not -2**31 <= x < 2**31:
            raise TypeError(f"{name} must be a host int32, got {x!r}")
    return _plan(q.shape, k.shape, v.shape, slot_pos.shape,
                 (q.dtype, k.dtype, v.dtype, slot_pos.dtype),
                 (k.is_contiguous(), v.is_contiguous(),
                  slot_pos.is_contiguous()), q.device)


def swa_decode_attention(q, k, v, slot_pos, pos: int, *, window: int = 0):
    """Masked-softmax decode attention of one token per request.

    q: (B, KV, G, dh); k, v: (B, L, KV, dh); slot_pos: (L,) int32, the token
    position each slot holds (-1: empty); pos: host int, the new token's
    position; ``window`` > 0 also hides slots at or below ``pos - window``.
    fp32 or bf16 (one dtype), fp32 accumulators; returns (B, KV, G, dh) in
    q's dtype.
    """
    if build.on_cpu(q, k, v, slot_pos):
        return ref.swa_decode_ref(q, k, v, slot_pos, pos, window=window)
    B, L, KV, G, dh, bf16, _ = _check(q, k, v, slot_pos, pos, window)
    k_ptr, v_ptr = k.data_ptr(), v.data_ptr()
    if (k_ptr | v_ptr) & 15:
        raise ValueError("k and v must start on a 16-byte boundary (the "
                         "kernel copies their rows with TMA)")
    q = q.contiguous()
    out = torch.empty_like(q)
    lib = _lib()
    err = lib.swa_decode(q.data_ptr(), k_ptr, v_ptr, slot_pos.data_ptr(),
                         out.data_ptr(), B, L, KV, G, dh, int(pos),
                         int(window), bf16, build.stream())
    if err != 0:
        raise RuntimeError(f"swa_decode launch failed: {_error(lib, err)}")
    launches["swa_decode"] += 1
    return out
