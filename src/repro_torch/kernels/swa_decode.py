"""Wrapper of the decode-attention CUDA kernel (``csrc/swa_decode.cu``), the
Hopper port of the Pallas kernel ``repro/kernels/swa_decode.py``.

One query token per request attends, with grouped-query heads, to a linear
or ring KV cache. K and V are read in place in their ``(B, L, KV, dh)``
cache layout (no transpose, no cast); any L is taken, the ragged last chunk
is masked in the kernel. A CUDA tensor goes to the kernel, a CPU tensor to
the plain twin ``ref.swa_decode_ref``; a mix raises. ``launches`` counts the
calls that launched the kernel (one call makes two launches: the chunks,
then their combine).
"""
from __future__ import annotations

import ctypes
import functools
import math
import numbers

import torch

from repro_torch.kernels import build, ref

#: Calls of the wrapper that launched the CUDA kernel.
launches = {"swa_decode": 0}

_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    """Set the launch count to 0."""
    launches["swa_decode"] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("swa_decode")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.swa_decode_chunk.argtypes = []
    lib.swa_decode_chunk.restype = i32
    lib.swa_decode_smem_limit.argtypes = []
    lib.swa_decode_smem_limit.restype = i32
    lib.swa_decode_smem_bytes.argtypes = [i32, i32]
    lib.swa_decode_smem_bytes.restype = ctypes.c_longlong
    lib.swa_decode.argtypes = [ptr] * 6 + [i32] * 8 + [ptr]
    lib.swa_decode.restype = i32
    lib.swa_decode_error_string.argtypes = [i32]
    lib.swa_decode_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v, slot_pos, pos, window):
    """Shapes, dtypes, layout and scalars the kernel takes; returns
    (B, L, KV, G, dh)."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"need q (B, KV, G, dh) and k, v (B, L, KV, dh); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    B, KV, G, dh = q.shape
    L = k.shape[1]
    if k.shape != (B, L, KV, dh) or v.shape != k.shape or \
            slot_pos.shape != (L,):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, slot_pos "
                         f"{tuple(slot_pos.shape)}")
    if dh % 32 or not 32 <= dh <= 256:
        raise ValueError(f"head_dim must be a multiple of 32 in [32, 256], "
                         f"got {dh}")
    if min(B, L, KV, G) < 1 or max(B, KV) > 65535:
        raise ValueError(f"need B, KV in [1, 65535] and L, G >= 1; got B={B}, "
                         f"L={L}, KV={KV}, G={G}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype in {_DTYPES}; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if slot_pos.dtype != torch.int32:
        raise TypeError(f"slot_pos must be int32, got {slot_pos.dtype}")
    for name, t in (("k", k), ("v", v), ("slot_pos", slot_pos)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, x in (("pos", pos), ("window", window)):
        if not isinstance(x, numbers.Integral) or not -2**31 <= x < 2**31:
            raise TypeError(f"{name} must be a host int32, got {x!r}")
    lib = _lib()
    if lib.swa_decode_smem_bytes(G, dh) > lib.swa_decode_smem_limit():
        raise ValueError(f"G={G} query heads per KV head at head_dim {dh} "
                         f"need more shared memory than a block has")
    return B, L, KV, G, dh


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
    B, L, KV, G, dh = _check(q, k, v, slot_pos, pos, window)
    q = q.contiguous()
    lib = _lib()
    n_chunks = math.ceil(L / lib.swa_decode_chunk())
    scratch = torch.empty(B * KV * n_chunks * G * (dh + 2),
                          dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    err = lib.swa_decode(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         slot_pos.data_ptr(), scratch.data_ptr(),
                         out.data_ptr(), B, L, KV, G, dh, int(pos),
                         int(window), int(q.dtype == torch.bfloat16),
                         build.stream())
    if err != 0:
        msg = lib.swa_decode_error_string(err).decode()
        raise RuntimeError(f"swa_decode launch failed: CUDA error {err} "
                           f"({msg})")
    launches["swa_decode"] += 1
    return out
