"""Wrappers of the two CUDA kernels of one Sherman-Morrison DP step
(``csrc/fedpa_dp.cu``), the Hopper port of the Pallas kernels in
``repro/kernels/fedpa_dp.py``.

Both take the cohort with a leading client axis (the TPU kernels ran one
client per call). A CUDA tensor goes to the kernel, a CPU tensor to the
plain twin in ``ref.py``; any other device raises. Each wrapper counts the
calls that launched its kernel in ``launches`` (a call of ``dp_reduce``
counts once, though it makes two launches: tiles, then their sum).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

#: Calls of each wrapper that launched its CUDA kernel.
launches = {"dp_reduce": 0, "dp_map": 0}

_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    """Set every launch count to 0."""
    for k in launches:
        launches[k] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("fedpa_dp")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fedpa_dp_reduce_tiles.argtypes = [i64]
    lib.fedpa_dp_reduce_tiles.restype = i32
    lib.fedpa_dp_reduce.argtypes = [ptr] * 5 + [i32, i32, i64, i32, ptr]
    lib.fedpa_dp_reduce.restype = i32
    lib.fedpa_dp_map.argtypes = [ptr] * 7 + [i32, i32, i64, i32, ptr]
    lib.fedpa_dp_map.restype = i32
    lib.fedpa_dp_error_string.argtypes = [i32]
    lib.fedpa_dp_error_string.restype = ctypes.c_char_p
    return lib


def _check_cohort(u, delta, V):
    """Shape/dtype/contiguity checks shared by both kernels; returns
    (C, lp, d)."""
    if u.dim() != 2 or V.dim() != 3:
        raise ValueError(f"need u, delta (C, d) and V (C, lp, d); got "
                         f"{tuple(u.shape)}, {tuple(V.shape)}")
    C, d = u.shape
    lp = V.shape[1]
    if delta.shape != u.shape or V.shape != (C, lp, d):
        raise ValueError(f"shape mismatch: u {tuple(u.shape)}, delta "
                         f"{tuple(delta.shape)}, V {tuple(V.shape)}")
    if not 1 <= C <= 65535 or lp < 1 or d < 1:
        raise ValueError(f"need 1 <= C <= 65535, lp >= 1, d >= 1; got "
                         f"C={C}, lp={lp}, d={d}")
    if u.dtype not in _DTYPES or delta.dtype != u.dtype or V.dtype != u.dtype:
        raise TypeError(f"u, delta, V must share one dtype in {_DTYPES}; got "
                        f"{u.dtype}, {delta.dtype}, {V.dtype}")
    for name, t in (("u", u), ("delta", delta), ("V", V)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return C, lp, d


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().fedpa_dp_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def dp_reduce(u, delta, V):
    """Reduce pass of one DP step, per client c:
    ``dots[c,k] = <V[c,k], u[c]>``, ``uu[c] = <u[c],u[c]>``,
    ``ud[c] = <u[c],delta[c]>``.

    u, delta: (C, d); V: (C, lp, d); one dtype, fp32 or bf16. Returns
    fp32 ``(dots (C, lp), uu (C,), ud (C,))``.
    """
    if build.on_cpu(u, delta, V):
        return ref.dp_reduce_ref(u, delta, V)
    C, lp, d = _check_cohort(u, delta, V)
    lib = _lib()
    n_tiles = lib.fedpa_dp_reduce_tiles(d)
    partials = torch.empty(C, n_tiles, lp + 2, dtype=torch.float32,
                           device=u.device)
    out = torch.empty(C, lp + 2, dtype=torch.float32, device=u.device)
    err = lib.fedpa_dp_reduce(u.data_ptr(), delta.data_ptr(), V.data_ptr(),
                              partials.data_ptr(), out.data_ptr(), C, lp, d,
                              int(u.dtype == torch.bfloat16), build.stream())
    _raise_on(err, "dp_reduce")
    launches["dp_reduce"] += 1
    return out[:, :lp], out[:, lp], out[:, lp + 1]


def dp_map(w, s, u, delta, V):
    """Map pass of one DP step, per client c:
    ``v[c] = u[c] - sum_k w[c,k] V[c,k]``, ``delta'[c] = delta[c] - s[c] v[c]``.

    w: (C, lp) fp32; s: (C,) fp32; u, delta: (C, d); V: (C, lp, d) (fp32 or
    bf16, one dtype). Returns ``(v, delta')`` in the input dtype.
    """
    if build.on_cpu(w, s, u, delta, V):
        return ref.dp_map_ref(w, s, u, delta, V)
    C, lp, d = _check_cohort(u, delta, V)
    if w.shape != (C, lp) or s.shape != (C,):
        raise ValueError(f"need w (C, lp) = ({C}, {lp}) and s (C,); got "
                         f"{tuple(w.shape)}, {tuple(s.shape)}")
    if w.dtype != torch.float32 or s.dtype != torch.float32:
        raise TypeError(f"w and s must be float32; got {w.dtype}, {s.dtype}")
    w, s = w.contiguous(), s.contiguous()
    vout = torch.empty_like(u)
    dout = torch.empty_like(delta)
    err = _lib().fedpa_dp_map(w.data_ptr(), s.data_ptr(), u.data_ptr(),
                              delta.data_ptr(), V.data_ptr(), vout.data_ptr(),
                              dout.data_ptr(), C, lp, d,
                              int(u.dtype == torch.bfloat16), build.stream())
    _raise_on(err, "dp_map")
    launches["dp_map"] += 1
    return vout, dout
