"""Wrappers of the two CUDA kernels of one Sherman-Morrison DP step
(``csrc/fedpa_dp.cu``), the Hopper port of the Pallas kernels in
``repro/kernels/fedpa_dp.py``, and of the step they make together.

All take the cohort with a leading client axis (the TPU kernels ran one
client per call). A CUDA tensor goes to the kernel, a CPU tensor to the
plain twin in ``ref.py``; any other device raises. Each call is one launch
of each kernel it names, counted in ``launches``: ``dp_reduce`` and
``dp_map`` one each, ``dp_step`` one of each (its reduce also computes the
step's coefficients, which its map reads in place: two launches and no
other device operation).

The checks of shapes, dtypes and layout are made once per (shapes,
dtypes, layout, devices) and remembered. The reduce's per-tile partials and
per-client ticket counters, and the step's combine weights and scale, are
scratch kept per device: allocated (the counters zeroed) on the first call
that needs more, never shrunk, and left by every launch with the counters
at 0. They assume that one stream at a time launches these kernels, and
that the first call at the largest shape comes before any CUDA-graph
capture (a capture that would need them to grow raises). Buffers outgrown
stay allocated, so a graph captured earlier keeps pointing at live memory.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build, ref

#: Calls of each wrapper that launched its CUDA kernel (``dp_step`` counts
#: one of each).
launches = {"dp_reduce": 0, "dp_map": 0}

_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    """Set every launch count to 0."""
    for k in launches:
        launches[k] = 0


def vector_bytes(d: int, esize: int, *ptrs: int) -> int:
    """Width in bytes of the kernels' loads and stores: the widest of 16,
    8, 4 and 2 bytes (and at least one element of ``esize`` bytes) that a
    row of ``d`` elements and every base address in ``ptrs`` are multiples
    of, so that every row of every operand starts on a whole vector. At the
    EMNIST CNN's d = 428,350 that is 8 bytes in fp32 and 4 in bf16."""
    bits = d * esize
    for p in ptrs:
        bits |= p
    vb = 16
    while vb > esize and bits & (vb - 1):
        vb //= 2
    return vb


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("fedpa_dp")
    ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
    lib.fedpa_dp_tile.argtypes = [i32]
    lib.fedpa_dp_tile.restype = i32
    lib.fedpa_dp_reduce.argtypes = ([ptr] * 10 + [i32] * 3 + [i64, f32, f32]
                                    + [i32] * 2 + [ptr])
    lib.fedpa_dp_reduce.restype = i32
    lib.fedpa_dp_map.argtypes = [ptr] * 7 + [i32] * 3 + [i64] + [i32] * 2 \
        + [ptr]
    lib.fedpa_dp_map.restype = i32
    lib.fedpa_dp_error_string.argtypes = [i32]
    lib.fedpa_dp_error_string.restype = ctypes.c_char_p
    return lib


def _error(err: int) -> str:
    return f"CUDA error {err} ({_lib().fedpa_dp_error_string(err).decode()})"


class _Plan(NamedTuple):
    C: int
    lp: int
    d: int
    bf16: int
    esize: int
    n_tiles: int
    device: torch.device


@functools.lru_cache(maxsize=None)
def _plan(u_shape, d_shape, V_shape, dtypes, contiguous, devices) -> _Plan:
    """The checks that depend only on shapes, dtypes, layout and devices,
    once per key."""
    if len(set(devices)) != 1 or devices[0].type != "cuda":
        raise ValueError(f"kernels take tensors on one CUDA device or all on "
                         f"the CPU, got {sorted(map(str, devices))}")
    if len(u_shape) != 2 or len(V_shape) != 3:
        raise ValueError(f"need u, delta (C, d) and V (C, lp, d); got "
                         f"{tuple(u_shape)}, {tuple(V_shape)}")
    C, d = u_shape
    lp = V_shape[1]
    if tuple(d_shape) != tuple(u_shape) or tuple(V_shape) != (C, lp, d):
        raise ValueError(f"shape mismatch: u {tuple(u_shape)}, delta "
                         f"{tuple(d_shape)}, V {tuple(V_shape)}")
    if not 1 <= C <= 65535 or lp < 1 or d < 1:
        raise ValueError(f"need 1 <= C <= 65535, lp >= 1, d >= 1; got "
                         f"C={C}, lp={lp}, d={d}")
    u_dt, d_dt, V_dt = dtypes
    if u_dt not in _DTYPES or d_dt != u_dt or V_dt != u_dt:
        raise TypeError(f"u, delta, V must share one dtype in {_DTYPES}; got "
                        f"{u_dt}, {d_dt}, {V_dt}")
    for name, ok in zip(("u", "delta", "V"), contiguous):
        if not ok:
            raise ValueError(f"{name} must be contiguous")
    bf16 = int(u_dt == torch.bfloat16)
    esize = 2 if bf16 else 4
    n_tiles = -(-d // _lib().fedpa_dp_tile(bf16))
    return _Plan(C, lp, d, bf16, esize, n_tiles, devices[0])


def _plan_of(u, delta, V) -> _Plan:
    return _plan(u.shape, delta.shape, V.shape,
                 (u.dtype, delta.dtype, V.dtype),
                 (u.is_contiguous(), delta.is_contiguous(),
                  V.is_contiguous()), (u.device, delta.device, V.device))


#: device index -> (fp32 buffer [w (C*lp) | scale (C) | partials], ticket
#: counters int32) of the reduce
_scratch: dict = {}
#: scratch outgrown, kept alive for CUDA graphs captured before
_retired: list = []


def _scratch_for(plan: _Plan, rows: int):
    """The device's reduce scratch, grown (outside any graph capture) to
    hold the step's w and scale and ``plan``'s partials at ``rows`` history
    rows."""
    need = plan.C * (plan.lp + 1) + plan.C * plan.n_tiles * (rows + 2)
    index = plan.device.index
    cur = _scratch.get(index)
    if cur is not None and cur[0].numel() >= need and \
            cur[1].numel() >= plan.C:
        return cur
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "fedpa_dp: the reduce's scratch must grow, which it cannot "
            "inside a CUDA-graph capture; call once at this shape first")
    if cur is not None:
        _retired.append(cur)
        need = max(need, cur[0].numel())
    n_tickets = max(plan.C, 0 if cur is None else cur[1].numel())
    new = (torch.empty(need, dtype=torch.float32, device=plan.device),
           torch.zeros(n_tickets, dtype=torch.int32, device=plan.device))
    _scratch[index] = new
    return new


def _launch_reduce(plan, u, delta, V, rows, outs, c_hist=None, g=0.0,
                   t=0.0):
    """One reduce launch; ``outs`` are the pointers (vec, s0, s1, s2) the
    kernel writes, None for the step's w and scale (the scratch's)."""
    buf, tickets = _scratch_for(plan, rows)
    base = buf.data_ptr()
    C, lp = plan.C, plan.lp
    vec, s0, s1, s2 = outs
    if vec is None:
        vec, s0 = base, base + 4 * C * lp
    ptrs = (u.data_ptr(), delta.data_ptr(), V.data_ptr())
    err = _lib().fedpa_dp_reduce(
        *ptrs, base + 4 * C * (lp + 1), tickets.data_ptr(), vec, s0, s1, s2,
        c_hist, C, lp, rows, plan.d, g, t, plan.bf16,
        vector_bytes(plan.d, plan.esize, *ptrs),
        build.stream(plan.device.index))
    if err != 0:
        raise RuntimeError(f"dp_reduce launch failed: {_error(err)}")
    launches["dp_reduce"] += 1


def _launch_map(plan, w, s, u, delta, V, rows):
    """One map launch reading w (C, lp) and s (C,) at these pointers;
    returns (v, delta')."""
    vout = torch.empty_like(u)
    dout = torch.empty_like(delta)
    ptrs = (u.data_ptr(), delta.data_ptr(), V.data_ptr(), vout.data_ptr(),
            dout.data_ptr())
    err = _lib().fedpa_dp_map(
        w, s, *ptrs, plan.C, plan.lp, rows, plan.d, plan.bf16,
        vector_bytes(plan.d, plan.esize, *ptrs),
        build.stream(plan.device.index))
    if err != 0:
        raise RuntimeError(f"dp_map launch failed: {_error(err)}")
    launches["dp_map"] += 1
    return vout, dout


def _rows_of(plan: _Plan, rows) -> int:
    """The history rows a call reads: all ``lp`` when None."""
    if rows is None:
        return plan.lp
    if not 1 <= rows <= plan.lp:
        raise ValueError(f"rows must be in [1, {plan.lp}], got {rows}")
    return rows


def dp_reduce(u, delta, V, rows=None):
    """Reduce pass of one DP step, per client c:
    ``dots[c,k] = <V[c,k], u[c]>``, ``uu[c] = <u[c],u[c]>``,
    ``ud[c] = <u[c],delta[c]>``.

    u, delta: (C, d); V: (C, lp, d); one dtype, fp32 or bf16. Returns
    fp32 ``(dots (C, lp), uu (C,), ud (C,))``. ``rows`` reads only the
    history rows ``k < rows`` (the live rows of a DP step) and gives 0
    for the dots of the rest; on the CPU the twin reads them all (the
    DP's dead rows hold zeros).
    """
    if not u.is_cuda and build.on_cpu(u, delta, V):
        return ref.dp_reduce_ref(u, delta, V)
    plan = _plan_of(u, delta, V)
    rows = _rows_of(plan, rows)
    dots = (torch.empty if rows == plan.lp else torch.zeros)(
        plan.C, plan.lp, dtype=torch.float32, device=plan.device)
    uu = torch.empty(plan.C, dtype=torch.float32, device=plan.device)
    ud = torch.empty(plan.C, dtype=torch.float32, device=plan.device)
    _launch_reduce(plan, u, delta, V, rows,
                   (dots.data_ptr(), uu.data_ptr(), ud.data_ptr(), None))
    return dots, uu, ud


def dp_map(w, s, u, delta, V, rows=None):
    """Map pass of one DP step, per client c:
    ``v[c] = u[c] - sum_k w[c,k] V[c,k]``, ``delta'[c] = delta[c] - s[c] v[c]``.

    w: (C, lp) fp32; s: (C,) fp32; u, delta: (C, d); V: (C, lp, d) (fp32 or
    bf16, one dtype). Returns ``(v, delta')`` in the input dtype. ``rows``
    reads only the history rows ``k < rows`` (their ``w`` must be 0
    beyond); on the CPU the twin reads them all.
    """
    if not u.is_cuda and build.on_cpu(w, s, u, delta, V):
        return ref.dp_map_ref(w, s, u, delta, V)
    plan = _plan_of(u, delta, V)
    rows = _rows_of(plan, rows)
    if w.device != plan.device or s.device != plan.device:
        raise ValueError(f"kernels take tensors on one CUDA device or all on "
                         f"the CPU, got w on {w.device}, s on {s.device}, u "
                         f"on {plan.device}")
    if w.shape != (plan.C, plan.lp) or s.shape != (plan.C,):
        raise ValueError(f"need w (C, lp) = ({plan.C}, {plan.lp}) and s "
                         f"(C,); got {tuple(w.shape)}, {tuple(s.shape)}")
    if w.dtype != torch.float32 or s.dtype != torch.float32:
        raise TypeError(f"w and s must be float32; got {w.dtype}, {s.dtype}")
    w, s = w.contiguous(), s.contiguous()
    return _launch_map(plan, w.data_ptr(), s.data_ptr(), u, delta, V, rows)


def dp_step(u, delta, V, c_hist, t: int, rho: float):
    """One Sherman-Morrison DP step: on the card the reduce kernel with the
    coefficients of ``ref.dp_coeffs`` in its epilogue, then the map kernel
    reading w and the scale where the reduce left them (the device's
    scratch); two launches, no other device operation, no host sync (it
    can be captured in a CUDA graph). Only the live history rows ``k <
    t-1`` are read (the rest are masked). On the CPU the twins' step
    ``ref.dp_step_ref``. Shapes as ``ops.dp_step``; returns ``(v, delta',
    a, c_new)``."""
    if not u.is_cuda and build.on_cpu(u, delta, V, c_hist):
        return ref.dp_step_ref(u, delta, V, c_hist, t, rho)
    if not isinstance(t, int) or t < 2:
        raise ValueError(f"t must be a host int >= 2, got {t!r}")
    plan = _plan_of(u, delta, V)
    C, lp = plan.C, plan.lp
    if c_hist.shape != (C, lp) or c_hist.dtype != torch.float32 or \
            not c_hist.is_contiguous() or c_hist.device != plan.device:
        raise ValueError(f"c_hist must be a contiguous float32 ({C}, {lp}) "
                         f"on {plan.device}; got {c_hist.dtype} "
                         f"{tuple(c_hist.shape)} on {c_hist.device}")
    rows = min(lp, t - 1)
    a = torch.empty(C, dtype=torch.float32, device=plan.device)
    c_new = torch.empty(C, dtype=torch.float32, device=plan.device)
    _launch_reduce(plan, u, delta, V, rows,
                   (None, None, a.data_ptr(), c_new.data_ptr()),
                   c_hist.data_ptr(), (t - 1.0) * rho / t, float(t))
    base = _scratch[plan.device.index][0].data_ptr()
    v, delta_new = _launch_map(plan, base, base + 4 * C * lp, u, delta, V,
                               rows)
    return v, delta_new, a, c_new
