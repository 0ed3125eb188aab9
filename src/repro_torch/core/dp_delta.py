"""Sherman-Morrison dynamic program for FedPA client deltas (Appendix C),
on the flat cohort (port of ``repro/core/dp_delta.py``).

Computes, for every client c of a cohort,

    Delta_hat_l[c] = Sigma_hat_l[c]^{-1} (x0[c] - xbar_l[c])

in O(l^2 d) time and O(l d) memory. The JAX reference works leaf by leaf
inside a ``lax.scan``; the port ravels the cohort's parameters into one
``(C, d)`` fp32 matrix (``tree_math.flatten``) so each step is one
``kernels.ops.dp_step``: one launch of each CUDA kernel for the whole
cohort. The recurrences are those of the reference (paper eqs. 21-28),
with ``a_t = <u_t, v_t>`` taken by conjugacy from the reduce pass, as the
kernel path of the reference does (``repro/kernels/ops.py:35``).
``online_dp_update`` and ``dp_delta`` take the step as ``step`` (default
``ops.dp_step``); an FSDP round passes the sharded step
(``ops.dp_step_sharded`` bound to its ranks, ``core/fsdp.py``), and the
vectors are then this rank's shard of every client's.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import tree_math as tm
from repro_torch.kernels import ops


def fedavg_delta(x0, x_final):
    """FedAvg's (biased) client delta: Delta = I (theta_0 - theta_K)."""
    return tm.tsub(x0, x_final)


class DPState(NamedTuple):
    """Any-time DP state of a cohort after ``t`` samples.

    ``xbar``, ``delta_tilde`` and ``x0`` are ``(C, d)`` fp32; ``v_hist`` is
    ``(C, ell_max-1, d)`` with v_2..v_t in rows 0..t-2 (zeros beyond);
    ``c_hist`` is ``(C, ell_max-1)``. ``t`` is a Python int.
    """

    t: int
    xbar: torch.Tensor
    delta_tilde: torch.Tensor
    v_hist: torch.Tensor
    c_hist: torch.Tensor
    x0: torch.Tensor


def online_dp_init(x0, ell_max: int) -> DPState:
    """Pre-sample state (t=0) for a ``(C, d)`` cohort ``x0``;
    ``ell_max`` sizes the history buffers."""
    x0 = x0.to(torch.float32)
    C, d = x0.shape
    lp = max(ell_max - 1, 1)
    zeros = torch.zeros(C, d, dtype=torch.float32, device=x0.device)
    return DPState(
        t=0, xbar=zeros, delta_tilde=zeros,
        v_hist=torch.zeros(C, lp, d, dtype=torch.float32, device=x0.device),
        c_hist=torch.zeros(C, lp, dtype=torch.float32, device=x0.device),
        x0=x0)


def online_dp_update(state: DPState, x_t, rho: float,
                     step=None) -> DPState:
    """Absorb one ``(C, d)`` posterior sample per client.

    The first sample only sets the mean; every later one is one ``step``
    (``ops.dp_step`` when None). The new ``v_t`` is written into
    ``state.v_hist`` in place (the buffer is the state's own, allocated by
    ``online_dp_init``).
    """
    x_t = x_t.to(torch.float32)
    t_new = state.t + 1
    if state.t == 0:
        return state._replace(t=t_new, xbar=x_t,
                              delta_tilde=state.x0 - x_t)
    u = x_t - state.xbar
    v, delta_tilde, _, c_new = (step or ops.dp_step)(
        u, state.delta_tilde, state.v_hist, state.c_hist, t_new, rho)
    state.v_hist[:, state.t - 1] = v
    state.c_hist[:, state.t - 1] = c_new
    return state._replace(t=t_new, xbar=state.xbar + (1.0 / t_new) * u,
                          delta_tilde=delta_tilde)


def online_dp_delta(state: DPState, rho: float):
    """Delta_hat_t = Delta~_t / rho_t — the any-time estimate (zeros at
    t=0; the FedAvg delta x0 - x1 at t=1)."""
    tf = max(state.t, 1)
    r = 1.0 / (1.0 + (tf - 1.0) * rho)
    return (1.0 / r) * state.delta_tilde


def dp_delta(x0, samples, rho: float, step=None):
    """Delta_hat_l from the cohort's stacked posterior samples.

    Args:
      x0: ``(C, d)`` (or ``(d,)``, broadcast over clients) flat server
        parameters.
      samples: ``(C, l, d)`` flat samples.
      rho: shrinkage parameter in (0, 1].
      step: the DP step (``ops.dp_step`` when None).

    Returns ``(C, d)`` fp32 Delta_hat_l.
    """
    C, ell, d = samples.shape
    state = online_dp_init(x0.to(torch.float32).expand(C, d), ell)
    for i in range(ell):
        state = online_dp_update(state, samples[:, i], rho, step)
    return online_dp_delta(state, rho)
