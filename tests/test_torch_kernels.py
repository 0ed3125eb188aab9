"""The port's DP kernels (plain twins on the CPU) against the JAX package's
Pallas kernels (interpret mode) and ``kernels/ref.py``, on the same numpy
inputs (the CUDA kernels against their twins: ``test_torch_gpu.py``).

Tolerances are ``tests/test_kernels.py``'s: one step 1e-5, the full
Delta_hat 2e-4 (fp32, different summation orders). For one step the 1e-5
absolute part scales with the largest entry of the vector compared: sums
taken in another order differ by an ulp of their largest term, and an entry
that cancels to a small value keeps that error (t=5 below: 3e-5 on an
entry of 3.8 whose neighbours reach 324).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fedpa_dp as jax_fedpa_dp
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.kernels import fedpa_dp, ops, ref


@pytest.fixture(scope="module", autouse=True)
def _x32():
    """Other test modules turn on jax x64 at import; the references here
    are fp32 like the port."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _dp_inputs(d, ell, n_clients=3):
    r = np.random.default_rng(d * 31 + ell)
    x0 = r.normal(size=(n_clients, d)).astype(np.float32)
    xs = r.normal(size=(n_clients, ell, d)).astype(np.float32)
    return x0, xs


@functools.lru_cache(maxsize=None)
def _jax_dp_flat(d, ell, rho):
    """Per-client JAX Pallas flat DP for the three clients of
    ``_dp_inputs``; cached so the C=1 case reuses client 0."""
    x0, xs = _dp_inputs(d, ell)
    return np.stack([
        np.asarray(jax_ops.dp_delta_flat(jnp.asarray(a), jnp.asarray(b),
                                         rho=rho))
        for a, b in zip(x0, xs)])


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("ell", [2, 3, 6])
@pytest.mark.parametrize("d", [64, 500, 1000, 1300, 4096])
def test_dp_delta_flat_vs_jax(d, ell, C):
    rho = 0.4
    x0, xs = _dp_inputs(d, ell)
    got = ops.dp_delta_flat(torch.from_numpy(x0[:C]), torch.from_numpy(xs[:C]),
                            rho=rho).numpy()
    np.testing.assert_allclose(got, _jax_dp_flat(d, ell, rho)[:C],
                               rtol=2e-4, atol=2e-4)


def _step_inputs(t, C=3, d=700, lp=6):
    r = np.random.default_rng(t)
    u = r.normal(size=(C, d)).astype(np.float32)
    delta = r.normal(size=(C, d)).astype(np.float32)
    V = r.normal(size=(C, lp, d)).astype(np.float32)
    c_hist = np.abs(r.normal(size=(C, lp))).astype(np.float32)
    return u, delta, V, c_hist


@pytest.mark.parametrize("t", [2, 3, 5])
def test_dp_step_vs_jax(t):
    rho = 0.7
    u, delta, V, c_hist = _step_inputs(t)
    got = ops.dp_step(*map(torch.from_numpy, (u, delta, V, c_hist)), t, rho)
    twin = ref.dp_step_ref(*map(torch.from_numpy, (u, delta, V, c_hist)), t,
                           rho)
    for c in range(u.shape[0]):
        args = [jnp.asarray(x[c]) for x in (u, delta, V, c_hist)]
        for want in (jax_ops.dp_step(*args, t, rho=rho),
                     jax_ref.dp_step_ref(*args, t, rho)):
            for g, tw, w in zip(got, twin, want):
                w = np.asarray(w)
                np.testing.assert_allclose(
                    g[c].numpy(), w, rtol=1e-5,
                    atol=1e-5 * max(1.0, float(np.abs(w).max())))
                np.testing.assert_array_equal(g[c].numpy(), tw[c].numpy())


def test_dp_reduce_vs_jax():
    """d=1300 is not a multiple of the 512 TPU tile (the ragged tail)."""
    r = np.random.default_rng(0)
    C, d, lp = 3, 1300, 4
    u = r.normal(size=(C, d)).astype(np.float32)
    delta = r.normal(size=(C, d)).astype(np.float32)
    V = r.normal(size=(C, lp, d)).astype(np.float32)
    dots, uu, ud = fedpa_dp.dp_reduce(*map(torch.from_numpy, (u, delta, V)))
    assert dots.shape == (C, lp) and uu.shape == ud.shape == (C,)
    for c in range(C):
        args = [jnp.asarray(x[c]) for x in (u, delta, V)]
        for want in (jax_fedpa_dp.dp_reduce(*args),
                     jax_ref.dp_reduce_ref(*args)):
            for g, w in zip((dots, uu, ud), want):
                np.testing.assert_allclose(g[c].numpy(), np.asarray(w),
                                           rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dp_map_vs_jax(dtype):
    r = np.random.default_rng(1)
    C, d, lp = 2, 1300, 3
    w = r.normal(size=(C, lp)).astype(np.float32)
    s = r.normal(size=(C,)).astype(np.float32)
    u, delta = (r.normal(size=(C, d)).astype(np.float32) for _ in range(2))
    V = r.normal(size=(C, lp, d)).astype(np.float32)
    tdt = getattr(torch, dtype)
    got = fedpa_dp.dp_map(torch.from_numpy(w), torch.from_numpy(s),
                          *(torch.from_numpy(x).to(tdt) for x in (u, delta, V)))
    assert all(g.dtype == tdt for g in got)
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    for c in range(C):
        args = [jnp.asarray(x[c], dtype) for x in (u, delta, V)]
        want = jax_fedpa_dp.dp_map(jnp.asarray(w[c]), s[c], *args)
        for g, wv in zip(got, want):
            np.testing.assert_allclose(g[c].float().numpy(),
                                       np.asarray(wv, np.float32),
                                       rtol=tol, atol=tol)


def test_wrappers_refuse_mixed_devices():
    u = torch.zeros(1, 8)
    with pytest.raises(ValueError, match="one CUDA device or all on the CPU"):
        fedpa_dp.dp_reduce(u, u, torch.zeros(1, 1, 8, device="meta"))
