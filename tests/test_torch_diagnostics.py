"""The port's ``core/diagnostics.py`` and ``data/dirichlet.py`` against the
JAX package's on the same numpy inputs.

Tolerances (fp32): the ESS, autocorrelation, bias and covariance norms to
1e-5 relative (reductions in another order); the Dirichlet problem's
draws are numpy in both packages and must be equal, not close.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import diagnostics as jax_diag
from repro.data import dirichlet as jax_dirichlet
from repro_torch.core import diagnostics
from repro_torch.data import dirichlet


@pytest.fixture(scope="module", autouse=True)
def _x32():
    """Other test modules turn on jax x64 at import; compare in fp32."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(
        np.float32)


def _both(fn_name, *arrays, **kw):
    got = getattr(diagnostics, fn_name)(*map(torch.from_numpy, arrays), **kw)
    want = getattr(jax_diag, fn_name)(*map(jnp.asarray, arrays), **kw)
    return got, want


@pytest.mark.parametrize("n,scale", [(1, 1.0), (8, 1.0), (64, 30.0),
                                     (200, 300.0)])
def test_ess_vs_jax(n, scale):
    """Scales up to 300 exercise the logsumexp stabilization."""
    x = _rand((n,), n, scale)
    for fn in ("effective_sample_size", "ess_from_losses"):
        got, want = _both(fn, x)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    assert 1.0 - 1e-5 <= float(got) <= n + 1e-3


@pytest.mark.parametrize("lag", [1, 2, 5])
@pytest.mark.parametrize("l,d", [(8, 3), (32, 100)])
def test_sample_autocorr_vs_jax(l, d, lag):
    walk = np.cumsum(_rand((l, d), l * d + lag), axis=0).astype(np.float32)
    got, want = _both("sample_autocorr", walk, lag=lag)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("trials,d", [(1, 4), (10, 7), (50, 40)])
def test_bias_variance_vs_jax(trials, d):
    est = _rand((trials, d), trials + d)
    exact = _rand((d,), d)
    got, want = _both("bias_variance", est, exact)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("seed,alpha", [(0, 0.1), (3, 1.0)])
def test_dirichlet_classification_equals_jax(seed, alpha):
    kw = dict(n_per_client=20, alpha=alpha, n_test=50, seed=seed)
    got = dirichlet.make_dirichlet_classification(5, 4, 6, **kw)
    want = jax_dirichlet.make_dirichlet_classification(5, 4, 6, **kw)
    assert (got.num_classes, got.d) == (want.num_classes, want.d)
    for a, b in zip(got.client_x + got.client_y,
                    want.client_x + want.client_y):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    np.testing.assert_array_equal(got.weights, want.weights)
    np.testing.assert_array_equal(got.test_x.numpy(), np.asarray(want.test_x))
    np.testing.assert_array_equal(got.test_y.numpy(), np.asarray(want.test_y))
    b = dirichlet.classification_batches(got.client_x[1], got.client_y[1],
                                         4, 3, seed=seed)
    jb = jax_dirichlet.classification_batches(want.client_x[1],
                                              want.client_y[1], 4, 3,
                                              seed=seed)
    for k in ("x", "y"):
        assert isinstance(b[k], np.ndarray) and b[k].shape[:2] == (3, 4)
        np.testing.assert_array_equal(b[k], np.asarray(jb[k]))
