"""The port's least-squares machinery against the JAX package in float64:
``synthetic_lsq`` (the same numpy draws), ``shrinkage`` (the dense
oracle), ``posterior`` (exact Gaussian posteriors) and ``schedules``.

Tolerances: numpy draws equal; float64 linear algebra 1e-10 relative
(solves and matrix powers in another order); schedules 1e-6 relative (the
reference computes them in fp32).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import posterior as jax_post
from repro.core import shrinkage as jax_shr
from repro.optim import schedules as jax_sched
from repro_torch.core import posterior, shrinkage
from repro_torch.data import synthetic_lsq
from repro_torch.optim import schedules

# repro.data re-exports make_federated_lsq over the module's name
jax_lsq = importlib.import_module("repro.data.synthetic_lsq")

F64 = dict(rtol=1e-10, atol=1e-12)


@pytest.fixture(scope="module", autouse=True)
def _x64():
    """Compare in float64: turn jax x64 on for this module only."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prev)


def _close(a, b, **tol):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), **(tol or F64))


def test_make_regression_is_the_same_draw():
    shift = np.arange(5.0)
    for got, want in zip(
            synthetic_lsq.make_regression(40, 5, n_informative=3, seed=4,
                                          coef_shift=shift),
            jax_lsq.make_regression(40, 5, n_informative=3, seed=4,
                                    coef_shift=shift)):
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def lsq_pair():
    kw = dict(heterogeneity=20.0, seed=3)
    return (synthetic_lsq.make_federated_lsq(5, 30, 6, dtype=torch.float64,
                                             **kw),
            jax_lsq.make_federated_lsq(5, 30, 6, dtype=jnp.float64, **kw))


def test_federated_lsq_data_and_posteriors(lsq_pair):
    (clients, data), (j_clients, j_data) = lsq_pair
    for (X, y), (jX, jy) in zip(data, j_data):
        assert X.dtype == torch.float64
        np.testing.assert_array_equal(X.numpy(), np.asarray(jX))
        np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    for c, jc in zip(clients, j_clients):
        for a, b in zip(c, jc):
            _close(a, b)
    b = synthetic_lsq.lsq_batches(*data[1], 7, 4, seed=11)
    jb = jax_lsq.lsq_batches(*j_data[1], 7, 4, seed=11)
    for k in ("x", "y"):
        assert isinstance(b[k], np.ndarray) and b[k].shape[:2] == (4, 7)
        np.testing.assert_array_equal(b[k], np.asarray(jb[k]))


def test_quadratic_clients():
    got = synthetic_lsq.make_quadratic_clients(3, 4, cond=20.0, seed=2,
                                               dtype=torch.float64)
    want = jax_lsq.make_quadratic_clients(3, 4, cond=20.0, seed=2,
                                          dtype=jnp.float64)
    for c, jc in zip(got, want):
        for a, b in zip(c, jc):
            _close(a, b)


def test_posterior_oracles(lsq_pair):
    (clients, _), (j_clients, _) = lsq_pair
    theta = np.linspace(-3.0, 3.0, 6)
    t, jt = torch.from_numpy(theta), jnp.asarray(theta)
    _close(posterior.global_posterior_mode(clients),
           jax_post.global_posterior_mode(j_clients))
    Q, grad_Q = posterior.global_quadratic(clients)
    jQ, jgrad_Q = jax_post.global_quadratic(j_clients)
    _close(Q(t), jQ(jt))
    _close(grad_Q(t), jgrad_Q(jt))
    _close(posterior.global_objective(clients)(t),
           jax_post.global_objective(j_clients)(jt))
    _close(posterior.fedavg_fixed_point(clients, 7, 1e-3),
           jax_post.fedavg_fixed_point(j_clients, 7, 1e-3))
    c, jc = clients[2], j_clients[2]
    _close(c.loss(t), jc.loss(jt))
    _close(c.exact_delta(t), jc.exact_delta(jt))
    r = np.random.default_rng(0)
    X, y = r.normal(size=(12, 3)), r.normal(size=12)
    for a, b in zip(posterior.client_from_data(torch.from_numpy(X),
                                               torch.from_numpy(y), 0.25),
                    jax_post.client_from_data(jnp.asarray(X),
                                              jnp.asarray(y), 0.25)):
        _close(a, b)


@pytest.mark.parametrize("ell,d", [(1, 4), (2, 5), (6, 9)])
def test_shrinkage_oracles(ell, d):
    r = np.random.default_rng(ell * 10 + d)
    samples, x0 = r.normal(size=(ell, d)), r.normal(size=d)
    ts, js = torch.from_numpy(samples), jnp.asarray(samples)
    for rho in (0.05, 1.0):
        assert shrinkage.rho_l(ell, rho) == jax_shr.rho_l(ell, rho)
        assert shrinkage.gamma_t(ell, rho) == jax_shr.gamma_t(ell, rho)
        _close(shrinkage.shrinkage_cov(ts, rho), jax_shr.shrinkage_cov(js, rho))
        _close(shrinkage.shrinkage_cov_unnormalized(ts, rho),
               jax_shr.shrinkage_cov_unnormalized(js, rho))
        _close(shrinkage.dense_delta(torch.from_numpy(x0), ts, rho),
               jax_shr.dense_delta(jnp.asarray(x0), js, rho))
    for a, b in zip(shrinkage.sample_mean_cov(ts),
                    jax_shr.sample_mean_cov(js)):
        _close(a, b)
    _close(shrinkage.oas_rho(ts), jax_shr.oas_rho(js))


SCHEDULES = [
    ("constant", (0.3,)),
    ("inverse_time_decay", (0.5, 0.2)),
    ("exponential_decay", (0.5, 0.9, 3)),
    ("cosine_decay", (0.4, 10, 0.01)),
    ("warmup_cosine", (0.4, 3, 12, 0.02)),
]


@pytest.mark.parametrize("name,args", SCHEDULES, ids=[s[0] for s in SCHEDULES])
def test_schedules(name, args):
    fn, jfn = getattr(schedules, name)(*args), getattr(jax_sched, name)(*args)
    for step in range(0, 15):
        got = fn(step)
        assert got.dtype == torch.float32
        _close(got, jfn(jnp.asarray(step, jnp.int32)), rtol=1e-6)
        _close(fn(torch.tensor(step)), got, rtol=0)
