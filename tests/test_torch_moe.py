"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX package's
on the same numpy inputs and weights, in fp32: both routings (GShard
one-hot, sort-based), top-k 1 and 2, the shared expert, the padding path
(T not a multiple of the chunk), capacity overflow, and router logits
with exact ties (the lower expert index wins, as ``jax.lax.top_k`` does).
Tolerance 2e-4, that of ``tests/test_moe_routing.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import moe as jax_moe
from repro_torch import configs
from repro_torch.convert import params_from_jax
from repro_torch.models import moe

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module", autouse=True)
def _x32():
    """Other test modules turn on jax x64 at import; compare in fp32."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _cfgs(routing="onehot", cf=8.0, k=2, shared=0, experts=4):
    """The qwen3-moe smoke config with these MoE knobs, in each package."""
    def make(pkg):
        cfg = pkg.get_smoke("qwen3-moe-30b-a3b")
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, routing=routing, capacity_factor=cf, num_experts=experts,
            top_k=k, shared_expert_d_ff=shared))
    return make(jax_configs), make(configs)


def _params(jcfg, seed=0):
    """Numpy MoE weights in the JAX layout, N(0, 1/fan_in)."""
    shapes = jax.eval_shape(lambda: jax_moe.init_moe_params(
        jax.random.PRNGKey(0), jcfg))
    r = np.random.default_rng(seed)
    return {k: (r.normal(size=s.shape) / np.sqrt(s.shape[-2])).astype(
        np.float32) for k, s in shapes.items()}


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _both(fn_jax, fn_torch, p, x, jcfg, tcfg):
    """(JAX (y, aux), port (y, aux)) as numpy."""
    yj, aj = fn_jax({k: jnp.asarray(v) for k, v in p.items()},
                    jnp.asarray(x), jcfg)
    yt, at = fn_torch(params_from_jax(p, "cpu"), torch.from_numpy(x), tcfg)
    return (np.asarray(yj), float(aj)), (yt.numpy(), float(at))


@pytest.mark.parametrize("routing", ["onehot", "sort"])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("shared", [0, 128])
def test_moe_ffn_matches_jax(routing, k, shared):
    """moe_ffn on (3, 33, d): 99 tokens in chunks of 64, so the last chunk
    is padded; ample capacity."""
    jcfg, tcfg = _cfgs(routing, k=k, shared=shared)
    p = _params(jcfg)
    x = _x((3, 33, tcfg.d_model))
    (yj, aj), (yt, at) = _both(jax_moe.moe_ffn, moe.moe_ffn, p, x, jcfg, tcfg)
    np.testing.assert_allclose(yt, yj, **TOL)
    assert at == pytest.approx(aj, rel=1e-5)


@pytest.mark.parametrize("routing", ["onehot", "sort"])
@pytest.mark.parametrize("k", [1, 2])
def test_capacity_overflow_matches_jax(routing, k):
    """Capacity factor 0.25: tokens are dropped, the same ones in both
    packages (rows of zeros where every slot of a token was dropped)."""
    jcfg, tcfg = _cfgs(routing, cf=0.25, k=k)
    p = _params(jcfg, seed=3)
    x = _x((64, tcfg.d_model), seed=2)
    route_j = jax_moe._route_chunk_sort if routing == "sort" \
        else jax_moe._route_chunk
    route_t = moe._route_chunk_sort if routing == "sort" \
        else moe._route_chunk
    (yj, aj), (yt, at) = _both(lambda p, x, c: route_j(x, p, c.moe),
                               lambda p, x, c: route_t(x, p, c.moe),
                               p, x, jcfg, tcfg)
    np.testing.assert_allclose(yt, yj, **TOL)
    assert at == pytest.approx(aj, rel=1e-5)
    dropped_j = np.linalg.norm(yj, axis=-1) == 0.0
    dropped_t = np.linalg.norm(yt, axis=-1) == 0.0
    assert dropped_j.sum() > 0
    np.testing.assert_array_equal(dropped_t, dropped_j)


def _tied_inputs(tcfg):
    """Tokens and a router whose logits are exact (small integers times
    0.5) and tie: expert 1's column equals expert 0's, 3's equals 2's."""
    r = np.random.default_rng(5)
    x = r.integers(-2, 3, size=(64, tcfg.d_model)).astype(np.float32)
    router = 0.5 * r.integers(-1, 2, size=(tcfg.d_model, 4)).astype(
        np.float32)
    router[:, 1] = router[:, 0]
    router[:, 3] = router[:, 2]
    return x, router


@pytest.mark.parametrize("routing", ["onehot", "sort"])
def test_router_ties_pick_the_lower_expert_like_jax(routing):
    jcfg, tcfg = _cfgs(routing, k=1)
    p = _params(jcfg, seed=4)
    x, p["router"] = _tied_inputs(tcfg)
    route_j = jax_moe._route_chunk_sort if routing == "sort" \
        else jax_moe._route_chunk
    route_t = moe._route_chunk_sort if routing == "sort" \
        else moe._route_chunk
    (yj, aj), (yt, at) = _both(lambda p, x, c: route_j(x, p, c.moe),
                               lambda p, x, c: route_t(x, p, c.moe),
                               p, x, jcfg, tcfg)
    np.testing.assert_allclose(yt, yj, **TOL)
    assert at == pytest.approx(aj, rel=1e-5)


def test_top_k_order_of_ties_matches_lax_top_k():
    """Values with ties in every row: the same values and indices as
    ``jax.lax.top_k`` (lower index first among equals)."""
    r = np.random.default_rng(6)
    probs = r.integers(0, 4, size=(50, 16)).astype(np.float32)
    for k in (1, 2, 5, 16):
        vj, ij = jax.lax.top_k(jnp.asarray(probs), k)
        vt, it = moe._top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))


@pytest.mark.parametrize("k", [1, 2])
def test_sort_equals_onehot_with_ample_capacity(k):
    """The port's two routes agree when nothing is dropped."""
    _, cfg1 = _cfgs("onehot", cf=8.0, k=k)
    p = params_from_jax(_params(_cfgs(k=k)[0]), "cpu")
    x = torch.from_numpy(_x((64, cfg1.d_model), seed=7))
    y1, a1 = moe._route_chunk(x, p, cfg1.moe)
    y2, a2 = moe._route_chunk_sort(x, p, cfg1.moe)
    torch.testing.assert_close(y1, y2, **TOL)
    assert float(a1) == pytest.approx(float(a2), rel=1e-5)


def test_one_hot_out_of_range_is_a_zero_row():
    """``jax.nn.one_hot``'s rule: -1 and n give zero rows, not a slot."""
    idx = np.array([-1, 0, 3, 4, 7], np.int32)
    np.testing.assert_array_equal(
        moe._one_hot(torch.from_numpy(idx), 4).numpy(),
        np.asarray(jax.nn.one_hot(jnp.asarray(idx), 4)))


def test_capacity_matches_jax():
    for arch in ("qwen3-moe-30b-a3b", "llama4-scout-17b-a16e"):
        for get in ("get_config", "get_smoke"):
            m_t = getattr(configs, get)(arch).moe
            m_j = getattr(jax_configs, get)(arch).moe
            for T in (1, 4, 64, 99, 4096, 8192):
                assert moe.capacity(m_t, T) == jax_moe.capacity(m_j, T)


@pytest.mark.parametrize("shared", [0, 128])
def test_init_shapes_match_jax(shared):
    """The port's init makes the JAX package's leaves, shape for shape."""
    jcfg, tcfg = _cfgs(shared=shared)
    want = {k: v.shape for k, v in _params(jcfg).items()}
    from repro_torch.models.model import _initializers
    got = moe.init_moe_params(_initializers(None, torch.float32, "meta"),
                              tcfg)
    assert {k: tuple(v.shape) for k, v in got.items()} == want


@pytest.mark.parametrize("routing", ["onehot", "sort"])
def test_kept_assignments(routing):
    """With ample capacity each token reaches its top-k experts (JAX's
    ``lax.top_k`` of the router's softmax); under overflow each expert
    takes at most C tokens, and the tokens that reach none are the zero
    rows of JAX's output."""
    for cf in (8.0, 0.25):
        jcfg, tcfg = _cfgs(routing, cf=cf, k=2)
        p = _params(jcfg, seed=3)
        x = _x((64, tcfg.d_model), seed=2)
        mask = moe.kept_assignments(torch.from_numpy(x),
                                    params_from_jax(p, "cpu"), tcfg.moe)
        if cf > 1:
            probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(p["router"]))
            _, idx = jax.lax.top_k(probs, 2)
            want = np.asarray(jax.nn.one_hot(idx, 4).sum(1)) > 0
            np.testing.assert_array_equal(mask.numpy(), want)
        else:
            assert (mask.sum(0) <= moe.capacity(tcfg.moe, 64)).all()
            route = jax_moe._route_chunk_sort if routing == "sort" \
                else jax_moe._route_chunk
            y, _ = route(jnp.asarray(x), {k: jnp.asarray(v)
                                          for k, v in p.items()}, jcfg.moe)
            np.testing.assert_array_equal(
                ~mask.any(1).numpy(), np.linalg.norm(np.asarray(y), axis=-1)
                == 0.0)
