"""The port's recurrent mixers against the JAX package's on the same numpy
inputs and weights: the depthwise causal conv (full and streaming), the
per-head norm, RG-LRU (forward with its log-depth scan, decode), mLSTM
(chunkwise forward at chunk 8 and 64, decode) and sLSTM (forward and
decode, fp32 and bf16, its state rounded to bf16 every step).

Tolerances: the conv and the norm 1e-6 (the same fp32 ops); RG-LRU and
mLSTM 1e-4 (the reference's tolerance for the mLSTM chunk invariance; the
scans sum in another order); sLSTM fp32 1e-5; bf16 runs 2e-2 (a few bf16
roundings, 2^-8 each, that may fall the other way in either package).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import layers as jax_layers
from repro.models import rglru as jax_rglru
from repro.models import xlstm as jax_xlstm
from repro_torch import configs
from repro_torch.convert import params_from_jax
from repro_torch.models import layers, rglru, xlstm

F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture(scope="module", autouse=True)
def _x32():
    """Other test modules turn on jax x64 at import; compare in fp32."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _params(init, cfg, seed=0):
    """Numpy weights in the JAX layout: matrices N(0, 1/fan_in), vectors
    the JAX init's values (biases, Lambda ramp) plus N(0, 0.1^2) noise."""
    ref = init(jax.random.PRNGKey(0), cfg)
    r = np.random.default_rng(seed)
    out = {}
    for k, v in ref.items():
        v = np.asarray(v, np.float32)
        if v.ndim >= 2:
            out[k] = (r.normal(size=v.shape) / np.sqrt(v.shape[-2])).astype(
                np.float32)
        else:
            out[k] = (v + 0.1 * r.normal(size=v.shape)).astype(np.float32)
    return out


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _jax(tree, dtype=jnp.float32):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree)


def _torch(tree, dtype=torch.float32):
    return {k: v.to(dtype) for k, v in params_from_jax(tree, "cpu").items()}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    """Every field of two states / outputs, as fp32 numpy."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **tol)


# --- layers --------------------------------------------------------------

@pytest.mark.parametrize("width", [1, 4])
def test_causal_conv1d_full_matches_jax(width):
    x, kern = _x((2, 13, 24)), _x((width, 24), seed=2)
    yj, sj = jax_layers.causal_conv1d(jnp.asarray(x), jnp.asarray(kern))
    yt, st = layers.causal_conv1d(torch.from_numpy(x), torch.from_numpy(kern))
    _close((yt, st), (yj, sj), dict(rtol=1e-6, atol=1e-6))


def test_causal_conv1d_streaming_matches_jax():
    """One token from a state: equals JAX's, and the streaming chain over a
    sequence equals the full conv."""
    x, kern = _x((2, 9, 24)), _x((4, 24), seed=2)
    state = _x((2, 3, 24), seed=3)
    yj, sj = jax_layers.causal_conv1d(jnp.asarray(x[:, :1]),
                                      jnp.asarray(kern), jnp.asarray(state))
    yt, st = layers.causal_conv1d(torch.from_numpy(x[:, :1]),
                                  torch.from_numpy(kern),
                                  torch.from_numpy(state))
    _close((yt, st), (yj, sj), dict(rtol=1e-6, atol=1e-6))
    full, _ = layers.causal_conv1d(torch.from_numpy(x),
                                   torch.from_numpy(kern))
    st = torch.zeros(2, 3, 24)
    for t in range(x.shape[1]):
        y, st = layers.causal_conv1d(torch.from_numpy(x[:, t:t + 1]),
                                     torch.from_numpy(kern), st)
        torch.testing.assert_close(y, full[:, t:t + 1], rtol=1e-6, atol=1e-6)


def test_group_norm_heads_matches_jax():
    x, scale = _x((2, 5, 4, 32)), 0.1 * _x((4, 32), seed=2)
    _close(layers.group_norm_heads(torch.from_numpy(x),
                                   torch.from_numpy(scale)),
           jax_layers.group_norm_heads(jnp.asarray(x), jnp.asarray(scale)),
           dict(rtol=1e-6, atol=1e-6))


# --- RG-LRU --------------------------------------------------------------

def _rg():
    return jax_configs.get_smoke("recurrentgemma-9b"), \
        configs.get_smoke("recurrentgemma-9b")


@pytest.mark.parametrize("S", [1, 37])
def test_linear_scan_equals_the_recurrence(S):
    a = torch.rand(2, S, 8, dtype=torch.float64)
    b = torch.randn(2, S, 8, dtype=torch.float64)
    h, want = torch.zeros(2, 8, dtype=torch.float64), []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    torch.testing.assert_close(rglru._linear_scan(a, b),
                               torch.stack(want, dim=1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_forward_matches_jax(dtype):
    jcfg, tcfg = _rg()
    p = _params(jax_rglru.init_rglru_params, jcfg)
    x = _x((2, 37, tcfg.d_model))
    yj, sj = jax_rglru.rglru_forward(_jax(p, dtype), jnp.asarray(x, dtype),
                                     jcfg, return_cache=True)
    yt, st = rglru.rglru_forward(_torch(p, getattr(torch, dtype)),
                                 torch.from_numpy(x).to(getattr(torch,
                                                                dtype)),
                                 tcfg, return_cache=True)
    assert st.h.dtype == torch.float32
    _close((yt, *st), (yj, *sj), F32 if dtype == "float32" else BF16)


def test_rglru_decode_matches_jax_and_the_forward():
    """Three decode steps from the forward's state equal JAX's steps and
    the forward over the longer sequence."""
    jcfg, tcfg = _rg()
    p = _params(jax_rglru.init_rglru_params, jcfg)
    x = _x((2, 20, tcfg.d_model))
    pj, pt = _jax(p), _torch(p)
    _, sj = jax_rglru.rglru_forward(pj, jnp.asarray(x[:, :17]), jcfg,
                                    return_cache=True)
    _, st = rglru.rglru_forward(pt, torch.from_numpy(x[:, :17]), tcfg,
                                return_cache=True)
    full, _ = rglru.rglru_forward(pt, torch.from_numpy(x), tcfg)
    for t in range(17, 20):
        yj, sj = jax_rglru.rglru_decode(pj, jnp.asarray(x[:, t:t + 1]), sj,
                                        jcfg)
        yt, st = rglru.rglru_decode(pt, torch.from_numpy(x[:, t:t + 1]), st,
                                    tcfg)
        _close((yt, *st), (yj, *sj), F32)
        _close(yt, full[:, t:t + 1], F32)


# --- mLSTM ---------------------------------------------------------------

def _xl():
    return jax_configs.get_smoke("xlstm-125m"), configs.get_smoke("xlstm-125m")


@pytest.mark.parametrize("chunk", [8, 64])
def test_mlstm_forward_matches_jax(chunk):
    jcfg, tcfg = _xl()
    p = _params(jax_xlstm.init_mlstm_params, jcfg)
    x = _x((2, 64, tcfg.d_model))
    yj, sj = jax_xlstm.mlstm_forward(_jax(p), jnp.asarray(x), jcfg,
                                     chunk=chunk, return_cache=True)
    yt, st = xlstm.mlstm_forward(_torch(p), torch.from_numpy(x), tcfg,
                                 chunk=chunk, return_cache=True)
    _close((yt, *st), (yj, *sj), F32)


def test_mlstm_chunk_size_invariance():
    """tests/test_models_consistency.py's check on the port: chunk 8 and 64
    within 1e-4."""
    _, tcfg = _xl()
    p = _torch(_params(jax_xlstm.init_mlstm_params, _xl()[0]))
    x = torch.from_numpy(_x((2, 64, tcfg.d_model), seed=4))
    y8, _ = xlstm.mlstm_forward(p, x, tcfg, chunk=8)
    y64, _ = xlstm.mlstm_forward(p, x, tcfg, chunk=64)
    torch.testing.assert_close(y8, y64, rtol=1e-4, atol=1e-4)


def test_mlstm_rejects_a_ragged_sequence():
    _, tcfg = _xl()
    p = _torch(_params(jax_xlstm.init_mlstm_params, _xl()[0]))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        xlstm.mlstm_forward(p, torch.zeros(1, 20, tcfg.d_model), tcfg,
                            chunk=8)


@pytest.mark.parametrize("start", ["prefill", "empty"])
def test_mlstm_decode_matches_jax(start):
    """Three steps from the forward's state (or from the empty state, whose
    stabilizer is -1e30) equal JAX's."""
    jcfg, tcfg = _xl()
    p = _params(jax_xlstm.init_mlstm_params, jcfg)
    x = _x((2, 19, tcfg.d_model), seed=5)
    pj, pt = _jax(p), _torch(p)
    if start == "prefill":
        _, sj = jax_xlstm.mlstm_forward(pj, jnp.asarray(x[:, :16]), jcfg,
                                        chunk=8, return_cache=True)
        _, st = xlstm.mlstm_forward(pt, torch.from_numpy(x[:, :16]), tcfg,
                                    chunk=8, return_cache=True)
    else:
        sj = jax_xlstm.init_mlstm_state(jcfg, 2)
        st = xlstm.init_mlstm_state(tcfg, 2)
    for t in range(16, 19):
        yj, sj = jax_xlstm.mlstm_decode(pj, jnp.asarray(x[:, t:t + 1]), sj,
                                        jcfg)
        yt, st = xlstm.mlstm_decode(pt, torch.from_numpy(x[:, t:t + 1]), st,
                                    tcfg)
        _close((yt, *st), (yj, *sj), F32)


# --- sLSTM ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_forward_matches_jax(dtype):
    jcfg, tcfg = _xl()
    p = _params(jax_xlstm.init_slstm_params, jcfg)
    x = _x((2, 24, tcfg.d_model), seed=6)
    yj, sj = jax_xlstm.slstm_forward(_jax(p, dtype), jnp.asarray(x, dtype),
                                     jcfg, return_cache=True)
    yt, st = xlstm.slstm_forward(_torch(p, getattr(torch, dtype)),
                                 torch.from_numpy(x).to(getattr(torch,
                                                                dtype)),
                                 tcfg, return_cache=True)
    assert st.h.dtype == getattr(torch, dtype)
    _close((yt, *st), (yj, *sj),
           dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else BF16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_decode_matches_jax(dtype):
    jcfg, tcfg = _xl()
    p = _params(jax_xlstm.init_slstm_params, jcfg)
    x = _x((2, 12, tcfg.d_model), seed=7)
    tdt = getattr(torch, dtype)
    pj, pt = _jax(p, dtype), _torch(p, tdt)
    _, sj = jax_xlstm.slstm_forward(pj, jnp.asarray(x[:, :9], dtype), jcfg,
                                    return_cache=True)
    _, st = xlstm.slstm_forward(pt, torch.from_numpy(x[:, :9]).to(tdt), tcfg,
                                return_cache=True)
    for t in range(9, 12):
        yj, sj = jax_xlstm.slstm_decode(pj, jnp.asarray(x[:, t:t + 1], dtype),
                                        sj, jcfg)
        yt, st = xlstm.slstm_decode(pt, torch.from_numpy(x[:, t:t + 1]).to(
            tdt), st, tcfg)
        _close((yt, *st), (yj, *sj),
               dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else BF16)
