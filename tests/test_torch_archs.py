"""The eight architectures that bring MoE FFNs, RG-LRU, mLSTM/sLSTM mixers
and frontends, through the port's whole model against the JAX package's
on the same numpy weights (carried across with ``convert``) and inputs:
the forward's logits and MoE aux loss, prefill then decode steps, the
parameter counts of every full config, the stub frontend embeddings, and
the serving entry point on every smoke config.

Model checks run in fp32 (compute and caches). Tolerance 2e-3, that of
``tests/test_models_consistency.py`` for prefill + decode against the
forward; the aux loss 1e-5 relative.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.data import SyntheticLMData as JaxLMData
from repro.models import model as jax_model
from repro_torch import configs
from repro_torch.convert import lm_params_from_jax
from repro_torch.data.lm_synthetic import SyntheticLMData
from repro_torch.kernels import swa_decode
from repro_torch.launch import serve
from repro_torch.models import model

NEW_ARCHS = ["xlstm-125m", "minitron-4b", "musicgen-medium", "internvl2-26b",
             "recurrentgemma-9b", "qwen3-moe-30b-a3b", "granite-34b",
             "llama4-scout-17b-a16e"]
B, S_TEXT, STEPS = 2, 24, 3
TOL = dict(rtol=2e-3, atol=2e-3)
#: leaves that hold biases, norm scales or the Lambda ramp: the JAX init's
#: values plus noise (the rest: N(0, 1/fan_in) matrices)
VECTORS = ("norm", "scale", "lam", "b_a", "b_x", "b_gates", "'b'")


@pytest.fixture(scope="module", autouse=True)
def _x32():
    """Other test modules turn on jax x64 at import; compare in fp32."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """(JAX cfg, port cfg, numpy params in the JAX layout, port params,
    tokens (B, S_TEXT), frontend (B, F, d) or None) of ``arch``'s smoke
    config."""
    jcfg, tcfg = jax_configs.get_smoke(arch), configs.get_smoke(arch)
    ref = jax_model.init_params(jax.random.PRNGKey(0), jcfg)
    r = np.random.default_rng(0)

    def draw(path, leaf):
        key = jax.tree_util.keystr(path)
        leaf = np.asarray(leaf, np.float32)
        if any(v in key for v in VECTORS):
            return (leaf + 0.1 * r.normal(size=leaf.shape)).astype(np.float32)
        fan_in = leaf.shape[-1] if "embed" in key else leaf.shape[-2]
        return (r.normal(size=leaf.shape) / np.sqrt(fan_in)).astype(
            np.float32)

    params = jax.tree_util.tree_map_with_path(draw, ref)
    tokens = r.integers(0, tcfg.vocab_size, size=(B, S_TEXT)).astype(
        np.int32)
    frontend = serve.make_frontend(tcfg, B, seed=3)
    return (jcfg, tcfg, params, lm_params_from_jax(params, "cpu"), tokens,
            frontend)


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_forward_logits_and_aux_vs_jax(arch):
    jcfg, tcfg, params, tparams, tokens, frontend = _setup(arch)
    lj, aj = jax.jit(functools.partial(
        jax_model.forward, cfg=jcfg, compute_dtype=jnp.float32, q_chunk=16,
        remat="none"))(params, jnp.asarray(tokens), frontend=_j(frontend))
    lt, at = model.forward(tparams, _t(tokens), tcfg, frontend=_t(frontend),
                           compute_dtype=torch.float32, q_chunk=16,
                           remat="none")
    F = tcfg.frontend_tokens if tcfg.frontend else 0
    assert lt.shape == (B, F + S_TEXT, tcfg.padded_vocab)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    assert float(at) == pytest.approx(float(aj), rel=1e-5, abs=1e-7)
    assert (float(at) > 0) == tcfg.moe.enabled


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_then_decode_vs_jax(arch):
    """Prefill the prompt, then STEPS teacher-forced decode steps from the
    states; the port's state updated in place, JAX's returned."""
    jcfg, tcfg, params, tparams, tokens, frontend = _setup(arch)
    F = tcfg.frontend_tokens if tcfg.frontend else 0
    max_len = F + S_TEXT + STEPS
    f32 = dict(compute_dtype=jnp.float32, cache_dtype=jnp.float32)
    lj, sj = jax.jit(lambda p, t, f: jax_model.prefill(
        p, t, jcfg, max_len, frontend=f, q_chunk=16, **f32))(
            params, jnp.asarray(tokens), _j(frontend))
    lt, st = model.prefill(tparams, _t(tokens), tcfg, max_len,
                           frontend=_t(frontend), q_chunk=16,
                           compute_dtype=torch.float32,
                           cache_dtype=torch.float32)
    assert st.pos == F + S_TEXT
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    step = jax.jit(lambda p, t, s: jax_model.decode_step(
        p, t, s, jcfg, compute_dtype=jnp.float32))
    forced = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, size=(B, STEPS)).astype(np.int32)
    for i in range(STEPS):
        lj, sj = step(params, jnp.asarray(forced[:, i]), sj)
        lt, st = model.decode_step(tparams, _t(forced[:, i]), st, tcfg,
                                   compute_dtype=torch.float32,
                                   use_kernel=True)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)


def test_param_counts_match_jax():
    """``count_params`` and ``active_param_count`` of all 11 full configs
    equal the JAX package's (e.g. 30,220,957,696 and 9,423,937,536)."""
    assert configs.ALL_ARCHS == jax_configs.ALL_ARCHS
    for arch in configs.ALL_ARCHS:
        t, j = configs.get_config(arch), jax_configs.get_config(arch)
        assert (t.param_count(), t.active_param_count()) == \
            (j.param_count(), j.active_param_count()), arch
    assert configs.get_config("qwen3-moe-30b-a3b").param_count() == \
        30_220_957_696
    assert configs.get_config("recurrentgemma-9b").param_count() == \
        9_423_937_536


def test_frontend_embeddings_bit_for_bit():
    t = SyntheticLMData(vocab_size=512, num_clients=3, seed=4)
    j = JaxLMData(vocab_size=512, num_clients=3, seed=4)
    got = t.frontend_embeddings(2, 3, 8, 64, salt=1)
    want = j.frontend_embeddings(2, 3, 8, 64, salt=1, host=True)
    assert got.dtype == np.float32 and got.shape == (3, 8, 64)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_serve_main_every_arch_on_cpu(arch, capsys):
    """``launch.serve.main`` on the smoke config: frontend archs take 8
    stub embeddings and 32 text tokens; finite logits; the CPU never
    launches the kernel."""
    swa_decode.reset_launches()
    res = serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                      "--prompt-len", "40", "--gen", "4"])
    out = capsys.readouterr().out
    cfg = res["cfg"]
    assert cfg.name == arch + "-smoke" and out.rstrip().endswith("ok")
    assert "prefill 2x40" in out
    F = cfg.frontend_tokens if cfg.frontend else 0
    assert res["prompts"].shape == (2, 40 - F)
    assert (res["frontend"] is None) == (not cfg.frontend)
    assert res["decode"]["tokens"].shape == (2, 4)
    assert all(torch.isfinite(x).all() for x in res["decode"]["logits"])
    assert swa_decode.launches["swa_decode"] == 0


def test_serve_batched_example_on_cpu(capsys):
    """``repro_torch.examples.serve_batched`` (gemma3's smoke config, its
    ring caches) runs on the CPU, and its flags override the example's."""
    from repro_torch.examples import serve_batched

    res = serve_batched.main(["--device", "cpu", "--gen", "4",
                              "--prompt-len", "40"])
    assert res["cfg"].name == "gemma3-27b-smoke"
    assert res["decode"]["tokens"].shape == (4, 4)
    assert capsys.readouterr().out.rstrip().endswith("ok")
