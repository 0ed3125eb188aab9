"""The port's LM serving stack against the JAX package on the same inputs:
layers, attention prefill and caches, decode steps through both attention
routes, prefill + greedy serving end to end, configs, the synthetic data,
the bf16 parameter conversion and the serving entry point.

JAX parameters are made once per config and converted (``convert``), so
both packages run the same weights. The model checks run in fp32 (compute
and cache). Tolerances: layers 1e-6 (the same fp32 ops); attention 1e-5
(sums of up to S terms in another order); logits 2e-3, the tolerance of
``tests/test_pallas_serving.py`` for the two decode routes.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro import configs as jax_configs
from repro.data import SyntheticLMData as JaxLMData
from repro.models import attention as jax_attn
from repro.models import layers as jax_layers
from repro.models import model as jax_model
from repro.models import steps as jax_steps
from repro_torch import configs
from repro_torch.convert import lm_params_from_jax, params_from_jax
from repro_torch.data.lm_synthetic import SyntheticLMData
from repro_torch.kernels import swa_decode
from repro_torch.launch import serve
from repro_torch.models import attention, layers, model, steps

F32 = torch.float32
PROMPT, GEN, MAX_LEN = 40, 6, 48


@pytest.fixture(scope="module", autouse=True)
def _x32():
    """Other test modules turn on jax x64 at import; compare in fp32."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _small(pkg):
    """d_model 256, 4 heads / 2 KV, head_dim 64, (swa 32, attn) x 2 + (swa,),
    vocab 512, built with each package's ``replace``."""
    swa = pkg.LayerSpec(mixer="swa", ffn="dense", window=32)
    return pkg.replace(
        pkg.get_config("gemma3-27b"), name="small", d_model=256, num_heads=4,
        num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512,
        pattern=(swa, pkg.LayerSpec(mixer="attn", ffn="dense")), repeats=2,
        tail=(swa,))


@functools.lru_cache(maxsize=None)
def _jax_params():
    """Numpy params in the small config's JAX layout (shapes from
    ``jax.eval_shape`` of its init): N(0, 1/fan_in) weights and nonzero
    norm scales, so the (1 + scale) weighting is exercised too."""
    shapes = jax.eval_shape(lambda: jax_model.init_params(
        jax.random.PRNGKey(0), _small(jax_configs)))
    r = np.random.default_rng(0)

    def draw(path, leaf):
        if "norm" in jax.tree_util.keystr(path) or "scale" in \
                jax.tree_util.keystr(path):
            return (0.1 * r.normal(size=leaf.shape)).astype(np.float32)
        fan_in = leaf.shape[-2] if "embed" not in jax.tree_util.keystr(path) \
            else leaf.shape[-1]
        return (r.normal(size=leaf.shape) / np.sqrt(fan_in)).astype(
            np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _np(x):
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# conversion
# ---------------------------------------------------------------------------

def test_bf16_tree_converts_bit_exactly():
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), _jax_params())
    params = lm_params_from_jax(tree, "cpu")
    got = jax.tree_util.tree_leaves(tree)
    for t, x in zip(jax.tree_util.tree_leaves(
            params, is_leaf=lambda n: isinstance(n, torch.Tensor)), got):
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == x.shape
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      x.view(np.int16))
    as_f32 = lm_params_from_jax(tree, "cpu", dtype=F32)
    np.testing.assert_array_equal(as_f32["embed"].numpy(),
                                  tree["embed"].astype(np.float32))


def test_lm_conversion_needs_an_lm_tree():
    with pytest.raises(KeyError, match="final_norm"):
        lm_params_from_jax({"embed": np.zeros((2, 2), np.float32),
                            "pattern": {}}, "cpu")


# ---------------------------------------------------------------------------
# layers and attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["rms_norm", "rope", "swiglu"])
def test_layer_vs_jax(name):
    r = np.random.default_rng(0)
    x = r.normal(size=(2, 9, 4, 64)).astype(np.float32)
    if name == "rms_norm":
        scale = r.normal(size=(64,)).astype(np.float32)
        args = (x, scale)
    elif name == "rope":
        args = (x, np.arange(3, 12, dtype=np.int32), 1e6)
    else:
        w = [r.normal(size=s).astype(np.float32) / 8
             for s in ((64, 96), (64, 96), (96, 64))]
        args = (x, *w)
    want = getattr(jax_layers, name)(
        *(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args))
    got = getattr(layers, name)(
        *(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
          for a in args))
    _close(got, want, 1e-6)


@pytest.mark.parametrize("layer", [0, 1], ids=["swa", "attn"])
def test_attn_forward_and_cache_vs_jax(layer):
    """A 40-token prompt past the 32-slot window, in q chunks of 16 (the
    last one ragged); the ring cache wraps."""
    jcfg, tcfg = _small(jax_configs), _small(configs)
    p = jax.tree_util.tree_map(lambda a: a[0],
                               _jax_params()["pattern"][f"pos_{layer}"])
    x = np.random.default_rng(1).normal(size=(2, PROMPT, 256)).astype(
        np.float32)
    fwd = jax.jit(functools.partial(
        jax_attn.attn_forward, cfg=jcfg, spec=jcfg.pattern[layer], q_chunk=16,
        return_cache=True))
    jy, jkv = fwd(jax.tree_util.tree_map(jnp.asarray, p["mixer"]),
                  jnp.asarray(x))
    ty, tkv = attention.attn_forward(
        params_from_jax(p["mixer"], "cpu"), torch.from_numpy(x), tcfg,
        tcfg.pattern[layer], q_chunk=16, return_cache=True)
    _close(ty, jy, 1e-5)
    jc = jax_attn.cache_from_prefill(jcfg, jcfg.pattern[layer], jkv, MAX_LEN,
                                     jnp.float32)
    tc = attention.cache_from_prefill(tcfg, tcfg.pattern[layer], tkv,
                                      MAX_LEN, F32)
    assert tc.k.shape[1] == (32 if layer == 0 else MAX_LEN)
    np.testing.assert_array_equal(tc.slot_pos.numpy(), np.asarray(jc.slot_pos))
    _close(tc.k, jc.k, 1e-5)
    _close(tc.v, jc.v, 1e-5)


# ---------------------------------------------------------------------------
# decode and serving
# ---------------------------------------------------------------------------

def _tokens(n, seed=1):
    return np.random.default_rng(seed).integers(0, 512, (2, n)).astype(
        np.int32)


@functools.lru_cache(maxsize=None)
def _jax_decode_logits(use_pallas):
    cfg = _small(jax_configs)
    step = jax.jit(functools.partial(jax_model.decode_step, cfg=cfg,
                                     compute_dtype=jnp.float32,
                                     use_pallas=use_pallas))
    params = jax.tree_util.tree_map(jnp.asarray, _jax_params())
    state = jax_model.init_decode_state(cfg, 2, MAX_LEN,
                                        cache_dtype=jnp.float32)
    out = []
    for tok in _tokens(GEN).T:
        logits, state = step(params, jnp.asarray(tok), state)
        out.append(np.asarray(logits))
    return out


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_decode_step_vs_jax(use_kernel, use_pallas):
    cfg = _small(configs)
    params = lm_params_from_jax(_jax_params(), "cpu")
    state = model.init_decode_state(cfg, 2, MAX_LEN, F32, device="cpu")
    for tok, want in zip(_tokens(GEN).T, _jax_decode_logits(use_pallas)):
        logits, state = model.decode_step(params, torch.from_numpy(tok), state,
                                          cfg, compute_dtype=F32,
                                          use_kernel=use_kernel)
        _close(logits, want, 2e-3)
    assert state.pos == GEN


@functools.lru_cache(maxsize=None)
def _jax_serve():
    """Prefill of the 40-token prompts, then greedy serve steps."""
    cfg = _small(jax_configs)
    params = jax.tree_util.tree_map(jnp.asarray, _jax_params())
    prompts = jnp.asarray(serve.make_prompts(_small(configs), 2, PROMPT, 0))
    pf = jax.jit(functools.partial(jax_model.prefill, cfg=cfg,
                                   max_len=MAX_LEN, compute_dtype=jnp.float32,
                                   q_chunk=16, cache_dtype=jnp.float32))
    logits, state = pf(params, prompts)
    out = [np.asarray(logits)]
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    toks = [np.asarray(tok)]
    step = jax.jit(functools.partial(jax_steps.serve_step, cfg=cfg,
                                     compute_dtype=jnp.float32,
                                     use_pallas=True))
    for _ in range(GEN - 1):
        tok, logits, state = step(params, tok, state)
        out.append(np.asarray(logits))
        toks.append(np.asarray(tok))
    return out, np.stack(toks, axis=1)


def test_prefill_and_serve_vs_jax():
    cfg = _small(configs)
    params = lm_params_from_jax(_jax_params(), "cpu")
    prompts = torch.from_numpy(serve.make_prompts(cfg, 2, PROMPT, 0))
    jlogits, jtoks = _jax_serve()
    logits, state = steps.prefill_step(params, prompts, cfg, MAX_LEN,
                                       compute_dtype=F32, q_chunk=16,
                                       cache_dtype=F32)
    _close(logits, jlogits[0], 2e-3)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    toks = [tok]
    for want in jlogits[1:]:
        tok, logits, state = steps.serve_step(params, tok, state, cfg,
                                              compute_dtype=F32,
                                              use_kernel=True)
        _close(logits, want, 2e-3)
        toks.append(tok)
    np.testing.assert_array_equal(torch.stack(toks, 1).numpy(), jtoks)
    assert state.pos == PROMPT + GEN - 1


def test_sampled_serve_step_skips_padded_vocab():
    cfg = configs.replace(_small(configs), vocab_size=500)   # padded to 512
    params = model.init_params(torch.Generator().manual_seed(0), cfg,
                               device="cpu")
    state = model.init_decode_state(cfg, 2, MAX_LEN, F32, device="cpu")
    gen = torch.Generator().manual_seed(1)
    tok = torch.zeros(2, dtype=torch.int32)
    for _ in range(3):
        tok, logits, state = steps.serve_step(
            params, tok, state, cfg, compute_dtype=F32, sample=True,
            generator=gen, temperature=100.0)
        assert tok.dtype == torch.int32 and (tok < 500).all()
        assert (logits[:, 500:] == -1e30).all()


# ---------------------------------------------------------------------------
# configs and data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gemma3-27b", "qwen3-32b"])
def test_configs_match_jax(arch):
    """Full and smoke configs field by field; parameter counts of the smoke
    config against the JAX package's, of the full one against its shapes
    written out (gemma3-27b: 27,008,335,616)."""
    for get in ("get_config", "get_smoke"):
        t, j = getattr(configs, get)(arch), getattr(jax_configs, get)(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.num_layers, t.padded_vocab, t.q_dim, t.kv_dim) == \
            (j.num_layers, j.padded_vocab, j.q_dim, j.kv_dim)
    assert configs.get_smoke(arch).param_count() == \
        jax_configs.get_smoke(arch).param_count()
    c = configs.get_config(arch)
    d, qd, kvd = c.d_model, c.q_dim, c.kv_dim
    layer = (2 * d * qd + 2 * d * kvd + 2 * c.head_dim + d    # attention
             + 3 * d * c.d_ff + d)                            # SwiGLU
    assert c.param_count() == c.padded_vocab * d + d + c.num_layers * layer


def test_small_config_param_count_matches_jax():
    assert _small(configs).param_count() == _small(jax_configs).param_count()


@pytest.mark.parametrize("make", [
    lambda pkg: pkg.get_config("recurrentgemma-9b"),
    lambda pkg: pkg.replace(pkg.get_smoke("gemma3-27b"),
                            pattern=(pkg.LayerSpec(mixer="mlstm",
                                                   ffn="none"),) * 2),
    lambda pkg: pkg.replace(pkg.get_smoke("gemma3-27b"),
                            moe=pkg.MoEConfig(num_experts=4)),
    lambda pkg: pkg.replace(pkg.get_smoke("gemma3-27b"),
                            frontend="vision"),
], ids=["arch", "mixer", "moe", "frontend"])
def test_unported_architectures_raise(make):
    """The configs the port refused before ROADMAP.md queue 1, item 11
    part 2 (an RG-LRU arch, an mLSTM mixer, an MoE FFN, a frontend) now
    construct, and equal the JAX package's field for field; the port
    trains them: ``lm_grad_fn`` gives a finite loss and finite grads (on
    the smoke config of the full-size arch), in the params' tree."""
    got, want = make(configs), make(jax_configs)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    cfg = configs.get_smoke(got.name) if got.param_count() > 10**8 else got
    params = model.init_params(torch.Generator().manual_seed(0), cfg,
                               device="cpu")
    r = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(r.integers(
        0, cfg.vocab_size, size=(2, 17)))}
    if cfg.frontend:
        batch["frontend"] = torch.from_numpy(r.normal(size=(
            2, cfg.frontend_tokens, cfg.d_model)).astype(np.float32))
    steps.lm_grad_fn(got)
    loss, grads = steps.lm_grad_fn(cfg)(params, batch)
    assert torch.isfinite(loss)
    assert pytree.tree_structure(grads) == pytree.tree_structure(params)
    assert all(torch.isfinite(g).all() for g in pytree.tree_leaves(grads))


def test_synthetic_lm_data_matches_jax():
    t = SyntheticLMData(vocab_size=512, num_clients=3, seed=4)
    j = JaxLMData(vocab_size=512, num_clients=3, seed=4)
    np.testing.assert_array_equal(t.client_batches(1, 2, 3, 17, salt=2),
                                  np.asarray(j.client_batches(1, 2, 3, 17,
                                                              salt=2)))
    np.testing.assert_array_equal(t.round_batches([0, 2], 1, 2, 9, 5),
                                  np.asarray(j.round_batches([0, 2], 1, 2, 9,
                                                             5)))


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plain", [False, True], ids=["kernel", "plain"])
def test_serve_main_on_cpu(plain, capsys):
    before = swa_decode.launches["swa_decode"]
    argv = ["--device", "cpu", "--batch", "2", "--prompt-len", "40", "--gen",
            "4"] + (["--plain-attention"] if plain else [])
    res = serve.main(argv, keep_prefill_state=True)
    assert res["decode"]["tokens"].shape == (2, 4)
    assert res["prefill_state"].pos == 40 and res["decode"]["state"].pos == 43
    assert all(torch.isfinite(x).all() for x in res["decode"]["logits"])
    assert swa_decode.launches["swa_decode"] == before   # the twin ran
    out = capsys.readouterr().out
    assert "prefill 2x40" in out and "decode ms per step" in out
    assert out.rstrip().endswith("ok")


def test_serving_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--batch", "1", "--prompt-len", "8", "--gen", "2"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_params(None, configs.get_smoke("gemma3-27b"))
