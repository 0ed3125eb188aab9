"""Training the families the port serves (MoE FFNs on both routes, RG-LRU,
mLSTM/sLSTM, vision and audio frontends) against the JAX package on the
same numpy weights and inputs: the loss, its metrics and its grads
(``jax.value_and_grad`` of ``repro.models.steps.lm_loss``), with the
frontend rounded to bf16 as the reference's training entry point rounds it;
the recompute of ``remat="full"`` under the round's ``vmap(grad)``
against keeping every activation; the gradient of
``tests/test_moe_routing.py::test_full_model_with_sort_routing``.

Everything runs in fp32 compute. Grads within 1e-4 of each leaf's largest
entry (measured: 1.4e-5 for xlstm-125m, 2e-6 to 3.3e-6 for the others:
sums over tokens and experts in another order); the loss 1e-5 relative;
``moe_aux`` 1e-5 relative. The recompute runs the same ops on the same
inputs: its grads equal the plain ones to 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_archs import NEW_ARCHS, _setup
from test_torch_lm_train import _fedlm_params, _jax_leaves, _port_leaf
from repro import configs as jax_configs
from repro.models import model as jax_model
from repro.models import steps as jax_steps
from repro_torch import configs
from repro_torch.convert import lm_params_from_jax
from repro_torch.core import tree_math as tm
from repro_torch.launch.train import bf16_values
from repro_torch.models import model, steps

B, S = 2, 24
F32 = dict(compute_dtype=jnp.float32, q_chunk=16, remat="none")


@pytest.fixture(scope="module", autouse=True)
def _x32():
    """Other test modules turn on jax x64 at import; compare in fp32."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _routed(cfg, routing):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, routing=routing))


#: (arch, MoE routing or None): the eight smoke archs, the two MoE archs
#: on the sort route too.
CASES = [(a, None) for a in NEW_ARCHS] + [
    ("qwen3-moe-30b-a3b", "sort"), ("llama4-scout-17b-a16e", "sort")]


def _batch(tcfg, seed=0, clients=None):
    """Numpy ``{"tokens": (B, S+1)[, "frontend": (B, F, d) bf16 values]}``,
    with a leading client axis when ``clients`` is given."""
    lead = () if clients is None else (clients,)
    r = np.random.default_rng(seed)
    batch = {"tokens": r.integers(0, tcfg.vocab_size, size=(*lead, B, S + 1))
             .astype(np.int32)}
    if tcfg.frontend:
        batch["frontend"] = bf16_values((r.normal(size=(
            *lead, B, tcfg.frontend_tokens, tcfg.d_model)) / np.sqrt(
                tcfg.d_model)).astype(np.float32))
    return batch


def _jax_value_and_grad(jcfg, params, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if "frontend" in jb:
        jb["frontend"] = jb["frontend"].astype(jnp.bfloat16)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: jax_steps.lm_loss(p, jb, jcfg, **F32), has_aux=True))(
            params)
    return float(loss), {k: float(v) for k, v in metrics.items()}, grads


def _assert_grads_close(tgrads, jgrads, scale_tol=1e-4):
    """Each port leaf within ``scale_tol`` of the JAX leaf's largest
    entry, leaf by leaf in the JAX tree's order."""
    leaves = _jax_leaves(jgrads)
    assert len(leaves) == len(tm.tleaves(tgrads))
    for path, want in leaves:
        got = _port_leaf(tgrads, path)
        assert np.isfinite(got).all(), path
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=scale_tol * np.abs(want).max(),
                                   err_msg=path)


def _tensors(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.mark.parametrize("arch,routing", CASES,
                         ids=[a + (f"-{r}" if r else "") for a, r in CASES])
def test_loss_and_grads_vs_jax(arch, routing):
    """``lm_grad_fn`` and ``lm_loss`` (frontend logits sliced off, the
    router aux term added) against ``jax.value_and_grad`` of the JAX
    ``lm_loss``."""
    jcfg, tcfg, params, tparams, _, _ = _setup(arch)
    if routing:
        jcfg, tcfg = _routed(jcfg, routing), _routed(tcfg, routing)
    batch = _batch(tcfg)
    jloss, jmetrics, jgrads = _jax_value_and_grad(jcfg, params, batch)
    tb = _tensors(batch)
    loss, grads = steps.lm_grad_fn(tcfg, compute_dtype=torch.float32,
                                   q_chunk=16)(tparams, tb)
    with torch.no_grad():
        total, metrics = steps.lm_loss(tparams, tb, tcfg,
                                       compute_dtype=torch.float32,
                                       q_chunk=16, remat="none")
    assert float(loss) == pytest.approx(jloss, rel=1e-5)
    assert float(total) == pytest.approx(jloss, rel=1e-5)
    assert float(metrics["xent"]) == pytest.approx(jmetrics["xent"],
                                                   rel=1e-5)
    assert float(metrics["moe_aux"]) == pytest.approx(
        jmetrics["moe_aux"], rel=1e-5, abs=1e-7)
    assert (jmetrics["moe_aux"] > 0) == tcfg.moe.enabled
    if tcfg.moe.enabled:      # the aux term is in the loss
        assert jloss - jmetrics["xent"] == pytest.approx(
            tcfg.moe.router_aux_weight * jmetrics["moe_aux"], rel=1e-3)
    _assert_grads_close(grads, jgrads)


#: One smoke arch per family, and the smoke fedlm-100m.
REMAT_ARCHS = ["fedlm-100m", "qwen3-moe-30b-a3b", "recurrentgemma-9b",
               "xlstm-125m", "internvl2-26b"]


def _smoke_params(arch):
    if arch == "fedlm-100m":
        return configs.get_smoke(arch), lm_params_from_jax(_fedlm_params(),
                                                           "cpu")
    _, tcfg, _, tparams, _, _ = _setup(arch)
    return tcfg, tparams


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_full_equals_none_under_vmap_grad(arch):
    """Two clients (their own params and batches) through
    ``vmap(lm_grad_fn)``: ``remat="full"`` recomputes each repeat in the
    backward pass (``model.recompute``, entered once per repeat) and gives
    the grads of keeping every activation."""
    tcfg, tparams = _smoke_params(arch)
    cparams = tm.tmap(lambda t: torch.stack([t, 1.01 * t]), tparams)
    batch = _tensors(_batch(tcfg, seed=1, clients=2))
    calls = []
    orig = model._Recompute.backward

    def backward(ctx, *grads):
        calls.append(1)
        return orig(ctx, *grads)

    out = {}
    for remat in ("none", "full"):
        fn = torch.func.vmap(steps.lm_grad_fn(
            tcfg, compute_dtype=torch.float32, q_chunk=16, remat=remat))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(model._Recompute, "backward", staticmethod(backward))
            out[remat] = fn(cparams, batch)
    assert len(calls) == tcfg.repeats
    torch.testing.assert_close(out["full"][0], out["none"][0], rtol=1e-6,
                               atol=1e-6)
    for a, b in zip(tm.tleaves(out["full"][1]), tm.tleaves(out["none"][1])):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_remat_dots_is_refused_under_torch_func_and_runs_under_autograd():
    """``"dots"`` keeps the weight products through
    ``torch.utils.checkpoint``'s selective policy, which plain autograd
    runs (``centralized_train_step``) and ``torch.func`` refuses: the
    round's ``lm_grad_fn`` names ROADMAP.md queue 1, item 13."""
    tcfg, tparams = _smoke_params("recurrentgemma-9b")
    batch = _tensors(_batch(tcfg, seed=2))
    with pytest.raises(NotImplementedError, match="queue 1, item 13"):
        torch.func.vmap(steps.lm_grad_fn(tcfg, remat="dots"))(
            tm.tmap(lambda t: t[None], tparams),
            tm.tmap(lambda t: t[None], batch))
    leaves, spec = torch.utils._pytree.tree_flatten(tparams)
    grads = {}
    for remat in ("none", "full", "dots"):
        with torch.enable_grad():
            ps = [p.detach().requires_grad_(True) for p in leaves]
            loss = steps.lm_loss(torch.utils._pytree.tree_unflatten(ps, spec),
                                 batch, tcfg, compute_dtype=torch.float32,
                                 q_chunk=16, remat=remat)[0]
            grads[remat] = torch.autograd.grad(loss, ps)
    for remat in ("full", "dots"):
        for a, b in zip(grads[remat], grads["none"]):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_full_model_with_sort_routing_grads_vs_jax():
    """The config of ``tests/test_moe_routing.py::
    test_full_model_with_sort_routing`` (the smoke qwen3-moe, sort route,
    4 experts, top-2, capacity factor 8) on its (2, 33) batch: the loss
    and grads equal the JAX package's, and are finite."""
    def cfg_of(pkg):
        cfg = pkg.get_smoke("qwen3-moe-30b-a3b")
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, routing="sort", capacity_factor=8.0, num_experts=4,
            top_k=2))

    jcfg, tcfg = cfg_of(jax_configs), cfg_of(configs)
    params = jax.tree_util.tree_map(np.asarray, jax_model.init_params(
        jax.random.PRNGKey(0), jcfg))
    tokens = np.array(jax.random.randint(jax.random.PRNGKey(3), (2, 33), 0,
                                         jcfg.vocab_size), np.int32)
    jloss, _, jgrads = _jax_value_and_grad(jcfg, params, {"tokens": tokens})
    loss, grads = steps.lm_grad_fn(tcfg, compute_dtype=torch.float32,
                                   q_chunk=16)(
        lm_params_from_jax(params, "cpu"),
        {"tokens": torch.from_numpy(tokens)})
    assert np.isfinite(float(loss))
    assert float(loss) == pytest.approx(jloss, rel=1e-5)
    _assert_grads_close(grads, jgrads)
