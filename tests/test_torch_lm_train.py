"""The port's LM training path against the JAX package on the same inputs:
the training forward, the cross entropy, the loss and its grads, the
plain-autograd step, one FedAvg (burn-in) and one FedPA round of the
smoke fedlm-100m through ``make_fed_round`` at ``parallel``, ``chunked``
and ``sequential`` (the one-process baseline of
``tests/test_torch_fsdp_round.py``), and one FedEP and one SCAFFOLD
round from the same numpy client states (the host store's slice) and
server control variate.

Parameters are numpy arrays at the JAX init's shapes, converted with
``convert.lm_params_from_jax``, so both packages run the same weights.

Tolerances (fp32 compute): logits and the loss 1e-5 relative; grads 1e-5
relative plus 1e-5 of the leaf's largest entry (sums over tokens in another
order cancel on small entries), as ``tests/test_torch_kernels.py`` scales its
absolute part. The bf16-compute loss 1e-2 relative and grads 5e-2 of each
leaf's largest entry: bf16 keeps 8 bits of mantissa and rounds at other
places in the two frameworks. Round params 1e-5 relative plus 1e-6
absolute after a FedAvg round and 1e-5 relative plus 1e-5 absolute after
the FedPA round that follows it (the goldens' 1e-5): 8 local steps of
sgdm through 2 layers, then the DP, whose ``a_t`` the port takes by
conjugacy (ROADMAP.md queue 3). The stateful rounds: params and FedEP's
sites 1e-5 relative plus 1e-5 of the leaf's largest entry. SCAFFOLD's
control variates are ``(theta_0 - theta_K) / (K lr)`` plus states of
~1e-2: a difference of params divided by K lr, so their absolute part is
that same 1e-5 of the params leaf's largest entry, divided by K lr.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_lm import _jax_params, _small
from repro import configs as jax_configs
from repro.configs.base import FedConfig as JaxFedConfig
from repro.algorithms import get_algorithm as jax_get_algorithm
from repro.core.server import init_server_state as jax_init_server_state
from repro.core.sharded_round import make_fed_round as jax_make_fed_round
from repro.models import layers as jax_layers
from repro.models import model as jax_model
from repro.models import steps as jax_steps
from repro.optim import get_optimizer as jax_get_optimizer
from repro_torch import configs
from repro_torch.algorithms import get_algorithm
from repro_torch.configs.base import FedConfig
from repro_torch.convert import lm_params_from_jax
from repro_torch.core import sharded_round
from repro_torch.core import tree_math as tm
from repro_torch.core.server import init_server_state
from repro_torch.models import layers, model, steps
from repro_torch.optim import get_optimizer

F32 = torch.float32
ARCH = "fedlm-100m"


@pytest.fixture(scope="module", autouse=True)
def _x32():
    """Other test modules turn on jax x64 at import; compare in fp32."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


@functools.lru_cache(maxsize=None)
def _fedlm_params():
    """Numpy params of the smoke fedlm at the JAX init's shapes: N(0,
    1/fan_in) weights and small nonzero norm scales."""
    shapes = jax.eval_shape(lambda: jax_model.init_params(
        jax.random.PRNGKey(0), jax_configs.get_smoke(ARCH)))
    r = np.random.default_rng(3)

    def draw(path, leaf):
        key = jax.tree_util.keystr(path)
        if "norm" in key or "scale" in key:
            return (0.1 * r.normal(size=leaf.shape)).astype(np.float32)
        fan_in = leaf.shape[-1] if "embed" in key else leaf.shape[-2]
        return (r.normal(size=leaf.shape) / np.sqrt(fan_in)).astype(
            np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


#: name -> (JAX config, port config, numpy params): the smoke fedlm (two
#: attn layers) and a small gemma3 (swa 32 + attn, x2, plus a swa tail).
MODELS = {
    "fedlm-smoke": lambda: (jax_configs.get_smoke(ARCH),
                            configs.get_smoke(ARCH), _fedlm_params()),
    "gemma3-small": lambda: (_small(jax_configs), _small(configs),
                             _jax_params()),
}


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(
        np.int32)


def _close_scaled(got, want, rtol, scale_tol):
    """``got`` within ``rtol`` relative plus ``scale_tol`` of ``want``'s
    largest entry."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=scale_tol * np.abs(want).max())


def _jax_leaves(tree):
    """(path, leaf) pairs in the JAX flatten order (sorted keys)."""
    return [(jax.tree_util.keystr(k), np.asarray(v))
            for k, v in jax.tree_util.tree_leaves_with_path(tree)]


def _port_leaf(tree, path: str):
    """The port's leaf at a JAX key path such as ``['pattern']['pos_0']``."""
    for key in path.strip("[]").split("']['"):
        tree = tree[key.strip("'")]
    return tree.detach().numpy()


def test_fedlm_config_matches_jax():
    """Full and smoke configs field by field; 100,684,032 parameters."""
    for get in ("get_config", "get_smoke"):
        t, j = getattr(configs, get)(ARCH), getattr(jax_configs, get)(ARCH)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.param_count() == j.param_count()
    assert configs.get_config(ARCH).param_count() == 100_684_032


@pytest.mark.parametrize("name", list(MODELS))
def test_forward_logits_vs_jax(name):
    """fp32 compute, q chunks of 12 over 40 tokens (the last ragged; past
    the 32-token window of the swa layers); and the last-5 slice."""
    jcfg, tcfg, params = MODELS[name]()
    toks = _tokens((2, 40), seed=1)
    fwd = jax.jit(functools.partial(jax_model.forward, cfg=jcfg,
                                    compute_dtype=jnp.float32, q_chunk=12))
    jl, _ = fwd(jax.tree_util.tree_map(jnp.asarray, params),
                jnp.asarray(toks))
    tp = lm_params_from_jax(params, "cpu")
    tl, aux = model.forward(tp, torch.from_numpy(toks), tcfg,
                            compute_dtype=F32, q_chunk=12)
    assert tl.shape == (2, 40, tcfg.padded_vocab) and float(aux) == 0.0
    _close_scaled(tl.numpy(), jl, 1e-5, 1e-5)
    tail, _ = model.forward(tp, torch.from_numpy(toks), tcfg,
                            compute_dtype=F32, q_chunk=12, logits_slice=5)
    _close_scaled(tail.numpy(), np.asarray(jl)[:, -5:], 1e-5, 1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_softmax_cross_entropy_vs_jax(masked):
    """valid_vocab 500 of 512 padded rows; a 0/1 token mask."""
    r = np.random.default_rng(2)
    logits = (3 * r.normal(size=(2, 7, 512))).astype(np.float32)
    targets = r.integers(0, 500, (2, 7)).astype(np.int32)
    mask = (r.random((2, 7)) < 0.6).astype(np.float32) if masked else None
    want = jax_layers.softmax_cross_entropy(
        jnp.asarray(logits), jnp.asarray(targets), valid_vocab=500,
        mask=None if mask is None else jnp.asarray(mask))
    got = layers.softmax_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(targets), valid_vocab=500,
        mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(dtype_name):
    jcfg = jax_configs.get_smoke(ARCH)
    fn = jax.jit(jax.value_and_grad(functools.partial(
        jax_steps.lm_loss, cfg=jcfg, compute_dtype=getattr(jnp, dtype_name),
        q_chunk=8), has_aux=True))
    params = jax.tree_util.tree_map(jnp.asarray, _fedlm_params())
    (loss, _), grads = fn(params, {"tokens": jnp.asarray(_tokens((2, 21)))})
    return float(loss), _jax_leaves(grads)


@pytest.mark.parametrize("dtype,loss_tol,grad_tol", [
    ("float32", 1e-5, 1e-5), ("bfloat16", 1e-2, 5e-2)])
def test_lm_grad_fn_vs_jax_value_and_grad(dtype, loss_tol, grad_tol):
    want_loss, want_grads = _jax_loss_and_grads(dtype)
    tp = lm_params_from_jax(_fedlm_params(), "cpu")
    fn = steps.lm_grad_fn(configs.get_smoke(ARCH),
                          compute_dtype=getattr(torch, dtype), q_chunk=8)
    loss, grads = fn(tp, {"tokens": torch.from_numpy(_tokens((2, 21)))})
    np.testing.assert_allclose(float(loss), want_loss, rtol=loss_tol)
    assert len(tm.tleaves(grads)) == len(want_grads)
    for path, want in want_grads:
        got = _port_leaf(grads, path)
        assert got.dtype == np.float32, path
        _close_scaled(got, want, grad_tol if dtype == "float32" else 0.0,
                      grad_tol)


def test_lm_grad_fn_refuses_remat():
    """torch's selective checkpointing (``remat="dots"``) does not compose
    with torch.func: refused, naming ROADMAP.md queue 1, item 13.
    ``"full"`` runs (``model.recompute``) and gives the grads of
    ``"none"``."""
    cfg = configs.get_smoke(ARCH)
    params = lm_params_from_jax(_fedlm_params(), "cpu")
    batch = {"tokens": torch.from_numpy(_tokens((2, 17), seed=5))}
    with pytest.raises(NotImplementedError, match="queue 1, item 13"):
        steps.lm_grad_fn(cfg, remat="dots")(params, batch)
    out = [steps.lm_grad_fn(cfg, compute_dtype=F32, q_chunk=8,
                            remat=remat)(params, batch)
           for remat in ("full", "none")]
    assert float(out[0][0]) == float(out[1][0])
    for a, b in zip(tm.tleaves(out[0][1]), tm.tleaves(out[1][1])):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


STEP_TOKENS = _tokens((2, 17), seed=4)


@functools.lru_cache(maxsize=None)
def _jax_centralized_step(opt_name):
    """Params and loss after one JAX step (remat "full", its default)."""
    jopt = jax_get_optimizer(opt_name, 0.1, 0.9)
    jp = jax.tree_util.tree_map(jnp.asarray, _fedlm_params())
    jstep = jax.jit(functools.partial(
        jax_steps.centralized_train_step, cfg=jax_configs.get_smoke(ARCH),
        opt=jopt, compute_dtype=jnp.float32, q_chunk=8))
    jnew, _, jloss, _ = jstep(jp, jopt.init(jp),
                              {"tokens": jnp.asarray(STEP_TOKENS)})
    return _jax_leaves(jnew), float(jloss)


@pytest.mark.parametrize("opt_name", ["sgd", "sgdm"])
@pytest.mark.parametrize("remat", ["full", "dots", "none"])
def test_centralized_train_step_vs_jax(opt_name, remat):
    """One step from the same params; remat recomputes, so the numbers
    do not depend on it."""
    want_params, want_loss = _jax_centralized_step(opt_name)
    topt = get_optimizer(opt_name, 0.1, 0.9)
    tp = lm_params_from_jax(_fedlm_params(), "cpu")
    tnew, _, tloss, metrics = steps.centralized_train_step(
        tp, topt.init(tp), {"tokens": torch.from_numpy(STEP_TOKENS)},
        configs.get_smoke(ARCH), topt, compute_dtype=F32, q_chunk=8,
        remat=remat)
    np.testing.assert_allclose(float(tloss), want_loss, rtol=1e-5)
    assert not tloss.requires_grad and float(metrics["moe_aux"]) == 0.0
    for path, want in want_params:
        _close_scaled(_port_leaf(tnew, path), want, 1e-5, 1e-6)


#: The round: 2 clients, 8 local steps, 2 burn-in steps, 2 per sample
#: (l = 3: two DP steps, the second reading a live history row).
ROUND_KW = dict(algorithm="fedpa", clients_per_round=2, local_steps=8,
                burn_in_steps=2, steps_per_sample=2, burn_in_rounds=1,
                shrinkage_rho=0.01, client_lr=0.05, server_lr=0.3)
ROUND_TOKENS = [_tokens((2, 8, 2, 17), seed=10 + r) for r in range(2)]


@functools.lru_cache(maxsize=None)
def _jax_rounds(placement):
    """Params after a FedAvg burn-in round and after the FedPA round from
    it, through the JAX package's ``make_fed_round`` (fp32 compute)."""
    jcfg = jax_configs.get_smoke(ARCH)
    fed = JaxFedConfig(**ROUND_KW)
    opt = jax_get_optimizer(fed.server_opt, fed.server_lr,
                            fed.server_momentum)
    state = jax_init_server_state(
        jax.tree_util.tree_map(jnp.asarray, _fedlm_params()), opt)
    out = []
    for use_sampling, toks in zip((False, True), ROUND_TOKENS):
        fn = jax.jit(jax_make_fed_round(
            jcfg, fed, placement=placement, compute_dtype=jnp.float32,
            q_chunk=8, use_sampling=use_sampling,
            chunk_size=1 if placement == "chunked" else None))
        state, metrics = fn(state, {"tokens": jnp.asarray(toks)})
        out.append((_jax_leaves(state.params),
                    {k: float(v) for k, v in metrics.items()}))
    return out


def test_remat_defaults_are_the_reference():
    """The port's ``lm_grad_fn``, ``make_fed_round(_split)`` and
    ``launch.train.main`` recompute each pattern repeat by default, as the
    reference's ``lm_loss`` and ``make_fed_round(_split)`` do:
    ``test_make_fed_round_vs_jax`` holds the two defaults' rounds to each
    other."""
    import inspect

    from repro.core.sharded_round import make_fed_round_split as jax_split
    from repro_torch.launch import train

    def default(fn):
        return inspect.signature(fn).parameters["remat"].default

    assert {default(f) for f in (steps.lm_grad_fn, steps.lm_loss,
                                 sharded_round.make_fed_round,
                                 sharded_round.make_fed_round_split,
                                 train.main)} == {"full"}
    assert {default(f) for f in (jax_steps.lm_loss, jax_make_fed_round,
                                 jax_split)} == {"full"}


@pytest.mark.parametrize("placement", ["parallel", "chunked", "sequential"])
def test_make_fed_round_vs_jax(placement):
    tcfg = configs.get_smoke(ARCH)
    fed = FedConfig(**ROUND_KW)
    opt = get_optimizer(fed.server_opt, fed.server_lr, fed.server_momentum)
    state = init_server_state(lm_params_from_jax(_fedlm_params(), "cpu"), opt)
    for (want_params, want_metrics), use_sampling, toks, atol in zip(
            _jax_rounds(placement), (False, True), ROUND_TOKENS,
            (1e-6, 1e-5)):
        fn = sharded_round.make_fed_round(
            tcfg, fed, placement=placement, compute_dtype=F32, q_chunk=8,
            use_sampling=use_sampling,
            chunk_size=1 if placement == "chunked" else None)
        state, metrics = fn(state, {"tokens": toks})
        for k, v in want_metrics.items():
            np.testing.assert_allclose(float(metrics[k]), v, rtol=1e-5)
        for path, want in want_params:
            np.testing.assert_allclose(_port_leaf(state.params, path), want,
                                       rtol=1e-5, atol=atol, err_msg=path)


#: The stateful rounds: FedEP (the FedPA round's settings, damping 0.7)
#: and SCAFFOLD (plain SGD clients, 8 steps).
STATEFUL_KW = {
    "fedep": dict(ROUND_KW, algorithm="fedep", fedep_damping=0.7),
    "scaffold": dict(ROUND_KW, algorithm="scaffold", client_opt="sgd"),
}


def _stateful_inputs(name):
    """Numpy client states for the 2 clients (a stack of one client's
    template) and, for SCAFFOLD, the server control variate: small
    normals, FedEP's precisions positive."""
    r = np.random.default_rng(21)
    params = _fedlm_params()

    def draw(shape, positive=False):
        x = 0.01 * r.normal(size=shape)
        return (np.abs(x) + 0.5 if positive else x).astype(np.float32)

    def stack(positive=False):
        return jax.tree_util.tree_map(
            lambda p: draw((2,) + p.shape, positive), params)

    if name == "fedep":
        return {"num": stack(), "den": stack(positive=True)}, None
    return stack(), jax.tree_util.tree_map(lambda p: draw(p.shape), params)


@functools.lru_cache(maxsize=None)
def _jax_stateful_round(name):
    jcfg = jax_configs.get_smoke(ARCH)
    fed = JaxFedConfig(**STATEFUL_KW[name])
    opt = jax_get_optimizer(fed.server_opt, fed.server_lr,
                            fed.server_momentum)
    cstates, c = _stateful_inputs(name)
    state = jax_init_server_state(
        jax.tree_util.tree_map(jnp.asarray, _fedlm_params()), opt,
        algorithm=jax_get_algorithm(fed))
    if c is not None:
        state = state._replace(algo_state=jax.tree_util.tree_map(
            jnp.asarray, c))
    fn = jax.jit(jax_make_fed_round(jcfg, fed, placement="parallel",
                                    compute_dtype=jnp.float32, q_chunk=8))
    state, metrics, new_states = fn(state, {"tokens": ROUND_TOKENS[1]},
                                    None, cstates)
    return (_jax_leaves(state.params), _jax_leaves(state.algo_state),
            _jax_leaves(new_states),
            {k: float(v) for k, v in metrics.items()})


@pytest.mark.parametrize("name", sorted(STATEFUL_KW))
def test_stateful_fed_round_vs_jax(name):
    """One round of the smoke fedlm-100m with the host store's slice: the
    params, SCAFFOLD's server control variate and the clients' new states
    against the JAX package's."""
    tcfg = configs.get_smoke(ARCH)
    fed = FedConfig(**STATEFUL_KW[name])
    opt = get_optimizer(fed.server_opt, fed.server_lr, fed.server_momentum)
    cstates, c = _stateful_inputs(name)
    state = init_server_state(lm_params_from_jax(_fedlm_params(), "cpu"),
                              opt, algorithm=get_algorithm(fed))
    if c is not None:
        state = state._replace(algo_state=lm_params_from_jax(c, "cpu"))
    fn = sharded_round.make_fed_round(tcfg, fed, placement="parallel",
                                      compute_dtype=F32, q_chunk=8)
    state, metrics, new_states = fn(state, {"tokens": ROUND_TOKENS[1]},
                                    None, cstates)
    want_params, want_c, want_states, want_metrics = \
        _jax_stateful_round(name)
    for k, v in want_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), v, rtol=1e-5)
    theta = dict(_jax_leaves(_fedlm_params()))
    delta_scale = fed.local_steps * fed.client_lr
    for tree, want, of_delta in ((state.params, want_params, False),
                                 (state.algo_state, want_c, True),
                                 (new_states, want_states,
                                  name == "scaffold")):
        assert len(tm.tleaves(tree)) == len(want)
        for path, w in want:
            got = tree
            for key in path.strip("[]").split("]["):
                got = got[key.strip("'")]
            if of_delta:
                np.testing.assert_allclose(
                    got.detach().numpy(), w, rtol=1e-5,
                    atol=1e-5 * np.abs(theta[path]).max() / delta_scale,
                    err_msg=path)
            else:
                _close_scaled(got.detach().numpy(), w, 1e-5, 1e-5)


def test_sequential_placement_steps_on_compute_dtype_params():
    """``sequential`` runs each client on the master params cast to the
    compute dtype (the reference's all-gather boundary); in fp32 it equals
    ``parallel``."""
    tcfg = configs.get_smoke(ARCH)
    fed = FedConfig(**ROUND_KW)
    opt = get_optimizer(fed.server_opt, fed.server_lr, fed.server_momentum)
    params = lm_params_from_jax(_fedlm_params(), "cpu")
    out = {}
    for placement in ("parallel", "sequential"):
        fn = sharded_round.make_fed_round(tcfg, fed, placement=placement,
                                          compute_dtype=F32, q_chunk=8)
        out[placement], _ = fn(init_server_state(params, opt),
                               {"tokens": ROUND_TOKENS[1]})
    for a, b in zip(tm.tleaves(out["parallel"].params),
                    tm.tleaves(out["sequential"].params)):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6)
    seen = []
    wrap = sharded_round._program_pieces(
        tcfg, fed, "sequential", torch.bfloat16, 8, "none", True,
        None)[1]["wrap_client"]
    wrap(lambda p, b: seen.append({t.dtype for t in tm.tleaves(p)}))(
        params, None)
    assert seen == [{torch.bfloat16}]


def test_default_placement():
    assert sharded_round.default_placement(configs.get_config(ARCH)) == \
        "parallel"
    assert sharded_round.default_placement(
        configs.get_config("gemma3-27b")) == "sequential"

