"""The port's client math against the JAX package on the same numpy
inputs: optimizers, IASG, the DP (batch and streaming), tree flattening,
``FedConfig`` validation, and the EMNIST CNN.

Tolerances: fp32 throughout. Elementwise updates (optimizers) 1e-6
relative; IASG samples and CNN outputs 1e-5 (matmul and convolution sums
run in another order); the DP 2e-4, as ``tests/test_kernels.py`` holds the
flat DP against the scan DP.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import engine_goldens_common as egc
from repro.configs import emnist_cnn as jax_emnist
from repro.configs.base import FedConfig as JaxFedConfig
from repro.core.iasg import iasg_sample as jax_iasg_sample
from repro.models import cnn as jax_cnn
from repro.optim import get_optimizer as jax_get_optimizer
from repro_torch.algorithms import phase_name
from repro_torch.configs import emnist_cnn
from repro_torch.configs.base import FedConfig
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core import dp_delta as port_dp
from repro_torch.core import tree_math as tm
from repro_torch.core.iasg import iasg_sample
from repro_torch.core.round_program import batched_grad
from repro_torch.models import cnn
from repro_torch.optim import get_optimizer

# repro.core re-exports a function named dp_delta over the module's name
jax_dp = importlib.import_module("repro.core.dp_delta")


@pytest.fixture(scope="module", autouse=True)
def _x32():
    """Other test modules turn on jax x64 at import; compare in fp32."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _tree(r, shapes):
    return {k: r.normal(size=s).astype(np.float32) for k, s in shapes.items()}


SHAPES = {"w": (3, 4), "b": (4,)}


@pytest.mark.parametrize("name", ["sgd", "sgdm", "adam", "adagrad", "yogi"])
def test_optimizers_vs_jax(name):
    r = np.random.default_rng(3)
    params = _tree(r, SHAPES)
    grads = [_tree(r, SHAPES) for _ in range(4)]
    jopt, topt = jax_get_optimizer(name, 0.1), get_optimizer(name, 0.1)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = params_from_jax(params, "cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        ju, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tu, ts = topt.update(params_from_jax(g, "cpu"), ts, tp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, ju)
        tp = tm.tmap(lambda p, u: p + u, tp, tu)
    for k in params:
        np.testing.assert_allclose(params_to_numpy(tp)[k], np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6)


def test_momentum_accessor_and_phase_name():
    p = {"w": torch.ones(2)}
    sgdm, sgd = get_optimizer("sgdm", 0.1), get_optimizer("sgd", 0.1)
    _, st = sgdm.update({"w": torch.full((2,), 3.0)}, sgdm.init(p), p)
    assert torch.equal(sgdm.momentum(st, p)["w"], torch.full((2,), 3.0))
    assert torch.equal(sgd.momentum(sgd.init(p), p)["w"], torch.zeros(2))
    fed = FedConfig(algorithm="fedpa", burn_in_rounds=1)
    assert [phase_name(fed, r) for r in (0, 1)] == ["fedavg (burn-in)",
                                                     "fedpa"]


def _lsq_grad_fns():
    def jloss(p, batch):
        r = batch["x"] @ p - batch["y"]
        return 0.5 * jnp.mean(r * r) * 50

    def tloss(p, batch):
        r = batch["x"] @ p - batch["y"]
        return 0.5 * (r * r).mean() * 50

    tgv = torch.func.grad_and_value(tloss)

    def tgrad(p, batch):
        g, loss = tgv(p, batch)
        return loss, g

    return jax.value_and_grad(jloss), tgrad


def test_iasg_sample_vs_jax():
    C, K_b, K_s, ell, D = 3, 2, 3, 3, 5
    r = np.random.default_rng(0)
    x = r.normal(size=(C, K_b + ell * K_s, 8, D)).astype(np.float32)
    y = r.normal(size=(C, K_b + ell * K_s, 8)).astype(np.float32)
    p0 = r.normal(size=D).astype(np.float32)
    jgrad, tgrad = _lsq_grad_fns()
    jopt, topt = jax_get_optimizer("sgdm", 0.01), get_optimizer("sgdm", 0.01)
    start = tm.tbroadcast(torch.from_numpy(p0), C)
    res = iasg_sample(start, topt, topt.init(start), batched_grad(tgrad),
                      {"x": torch.from_numpy(x), "y": torch.from_numpy(y)},
                      K_b, K_s, ell)
    assert res.samples.shape == (C, ell, D)
    for c in range(C):
        want = jax_iasg_sample(jnp.asarray(p0), jopt,
                               jopt.init(jnp.asarray(p0)), jgrad,
                               {"x": jnp.asarray(x[c]), "y": jnp.asarray(y[c])},
                               K_b, K_s, ell)
        np.testing.assert_allclose(res.samples[c].numpy(),
                                   np.asarray(want.samples), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(res.sample_losses[c].numpy(),
                                   np.asarray(want.sample_losses), rtol=1e-5)
        np.testing.assert_allclose(res.burn_in_losses[c].numpy(),
                                   np.asarray(want.burn_in_losses), rtol=1e-5)


DP_SHAPES = {"a": (6, 5), "b": (7,)}


def _dp_case(ell, C=3, seed=0):
    r = np.random.default_rng(seed)
    x0 = _tree(r, DP_SHAPES)
    samples = [{k: (x0[k] + 0.3 * r.normal(size=(ell,) + v.shape))
                .astype(np.float32) for k, v in x0.items()}
               for _ in range(C)]
    return x0, samples


def _flat_np(tree, lead=0):
    return tm.flatten(params_from_jax(tree, "cpu"), lead_dims=lead).numpy()


@pytest.mark.parametrize("ell", [1, 2, 5])
def test_dp_delta_vs_jax(ell):
    rho = 0.3
    x0, samples = _dp_case(ell)
    flat_samples = torch.from_numpy(np.stack(
        [_flat_np(s, lead=1) for s in samples]))
    got = port_dp.dp_delta(torch.from_numpy(_flat_np(x0)), flat_samples,
                           rho).numpy()
    for c, s in enumerate(samples):
        want = jax_dp.dp_delta({k: jnp.asarray(v) for k, v in x0.items()},
                               {k: jnp.asarray(v) for k, v in s.items()}, rho)
        want = _flat_np({k: np.asarray(v) for k, v in want.items()})
        np.testing.assert_allclose(got[c], want, rtol=2e-4, atol=2e-4)


def test_streaming_dp_vs_jax():
    """The online any-time estimate after every sample, as the streaming
    FedPA client absorbs them."""
    rho, ell = 0.5, 4
    x0, samples = _dp_case(ell, seed=1)
    C = len(samples)
    flat = np.stack([_flat_np(s, lead=1) for s in samples])   # (C, l, d)
    state = port_dp.online_dp_init(
        torch.from_numpy(_flat_np(x0)).expand(C, -1), ell)
    jstates = [jax_dp.online_dp_init({k: jnp.asarray(v)
                                      for k, v in x0.items()}, ell)
               for _ in range(C)]
    for i in range(ell):
        state = port_dp.online_dp_update(state, torch.from_numpy(flat[:, i]),
                                         rho)
        got = port_dp.online_dp_delta(state, rho).numpy()
        for c in range(C):
            jstates[c] = jax_dp.online_dp_update(
                jstates[c], {k: jnp.asarray(v[i])
                             for k, v in samples[c].items()}, rho)
            want = jax_dp.online_dp_delta(jstates[c], rho)
            want = _flat_np({k: np.asarray(v) for k, v in want.items()})
            np.testing.assert_allclose(got[c], want, rtol=2e-4, atol=2e-4)


def test_fedavg_delta_is_single_sample_dp():
    x0, samples = _dp_case(1)
    flat = torch.from_numpy(np.stack([_flat_np(s, lead=1) for s in samples]))
    x0f = torch.from_numpy(_flat_np(x0))
    torch.testing.assert_close(port_dp.dp_delta(x0f, flat, 0.3),
                               port_dp.fedavg_delta(x0f, flat[:, 0]))


def test_flatten_round_trip():
    r = np.random.default_rng(2)
    params = params_from_jax(_tree(r, DP_SHAPES), "cpu")
    stacked = tm.tbroadcast(params, 4)
    flat = tm.flatten(stacked)
    assert flat.shape == (4, 37) and flat.dtype == torch.float32
    back = tm.unflatten(flat, params)
    for k in params:
        assert torch.equal(back[k][2], params[k])
    assert torch.equal(tm.unflatten(tm.flatten(params, lead_dims=0),
                                    params)["a"], params["a"])
    with pytest.raises(ValueError, match="entries"):
        tm.unflatten(flat[:, :-1], params)


#: In-scope knobs: both packages accept or both raise ValueError.
#: Codec specs the reference's ``parse_codec`` rejects: an unknown stage,
#: ``none`` composed, a duplicate stage, a linear stage after a nonlinear
#: one; with the codec algorithm and with one that takes no codec.
BAD_CODECS = [dict(algorithm=alg, payload_codec=spec)
              for alg in ("fedlora", "fedavg")
              for spec in ("bogus", "none+int8", "int8+int8", "int8+lowrank")]

CONFIG_CASES = [
    *BAD_CODECS,
    *[kw for kw, _ in (egc.SPECS[n] for n in
                       ("fedavg", "fedpa", "fedpa_stream"))],
    dict(algorithm="fedpa", burn_in_rounds=2, delta_dtype="bfloat16"),
    dict(algorithm="fedpa", local_steps=6, burn_in_steps=4,
         steps_per_sample=2),
    dict(algorithm="fedpa", local_steps=7),
    dict(algorithm="fedpa", local_steps=4, burn_in_steps=4),
    dict(algorithm="fedavg", streaming_dp=True),
    dict(shrinkage_rho=0.0), dict(clients_per_round=0), dict(client_lr=-1.0),
    dict(server_opt="nope"), dict(delta_dtype="int32"),
    dict(delta_dtype="nope"), dict(payload_codec="lowrank"),
    dict(quant_bits=4), dict(round_placement="diagonal"),
    dict(prefetch_backend="nope"), dict(staleness_discount=1.5),
    dict(straggler_rate=0.5), dict(min_local_steps=20),
    dict(algorithm="nope"),
    *[kw for kw, _ in (egc.SPECS[n] for n in
                       ("fedavg_dropout", "fedprox", "mime",
                        "fedpa_precision"))],
    dict(algorithm="fedprox", fedprox_mu=-1.0),
    dict(algorithm="mime", mime_beta=1.5),
    dict(algorithm="fedpa_precision", streaming_dp=True),
    dict(algorithm="mime", client_opt="sgd", min_local_steps=2),
    dict(algorithm="fedpa", client_opt="sgd", min_local_steps=2,
         round_placement="sequential"),
    dict(round_placement="chunked", round_chunk_size=-1),
    dict(availability="diurnal", availability_duty=0.0),
    dict(dropout_rate=1.5), dict(qffl_q=-1.0),
    egc.SPECS["fedlora"][0],
    dict(algorithm="fedlora", payload_codec="lowrank+int8", quant_bits=16),
    dict(algorithm="fedlora", payload_codec="int8", error_feedback=False),
    dict(algorithm="fedlora", payload_codec="lowrank", lora_rank=0),
    dict(algorithm="fedlora", payload_codec="int8", quant_bits=7),
    dict(algorithm="fedlora", error_feedback=1),
    dict(algorithm="fedlora", streaming_dp=True),
    dict(algorithm="fedlora", local_steps=7),
]


def _outcome(cls, kw):
    try:
        cls(**kw)
    except ValueError:
        return "ValueError"
    return "ok"


@pytest.mark.parametrize("kw", CONFIG_CASES, ids=lambda kw: repr(kw)[:60])
def test_fedconfig_accepts_and_rejects_like_jax(kw):
    assert _outcome(FedConfig, kw) == _outcome(JaxFedConfig, kw)


@pytest.mark.parametrize("kw", BAD_CODECS, ids=lambda kw: repr(kw)[:60])
def test_bad_codec_specs_raise_value_error_in_both(kw):
    """Both packages name the codec spec in the error."""
    for cls in (FedConfig, JaxFedConfig):
        with pytest.raises(ValueError, match="codec"):
            cls(**kw)


#: Knobs valid in the reference -> the ROADMAP.md queue-1 item the port
#: still waits for, or None where the port runs them (async rounds and
#: prefetching, the placements, mime, scaffold, the device client store,
#: cohort faults, q-FFL, step budgets, fedlora and its codecs).
KNOBS = [
    (dict(async_rounds=True), None), (dict(round_placement="chunked"), None),
    (dict(algorithm="scaffold", client_opt="sgd"), None),
    (dict(algorithm="mime"), None),
    (dict(algorithm="fedlora", payload_codec="lowrank"), None),
    (dict(prefetch_rounds=2), None), (dict(dropout_rate=0.1), None),
    (dict(availability="diurnal"), None), (dict(qffl_q=1.0), None),
    (dict(client_state_placement="device"), None),
    (dict(client_opt="sgd", min_local_steps=2), None),
]


@pytest.mark.parametrize("kw", [kw for kw, _ in KNOBS],
                         ids=lambda kw: repr(kw)[:60])
def test_fedconfig_refuses_unported_knobs(kw):
    """The port refuses what it cannot run, naming the item that ports it,
    and builds the rest with the reference's field values."""
    want = dataclasses.asdict(JaxFedConfig(**kw))   # valid in the reference
    item = dict((repr(k), i) for k, i in KNOBS)[repr(kw)]
    if item is None:
        assert dataclasses.asdict(FedConfig(**kw)) == want
        return
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP.md queue 1, item {item}"):
        FedConfig(**kw)


def numpy_cnn_params(cfg, seed):
    """CNN weights made with numpy at the JAX init's shapes (eager JAX init
    takes seconds on the CPU)."""
    shapes = jax.eval_shape(
        lambda: jax_cnn.init_cnn_params(jax.random.PRNGKey(0), cfg))
    r = np.random.default_rng(seed)
    return {k: (0.2 * r.normal(size=v.shape)).astype(np.float32)
            for k, v in shapes.items()}


def _smoke_cnn():
    cfg_j, cfg_t = jax_emnist.smoke(), emnist_cnn.smoke()
    params = numpy_cnn_params(cfg_j, 0)
    r = np.random.default_rng(5)
    s = cfg_j.image_size
    batch = {"x": r.normal(size=(8, s, s, 1)).astype(np.float32),
             "y": r.integers(0, cfg_j.num_classes, size=8).astype(np.int32)}
    return cfg_j, cfg_t, params, batch


def test_cnn_forward_loss_grad_vs_jax():
    cfg_j, cfg_t, params, batch = _smoke_cnn()
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    tp = params_from_jax(params, "cpu")
    tb = params_from_jax(batch, "cpu")
    np.testing.assert_allclose(
        cnn.cnn_forward(tp, tb["x"], cfg_t).detach().numpy(),
        np.asarray(jax.jit(jax_cnn.cnn_forward, static_argnums=2)(
            jp, jb["x"], cfg_j)),
        rtol=1e-5, atol=1e-5)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_cnn.cnn_loss(p, jb, cfg_j)))(jp)
    tloss, tgrads = cnn.cnn_grad_fn(cfg_t)(tp, tb)
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)
    for k, g in params_to_numpy(tgrads).items():
        assert g.shape == params[k].shape
        np.testing.assert_allclose(g, np.asarray(jgrads[k]), rtol=1e-4,
                                   atol=1e-5)


def test_cnn_init_shapes_match_jax():
    cfg = emnist_cnn.config()
    tp = cnn.init_cnn_params(torch.Generator().manual_seed(0), cfg)
    jp = jax.eval_shape(lambda: jax_cnn.init_cnn_params(
        jax.random.PRNGKey(0), jax_emnist.config()))
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    assert tm.tree_size(tp) == 428_350
