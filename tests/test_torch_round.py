"""The port's round as a whole, on the CPU: ``FedSim(device="cpu")``
replays the JAX engine goldens and matches JAX ``FedSim`` on the smoke
EMNIST CNN; plus the port's import and device guards.

Tolerances (fp32): golden params and losses to 1e-5 relative — the port
takes the DP's ``a_t`` by conjugacy (the kernel form) where the JAX round
takes ``<u, v>`` directly, and sums in another order, which moves the
goldens' params by ~1e-7 relative after 6 rounds. The CNN's final params
to 1e-4 (weights of magnitude ~0.1-1): two rounds of 4 local steps over
convolutions whose sums run in another order.
"""
import ast
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import engine_goldens_common as egc
from test_torch_core import numpy_cnn_params
from repro.configs import emnist_cnn as jax_emnist
from repro.configs.base import FedConfig as JaxFedConfig
from repro.core import FedSim as JaxFedSim
from repro.models import cnn as jax_cnn
from repro_torch.configs import emnist_cnn
from repro_torch.configs.base import FedConfig
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core.round import FedSim
from repro_torch.data.synthetic_lsq import lsq_batches, make_federated_lsq
from repro_torch.models import cnn

ROOT = pathlib.Path(__file__).resolve().parents[1]
UNIFORM_KEYS = {"round", "staleness", "loss_first", "loss_last",
                "client_loss", "bytes_up", "bytes_down", "dropped",
                "straggled", "state_drops"}


@pytest.fixture(scope="module", autouse=True)
def _x32():
    """Other test modules turn on jax x64 at import; compare in fp32."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def torch_lsq_problem():
    """``engine_goldens_common.make_problem``'s problem through the port's
    ``synthetic_lsq`` (the same numpy draws): numpy batches, the loss in
    torch. Returns ``(grad_fn, batch_fn)``."""
    _, data = make_federated_lsq(egc.C, 50, egc.D, heterogeneity=20.0,
                                 seed=0)

    def batch_fn(cid, r, steps):
        X, y = data[cid]
        return lsq_batches(X, y, 10, steps, seed=r * 131 + cid)

    def loss(p, batch):
        r = batch["x"] @ p - batch["y"]
        return 0.5 * (r * r).mean() * 50

    grad_and_value = torch.func.grad_and_value(loss)

    def grad_fn(p, batch):
        g, value = grad_and_value(p, batch)
        return value, g

    return grad_fn, batch_fn


@pytest.fixture(scope="module")
def lsq_problem():
    """``torch_lsq_problem`` once per module."""
    return torch_lsq_problem()


@pytest.mark.parametrize("name", ["fedavg", "fedavg_weighted", "fedpa",
                                  "fedpa_stream"])
def test_replays_sync_parallel_goldens(name, lsq_problem):
    kwargs, weights = egc.SPECS[name]
    grad_fn, batch_fn = lsq_problem
    sim = FedSim(FedConfig(**kwargs), grad_fn, batch_fn, num_clients=egc.C,
                 client_weights=(None if weights is None
                                 else np.asarray(weights, np.float32)),
                 device="cpu")
    state, history = sim.run(torch.zeros(egc.D), egc.ROUNDS,
                             eval_fn=lambda p: {"eval_loss": (p * p).sum()},
                             eval_every=2)
    g_arrays, g_history = egc.load_case(name, "sync", "parallel")
    np.testing.assert_allclose(state.params.numpy(), g_arrays["param::"],
                               rtol=1e-5)
    json.dumps(history)
    assert len(history) == len(g_history)
    for rec, g_rec in zip(history, g_history):
        assert set(rec) == set(g_rec) | UNIFORM_KEYS
        for k, v in g_rec.items():
            if isinstance(v, float):
                assert rec[k] == pytest.approx(v, rel=1e-5), k
            else:
                assert rec[k] == v, k


def _cnn_problem(cfg, num_clients, batch=8, seed=0):
    r = np.random.default_rng(seed)
    s = cfg.image_size
    xs = r.normal(size=(num_clients, 4 * batch, s, s, 1)).astype(np.float32)
    ys = r.integers(0, cfg.num_classes,
                    size=(num_clients, 4 * batch)).astype(np.int32)

    def batch_fn(cid, rnd, num_steps):
        idx = np.random.default_rng(rnd * 997 + cid).integers(
            0, 4 * batch, size=(num_steps, batch))
        return {"x": xs[cid][idx], "y": ys[cid][idx]}

    return batch_fn


def test_smoke_cnn_fedpa_matches_jax_fedsim():
    """fedpa, one burn-in round then one sampling round, 4 clients of 6,
    l = 3, from the same weights and numpy batches."""
    kw = dict(algorithm="fedpa", clients_per_round=4, local_steps=4,
              burn_in_steps=1, steps_per_sample=1, shrinkage_rho=0.1,
              burn_in_rounds=1, client_opt="sgdm", client_lr=0.05,
              server_opt="sgdm", server_lr=0.5)
    cfg_j, cfg_t = jax_emnist.smoke(), emnist_cnn.smoke()
    batch_fn = _cnn_problem(cfg_j, num_clients=6)
    params = numpy_cnn_params(cfg_j, 1)

    def jgrad(p, b):
        return jax.value_and_grad(lambda q: jax_cnn.cnn_loss(q, b, cfg_j))(p)

    jsim = JaxFedSim(JaxFedConfig(**kw), jgrad, batch_fn, num_clients=6)
    jstate, jhist = jsim.run(jax.tree_util.tree_map(jnp.asarray, params), 2)
    tsim = FedSim(FedConfig(**kw), cnn.cnn_grad_fn(cfg_t), batch_fn,
                  num_clients=6, device="cpu")
    tstate, thist = tsim.run(params_from_jax(params, "cpu"), 2)

    got = params_to_numpy(tstate.params)
    for k, v in jstate.params.items():
        np.testing.assert_allclose(got[k], np.asarray(v), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    assert [h["bytes_up"] for h in thist] == [h["bytes_up"] for h in jhist]
    for th, jh in zip(thist, jhist):
        assert th["loss_last"] == pytest.approx(jh["loss_last"], rel=1e-4)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    names = {f.relative_to(ROOT / "src" / "repro_torch").as_posix()
             for f in files[:-1]}
    assert {"data/synthetic_lsq.py", "data/cohort_source.py",
            "core/shrinkage.py", "core/posterior.py", "core/client.py",
            "optim/schedules.py", "algorithms/fedprox.py",
            "algorithms/mime.py", "algorithms/fedpa_precision.py",
            "examples/quickstart.py", "algorithms/fedlora.py",
            "compression/threefry.py", "compression/lowrank.py",
            "compression/quant.py"} <= names
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (f, mod)


def test_fedsim_without_device_needs_cuda(monkeypatch, lsq_problem):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    grad_fn, batch_fn = lsq_problem
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FedSim(FedConfig(algorithm="fedavg", clients_per_round=2), grad_fn,
               batch_fn, num_clients=egc.C)
