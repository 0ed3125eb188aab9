"""The port's whole synchronous round on the CPU: every stateless
``__sync__`` engine golden in all three placements, the 12 stateful ones
(``scaffold``, ``fedep`` and their device-store twins, with the client
store's buffers and stamps), fault-injected and q-FFL rounds against JAX
``FedSim``, the all-dropped cohort, and the quickstart against JAX
``FedSim``.

Tolerances (fp32): params and losses to 1e-5 relative, history keys and
ints exact, as ``tests/test_torch_round.py``: the port takes the DP's
``a_t`` by conjugacy and sums in another order (the golden replays agree
to ~1e-6 relative and better). The quickstart's params after 3 rounds of
300 local steps: 1e-4 relative (its losses are ~1e5, so one fp32 rounding
of a gradient is ~1e-2 absolute; 900 steps compound it). The stateful
goldens' store buffers: 1e-5 relative; their stamps exact.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import engine_goldens_common as egc
from test_torch_round import UNIFORM_KEYS, torch_lsq_problem
from repro.configs.base import FedConfig as JaxFedConfig
from repro.core import FedSim as JaxFedSim
from repro_torch.checkpoint import leaves_with_paths
from repro_torch.configs.base import FedConfig
from repro_torch.core.round import FedSim
from repro_torch.core.round_program import make_cohort_program
from repro_torch.core.server import init_server_state
from repro_torch.examples import quickstart
from repro_torch.optim import get_optimizer

#: The stateless specs of the golden matrix (the async-only straggler spec
#: is in ``test_torch_async.py``, fedlora's goldens in
#: ``test_torch_fedlora.py``).
STATELESS = ("fedavg", "fedavg_weighted", "fedavg_dropout", "fedpa",
             "fedpa_stream", "fedprox", "mime", "fedpa_precision")
#: The stateful specs: the host store and the device store (``_dev``).
STATEFUL = ("scaffold", "fedep", "scaffold_dev", "fedep_dev")
#: Replayed at ``parallel`` by ``test_torch_round.py`` already.
ROUND_FILE = ("fedavg", "fedavg_weighted", "fedpa", "fedpa_stream")


@pytest.fixture(scope="module", autouse=True)
def _x32():
    """Other test modules turn on jax x64 at import; compare in fp32."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


@pytest.fixture(scope="module")
def lsq_problem():
    return torch_lsq_problem()


def _sim(name, placement, problem, **over):
    kwargs, weights = egc.SPECS[name]
    grad_fn, batch_fn = problem
    return FedSim(FedConfig(**{**kwargs, **over}), grad_fn, batch_fn,
                  num_clients=egc.C,
                  client_weights=(None if weights is None
                                  else np.asarray(weights, np.float32)),
                  device="cpu", placement=placement)


def _assert_history(history, g_history):
    json.dumps(history)
    assert len(history) == len(g_history)
    for rec, g_rec in zip(history, g_history):
        assert set(rec) == set(g_rec) | UNIFORM_KEYS
        for k, v in g_rec.items():
            if isinstance(v, float):
                assert rec[k] == pytest.approx(v, rel=1e-5), k
            else:
                assert rec[k] == v, k


@pytest.mark.parametrize("name,placement", [
    (n, p) for n in STATELESS for p in egc.PLACEMENTS
    if not (p == "parallel" and n in ROUND_FILE)])
def test_replays_stateless_sync_goldens(name, placement, lsq_problem):
    sim = _sim(name, placement, lsq_problem)
    state, history = sim.run(torch.zeros(egc.D), egc.ROUNDS,
                             eval_fn=lambda p: {"eval_loss": (p * p).sum()},
                             eval_every=2)
    g_arrays, g_history = egc.load_case(name, "sync", placement)
    np.testing.assert_allclose(state.params.numpy(), g_arrays["param::"],
                               rtol=1e-5)
    _assert_history(history, g_history)


@pytest.mark.parametrize("name,placement", [
    (n, p) for n in STATEFUL for p in egc.PLACEMENTS])
def test_replays_stateful_sync_goldens(name, placement, lsq_problem):
    """Params, the per-client store (``store::['buffers']...`` as the
    goldens key it) and the history; stamps exact, and no CAS drop."""
    sim = _sim(name, placement, lsq_problem)
    state, history = sim.run(torch.zeros(egc.D), egc.ROUNDS,
                             eval_fn=lambda p: {"eval_loss": (p * p).sum()},
                             eval_every=2)
    g_arrays, g_history = egc.load_case(name, "sync", placement)
    got = {"param::": state.params.numpy()}
    got.update({f"store::{path}": np.asarray(leaf) for path, leaf in
                leaves_with_paths(sim.client_store.state_dict())})
    assert set(got) == set(g_arrays)
    for key, want in g_arrays.items():
        if key == "store::['stamps']":
            np.testing.assert_array_equal(got[key], want)
        else:
            np.testing.assert_allclose(got[key], want, rtol=1e-5,
                                       err_msg=key)
    _assert_history(history, g_history)
    assert all(h["state_drops"] == 0 for h in history)


#: Faults and q-FFL beyond the goldens: q-FFL on a dropout cohort, step
#: budgets (FedPA with plain SGD), and the precision-weighted ratio under
#: diurnal availability and q-FFL. ``round_chunk_size=3`` pads the cohort
#: of 4 with two zero-weight clients at ``chunked``.
FAULT_CASES = {
    "fedavg_qffl_dropout": dict(
        algorithm="fedavg", server_opt="sgdm", server_lr=0.5, qffl_q=1.0,
        dropout_rate=0.4, **egc._OPT),
    "fedpa_budgets": dict(algorithm="fedpa", min_local_steps=6, **egc._PA),
    "fedpa_precision_qffl_diurnal": dict(
        algorithm="fedpa_precision", burn_in_rounds=1, qffl_q=1.0,
        availability="diurnal", dropout_rate=0.2, **egc._PA),
}
FAULT_ROUNDS = 3


def _jax_problem():
    grad_fn, batch_fn = egc.make_problem()

    def np_batch_fn(cid, r, steps):
        return {k: np.asarray(v) for k, v in batch_fn(cid, r, steps).items()}

    return grad_fn, np_batch_fn


@pytest.mark.parametrize("placement", egc.PLACEMENTS)
@pytest.mark.parametrize("case", sorted(FAULT_CASES))
def test_faults_and_qffl_match_jax_fedsim(case, placement, lsq_problem):
    kw = dict(FAULT_CASES[case], round_placement=placement,
              round_chunk_size=3)
    jgrad, jbatch = _jax_problem()
    jsim = JaxFedSim(JaxFedConfig(**kw), jgrad, jbatch, num_clients=egc.C)
    jstate, jhist = jsim.run(jnp.zeros(egc.D), FAULT_ROUNDS)
    grad_fn, batch_fn = lsq_problem
    sim = FedSim(FedConfig(**kw), grad_fn, batch_fn, num_clients=egc.C,
                 device="cpu")
    state, hist = sim.run(torch.zeros(egc.D), FAULT_ROUNDS)
    for r in range(FAULT_ROUNDS):
        ids, faults = sim.source.draw(r)
        j_ids, j_faults = jsim.source.draw(r)
        np.testing.assert_array_equal(ids, j_ids)
        assert faults.dropped == j_faults.dropped
    np.testing.assert_allclose(state.params.numpy(),
                               np.asarray(jstate.params), rtol=1e-5,
                               atol=1e-6)
    assert [h["dropped"] for h in hist] == [h["dropped"] for h in jhist]
    for h, jh in zip(hist, jhist):
        for k in ("loss_first", "loss_last"):
            assert h[k] == pytest.approx(jh[k], rel=1e-5, abs=1e-6), k
    assert sum(h["dropped"] for h in hist) > 0 or case == "fedpa_budgets"


@pytest.mark.parametrize("placement", egc.PLACEMENTS)
def test_all_dropped_cohort_is_a_zero_aggregate(placement, lsq_problem):
    """dropout_rate 1: every client drops, so the aggregate is zero, the
    server step leaves the params where they are, and the losses are 0.0;
    user weights that sum to zero still raise."""
    fed = FedConfig(algorithm="fedpa_precision", dropout_rate=1.0,
                    round_placement=placement, round_chunk_size=3,
                    qffl_q=1.0, **egc._PA)
    grad_fn, batch_fn = lsq_problem
    sim = FedSim(fed, grad_fn, batch_fn, num_clients=egc.C,
                 client_weights=np.arange(1, egc.C + 1, dtype=np.float32),
                 device="cpu")
    params0 = torch.linspace(-1.0, 1.0, egc.D)
    state = sim.init(params0)
    cohort = sim.cohort(0)
    assert cohort.dropped == egc.C and not cohort.survivors.any()
    cohort_fn = make_cohort_program(grad_fn, fed)
    agg, losses = cohort_fn(state, cohort.batches, cohort.weights,
                            cohort.survivors)
    for part in agg.values():
        assert torch.equal(part, torch.zeros(egc.D))
    assert float(losses["loss_first"]) == 0.0
    assert float(losses["loss_last"]) == 0.0
    state, history = sim.run(params0, 2)
    assert torch.equal(state.params, params0)
    assert [(h["dropped"], h["loss_first"], h["loss_last"])
            for h in history] == [(egc.C, 0.0, 0.0)] * 2
    with pytest.raises(ValueError, match="positive total"):
        cohort_fn(state, cohort.batches, np.zeros(egc.C, np.float32))


def test_mime_broadcasts_the_server_momentum(lsq_problem):
    """MIME's client update reads the server optimizer's momentum: after a
    round with sgdm the broadcast is the momentum buffer, not zeros, and
    the next round's aggregate moves with it."""
    fed = FedConfig(**egc.SPECS["mime"][0])
    grad_fn, batch_fn = lsq_problem
    sim = FedSim(fed, grad_fn, batch_fn, num_clients=egc.C, device="cpu")
    state = sim.init(torch.zeros(egc.D))
    state, _ = sim.round(state, 0)
    (m,) = sim._alg.broadcast(state, sim.server_opt)
    assert torch.equal(m, state.opt_state["m"]) and m.abs().sum() > 0
    opt = get_optimizer("sgdm", 0.5, 0.9)
    frozen = init_server_state(state.params, opt)
    cohort = sim.cohort(1)
    cohort_fn = make_cohort_program(grad_fn, fed, server_opt=opt)
    with_m, _ = cohort_fn(state, cohort.batches)
    without_m, _ = cohort_fn(frozen, cohort.batches)
    assert not torch.allclose(with_m, without_m)


def test_quickstart_matches_jax_fedsim_at_3_rounds():
    """FedAvg at ``parallel`` and FedPA at ``chunked`` (2 clients per
    chunk): the port's quickstart and JAX ``FedSim`` on the same numpy
    batches, 3 rounds."""
    from repro.data import make_federated_lsq as jax_lsq  # noqa: PLC0415
    from repro.data.synthetic_lsq import lsq_batches as jax_batches

    rounds = 3
    res = quickstart.run("cpu", rounds)
    _, data = jax_lsq(quickstart.N_CLIENTS, quickstart.N_PER_CLIENT,
                      quickstart.D, heterogeneity=20.0, seed=0)

    def grad_fn(params, batch):
        def loss(p):
            r = batch["x"] @ p - batch["y"]
            return 0.5 * jnp.mean(r * r) * quickstart.N_PER_CLIENT
        return jax.value_and_grad(loss)(params)

    def batch_fn(cid, round_idx, steps):
        X, y = data[cid]
        return jax_batches(X, y, batch_size=25, num_steps=steps,
                           seed=round_idx * 977 + cid)

    for name, fed in quickstart.CONFIGS.items():
        kw = {f: getattr(fed, f) for f in fed.__dataclass_fields__}
        jsim = JaxFedSim(JaxFedConfig(**kw), grad_fn, batch_fn,
                         num_clients=quickstart.N_CLIENTS)
        jstate, jhist = jsim.run(jnp.zeros(quickstart.D), rounds)
        np.testing.assert_allclose(res[name]["params"],
                                   np.asarray(jstate.params), rtol=1e-4,
                                   err_msg=name)
        for h, jh in zip(res[name]["history"], jhist):
            assert h["loss_last"] == pytest.approx(jh["loss_last"], rel=1e-4)
    assert quickstart.CONFIGS["fedpa"].round_placement == "chunked"


def test_quickstart_needs_cuda_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quickstart.main(["--rounds", "1"])
