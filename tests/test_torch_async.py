"""The port's staleness-general engine on the CPU: the 39 ``__async2__``
engine goldens (every spec but fedlora, ``fedavg_straggler`` included) in
all three placements, ``async_rounds=True, max_staleness=0`` against the
``__sync__`` goldens, the straggler draws against JAX ``CohortSource``'s,
an async FedPA run with stragglers and dropout against JAX ``FedSim``,
and the engine's behaviour as ``tests/test_async_engine.py`` pins it for
the reference (staleness ramp, discount, eval history, knob validation).
Cohorts are built inline or on the thread prefetcher: nothing here starts
a process (``tests/test_torch_prefetch.py`` runs the process backend in
a subprocess).

Tolerances (fp32), as ``tests/test_torch_goldens.py``: params and losses
to 1e-5 relative, ints, ``staleness``, ``straggled``, ``dropped`` and
``state_drops`` exact, stamps exact. The stores' buffers to 1e-5
relative plus 1e-5 of the buffer's largest entry: after the async
rounds, FedEP's ``num`` has an entry of -1.15 beside entries of -309 in
the same row, where the port and the golden differ by 1.9e-4 — and a
float64 run of the same rounds lies 5.5e-4 from both fp32 results, so
that is rounding, not a fault (the absolute part scales as
``tests/test_torch_kernels.py`` scales its own;
``test_float64_run_lands_within_store_tolerance`` holds the float64 run
to it). The window-0 runs take the stages the synchronous runs take, a
fresh delta undiscounted, so they equal the port's own synchronous runs
exactly.
"""
import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import engine_goldens_common as egc
from test_torch_goldens import _jax_problem
from test_torch_round import UNIFORM_KEYS, torch_lsq_problem
from repro.configs.base import FedConfig as JaxFedConfig
from repro.core import FedSim as JaxFedSim
from repro.data.cohort_source import CohortSource as JaxCohortSource
from repro_torch.checkpoint import leaves_with_paths
from repro_torch.configs.base import FedConfig
from repro_torch.core.async_engine import AsyncRoundEngine
from repro_torch.core.engine import RoundEngine
from repro_torch.core.round import FedSim
from repro_torch.data.cohort_source import CohortSource

#: Every spec of the golden matrix but fedlora (ROADMAP.md queue 1, item 9).
PORTED = tuple(n for n in egc.SPECS if n != "fedlora")
#: The specs that also have ``__sync__`` goldens.
SYNC_SPECS = tuple(n for n in PORTED if n not in egc.ASYNC_ONLY)


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


def _run(sim):
    return sim.run(torch.zeros(egc.D), egc.ROUNDS,
                   eval_fn=lambda p: {"eval_loss": (p * p).sum()},
                   eval_every=2)


def _arrays(sim, state):
    """``{"param::": ..., "store::<path>": ...}`` as the goldens key them."""
    got = {"param::": state.params.numpy()}
    if sim.client_store is not None:
        got.update({f"store::{path}": np.asarray(leaf) for path, leaf in
                    leaves_with_paths(sim.client_store.state_dict())})
    return got


def _assert_arrays(got, g_arrays):
    assert set(got) == set(g_arrays)
    for key, want in g_arrays.items():
        if key == "store::['stamps']":
            np.testing.assert_array_equal(got[key], want)
        elif key.startswith("store::"):
            np.testing.assert_allclose(got[key], want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max(),
                                       err_msg=key)
        else:
            np.testing.assert_allclose(got[key], want, rtol=1e-5,
                                       err_msg=key)


def _assert_golden(got, history, g_arrays, g_history):
    _assert_arrays(got, g_arrays)
    json.dumps(history)
    assert len(history) == len(g_history)
    for rec, g_rec in zip(history, g_history):
        assert set(rec) == set(g_rec) | UNIFORM_KEYS
        for k, v in g_rec.items():
            if isinstance(v, float):
                assert rec[k] == pytest.approx(v, rel=1e-5), k
            else:
                assert rec[k] == v, k


@pytest.mark.parametrize("placement", egc.PLACEMENTS)
@pytest.mark.parametrize("name", PORTED)
def test_replays_async2_goldens(name, placement, lsq_problem):
    """Window 3, discount 0.9: params, stores, and the history with its
    staleness ramp, straggler lateness and CAS drops."""
    sim = _sim(name, placement, lsq_problem, **egc.MODES["async2"])
    state, history = _run(sim)
    g_arrays, g_history = egc.load_case(name, "async2", placement)
    _assert_golden(_arrays(sim, state), history, g_arrays, g_history)


@pytest.mark.parametrize("name", ["fedep", "fedep_dev", "scaffold",
                                  "scaffold_dev"])
def test_float64_run_lands_within_store_tolerance(name, lsq_problem):
    """The witness for the stores' absolute tolerance: the same async
    rounds with float64 params and batches land within it of the fp32
    golden and of the port's fp32 run, so a gap that size is rounding."""
    grad_fn, batch_fn = lsq_problem

    def batch64(cid, r, steps):
        return {k: np.asarray(v, np.float64)
                for k, v in batch_fn(cid, r, steps).items()}

    runs = []
    for problem, dtype in (((grad_fn, batch64), torch.float64),
                           (lsq_problem, torch.float32)):
        sim = _sim(name, "parallel", problem, **egc.MODES["async2"])
        state, _ = sim.run(torch.zeros(egc.D, dtype=dtype), egc.ROUNDS)
        runs.append(_arrays(sim, state))
    f64, f32 = runs
    assert f64["param::"].dtype == np.float64
    g_arrays, _ = egc.load_case(name, "async2", "parallel")
    _assert_arrays(f64, g_arrays)
    _assert_arrays(f64, f32)


@pytest.mark.parametrize("placement", egc.PLACEMENTS)
def test_fedlora_async2_goldens_wait_for_item_9(placement):
    pytest.skip("fedlora and its codecs are not ported yet (ROADMAP.md "
                "queue 1, item 9)")


@pytest.mark.parametrize("placement", egc.PLACEMENTS)
@pytest.mark.parametrize("name", SYNC_SPECS)
def test_window_zero_matches_sync(name, placement, lsq_problem):
    """``async_rounds=True, max_staleness=0`` against the ``__sync__``
    goldens (tolerance), and against the port's synchronous run exactly:
    both take the same stages, with no discount on a fresh delta."""
    sync_sim = _sim(name, placement, lsq_problem)
    sync_state, sync_hist = _run(sync_sim)
    sim = _sim(name, placement, lsq_problem, async_rounds=True,
               max_staleness=0)
    state, history = _run(sim)
    g_arrays, g_history = egc.load_case(name, "sync", placement)
    got = _arrays(sim, state)
    _assert_golden(got, history, g_arrays, g_history)
    for key, want in _arrays(sync_sim, sync_state).items():
        np.testing.assert_array_equal(got[key], want, err_msg=key)
    assert history == sync_hist


#: Straggler configurations (async only), with dropout and diurnal
#: availability beside them.
STRAGGLERS = {
    "straggler": dict(straggler_rate=0.5, straggler_max_lateness=2),
    "straggler_lateness_4": dict(straggler_rate=0.3,
                                 straggler_max_lateness=4),
    "all": dict(straggler_rate=0.6, straggler_max_lateness=3,
                dropout_rate=0.25, availability="diurnal",
                availability_period=4, availability_duty=0.5),
}


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("faults", sorted(STRAGGLERS))
def test_straggler_draws_equal_jax(faults, seed):
    kw = dict(algorithm="fedavg", clients_per_round=3, local_steps=2,
              async_rounds=True, **STRAGGLERS[faults])

    def stack(ids, r):
        return {"x": np.full((len(ids), 2), r, np.float32)}

    port = CohortSource(FedConfig(**kw), 8, stack, seed=seed)
    ref = JaxCohortSource(JaxFedConfig(**kw), 8, stack, seed=seed)
    late = []
    for r in range(16):
        ids, f = port.draw(r)
        j_ids, jf = ref.draw(r)
        np.testing.assert_array_equal(ids, j_ids)
        assert (f.extra_staleness, f.dropped) == (jf.extra_staleness,
                                                  jf.dropped)
        c, jc = port.cohort(r), ref.cohort(r)
        assert (c.extra_staleness, c.dropped) == (jc.extra_staleness,
                                                  jc.dropped)
        late.append(f.extra_staleness)
    lateness = STRAGGLERS[faults]["straggler_max_lateness"]
    assert 0 < sum(x > 0 for x in late) < 16
    assert max(late) <= lateness


@pytest.mark.parametrize("placement", egc.PLACEMENTS)
def test_async_fedpa_with_faults_matches_jax_fedsim(placement, lsq_problem):
    """Stragglers, dropout and a window of 2 beyond the goldens: FedPA with
    a burn-in round, against JAX ``FedSim`` on the same numpy batches."""
    kw = dict(egc.SPECS["fedpa"][0], burn_in_rounds=1, async_rounds=True,
              max_staleness=1, staleness_discount=0.8, straggler_rate=0.5,
              straggler_max_lateness=2, dropout_rate=0.3,
              round_placement=placement, round_chunk_size=3)
    rounds = 5
    jgrad, jbatch = _jax_problem()
    jsim = JaxFedSim(JaxFedConfig(**kw), jgrad, jbatch, num_clients=egc.C,
                     seed=3)
    jstate, jhist = jsim.run(jnp.zeros(egc.D), rounds)
    grad_fn, batch_fn = lsq_problem
    sim = FedSim(FedConfig(**kw), grad_fn, batch_fn, num_clients=egc.C,
                 seed=3, device="cpu")
    state, hist = sim.run(torch.zeros(egc.D), rounds)
    np.testing.assert_allclose(state.params.numpy(),
                               np.asarray(jstate.params), rtol=1e-5,
                               atol=1e-6)
    for k in ("round", "staleness", "straggled", "dropped"):
        assert [h[k] for h in hist] == [h[k] for h in jhist], k
    for h, jh in zip(hist, jhist):
        for k in ("loss_first", "loss_last"):
            assert h[k] == pytest.approx(jh[k], rel=1e-5, abs=1e-6), k
    assert sum(h["straggled"] for h in hist) > 0
    assert sum(h["dropped"] for h in hist) > 0


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("name", ["fedavg", "fedpa", "fedpa_stream"])
def test_staleness_zero_matches_sync_with_prefetch(name, prefetch,
                                                   lsq_problem):
    """``max_staleness=0`` equals the synchronous run exactly, with the
    cohorts built inline or two rounds ahead on the thread prefetcher."""
    want, _ = _sim(name, "parallel", lsq_problem).run(torch.zeros(egc.D),
                                                      egc.ROUNDS)
    sim = _sim(name, "parallel", lsq_problem, async_rounds=True,
               max_staleness=0, prefetch_rounds=prefetch,
               prefetch_backend="thread")
    got, hist = sim.run(torch.zeros(egc.D), egc.ROUNDS)
    assert torch.equal(got.params, want.params)
    assert [h["staleness"] for h in hist] == [0] * egc.ROUNDS


def test_staleness_ramp_and_history(lsq_problem):
    """Pipeline depth max_staleness + 1: staleness ramps 0, 1, .., s and
    stays; the thread prefetcher changes no number."""
    runs = [_sim("fedavg", "parallel", lsq_problem, async_rounds=True,
                 max_staleness=2, prefetch_rounds=p,
                 prefetch_backend="thread").run(torch.zeros(egc.D),
                                                egc.ROUNDS)
            for p in (0, 2)]
    for _, hist in runs:
        assert [h["staleness"] for h in hist] == [0, 1, 2, 2, 2, 2]
        for h in hist:
            assert math.isfinite(h["loss_first"])
            assert math.isfinite(h["loss_last"])
    assert torch.equal(runs[0][0].params, runs[1][0].params)


def test_staleness_discount_downweights_stale_deltas(lsq_problem):
    """discount 0 zeroes every stale delta: with an SGD server, the params
    move only on the staleness-0 round, the first one."""
    over = dict(server_opt="sgd")
    sim = _sim("fedavg", "parallel", lsq_problem, async_rounds=True,
               max_staleness=1, staleness_discount=0.0, **over)
    state, hist = sim.run(torch.zeros(egc.D), 4)
    assert [h["staleness"] for h in hist] == [0, 1, 1, 1]
    sync = _sim("fedavg", "parallel", lsq_problem, **over)
    one, _ = sync.round(sync.init(torch.zeros(egc.D)), 0)
    torch.testing.assert_close(state.params, one.params, rtol=1e-6,
                               atol=0.0)


@pytest.mark.parametrize("async_mode", [False, True], ids=["sync", "async"])
def test_history_eval_metrics_are_json(async_mode, lsq_problem):
    sim = _sim("fedavg", "parallel", lsq_problem, async_rounds=async_mode)

    def eval_fn(params):
        return {"eval_loss": (params * params).sum(),
                "param_head": params[:2]}

    _, hist = sim.run(torch.zeros(egc.D), 4, eval_fn=eval_fn, eval_every=2)
    json.dumps(hist)
    for h in hist:
        for v in h.values():
            assert isinstance(v, (int, float, list)), (type(v), h)
    assert "eval_loss" in hist[0] and "eval_loss" not in hist[1]
    assert isinstance(hist[0]["eval_loss"], float)
    assert isinstance(hist[0]["param_head"], list)
    assert len(hist[0]["param_head"]) == 2


@pytest.mark.parametrize("async_mode", [False, True], ids=["sync", "async"])
@pytest.mark.parametrize("eval_every", [0, -1])
def test_run_rejects_nonpositive_eval_every(async_mode, eval_every,
                                            lsq_problem):
    sim = _sim("fedavg", "parallel", lsq_problem, async_rounds=async_mode)
    with pytest.raises(ValueError, match="eval_every"):
        sim.run(torch.zeros(egc.D), 2, eval_fn=lambda p: {"e": 0.0},
                eval_every=eval_every)
    _, hist = sim.run(torch.zeros(egc.D), 1, eval_fn=None,
                      eval_every=eval_every)
    assert len(hist) == 1


def _noop(*args):
    del args


def test_engine_validates_knobs():
    """As the reference's engine and config: bad knobs raise
    ``ValueError``, and so does an engine missing a stage."""
    for kw in (dict(max_staleness=-1), dict(staleness_discount=1.5)):
        with pytest.raises(ValueError):
            AsyncRoundEngine(cohort_fn=_noop, server_fn=_noop, **kw)
    for kw in (dict(max_staleness=-1), dict(staleness_discount=-0.1),
               dict(prefetch_rounds=-1)):
        with pytest.raises(ValueError):
            FedConfig(**kw)
        with pytest.raises(ValueError):
            JaxFedConfig(**kw)
    for kw in (dict(cohort_fn=_noop, server_fn=None),
               dict(cohort_fn=None, server_fn=_noop)):
        with pytest.raises(ValueError, match="both stages"):
            RoundEngine(**kw)
    assert AsyncRoundEngine(cohort_fn=_noop, server_fn=_noop).max_staleness \
        == 1
    assert RoundEngine(cohort_fn=_noop, server_fn=_noop).max_staleness == 0


def test_device_store_drops_stay_on_the_device_until_history(lsq_problem):
    """FedEP on the device store, window 3: each raw record's
    ``state_drops`` is a tensor (no per-round host read) and the finished
    history holds the golden's ints."""
    sim = _sim("fedep_dev", "parallel", lsq_problem, **egc.MODES["async2"])
    raw = []
    state = sim.init(torch.zeros(egc.D))
    _, history = sim.engine.run(state, sim.source.cohort, egc.ROUNDS,
                                on_round=lambda rec, s: raw.append(rec))
    stateful = [rec["state_drops"] for rec in raw[2:]]   # after burn-in
    assert all(isinstance(d, torch.Tensor) for d in stateful)
    _, g_history = egc.load_case("fedep_dev", "async2", "parallel")
    assert [h["state_drops"] for h in history] == \
        [h.get("state_drops", 0) for h in g_history]
    assert sum(h["state_drops"] for h in history) > 0


def test_async_fields_reach_the_engine(lsq_problem):
    fed_kw = dict(async_rounds=True, max_staleness=2, staleness_discount=0.5,
                  prefetch_rounds=3, prefetch_backend="thread",
                  straggler_rate=0.1)
    eng = _sim("fedavg", "parallel", lsq_problem, **fed_kw).engine
    got = {f.name: getattr(eng, f.name) for f in dataclasses.fields(eng)}
    assert (got["max_staleness"], got["staleness_discount"],
            got["prefetch_rounds"], got["prefetch_backend"]) == \
        (2, 0.5, 3, "thread")
    assert got["cohort_fn"] is not None and got["server_fn"] is not None
    sync = _sim("fedavg", "parallel", lsq_problem).engine
    assert sync.max_staleness == 0
