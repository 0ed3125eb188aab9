"""FedLoRA (``algorithms/fedlora.py``) through the port's engine on the
CPU: the 6 fedlora engine goldens (``__sync__`` and ``__async2__``, three
placements) and window 0 against the ``__sync__`` ones, then, each case
against JAX ``FedSim`` on the same numpy inputs: error-feedback residuals
against an eager loop, fedlora with the identity
codec equal to ``fedpa_precision``, the 5%-loss / 8x-bytes gate with error
feedback helping, the bytes in both engines' histories and through the
burn-in, async window 3 on the matrix problem (the sketch's round is the
dispatch-time ``state.round``), ``round_bytes`` on fedlm-100m's meta tree
(the JAX package's numbers, with no Threefry or QR run), and the
algorithm's hooks. Params to 1e-5 relative; residuals, which are
differences of corrected deltas ``c``, to 1e-5 relative plus 1e-5 of the
largest ``|c|``: the residuals ``c - Q(c)`` are cut from corrected
deltas of size up to ~150 in the goldens, which the port and JAX compute
6.5e-6 apart relative to that size (the DP's own rounding, in its first
sampling round), and no quantization step flips (a flip would move a
residual by a whole ``scale``, ~1). The goldens' params and history are
held as ``test_torch_goldens.py`` holds the others'. The codecs
themselves are ``test_torch_compression.py``'s.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import engine_goldens_common as egc
from test_torch_goldens import _assert_history
from test_torch_round import torch_lsq_problem
from repro import configs as jax_configs
from repro.algorithms import get_algorithm as jax_get_algorithm
from repro.compression import round_bytes as jax_round_bytes
from repro.configs.base import FedConfig as JaxFedConfig
from repro.core import FedSim as JaxFedSim
from repro.models import model as jax_model
from repro_torch import configs
from repro_torch.algorithms import get_algorithm
from repro_torch.algorithms.fedlora import FedLoRA
from repro_torch.checkpoint import leaves_with_paths
from repro_torch.compression import round_bytes, threefry
from repro_torch.compression.lowrank import LowRankCodec
from repro_torch.configs.base import FedConfig
from repro_torch.core import tree_math as tm
from repro_torch.core.round import FedSim
from repro_torch.core.round_program import batched_grad
from repro_torch.core.server import init_server_state, normalized_weights
from repro_torch.models.model import init_params
from repro_torch.optim import get_optimizer


@pytest.fixture(scope="module", autouse=True)
def _x32():
    """Other test modules turn on jax x64 at import; compare in fp32."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


#: fedlora knobs, as ``tests/test_compression.py``
LORA_KW = dict(local_steps=6, burn_in_steps=2, steps_per_sample=2,
               shrinkage_rho=0.5, server_opt="sgd", server_lr=0.1,
               client_opt="sgd", client_lr=0.01)


def _kw(codec, **over):
    base = dict(algorithm="fedlora", payload_codec=codec, lora_rank=2,
                clients_per_round=3, **LORA_KW)
    base.update(over)
    return base


# ---------------------------------------------------------------------------
# The fedlora engine goldens
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def wire_max(monkeypatch):
    """Inside the block, FedLoRA records in the yielded list the largest
    ``|c|`` of any dequantized delta it aggregates (the scale of the
    corrected deltas its residuals are cut from)."""
    seen = [0.0]
    accum = FedLoRA.payload_accum

    def payload_accum(self, payload):
        seen[0] = max([seen[0]] + [float(x.abs().max()) for x in tm.tleaves(
            self.codec.to_accum(payload["delta"]))])
        return accum(self, payload)

    with monkeypatch.context() as m:
        m.setattr(FedLoRA, "payload_accum", payload_accum)
        yield seen


@pytest.fixture(scope="module")
def lsq_problem():
    return torch_lsq_problem()


def _golden_run(placement, problem, monkeypatch, **over):
    """The fedlora golden spec through the port's ``FedSim`` on the CPU;
    returns ``(arrays as the goldens key them, history, largest |c|)``."""
    kwargs, _ = egc.SPECS["fedlora"]
    sim = FedSim(FedConfig(**{**kwargs, **over}), *problem,
                 num_clients=egc.C, device="cpu", placement=placement)
    with wire_max(monkeypatch) as seen:
        state, history = sim.run(torch.zeros(egc.D), egc.ROUNDS,
                                 eval_fn=lambda p: {"eval_loss": (p * p)
                                                    .sum()},
                                 eval_every=2)
    got = {"param::": state.params.numpy()}
    got.update({f"store::{path}": np.asarray(leaf) for path, leaf in
                leaves_with_paths(sim.client_store.state_dict())})
    return got, history, seen[0]


def _assert_fedlora_golden(got, history, c_max, mode, placement):
    """Params to 1e-5, stamps exact, residuals to 1e-5 relative plus 1e-5
    of ``c_max`` (module docstring), the history as the other goldens."""
    g_arrays, g_history = egc.load_case("fedlora", mode, placement)
    assert set(got) == set(g_arrays)
    assert c_max > 0
    np.testing.assert_allclose(got["param::"], g_arrays["param::"],
                               rtol=1e-5)
    np.testing.assert_array_equal(got["store::['stamps']"],
                                  g_arrays["store::['stamps']"])
    np.testing.assert_allclose(got["store::['buffers']"],
                               g_arrays["store::['buffers']"], rtol=1e-5,
                               atol=1e-5 * c_max)
    _assert_history(history, g_history)


@pytest.mark.parametrize("placement", egc.PLACEMENTS)
def test_replays_fedlora_sync_goldens(placement, lsq_problem, monkeypatch):
    """lowrank+int8 at rank 2 with error feedback, two burn-in rounds: the
    goldens' (3,) vector passes the sketch (1-D), so int8, the projected
    precision and the residual store are what they pin."""
    got, history, c_max = _golden_run(placement, lsq_problem, monkeypatch)
    _assert_fedlora_golden(got, history, c_max, "sync", placement)
    assert [h["bytes_up"] for h in history] == \
        [4 * 12] * 2 + [4 * 2 * (3 + 4)] * 4


@pytest.mark.parametrize("placement", egc.PLACEMENTS)
def test_replays_fedlora_async2_goldens(placement, lsq_problem,
                                        monkeypatch):
    """Window 3, discount 0.9: each cohort encodes and decodes against its
    dispatch-time ``state.round`` (the goldens' 1-D vector is never
    sketched; the sketch's round is pinned by
    ``test_async_window_3_sketches_with_the_dispatch_round``)."""
    got, history, c_max = _golden_run(placement, lsq_problem, monkeypatch,
                                      **egc.MODES["async2"])
    _assert_fedlora_golden(got, history, c_max, "async2", placement)
    assert [h["staleness"] for h in history] == [0, 1, 2, 2, 2, 2]


@pytest.mark.parametrize("placement", egc.PLACEMENTS)
def test_fedlora_window_zero_matches_sync(placement, lsq_problem,
                                          monkeypatch):
    """``async_rounds=True, max_staleness=0`` against the ``__sync__``
    golden, and against the port's synchronous run exactly, residual store
    included."""
    got, history, c_max = _golden_run(placement, lsq_problem, monkeypatch,
                                      async_rounds=True, max_staleness=0)
    _assert_fedlora_golden(got, history, c_max, "sync", placement)
    sync_got, sync_history, _ = _golden_run(placement, lsq_problem,
                                            monkeypatch)
    for key, want in sync_got.items():
        np.testing.assert_array_equal(got[key], want, err_msg=key)
    assert history == sync_history


# ---------------------------------------------------------------------------
# The engine, against JAX FedSim
# ---------------------------------------------------------------------------

C, DIN, DOUT, N = 3, 8, 6, 48


def _matrix_data(C, din, dout, n):
    """``tests/test_compression.py``'s heterogeneous matrix LSQ, numpy."""
    rng = np.random.RandomState(0)
    w_true = rng.randn(din, dout).astype(np.float32)
    data = {}
    for cid in range(C):
        shift = rng.randn(din, dout).astype(np.float32) * 0.5
        X = rng.randn(n, din).astype(np.float32)
        y = X @ (w_true + shift) + 0.1 * rng.randn(n, dout).astype(
            np.float32)
        data[cid] = (X, y)
    return data


def _problems(data, n):
    def batch_fn(cid, r, steps):
        X, y = data[cid]
        idx = np.random.RandomState(r * 131 + cid).randint(0, n,
                                                            size=(steps, 16))
        return {"x": X[idx], "y": y[idx]}

    def loss(p, batch):
        r = batch["x"] @ p["w"] - batch["y"]
        return 0.5 * (r * r).mean()

    grad_and_value = torch.func.grad_and_value(loss)

    def grad_fn(p, batch):
        g, value = grad_and_value(p, batch)
        return value, g

    def jgrad_fn(params, batch):
        def jloss(p):
            r = batch["x"] @ p["w"] - batch["y"]
            return 0.5 * jnp.mean(r * r)
        return jax.value_and_grad(jloss)(params)

    return (grad_fn, batch_fn), (jgrad_fn, batch_fn)


@pytest.fixture(scope="module")
def matrix_problem():
    return _problems(_matrix_data(C, DIN, DOUT, N), N)


def _run_both(kw, problems, rounds, num_clients=C, params=None):
    """The port's and JAX's FedSim on the same config and numpy batches."""
    (grad_fn, batch_fn), (jgrad_fn, jbatch_fn) = problems
    din, dout = (DIN, DOUT) if params is None else params
    sim = FedSim(FedConfig(**kw), grad_fn, batch_fn,
                 num_clients=num_clients, device="cpu")
    state, hist = sim.run({"w": torch.zeros(din, dout)}, rounds)
    jsim = JaxFedSim(JaxFedConfig(**kw), jgrad_fn, jbatch_fn,
                     num_clients=num_clients)
    jstate, jhist = jsim.run({"w": jnp.zeros((din, dout))}, rounds)
    return (sim, state, hist), (jsim, jstate, jhist)


def _assert_residuals(sim, jsim, c_max):
    got = sim.client_store.state_dict()
    want = jsim.client_store.state_dict()
    np.testing.assert_array_equal(got["stamps"], np.asarray(want["stamps"]))
    np.testing.assert_allclose(got["buffers"]["w"],
                               np.asarray(want["buffers"]["w"]), rtol=1e-5,
                               atol=1e-5 * c_max)


def test_error_feedback_residuals_match_eager_loop_and_jax(matrix_problem,
                                                           monkeypatch):
    """Two rounds at ``parallel``: the store's residuals and the params
    equal an eager loop that threads ``residual -> update ->
    state_update`` client by client through the same hooks, and JAX
    ``FedSim``'s."""
    kw = _kw("lowrank+int8", round_placement="parallel")
    (grad_fn, batch_fn), _ = matrix_problem
    with wire_max(monkeypatch) as seen:
        (sim, state, _), (jsim, jstate, _) = _run_both(kw, matrix_problem, 2)
    fed = sim.fed
    alg = get_algorithm(fed)
    client_opt = get_optimizer(fed.client_opt, fed.client_lr,
                               fed.client_momentum)
    server_opt = get_optimizer(fed.server_opt, fed.server_lr,
                               fed.server_momentum)
    update = alg.make_client_update(batched_grad(grad_fn), client_opt)
    params0 = {"w": torch.zeros(DIN, DOUT)}
    ref = init_server_state(params0, server_opt, algorithm=alg)
    residuals = {c: tm.tbroadcast(alg.init_client_state(params0), 1)
                 for c in range(C)}
    with torch.no_grad():
        for r in range(2):
            ids = [int(i) for i in sim.sampler.sample(r)]
            extras = alg.broadcast(ref, server_opt)
            payloads = []
            for cid in ids:
                batches = tm.tmap(lambda a: torch.from_numpy(a[None]),
                                  batch_fn(cid, r, fed.local_steps))
                res = update(ref.params, batches, residuals[cid], *extras)
                payloads.append(res.payload)
                residuals[cid] = res.state_update
            stacked = tm.tmap(lambda *xs: torch.cat(xs), *payloads)
            agg = alg.reduce_stacked(stacked, normalized_weights(None, C))
            ref = alg.server_update(ref, alg.finish_cohort(ref, agg),
                                    server_opt)
    torch.testing.assert_close(state.params["w"], ref.params["w"],
                               rtol=1e-6, atol=1e-7)
    got, _ = sim.client_store.gather(np.arange(C))
    for cid in range(C):
        want = residuals[cid]["w"][0].numpy()
        assert np.abs(want).max() > 1e-4
        np.testing.assert_allclose(got["w"][cid], want, rtol=1e-6,
                                   atol=1e-7)
    np.testing.assert_allclose(state.params["w"].numpy(),
                               np.asarray(jstate.params["w"]), rtol=1e-5,
                               atol=1e-6)
    _assert_residuals(sim, jsim, seen[0])


def test_identity_codec_is_fedpa_precision(matrix_problem):
    """``payload_codec='none'`` without error feedback is
    ``fedpa_precision``, in the port and against JAX's fedlora."""
    kw = dict(clients_per_round=C, **LORA_KW)
    lora = dict(algorithm="fedlora", payload_codec="none",
                error_feedback=False, **kw)
    (sim, state, _), (_, jstate, _) = _run_both(lora, matrix_problem, 3)
    assert sim.client_store is None
    dense = FedSim(FedConfig(algorithm="fedpa_precision", **kw),
                   *matrix_problem[0], num_clients=C, device="cpu")
    dstate, _ = dense.run({"w": torch.zeros(DIN, DOUT)}, 3)
    torch.testing.assert_close(state.params["w"], dstate.params["w"],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(state.params["w"].numpy(),
                               np.asarray(jstate.params["w"]), rtol=1e-5,
                               atol=1e-6)


def _final_loss(w, data):
    return float(np.mean([0.5 * np.mean((X @ w - y) ** 2)
                          for X, y in data.values()]))


def test_acceptance_within_5pct_at_8x_fewer_bytes(record_property):
    """Heterogeneous matrix LSQ (6 clients, (32, 16)): lowrank+int8 at rank
    4 within 5% of dense ``fedpa_precision``'s final loss at >= 8x fewer
    uplink bytes, error feedback closing a measurable gap; the same three
    runs in JAX land on the same losses (lowrank+int8 may flip a
    quantization step, so to 1e-2 relative; the largest gap is
    recorded)."""
    c, din, dout, n = 6, 32, 16, 64
    data = _matrix_data(c, din, dout, n)
    problems = _problems(data, n)
    kw = dict(clients_per_round=c, local_steps=12, burn_in_steps=4,
              steps_per_sample=2, shrinkage_rho=0.3, burn_in_rounds=2,
              server_opt="sgd", server_lr=0.5, client_opt="sgd",
              client_lr=0.05)
    runs = {"dense": dict(algorithm="fedpa_precision", **kw),
            "lora": dict(algorithm="fedlora", payload_codec="lowrank+int8",
                         lora_rank=4, **kw),
            "noef": dict(algorithm="fedlora", payload_codec="lowrank+int8",
                         lora_rank=4, error_feedback=False, **kw)}
    loss, jloss, hist = {}, {}, {}
    for name, run_kw in runs.items():
        (_, state, h), (_, jstate, jh) = _run_both(
            run_kw, problems, 50, num_clients=c, params=(din, dout))
        loss[name] = _final_loss(state.params["w"].numpy(), data)
        jloss[name] = _final_loss(np.asarray(jstate.params["w"]), data)
        hist[name] = h
        assert [r["bytes_up"] for r in h] == [r["bytes_up"] for r in jh]
    gap = max(abs(loss[k] - jloss[k]) / jloss[k] for k in loss)
    record_property("largest_loss_gap_vs_jax", gap)
    assert gap <= 1e-2, (loss, jloss)
    assert loss["lora"] <= loss["dense"] * 1.05, loss
    assert hist["dense"][-1]["bytes_up"] / hist["lora"][-1]["bytes_up"] >= 8
    assert loss["noef"] > loss["lora"] * 1.2, loss


@pytest.mark.parametrize("name", ["fedavg", "scaffold", "fedlora",
                                  "fedlora_burn", "fedlora_async"])
def test_history_bytes_equal_jax(name, matrix_problem):
    """Every algorithm's records carry ``round_bytes`` as ints, equal to
    JAX's; fedlora's burn-in round is dense FedAvg; the async engine
    stamps the same bytes."""
    kws = {
        "fedavg": dict(algorithm="fedavg", clients_per_round=C,
                       local_steps=4, client_opt="sgd", client_lr=0.05),
        "scaffold": dict(algorithm="scaffold", clients_per_round=C,
                         local_steps=4, client_opt="sgd", client_lr=0.05),
        "fedlora": _kw("lowrank+int8"),
        "fedlora_burn": _kw("lowrank+int8", burn_in_rounds=1),
        "fedlora_async": _kw("lowrank+int8", async_rounds=True,
                             max_staleness=0, prefetch_rounds=2,
                             prefetch_backend="thread"),
    }
    (sim, _, hist), (_, _, jhist) = _run_both(kws[name], matrix_problem, 3)
    params = {"w": torch.zeros(DIN, DOUT)}
    want = round_bytes(sim.fed, params)
    burn = round_bytes(sim.fed, params, use_sampling=False)
    for r, (h, jh) in enumerate(zip(hist, jhist)):
        assert type(h["bytes_up"]) is int
        assert (h["bytes_up"], h["bytes_down"]) == (jh["bytes_up"],
                                                    jh["bytes_down"])
        rb = burn if r < sim.fed.burn_in_rounds else want
        assert (h["bytes_up"], h["bytes_down"]) == (rb["bytes_up"],
                                                    rb["bytes_down"])
    if name == "fedlora_burn":
        assert hist[0]["bytes_up"] > hist[1]["bytes_up"] == \
            hist[2]["bytes_up"]
    if name == "fedlora":
        # the i32 round index rides down beside the params
        assert hist[0]["bytes_down"] == C * (4 * DIN * DOUT + 4)


def test_async_window_3_sketches_with_the_dispatch_round(matrix_problem,
                                                         monkeypatch):
    """Window 3 (``max_staleness=2``), lowrank at rank 2 with error
    feedback: rounds 0-2 dispatch against ``state.round = 0``, so they
    encode and decode against round 0's sketch; params and residuals equal
    JAX ``FedSim``'s. A codec keyed by the engine's round index would
    decode rounds 1 and 2 in other sketches."""
    kw = _kw("lowrank", round_placement="parallel", async_rounds=True,
             max_staleness=2, staleness_discount=0.9,
             prefetch_backend="thread")
    rounds = []
    basis = LowRankCodec._basis

    def spy(self, last_dim, round_idx, leaf_idx, device):
        rounds.append(int(round_idx))
        return basis(self, last_dim, round_idx, leaf_idx, device)

    monkeypatch.setattr(LowRankCodec, "_basis", spy)
    with wire_max(monkeypatch) as seen:
        (sim, state, hist), (jsim, jstate, jhist) = _run_both(
            kw, matrix_problem, 5)
    assert [h["staleness"] for h in hist] == [h["staleness"]
                                              for h in jhist] == \
        [0, 1, 2, 2, 2]
    assert sorted(set(rounds)) == [0, 1, 2]
    np.testing.assert_allclose(state.params["w"].numpy(),
                               np.asarray(jstate.params["w"]), rtol=1e-5,
                               atol=1e-6)
    _assert_residuals(sim, jsim, seen[0])


# ---------------------------------------------------------------------------
# Bytes of the full-width fedlm-100m, on meta tensors
# ---------------------------------------------------------------------------

#: per-client uplink of the fedlm-100m tree (d = 100,684,032), as the JAX
#: package's ``round_bytes`` gives them
FEDLM_UP = {("fedpa_precision", "none"): 805_472_256,
            ("fedlora", "lowrank"): 3_612_160,
            ("fedlora", "lowrank+int8"): 903_144,
            ("fedlora", "int8"): 201_368_168}


@pytest.mark.parametrize("alg,codec", sorted(FEDLM_UP))
def test_round_bytes_of_fedlm_100m_equal_jax(alg, codec, monkeypatch):
    kw = dict(algorithm=alg, payload_codec=codec, lora_rank=4,
              clients_per_round=4, local_steps=12, burn_in_steps=4,
              steps_per_sample=2, burn_in_rounds=1)
    jparams = jax.eval_shape(lambda: jax_model.init_params(
        jax.random.PRNGKey(0), jax_configs.get_config("fedlm-100m")))
    want = jax_round_bytes(JaxFedConfig(**kw), jparams)
    jburn = jax_round_bytes(JaxFedConfig(**kw), jparams, use_sampling=False)

    def refuse(*a, **k):
        raise AssertionError("the meta path ran a sketch")

    monkeypatch.setattr(threefry, "normal", refuse)
    monkeypatch.setattr(torch.linalg, "qr", refuse)
    params = init_params(None, configs.get_config("fedlm-100m"),
                         device="meta")
    got = round_bytes(FedConfig(**kw), params)
    burn = round_bytes(FedConfig(**kw), params, use_sampling=False)
    assert got == want and burn == jburn
    assert got["bytes_up_per_client"] == FEDLM_UP[(alg, codec)]
    assert got["bytes_down_per_client"] == 402_736_128 + 4 * (
        alg == "fedlora")
    assert burn["bytes_up_per_client"] == burn["bytes_down_per_client"] \
        == 402_736_128


def test_fedlora_hooks_mirror_jax():
    """Stateful only with error feedback; the burn-in regime is dense
    FedAvg; one i32 scalar rides down."""
    for ef in (True, False):
        kw = _kw("lowrank+int8", error_feedback=ef, burn_in_rounds=1)
        alg, jalg = get_algorithm(FedConfig(**kw)), jax_get_algorithm(
            JaxFedConfig(**kw))
        assert alg.stateful == jalg.stateful == ef
        burn, jburn = alg.burn_algorithm(), jalg.burn_algorithm()
        assert burn.name == jburn.name == "fedavg"
        assert dataclasses.asdict(burn.fed) == dataclasses.asdict(jburn.fed)
        (extra,) = alg.abstract_broadcast_extras(None)
        assert (extra.shape, extra.dtype) == ((), torch.int32)
