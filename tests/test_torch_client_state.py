"""The port's per-client state (``repro_torch.core.client_state``) against
the JAX package's, on the CPU: the store contract run on both port
placements (the device store on ``device="cpu"`` tensors) and on both JAX
stores with the same numpy operations, the stateful algorithms' fp32
state, the stateful round's signatures, and host-store against
device-store FedSim runs, bitwise, in every placement with dropped clients
and a padded chunk.

The store operations move data and compare integers, so every store must
give the same values exactly; the FedSim runs of the two port placements
are bitwise equal (the same arithmetic on the same device).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import engine_goldens_common as egc
from test_torch_round import torch_lsq_problem
from repro.algorithms import get_algorithm as jax_get_algorithm
from repro.configs.base import FedConfig as JaxFedConfig
from repro.core import client_state as jax_cs
from repro_torch.algorithms import get_algorithm
from repro_torch.configs.base import FedConfig
from repro_torch.core import client_state as cs
from repro_torch.core import tree_math as tm
from repro_torch.core.round import FedSim
from repro_torch.core.round_program import (make_cohort_program,
                                            make_round_program)
from repro_torch.core.server import init_server_state
from repro_torch.optim import get_optimizer

#: Every store the contract is held on: the port's two placements and the
#: JAX package's two, built for a population of ``n``.
STORES = {
    "torch-host": lambda n: cs.ClientStateStore(n),
    "torch-device": lambda n: cs.DeviceClientStateStore(n, device="cpu"),
    "jax-host": lambda n: jax_cs.ClientStateStore(n),
    "jax-device": lambda n: jax_cs.DeviceClientStateStore(n),
}
ALL_STORES = pytest.mark.parametrize("kind", sorted(STORES))

SCAFFOLD = dict(algorithm="scaffold", clients_per_round=4, local_steps=12,
                server_opt="sgd", server_lr=0.1, client_opt="sgd",
                client_lr=0.01)
FEDEP = dict(algorithm="fedep", clients_per_round=4, local_steps=12,
             burn_in_steps=4, steps_per_sample=2, shrinkage_rho=0.5,
             burn_in_rounds=1, fedep_damping=0.7, server_opt="sgd",
             server_lr=0.1, client_opt="sgd", client_lr=0.01)


@pytest.fixture(scope="module", autouse=True)
def _x32():
    """Other test modules turn on jax x64 at import; compare in fp32."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _np(x):
    """A numpy view of a store output (torch tensor, jax or numpy array)."""
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _flat(tree):
    return np.ravel(_np(tree))


@ALL_STORES
def test_store_lazy_init_gather_scatter(kind):
    store = STORES[kind](6)
    assert not store.initialized
    with pytest.raises(RuntimeError, match="uninitialized"):
        store.gather([0])
    template = {"c": np.zeros(2, np.float32), "n": np.zeros((), np.int32)}
    store.ensure(template)
    store.ensure(template)  # idempotent
    assert store.initialized

    states, stamps = store.gather([1, 4])
    np.testing.assert_array_equal(_np(states["c"]), np.zeros((2, 2)))
    np.testing.assert_array_equal(_np(stamps), [0, 0])

    upd = {"c": np.asarray([[1.0, 2.0], [3.0, 4.0]], np.float32),
           "n": np.asarray([7, 8], np.int32)}
    assert store.scatter([1, 4], upd, stamps) == 0
    got, stamps2 = store.gather([4, 1])
    np.testing.assert_array_equal(_np(got["c"]), [[3.0, 4.0], [1.0, 2.0]])
    np.testing.assert_array_equal(_np(got["n"]), [8, 7])
    np.testing.assert_array_equal(_np(stamps2), [1, 1])
    # untouched clients stay zero
    np.testing.assert_array_equal(_np(store.gather([0])[0]["c"]),
                                  np.zeros((1, 2)))


@ALL_STORES
def test_store_overlap_write_is_dropped_not_clobbered(kind):
    """Two cohorts gather the same client before either writes: the write
    applied second is dropped, so the first applied update is never
    lost."""
    store = STORES[kind](3).ensure(np.zeros(1, np.float32))
    _, stamps_a = store.gather([0, 1])
    _, stamps_b = store.gather([0, 2])          # overlaps client 0
    one = np.asarray([[1.0], [1.0]], np.float32)
    assert store.scatter([0, 1], one, stamps_a) == 0
    # cohort B gathered before A wrote: its client-0 write is dropped
    assert store.scatter([0, 2], np.asarray([[9.0], [2.0]], np.float32),
                         stamps_b) == 1
    np.testing.assert_array_equal(_flat(store.gather([0, 1, 2])[0]),
                                  [1.0, 1.0, 2.0])
    # a gather after A's write sees the new stamp and may overwrite
    _, stamps_c = store.gather([0])
    assert store.scatter([0], np.asarray([[5.0]], np.float32),
                         stamps_c) == 0
    np.testing.assert_array_equal(_flat(store.gather([0])[0]), [5.0])


@ALL_STORES
def test_store_reset_and_unconditional_scatter(kind):
    store = STORES[kind](2).ensure(np.zeros(1, np.float32))
    store.scatter([0], np.asarray([[3.0]], np.float32))   # always writes
    np.testing.assert_array_equal(_flat(store.gather([0])[0]), [3.0])
    store.reset()
    states, stamps = store.gather([0, 1])
    np.testing.assert_array_equal(_np(states), np.zeros((2, 1)))
    np.testing.assert_array_equal(_np(stamps), [0, 0])


@ALL_STORES
def test_store_scatter_rejects_duplicate_client_ids(kind):
    store = STORES[kind](4).ensure(np.zeros(1, np.float32))
    upd = np.asarray([[1.0], [2.0], [3.0]], np.float32)
    with pytest.raises(ValueError, match="duplicate client ids"):
        store.scatter([1, 2, 1], upd)
    _, stamps = store.gather([1, 2, 1])
    with pytest.raises(ValueError, match="duplicate client ids"):
        store.scatter([1, 2, 1], upd, stamps)
    # the failed scatters wrote and bumped nothing
    states, stamps = store.gather([1, 2])
    np.testing.assert_array_equal(_np(states), np.zeros((2, 1)))
    np.testing.assert_array_equal(_np(stamps), [0, 0])
    assert store.scatter([1, 2], upd[:2]) == 0


@pytest.mark.parametrize("kind", ["torch-host", "torch-device", "jax-host"])
def test_store_write_mask_suppresses_writes_without_drops(kind):
    """A masked-out (dropped) client neither writes nor bumps its stamp,
    and does not count as a CAS drop; a stale survivor still does."""
    store = STORES[kind](4).ensure(np.zeros(1, np.float32))
    _, stale = store.gather([3])
    store.scatter([3], np.asarray([[4.0]], np.float32), stale)
    _, stamps = store.gather([0, 1, 2])
    stamps = _np(stamps).copy()
    upd = np.asarray([[1.0], [2.0], [3.0], [9.0]], np.float32)
    drops = store.scatter([0, 1, 2, 3], upd,
                          np.concatenate([stamps, _np(stale)]),
                          write_mask=np.asarray([1.0, 0.0, 1.0, 1.0],
                                                np.float32))
    assert drops == 1                       # client 3's stale write
    states, stamps = store.gather([0, 1, 2, 3])
    np.testing.assert_array_equal(_flat(states), [1.0, 0.0, 3.0, 4.0])
    np.testing.assert_array_equal(_np(stamps), [1, 0, 1, 1])


def test_device_store_prepare_ids_validates():
    store = cs.DeviceClientStateStore(4, device="cpu").ensure(
        np.zeros(1, np.float32))
    with pytest.raises(ValueError, match="duplicate client ids"):
        store.prepare_ids([0, 0, 1])
    with pytest.raises(ValueError, match="out of range"):
        store.prepare_ids([0, 4])
    with pytest.raises(ValueError, match="out of range"):
        store.gather([4])
    ids = store.prepare_ids([2, 0])
    assert ids.dtype == torch.int64 and ids.device.type == "cpu"
    np.testing.assert_array_equal(ids.numpy(), [2, 0])


def test_device_store_scatter_is_in_place_and_drops_stay_tensors():
    """``device_scatter`` writes the store's own tensors (no second copy of
    the buffers) and returns the drop count as a tensor, unread."""
    store = cs.DeviceClientStateStore(3, device="cpu").ensure(
        np.zeros(2, np.float32))
    state = store.device_state()
    buf, stamps_t = state["buffers"], state["stamps"]
    ids = store.prepare_ids([2, 0])
    rows, stamps = cs.device_gather(state, ids)
    new_state, drops = cs.device_scatter(state, ids, rows + 1.0, stamps)
    assert isinstance(drops, torch.Tensor) and int(drops) == 0
    assert new_state["buffers"] is buf and new_state["stamps"] is stamps_t
    np.testing.assert_array_equal(buf.numpy(), [[1, 1], [0, 0], [1, 1]])
    np.testing.assert_array_equal(stamps_t.numpy(), [1, 0, 1])


@pytest.mark.parametrize("kw", [SCAFFOLD, FEDEP], ids=["scaffold", "fedep"])
def test_persistent_state_is_fp32_even_for_bf16_configs(kw):
    """Control variates and sites are fp32 running statistics in both
    packages; only the shipped payload gets the wire dtype."""
    kw = dict(kw, delta_dtype="bfloat16")
    alg = get_algorithm(FedConfig(**kw))
    jalg = jax_get_algorithm(JaxFedConfig(**kw))
    params = torch.zeros(4, dtype=torch.bfloat16)
    jparams = jnp.zeros(4, jnp.bfloat16)
    for got, want in ((alg.init_client_state(params),
                       jalg.init_client_state(jparams)),
                      (alg.init_algo_state(params),
                       jalg.init_algo_state(jparams))):
        got_l, want_l = tm.tleaves(got), jax.tree_util.tree_leaves(want)
        assert len(got_l) == len(want_l)
        assert all(x.dtype == torch.float32 for x in got_l)
        assert all(x.dtype == jnp.float32 for x in want_l)


@ALL_STORES
def test_store_load_rejects_wrong_population(kind):
    store = STORES[kind](2).ensure(np.zeros(1, np.float32))
    other = STORES[kind](3).ensure(np.zeros(1, np.float32))
    with pytest.raises(ValueError, match="population"):
        store.load_state_dict(other.state_dict())


def test_make_client_store_resolves_placement():
    assert isinstance(cs.make_client_store("host", 2), cs.ClientStateStore)
    dev = cs.make_client_store("device", 2, device="cpu")
    assert isinstance(dev, cs.DeviceClientStateStore)
    assert isinstance(dev, cs.BaseClientStateStore)
    with pytest.raises(ValueError, match="client_state_placement"):
        cs.make_client_store("tpu", 2)
    with pytest.raises(ValueError, match="client_state_placement"):
        FedConfig(client_state_placement="tpu")
    for call in (lambda: cs.make_client_store("device", 2, mesh=object()),
                 lambda: cs.population_layout(None, 2),
                 lambda: dev.local_state_dict()):
        with pytest.raises(NotImplementedError,
                           match="ROADMAP.md queue 1, item 10"):
            call()


def test_device_store_needs_cuda_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cs.make_client_store("device", 2)


@pytest.mark.parametrize("place", ["host", "device"])
def test_stateful_round_requires_client_states(place):
    grad_fn, _ = torch_lsq_problem()
    fed = FedConfig(**SCAFFOLD, client_state_placement=place)
    state = init_server_state(torch.zeros(egc.D), get_optimizer("sgd", 0.1),
                              algorithm=get_algorithm(fed))
    batches = {"x": np.zeros((4, 12, 10, egc.D), np.float32),
               "y": np.zeros((4, 12, 10), np.float32)}
    for fn in (make_round_program(grad_fn, fed),
               make_cohort_program(grad_fn, fed)):
        with pytest.raises(ValueError, match="stateful"):
            fn(state, batches)


@pytest.mark.parametrize("kw", [
    FEDEP, dict(FEDEP, burn_in_rounds=0), SCAFFOLD,
    dict(FEDEP, algorithm="fedpa")], ids=["fedep", "fedep-no-burn-in",
                                         "scaffold", "fedpa"])
def test_regimes_statefulness_matches_the_reference(kw):
    """``burns_in`` / ``burn_stateful`` against the rule of the JAX
    ``FedSim``: FedEP burns in as stateless FedAvg; without a burn-in
    regime the burn-in rounds run the algorithm itself."""
    alg = get_algorithm(FedConfig(**kw))
    jalg = jax_get_algorithm(JaxFedConfig(**kw))
    burns_in = jalg.has_burn_regime and kw.get("burn_in_rounds", 0) > 0
    assert alg.burns_in == burns_in
    assert alg.stateful == jalg.stateful
    assert alg.burn_stateful == (jalg.burn_algorithm().stateful if burns_in
                                 else jalg.stateful)


def _stamps_from_draws(sim, rounds, burn_in_rounds):
    """Each client's expected stamp: the non-burn-in rounds it was drawn
    in and survived."""
    want = np.zeros(sim.num_clients, np.int64)
    for r in range(burn_in_rounds, rounds):
        ids, faults = sim.source.draw(r)
        alive = (np.ones(len(ids), bool) if faults.survivors is None
                 else np.asarray(faults.survivors) > 0)
        want[np.asarray(ids)[alive]] += 1
    return want


@pytest.mark.parametrize("placement", egc.PLACEMENTS)
@pytest.mark.parametrize("kw", [SCAFFOLD, FEDEP], ids=["scaffold", "fedep"])
def test_host_vs_device_store_bitwise(kw, placement):
    """6 clients, 4 per round, dropout 0.3, chunk 3 (two padding copies of
    client 0): the two placements give bitwise equal params, algo state
    and stores, and each stamp counts exactly the surviving draws (a
    dropped client or a padding copy never writes)."""
    grad_fn, batch_fn = torch_lsq_problem()
    base = dict(kw, round_placement=placement, round_chunk_size=3,
                dropout_rate=0.3)
    out = {}
    for place in ("host", "device"):
        sim = FedSim(FedConfig(**base, client_state_placement=place),
                     grad_fn, lambda c, r, k: batch_fn(c % egc.C, r, k),
                     num_clients=6, device="cpu")
        state, hist = sim.run(torch.zeros(egc.D), 4)
        out[place] = (state, sim.client_store.state_dict(), hist, sim)
    (hs, hstore, hhist, sim), (ds, dstore, dhist, _) = (out["host"],
                                                        out["device"])
    assert torch.equal(hs.params, ds.params)
    for a, b in zip(tm.tleaves(hs.algo_state), tm.tleaves(ds.algo_state)):
        assert torch.equal(a, b)
    for a, b in zip(tm.tleaves(hstore), tm.tleaves(dstore)):
        np.testing.assert_array_equal(a, b)
    assert hhist == dhist
    assert sum(h["dropped"] for h in hhist) > 0
    assert [h["state_drops"] for h in hhist] == [0] * 4
    want = _stamps_from_draws(sim, 4, kw.get("burn_in_rounds", 0))
    np.testing.assert_array_equal(hstore["stamps"], want)
    never = want == 0
    for leaf in tm.tleaves(hstore["buffers"]):
        assert not leaf[never].any()
        assert leaf[~never].any()
