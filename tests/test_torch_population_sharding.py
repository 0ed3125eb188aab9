"""Population sharding in the port (``repro_torch.core.client_state``,
``launch.mesh``, ``core.collective``) on the CPU, the counterpart of
``tests/_population_sharding_script.py``'s matrix.

* The padded layout's arithmetic equals the JAX package's
  ``population_layout`` for populations of 1 to 1,000,000 over 1 to 16
  shards and on the production meshes' shapes.
* The reference's parity matrix, over ranks: scaffold and fedep, each in
  the three placements, sync and async with a window of 0, each through
  ``FedSim(mesh=)`` in one group of 4 gloo ranks (spawned children, all
  twelve cases in one group): the population of 10 pads to 12, rows 10
  and 11 dead. Each case's params and the store put back together from
  the ranks' rows equal the one-process port run within rtol 1e-6, atol
  1e-7 (the sharded sum is the one-process sum, so they agree bit for
  bit), with stamps exact, padding stamps -1 and the ranks' params
  bitwise equal; and each equals the JAX package's unsharded ``FedSim``
  within the goldens' 1e-5.
* Two cases on 2 ranks exercise the rest of the aggregation: mid-round
  dropouts and q-FFL, against the one-process run.
* Each rank's store holds exactly ``R = padded / W`` rows.
"""
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mp as mpt
from repro.configs.base import FedConfig as JaxFedConfig
from repro.core import FedSim as JaxFedSim
from repro.core import client_state as jax_cs
from repro.data import make_federated_lsq as jax_make_federated_lsq
from repro.data.synthetic_lsq import lsq_batches as jax_lsq_batches
from repro_torch.checkpoint.io import leaves_with_paths
from repro_torch.configs.base import MULTI_POD, SINGLE_POD, FedConfig
from repro_torch.core import client_state as cs
from repro_torch.core import tree_math as tm
from repro_torch.core.round import FedSim
from repro_torch.data import prefetch
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.mesh import ProcessMesh

W = 4
CASES = mpt.matrix()
EXTRA = mpt.extra_cases()


@pytest.fixture(scope="module", autouse=True)
def _x32():
    """Other test modules turn on jax x64 at import; compare in fp32."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


class _Shape:
    """Only what ``population_layout`` reads of a mesh."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


@pytest.mark.parametrize("n", [1, 7, 10, 16, 1_000_000])
def test_population_layout_matches_jax(n):
    meshes = [_Shape({"data": e}) for e in (1, 2, 4, 8, 16)] + [
        _Shape(dict(zip(mc.axes, mc.shape))) for mc in (SINGLE_POD,
                                                        MULTI_POD)]
    for mesh in meshes:
        got = cs.population_layout(mesh, n)
        want = jax_cs.population_layout(mesh, n)
        assert (got.padded_num_clients, got.extent, got.padding) == (
            want.padded_num_clients, want.extent, want.padding), mesh.shape
        assert got.rows_per_shard == want.padded_num_clients // want.extent
    spec = cs.population_layout(_Shape({"pod": 2, "data": 16}), n,
                                (("pod", "data"),))
    assert spec.extent == 32 and spec.padded_num_clients % 32 == 0


def _group(cases, world):
    out = tempfile.mkdtemp(prefix="torch_sharding_")
    mpt.run_group(mpt.rank_cases, world, (out, cases))
    return out


@pytest.fixture(scope="module")
def matrix_dir():
    """The twelve cases, run once on one group of 4 ranks."""
    return _group(CASES, W)


@pytest.fixture(scope="module")
def extra_dir():
    """The two aggregation cases, run once on one group of 2 ranks."""
    return _group(EXTRA, 2)


def _ranks(out, i, world):
    return [dict(np.load(f"{out}/{i}.rank{r}.npz")) for r in range(world)]


def _check_against_one_process(kw, ranks):
    """Params, the whole store and its stamps against ``run_case(kw)``
    without a mesh; returns the one-process params."""
    sim, state = mpt.run_case(kw)
    want = sim.client_store.state_dict()
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["params"], ranks[0]["params"])
    np.testing.assert_allclose(ranks[0]["params"], state.params.numpy(),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(
        np.concatenate([r["stamps"] for r in ranks]), want["stamps"])
    for j, leaf in enumerate(tm.tleaves(want["buffers"])):
        np.testing.assert_allclose(
            np.concatenate([r[f"buf_{j}"] for r in ranks]), leaf,
            rtol=1e-6, atol=1e-7)
    return state.params.numpy(), want


def _jax_run(kw):
    """The JAX package's unsharded ``FedSim`` on the same problem."""
    _, data = jax_make_federated_lsq(mpt.N, 50, mpt.D, heterogeneity=20.0,
                                     seed=0)

    def grad_fn(params, batch):
        def loss(p):
            r = batch["x"] @ p - batch["y"]
            return 0.5 * jnp.mean(r * r) * 50
        return jax.value_and_grad(loss)(params)

    def batch_fn(cid, r, steps):
        X, y = data[cid]
        return jax_lsq_batches(X, y, 10, steps, seed=r * 131 + cid)

    sim = JaxFedSim(fed=JaxFedConfig(**kw), grad_fn=grad_fn,
                    batch_fn=batch_fn, num_clients=mpt.N)
    state, _ = sim.run(jnp.zeros(mpt.D), mpt.ROUNDS)
    return np.asarray(state.params), jax.tree_util.tree_map(
        np.asarray, sim.client_store.state_dict())


@pytest.mark.parametrize("i,name", list(enumerate(CASES)),
                         ids=list(CASES))
def test_sharded_matrix_matches_one_process_and_jax(i, name, matrix_dir):
    kw = CASES[name]
    ranks = _ranks(matrix_dir, i, W)
    assert [int(r["offset"]) for r in ranks] == [0, 3, 6, 9]
    # rank 3 holds row 9 and the two dead padding rows
    np.testing.assert_array_equal(ranks[-1]["raw_stamps"][1:], [-1, -1])
    params, store = _check_against_one_process(kw, ranks)
    jparams, jstore = _jax_run(kw)
    np.testing.assert_allclose(params, jparams, rtol=1e-5)
    np.testing.assert_array_equal(store["stamps"], jstore["stamps"])
    # the JAX package flattens dicts in sorted key order, as the port's
    # checkpoints do
    for (_, got), want in zip(leaves_with_paths(store["buffers"]),
                              jax.tree_util.tree_leaves(jstore["buffers"])):
        np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("i,name", list(enumerate(EXTRA)), ids=list(EXTRA))
def test_two_rank_aggregation_matches_one_process(i, name, extra_dir):
    ranks = _ranks(extra_dir, i, 2)
    _check_against_one_process(EXTRA[name], ranks)


@pytest.mark.parametrize("alg", ["scaffold", "fedep"])
def test_each_rank_holds_exactly_its_rows(alg, matrix_dir):
    """The counterpart of the reference's ``MARKER mem``: a rank's store
    is ``R = 12 / 4 = 3`` rows of the padded population, not more."""
    i = list(CASES).index(f"{alg} parallel sync")
    for r in _ranks(matrix_dir, i, W):
        assert int(r["store_bytes"]) == 3 * int(r["row_bytes"])
        assert r["raw_stamps"].shape == (3,)


def test_sharded_store_routes_rows_on_one_process():
    """One process standing for rank 1 of 2 (no group): the route sends
    its owned rows to the ranks that run them and expects its own cohort
    rows from their owners."""
    mesh = ProcessMesh(("data",), (2,), 1, torch.device("cpu"))
    store = cs.DeviceClientStateStore(5, mesh=mesh).ensure(
        np.zeros(2, np.float32))
    assert (store.rows, store.row_offset, store.layout.padding) == (3, 3, 1)
    assert store.device_state()["stamps"].tolist() == [0, 0, -1]
    route = store.prepare_ids([4, 0, 3, 1])
    # rank 1 runs positions 2, 3 (ids 3, 1) and owns ids 3, 4
    assert (route.lo, route.hi) == (2, 4)
    assert route.own_rows.tolist() == [1, 0]        # ids 4, 3
    assert route.send_counts == (1, 1) and route.recv_counts == (1, 1)
    with pytest.raises(ValueError, match="out of range"):
        store.prepare_ids([5, 0])
    with pytest.raises(RuntimeError, match="local_state_dict"):
        store.state_dict()


def test_mesh_without_a_group():
    """One process with no group is a one-rank ``("data",)`` mesh; the
    production meshes need their 256 / 512 ranks, as the reference's
    need their devices; coordinates are row-major."""
    mesh = mesh_lib.make_host_mesh("cpu")
    assert (mesh.shape, mesh.size, mesh.rank, mesh.group) == (
        {"data": 1}, 1, 0, None)
    assert mesh.device == torch.device("cpu") and mesh.backend is None
    for multi_pod, n in ((False, 256), (True, 512)):
        with pytest.raises(RuntimeError, match=f"needs {n} ranks"):
            mesh_lib.make_production_mesh(multi_pod=multi_pod,
                                          device="cpu")
        assert mesh_lib.mesh_config(multi_pod).num_devices == n
    pods = ProcessMesh(MULTI_POD.axes, MULTI_POD.shape, 300,
                       torch.device("cpu"))
    assert pods.coords() == {"pod": 1, "data": 2, "model": 12}
    assert mesh_lib.rank_device("cpu", 3) == torch.device("cpu")
    assert cs.population_layout(pods, 10).extent == 32


def test_rank_feeding_places_only_this_ranks_rows():
    """Rank 1 of 2 runs cohort rows [2, 4): its batches are checked to be
    exactly those rows and placed on its device; a cohort that does not
    split evenly raises, as the reference's sharding does."""
    mesh = ProcessMesh(("data",), (2,), 1, torch.device("cpu"))
    assert prefetch.local_row_range(mesh, "data", 4) == (2, 4)
    local = {"tokens": np.arange(6).reshape(2, 3)}
    got = prefetch.globalize_cohort_batches(local, mesh, "data", 4, 2)
    assert torch.equal(got["tokens"], torch.arange(6).reshape(2, 3))
    with pytest.raises(RuntimeError, match="runs \\[2, 4\\)"):
        prefetch.globalize_cohort_batches(local, mesh, "data", 4, 0)
    with pytest.raises(ValueError, match="does not split evenly"):
        prefetch.local_row_range(mesh, "data", 5)
    rep = prefetch.replicate_global({"w": np.ones(3, np.float32), "n": 2},
                                    mesh)
    assert isinstance(rep["w"], torch.Tensor) and rep["n"] == 2


def test_host_store_does_not_split_over_ranks():
    """A host store's slice is one process's: a stateful algorithm on it
    cannot split its cohort over two ranks (the multi-process entry point
    refuses the same with ``SystemExit``)."""
    kw = dict(mpt.BASE["scaffold"], client_state_placement="host")
    grad_fn, batch_fn = mpt.lsq_problem()
    sim = FedSim(FedConfig(**kw), grad_fn, batch_fn, mpt.N,
                 mesh=ProcessMesh(("data",), (2,), 0, torch.device("cpu")))
    sim.init(torch.zeros(mpt.D))
    with pytest.raises(ValueError, match="client_state_placement='device'"):
        sim.engine
