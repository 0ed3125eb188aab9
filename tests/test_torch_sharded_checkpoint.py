"""Shard-local client-store checkpoints of the port
(``repro_torch.checkpoint.io``) against the JAX package's, on the CPU.

The family crosses packages both ways: shards the JAX package writes
restore into the port's stores (one shard into one process, two shards
into the two ranks that own their rows), and shards the port's ranks
write restore into an unsharded JAX store, which reads every shard.
``latest_sharded_checkpoint`` skips an incomplete set in both packages,
and a change of topology (two shards restored by one rank, or by four
ranks of another layout) goes through the restore that reads every shard.
Ranks here are ``ProcessMesh`` objects without a group: checkpoints move
no data between ranks. Stores move data and checkpoints copy it, so
everything compares exactly.
"""
import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jax_io
from repro.core import client_state as jax_cs
from repro_torch.checkpoint import io
from repro_torch.core import client_state as cs
from repro_torch.launch.mesh import ProcessMesh

N = 10
TEMPLATE = {"num": np.zeros((2, 3), np.float32),
            "den": np.zeros(3, np.float32)}


@pytest.fixture(scope="module", autouse=True)
def _x32():
    """Other test modules turn on jax x64 at import; keep fp32 stores."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _state(seed=0):
    r = np.random.default_rng(seed)
    return {"buffers": {k: r.normal(size=(N,) + v.shape).astype(np.float32)
                        for k, v in TEMPLATE.items()},
            "stamps": r.integers(0, 5, N).astype(np.int64)}


def _rank(rank, world):
    return ProcessMesh(("data",), (world,), rank, torch.device("cpu"))


def _port_ranks(world, state=None):
    """``world`` sharded port stores, one per rank, loaded with
    ``state``."""
    stores = [cs.DeviceClientStateStore(N, mesh=_rank(r, world)).ensure(
        TEMPLATE) for r in range(world)]
    if state is not None:
        for s in stores:
            s.load_state_dict(state)
    return stores


def _full(stores):
    """The population put back together from the ranks' rows."""
    parts = [s.local_state_dict()[0] for s in stores]
    return {"buffers": {k: np.concatenate([p["buffers"][k] for p in parts])
                        for k in TEMPLATE},
            "stamps": np.concatenate([p["stamps"] for p in parts])}


def _assert_state(got, want):
    np.testing.assert_array_equal(got["stamps"], want["stamps"])
    for k in TEMPLATE:
        np.testing.assert_array_equal(np.asarray(got["buffers"][k]),
                                      want["buffers"][k])


def _port_save(ckpt, stores, step):
    for r, s in enumerate(stores):
        local, offset = s.local_state_dict()
        io.save_checkpoint_shard(ckpt, local, step, row_offset=offset,
                                 shard_index=r, num_shards=len(stores))


def _jax_save(ckpt, state, step, bounds):
    """The JAX package's shards of ``state``, one per ``[lo, hi)``."""
    for k, (lo, hi) in enumerate(bounds):
        rows = {"buffers": {n: b[lo:hi] for n, b in state["buffers"].items()},
                "stamps": state["stamps"][lo:hi]}
        jax_io.save_checkpoint_shard(ckpt, rows, step, row_offset=lo,
                                     shard_index=k, num_shards=len(bounds))


@pytest.mark.parametrize("bounds", [[(0, N)], [(0, 5), (5, N)]],
                         ids=["one shard", "two shards"])
def test_jax_shards_restore_into_the_port(bounds, tmp_path):
    state = _state()
    _jax_save(str(tmp_path), state, 3, bounds)
    one = cs.DeviceClientStateStore(N, device="cpu").ensure(TEMPLATE)
    assert io.restore_store_sharded(str(tmp_path), one) == 3
    _assert_state(one.state_dict(), state)
    ranks = _port_ranks(len(bounds))
    for s in ranks:
        assert io.restore_store_sharded(str(tmp_path), s) == 3
    _assert_state(_full(ranks), state)


def test_port_shards_restore_into_jax(tmp_path):
    state = _state(1)
    _port_save(str(tmp_path), _port_ranks(2, state), 5)
    store = jax_cs.DeviceClientStateStore(N).ensure(TEMPLATE)
    assert jax_io.restore_store_sharded(str(tmp_path), store) == 5
    _assert_state(store.state_dict(), state)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_latest_sharded_checkpoint_skips_an_incomplete_set(writer,
                                                           tmp_path):
    ckpt, state = str(tmp_path), _state(2)
    if writer == "jax":
        _jax_save(ckpt, state, 2, [(0, 5), (5, N)])
        # step 4: one shard of three written, the save cut short
        jax_io.save_checkpoint_shard(ckpt, state, 4, row_offset=0,
                                     shard_index=0, num_shards=3)
    else:
        stores = _port_ranks(2, state)
        _port_save(ckpt, stores, 2)
        local, offset = stores[0].local_state_dict()
        io.save_checkpoint_shard(ckpt, local, 4, row_offset=offset,
                                 shard_index=0, num_shards=2)
    assert io.latest_sharded_checkpoint(ckpt) == 2
    assert jax_io.latest_sharded_checkpoint(ckpt) == 2
    with pytest.raises(FileNotFoundError, match="shards"):
        io.restore_store_sharded(ckpt, _port_ranks(2)[0], step=4)
    assert io.latest_sharded_checkpoint(str(tmp_path / "none")) is None


@pytest.mark.parametrize("world", [1, 4], ids=["one rank", "four ranks"])
def test_a_topology_change_reads_every_shard(world, tmp_path):
    """Two ranks' shards restored by one rank (one process with
    ``--shard-population``) and by four ranks of 3 rows each (12 with two
    dead rows): no shard matches a rank's rows, so each rank reads every
    shard and keeps its own rows."""
    state = _state(3)
    _port_save(str(tmp_path), _port_ranks(2, state), 7)
    ranks = _port_ranks(world)
    for s in ranks:
        assert io.restore_store_sharded(str(tmp_path), s) == 7
    _assert_state(_full(ranks), state)
    if world == 4:
        assert ranks[-1].device_state()["stamps"][1:].tolist() == [-1, -1]
