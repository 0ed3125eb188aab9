"""The port's checkpoints (``repro_torch.checkpoint``) on the CPU: the round
trip, the latest step, a shape mismatch and a missing directory (as
``tests/test_checkpoint.py``), the manifest the JAX package writes for the
same tree, and checkpoints across packages: a JAX-written ``{"server",
"clients"}`` checkpoint of a FedEP least-squares run restores into the
port and continues to the params and store JAX reaches, a port-written one
restores in ``repro.checkpoint.restore_checkpoint`` and continues there,
and a port checkpoint restores into either store placement bitwise.

Tolerances: the continued runs agree across packages to 1e-5 relative
(the goldens' fp32 bound); within the port, bitwise.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import engine_goldens_common as egc
from test_torch_round import torch_lsq_problem
from repro.checkpoint import restore_checkpoint as jax_restore
from repro.checkpoint import save_checkpoint as jax_save
from repro.configs.base import FedConfig as JaxFedConfig
from repro.core import FedSim as JaxFedSim
from repro.core.server import ServerState as JaxServerState
from repro_torch.checkpoint import (latest_checkpoint, leaves_with_paths,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.configs.base import FedConfig
from repro_torch.core import tree_math as tm
from repro_torch.core.round import FedSim
from repro_torch.core.server import ServerState

#: FedEP on the goldens' least squares, 6 clients, 4 per round: rounds 0
#: (burn-in) and 1 run before the checkpoint, 2 and 3 after it.
FEDEP = dict(egc.SPECS["fedep"][0], burn_in_rounds=1)
N, SPLIT, ROUNDS = 6, 2, 4


@pytest.fixture(scope="module", autouse=True)
def _x32():
    """Other test modules turn on jax x64 at import; compare in fp32."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _state():
    params = {"w": torch.arange(6.0).reshape(2, 3),
              "b": {"x": torch.ones(4, dtype=torch.bfloat16)}}
    opt = {"m": torch.zeros(2, 3), "step": 7}
    return ServerState(params, opt, 3)


def test_roundtrip(tmp_path):
    st = _state()
    save_checkpoint(str(tmp_path), st, 3, {"arch": "t"})
    got, step, meta = restore_checkpoint(str(tmp_path), st)
    assert step == 3 and meta["arch"] == "t"
    assert torch.equal(got.params["w"], st.params["w"])
    assert got.params["b"]["x"].dtype == torch.bfloat16
    assert torch.equal(got.params["b"]["x"], st.params["b"]["x"])
    assert got.round == 3 and isinstance(got.round, int)
    assert got.opt_state["step"] == 7 and got.algo_state == ()


def test_latest_and_multiple(tmp_path):
    st = _state()
    for s in (1, 5, 3):
        save_checkpoint(str(tmp_path), st, s)
    assert latest_checkpoint(str(tmp_path)) == 5
    assert restore_checkpoint(str(tmp_path), st)[1] == 5
    assert restore_checkpoint(str(tmp_path), st, step=3)[1] == 3


def test_shape_mismatch_fails(tmp_path):
    st = _state()
    save_checkpoint(str(tmp_path), st, 1)
    bad = st._replace(params={"w": torch.zeros(3, 3),
                              "b": {"x": torch.ones(4,
                                                    dtype=torch.bfloat16)}})
    with pytest.raises(ValueError):
        restore_checkpoint(str(tmp_path), bad)
    with pytest.raises(KeyError, match="missing leaf"):
        restore_checkpoint(str(tmp_path), st._replace(
            params={"v": torch.zeros(2, 3),
                    "b": {"x": torch.ones(4, dtype=torch.bfloat16)}}))


def test_missing_dir_fails(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "nope"), _state())


def test_manifest_equals_the_reference(tmp_path):
    """The same tree written by both packages: the same paths, shapes and
    dtypes, leaf for leaf (bf16 widened to fp32 with its dtype kept, the
    Python ints as int32 scalars)."""
    st = _state()
    jst = JaxServerState(
        {"w": jnp.arange(6.0).reshape(2, 3),
         "b": {"x": jnp.ones(4, jnp.bfloat16)}},
        {"m": jnp.zeros((2, 3)), "step": jnp.asarray(7, jnp.int32)},
        jnp.asarray(3, jnp.int32))
    save_checkpoint(str(tmp_path / "t"), {"server": st, "n": None}, 1)
    jax_save(str(tmp_path / "j"), {"server": jst, "n": None}, 1)
    manifests = [json.loads((tmp_path / k / "ckpt_00000001.json")
                            .read_text())["manifest"] for k in ("t", "j")]
    assert manifests[0] == manifests[1]
    assert [m["path"] for m in manifests[0]] == [
        "['server'].params['b']['x']", "['server'].params['w']",
        "['server'].opt_state['m']", "['server'].opt_state['step']",
        "['server'].round"]
    assert [p for p, _ in leaves_with_paths(torch.zeros(2))] == ["<root>"]


def _jax_sim():
    grad_fn, batch_fn = egc.make_problem()
    return JaxFedSim(JaxFedConfig(**FEDEP), grad_fn,
                     lambda c, r, k: batch_fn(c % egc.C, r, k),
                     num_clients=N)


def _port_sim(place):
    grad_fn, batch_fn = torch_lsq_problem()
    return FedSim(FedConfig(**FEDEP, client_state_placement=place), grad_fn,
                  lambda c, r, k: batch_fn(c % egc.C, r, k), num_clients=N,
                  device="cpu")


def _run(sim, state, lo, hi):
    for r in range(lo, hi):
        state, _ = sim.round(state, r)
    return state


def _ckpt_tree(sim, state):
    return {"server": state, "clients": sim.client_store.state_dict()}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_close(got_state, got_store, want_state, want_store):
    np.testing.assert_allclose(_np(got_state.params),
                               _np(want_state.params), rtol=1e-5)
    assert int(got_state.round) == int(want_state.round) == ROUNDS
    got = dict(leaves_with_paths(got_store))
    want = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_leaves_with_path(want_store)}
    assert set(got) == set(want)
    for path, w in want.items():
        np.testing.assert_allclose(_np(got[path]), w, rtol=1e-5,
                                   err_msg=path)


@pytest.mark.parametrize("place", ["host", "device"])
def test_jax_checkpoint_continues_in_the_port(place, tmp_path):
    jsim = _jax_sim()
    jstate = _run(jsim, jsim.init(jnp.zeros(egc.D)), 0, SPLIT)
    jax_save(str(tmp_path), _ckpt_tree(jsim, jstate), SPLIT,
             {"algorithm": "fedep"})
    jstate = _run(jsim, jstate, SPLIT, ROUNDS)

    sim = _port_sim(place)
    template = _ckpt_tree(sim, sim.init(torch.zeros(egc.D)))
    restored, step, meta = restore_checkpoint(str(tmp_path), template)
    assert (step, meta["algorithm"]) == (SPLIT, "fedep")
    assert restored["server"].round == SPLIT
    assert restored["clients"]["stamps"].dtype == np.int64
    sim.client_store.load_state_dict(restored["clients"])
    state = _run(sim, restored["server"], SPLIT, ROUNDS)
    _assert_close(state, sim.client_store.state_dict(), jstate,
                  jsim.client_store.state_dict())


def test_port_checkpoint_continues_in_jax(tmp_path):
    sim = _port_sim("device")
    state = _run(sim, sim.init(torch.zeros(egc.D)), 0, SPLIT)
    save_checkpoint(str(tmp_path), _ckpt_tree(sim, state), SPLIT,
                    {"algorithm": "fedep"})
    state = _run(sim, state, SPLIT, ROUNDS)

    jsim = _jax_sim()
    template = _ckpt_tree(jsim, jsim.init(jnp.zeros(egc.D)))
    restored, step, _ = jax_restore(str(tmp_path), template)
    assert step == SPLIT and int(restored["server"].round) == SPLIT
    jsim.client_store.load_state_dict(restored["clients"])
    jstate = _run(jsim, restored["server"], SPLIT, ROUNDS)
    _assert_close(state, sim.client_store.state_dict(), jstate,
                  jsim.client_store.state_dict())


@pytest.mark.parametrize("place", ["host", "device"])
def test_port_checkpoint_restores_into_either_placement(place, tmp_path):
    """Written from the host store, restored into ``place``: the continued
    run equals the unbroken host-store run bit for bit."""
    sim = _port_sim("host")
    state = _run(sim, sim.init(torch.zeros(egc.D)), 0, SPLIT)
    save_checkpoint(str(tmp_path), _ckpt_tree(sim, state), SPLIT)
    want = _run(sim, state, SPLIT, ROUNDS)
    want_store = sim.client_store.state_dict()

    sim2 = _port_sim(place)
    restored, _, _ = restore_checkpoint(
        str(tmp_path), _ckpt_tree(sim2, sim2.init(torch.zeros(egc.D))))
    sim2.client_store.load_state_dict(restored["clients"])
    got = _run(sim2, restored["server"], SPLIT, ROUNDS)
    assert torch.equal(got.params, want.params) and got.round == want.round
    for a, b in zip(tm.tleaves(sim2.client_store.state_dict()),
                    tm.tleaves(want_store)):
        np.testing.assert_array_equal(a, b)
