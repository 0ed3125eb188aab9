"""FSDP over ranks for the ``sequential`` placement (``core/fsdp.py``,
``core/sharded_round.py``) against the JAX package and the port's
one-process round, on gloo ranks spawned on the CPU.

Every case is ``tests/test_torch_lm_train.py``'s round: the smoke
fedlm-100m, a FedAvg burn-in round then a FedPA round (fp32 compute), 2
clients with 2 batch rows each. One spawned group per mesh
(``_torch_mp.fsdp_rank``) runs batch and streaming DP and writes what each
rank found; the module's fixture starts both groups, computes the JAX
rounds and the one-process rounds meanwhile, then joins the groups within
a deadline, and the tests only compare.

* 2 x 2 ``("data", "model")`` mesh, 4 ranks: each data rank takes one
  row of each client, the model ranks the same row. The gathered params
  and the losses after each round equal JAX's one-device ``sequential``
  round (the batch-DP run, which both DP forms equal) and the port's
  one-process one, at ``test_make_fed_round_vs_jax``'s tolerances (rtol
  1e-5, atol 1e-6 after the burn-in round and 1e-5 after the FedPA
  round: the grads are means of per-row means here, summed over ranks in
  fp32); every rank holds ``ceil(d / 4)`` elements of each
  parameter-shaped tensor.
* 1 x 2, 2 ranks: the batch does not split, so only the DP's dot
  products, summed over the two shards, differ from one process: within
  1e-6 of the one-process params' largest entry.
* Collectives: one params all-gather per local step per client, and the
  bytes of each kind by the layout's formula.

Without a group: the sharded DP step over simulated shards against
``ref.dp_step_ref``, the glue against ``ref.dp_coeffs``, the mesh's data
slot, and the refusals.
"""
import json
import math
import os

import jax
import numpy as np
import pytest
import torch

import _torch_mp as mpt
from test_torch_lm_train import (ARCH, F32, ROUND_KW, ROUND_TOKENS,
                                 _fedlm_params, _jax_rounds)
from repro_torch import configs
from repro_torch.configs.base import FedConfig
from repro_torch.convert import lm_params_from_jax
from repro_torch.core import fsdp, sharded_round
from repro_torch.core import tree_math as tm
from repro_torch.core.server import init_server_state
from repro_torch.kernels import ops, ref
from repro_torch.launch.mesh import ProcessMesh
from repro_torch.optim import get_optimizer

#: mesh name -> ("data", "model") extents
MESHES = {"2x2": (2, 2), "1x2": (1, 2)}
DPS = ("batch", "streaming")
#: atol of the params after the burn-in round and after the FedPA round
ATOLS = (1e-6, 1e-5)
#: seconds the groups may take after the parent's own work
JOIN_S = 150.0


@pytest.fixture(scope="module", autouse=True)
def _x32():
    """Other test modules turn on jax x64 at import; compare in fp32."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _by_path(tree, prefix=""):
    """A nested dict of arrays -> ``{"a/b": array}``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_by_path(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _one_process(dp: str):
    """The port's one-process sequential rounds: per round, ``({path:
    params}, losses)``."""
    tcfg = configs.get_smoke(ARCH)
    fed = FedConfig(**ROUND_KW, streaming_dp=dp == "streaming")
    opt = get_optimizer(fed.server_opt, fed.server_lr, fed.server_momentum)
    state = init_server_state(lm_params_from_jax(_fedlm_params(), "cpu"),
                              opt)
    out = []
    for use_sampling, toks in zip((False, True), ROUND_TOKENS):
        fn = sharded_round.make_fed_round(
            tcfg, fed, placement="sequential", compute_dtype=F32, q_chunk=8,
            use_sampling=use_sampling)
        state, metrics = fn(state, {"tokens": toks})
        out.append(({p: x.numpy() for p, x in fsdp._paths(state.params)},
                    {k: float(v) for k, v in metrics.items()}))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{"jax": ..., "one": {dp: ...}, mesh: {dp: [rank npz]}}``."""
    groups = {}
    for name, shape in MESHES.items():
        out = str(tmp_path_factory.mktemp(f"fsdp_{name}"))
        np.savez(os.path.join(out, "inputs.npz"),
                 round_kw=json.dumps(ROUND_KW),
                 tokens0=ROUND_TOKENS[0], tokens1=ROUND_TOKENS[1],
                 **{f"p/{k}": v for k, v in
                    _by_path(_fedlm_params()).items()})
        groups[name] = (out, math.prod(shape),
                        mpt.start_group(mpt.fsdp_rank, math.prod(shape),
                                        (out, shape)))
    found = {"jax": _jax_rounds("sequential"),
             "one": {dp: _one_process(dp) for dp in DPS}}
    for name, (out, world, procs) in groups.items():
        mpt.join_group(procs, JOIN_S)
        found[name] = {dp: [dict(np.load(os.path.join(
            out, f"{dp}.rank{r}.npz"))) for r in range(world)] for dp in DPS}
    return found


@pytest.mark.parametrize("dp", DPS)
def test_fsdp_2x2_equals_jax_and_one_process(runs, dp):
    for r, (want_jax, want_one, atol) in enumerate(zip(
            runs["jax"], runs["one"][dp], ATOLS)):
        jax_params, jax_metrics = want_jax
        one_params, one_metrics = want_one
        for got in runs["2x2"][dp]:
            for k, v in jax_metrics.items():
                np.testing.assert_allclose(got[f"r{r}/{k}"], v, rtol=1e-5)
                np.testing.assert_allclose(got[f"r{r}/{k}"], one_metrics[k],
                                           rtol=1e-5)
            assert len(jax_params) == len(one_params)
            for path, want in jax_params:
                np.testing.assert_allclose(got[f"r{r}/{path}"], want,
                                           rtol=1e-5, atol=atol,
                                           err_msg=path)
                np.testing.assert_allclose(got[f"r{r}/{path}"],
                                           one_params[path], rtol=1e-5,
                                           atol=atol, err_msg=path)
        first = runs["2x2"][dp][0]
        for got in runs["2x2"][dp][1:]:
            for path in one_params:
                np.testing.assert_array_equal(got[f"r{r}/{path}"],
                                              first[f"r{r}/{path}"])


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_fsdp_ranks_hold_their_shard(runs, mesh):
    """Each rank holds ``ceil(d / W)`` elements of the master, the server
    momentum, the accumulator, the iterate, the samples and ``v_hist``."""
    W = math.prod(MESHES[mesh])
    for dp in DPS:
        for got in runs[mesh][dp]:
            d, n = int(got["d"]), int(got["n"])
            assert d == 1_312_256 and n == -(-d // W)
            for r in (0, 1):
                assert got[f"r{r}/master"] == n
                assert got[f"r{r}/momentum"] == n
            for key in ("accumulator", "iterate", "samples", "v_hist"):
                assert got[f"held/{key}"].tolist() == [n], key


def test_fsdp_1x2_within_one_process(runs):
    for dp in DPS:
        for r, (want, _) in enumerate(runs["one"][dp]):
            scale = max(np.abs(v).max() for v in want.values())
            for got in runs["1x2"][dp]:
                for path, w in want.items():
                    np.testing.assert_allclose(got[f"r{r}/{path}"], w,
                                               rtol=0, atol=1e-6 * scale,
                                               err_msg=path)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_fsdp_collectives_per_round(runs, mesh):
    """One params all-gather per local step per client; the bytes sent by
    the layout: the shard to W - 1 ranks per gather, the gloo route's
    all-reduce of the padded gradient ``2 (W - 1) n`` fp32 per step, the
    losses and the DP's ``(1, lp + 2)`` partials to W - 1 ranks."""
    W = math.prod(MESHES[mesh])
    C, K = ROUND_KW["clients_per_round"], ROUND_KW["local_steps"]
    ell = ((K - ROUND_KW["burn_in_steps"]) // ROUND_KW["steps_per_sample"])
    for dp in DPS:
        for got in runs[mesh][dp]:
            n = int(got["n"])
            for r, dp_steps in enumerate((0, C * (ell - 1))):
                t = {k.split("/")[-1]: got[k] for k in got
                     if k.startswith(f"r{r}/traffic/")}
                assert t["param_gathers"] == C * K
                assert t["params"] == C * K * (W - 1) * n * 4
                assert t["grad_reduces"] == C * K
                assert t["grads"] == C * K * 2 * (W - 1) * n * 4
                assert t["small_reduces"] == C * K + dp_steps
                assert t["small"] == (W - 1) * 4 * (
                    C * K + dp_steps * (ell - 1 + 2))
                assert t["rows"] == t["accumulator"] == t["gathered"] == 0


@pytest.mark.parametrize("W", [1, 3, 4])
@pytest.mark.parametrize("t", [2, 4])
def test_sharded_dp_step_matches_ref(W, t):
    """``ops.dp_step_sharded`` on W shards of a padded vector, its partials
    summed by hand, equals ``ref.dp_step_ref`` on the whole vector."""
    r = np.random.default_rng(W * 10 + t)
    C, lp, d, rho = 2, 3, 1001, 0.01
    n = -(-d // W)

    def draw(*shape):
        return torch.from_numpy(r.normal(size=shape).astype(np.float32))

    u, delta, V = draw(C, d), draw(C, d), draw(C, lp, d)
    V[:, t - 1:] = 0.0                    # rows past the live ones
    # history coefficients g / (1 + g a) of the DP's size (rho 0.01)
    c_hist = torch.from_numpy(0.01 * np.abs(r.normal(size=(C, lp))).astype(
        np.float32))

    def shards(x):
        x = torch.nn.functional.pad(x, (0, W * n - d))
        return [x[..., k * n:(k + 1) * n].contiguous() for k in range(W)]

    parts = list(zip(shards(u), shards(delta), shards(V)))
    total = sum(ops.dp_partials(*p) for p in parts)
    out = [ops.dp_step_sharded(*p, c_hist, t, rho, all_reduce=lambda _: total)
           for p in parts]
    want = ref.dp_step_ref(u, delta, V, c_hist, t, rho)
    for k in (0, 1):
        got = torch.cat([o[k] for o in out], dim=-1)[..., :d]
        torch.testing.assert_close(got, want[k], rtol=0,
                                   atol=1e-6 * want[k].abs().max().item())
    for k in (2, 3):
        for o in out:
            torch.testing.assert_close(o[k], want[k], rtol=1e-6, atol=0)


def test_dp_coeffs_glue_matches_ref():
    r = np.random.default_rng(5)
    C, lp = 3, 4
    dots, c_hist = (torch.from_numpy(r.normal(size=(C, lp)).astype(
        np.float32)) for _ in range(2))
    uu = torch.from_numpy(np.abs(r.normal(size=C)).astype(np.float32)) + 1
    ud = torch.from_numpy(r.normal(size=C).astype(np.float32))
    for t in (2, 3, 5):
        for got, want in zip(ops.dp_coeffs(dots, uu, ud, c_hist, t, 0.1),
                             ref.dp_coeffs(dots, uu, ud, c_hist, t, 0.1)):
            torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("axes,sizes,want", [
    (("data",), (4,), [(4, r) for r in range(4)]),
    (("data", "model"), (2, 2), [(2, 0), (2, 0), (2, 1), (2, 1)]),
    (("pod", "data", "model"), (2, 2, 2),
     [(4, r // 2) for r in range(8)]),
])
def test_mesh_data_slot(axes, sizes, want):
    """Ranks along "model" take the same rows; "pod" and "data" split."""
    mesh = ProcessMesh(axes, sizes, 0, torch.device("cpu"))
    assert [mesh.data_slot(r) for r in range(mesh.size)] == want


def test_layout_shards_and_gathers_by_path():
    """``shard_tree`` of a tree in another key order, then ``gather_tree``
    over simulated ranks: the same tree back; the padding is zero."""
    template = {"b": torch.zeros(3, 2, device="meta"),
                "a": {"y": torch.zeros(5, device="meta"),
                      "x": torch.zeros(1, device="meta")}}
    tree = {"a": {"x": torch.tensor([1.0]),
                  "y": torch.arange(2.0, 7.0)},
            "b": torch.arange(7.0, 13.0).reshape(3, 2)}
    W = 5
    meshes = [ProcessMesh(("data",), (W,), r, torch.device("cpu"))
              for r in range(W)]
    shards = [fsdp.FlatShard(template, m).shard_tree(tree) for m in meshes]
    flat = torch.cat(shards)
    assert flat.tolist() == [7.0, 8, 9, 10, 11, 12, 2, 3, 4, 5, 6, 1, 0, 0,
                             0]
    layout = fsdp.FlatShard(template)
    back = layout.gather_tree(flat[:layout.n])
    for path, x in fsdp._paths(tree):
        assert torch.equal(dict(fsdp._paths(back))[path], x)


def _state():
    fed = FedConfig(**ROUND_KW)
    opt = get_optimizer(fed.server_opt, fed.server_lr, fed.server_momentum)
    return init_server_state(lm_params_from_jax(_fedlm_params(), "cpu"),
                             opt)


@pytest.mark.parametrize("algorithm", ["scaffold", "fedprox",
                                       "fedpa_precision"])
def test_fsdp_refuses_other_algorithms(algorithm):
    mesh = ProcessMesh(("data",), (2,), 0, torch.device("cpu"))
    kw = dict(ROUND_KW, algorithm=algorithm)
    if algorithm == "scaffold":
        kw.update(client_opt="sgd")
    with pytest.raises(NotImplementedError, match="10 part 3"):
        sharded_round.make_fed_round(configs.get_smoke(ARCH),
                                     FedConfig(**kw), placement="sequential",
                                     compute_dtype=F32, mesh=mesh)


def test_fsdp_refuses_rows_that_do_not_divide():
    """3 batch rows over a data extent of 2 (no collective is reached)."""
    mesh = ProcessMesh(("data", "model"), (2, 2), 0, torch.device("cpu"))
    cfg = configs.get_smoke(ARCH)
    fn = sharded_round.make_fed_round(
        cfg, FedConfig(**ROUND_KW), placement="sequential",
        compute_dtype=F32, use_sampling=False, mesh=mesh)
    layout = sharded_round.fsdp_layout(cfg, mesh)
    state = layout.shard_state(_state())
    assert tm.tree_size(state.params) == layout.n == -(-1_312_256 // 4)
    tokens = np.zeros((2, 8, 3, 17), np.int32)
    with pytest.raises(ValueError, match="do not split evenly"):
        fn(state, {"tokens": tokens})
