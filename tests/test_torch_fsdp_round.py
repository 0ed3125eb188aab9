"""FSDP over ranks for the ``sequential`` placement (``core/fsdp.py``,
``core/sharded_round.py``) against the JAX package and the port's
one-process round, on gloo ranks spawned on the CPU.

Every case is ``tests/test_torch_lm_train.py``'s round: the smoke
fedlm-100m, fp32 compute, 2 clients with 2 batch rows each. One spawned
group per mesh (``_torch_mp.fsdp_rank``) runs a FedAvg burn-in round then
a FedPA round with batch and streaming DP, then one round of each other
algorithm (``ALGO_KW``), and on the 1 x 2 mesh a ``RoundEngine`` run;
it writes what each rank found. The module's fixture starts both groups,
computes the JAX rounds and the one-process rounds meanwhile, then joins
the groups within a deadline, and the tests only compare.

* 2 x 2 ``("data", "model")`` mesh, 4 ranks: each data rank takes one
  row of each client, the model ranks the same row. The gathered params
  and the losses after each round equal JAX's one-device ``sequential``
  round (the batch-DP run, which both DP forms equal) and the port's
  one-process one, at ``test_make_fed_round_vs_jax``'s tolerances (rtol
  1e-5, atol 1e-6 after a round without the DP and 1e-5 after a DP
  round: the grads are means of per-row means here, summed over ranks in
  fp32). SCAFFOLD's control variates are ``(theta_0 - theta_K) / (K
  lr)``: they carry the params' absolute error times ``1 / (K lr)``, so
  their atol is the params' over ``K lr``. FedEP and SCAFFOLD also equal
  the JAX package's round from the same client states
  (``test_stateful_fed_round_vs_jax``'s tolerances), and FedLoRA
  ``lowrank`` (error feedback) equals the JAX package's one-device
  ``sequential`` round (computed in a spawned child, beside the parent's
  work). Every rank holds ``ceil(d / 4)`` elements of each
  parameter-shaped tensor. The ranks write FedEP's state and store after
  its round (``save_checkpoint_fsdp``) and read them back bitwise; the
  parent restores them at W = 1 (equal to what the ranks gathered, and
  through the JAX package's ``restore_checkpoint``) and at W = 3 over
  simulated ranks.
* 1 x 2, 2 ranks: the batch does not split, so each rank computes the
  one-process gradient and the mean over the two ranks is exact (``g +
  g`` and the halving round nothing). Without the DP (FedProx, MIME,
  SCAFFOLD) every other step is elementwise, so the rounds equal one
  process's bit for bit (run with the ranks' thread count, one); with
  the DP only its dot products, summed over the two shards, differ:
  within 1e-6 of each leaf's largest entry, the losses bitwise. The
  engine run (FedEP, window 2) takes the same CAS decisions as one
  process, its stale rounds discounted through the sharded mean
  precision.
* FedLoRA's codecs (``lowrank``, ``lowrank+int8`` with error feedback on
  the device store, ``int8`` without): ``lowrank`` at the DP rounds'
  tolerances on both meshes; a quantizing round's codes may flip where a
  value sits on a rounding boundary, so its codes are compared code by
  code (one apart at most), the flips counted, and its params and
  residuals held to the bound those flips allow (``_int8_bounds``).
* Collectives: one params all-gather per gradient (``K`` a client, ``3K``
  for MIME), the codec's all-reduces (a sum of the sketches' partials
  and a max of the scales' per client), and the bytes of each kind by
  the layout's formula.

Without a group: the sharded DP step over simulated shards against
``ref.dp_step_ref``, the glue against ``ref.dp_coeffs``, the mesh's data
slot, ``fedpa_precision``'s discounted server step over three simulated
shards (the padding left out of its mean precision), the layout of the
state and of client rows by key path, and the whole-tree writers'
refusal of a flat-layout state or store (``tests/test_torch_fsdp_codecs.py``
holds the codecs and the checkpoints over simulated ranks).
"""
import json
import math
import multiprocessing as mp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mp as mpt
from test_torch_lm_train import (ARCH, F32, ROUND_KW, ROUND_TOKENS,
                                 STATEFUL_KW, JaxFedConfig, _fedlm_params,
                                 _jax_leaves, _jax_rounds,
                                 _jax_stateful_round, _stateful_inputs,
                                 _tokens, jax_configs, jax_get_algorithm,
                                 jax_get_optimizer, jax_init_server_state,
                                 jax_make_fed_round)
from repro.checkpoint import restore_checkpoint as jax_restore
from repro.core.server import ServerState as JaxServerState
from repro_torch import configs
from repro_torch.algorithms import algorithm_names, get_algorithm
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.configs.base import FedConfig
from repro_torch.convert import lm_params_from_jax
from repro_torch.core import collective, fsdp, sharded_round
from repro_torch.core import tree_math as tm
from repro_torch.core.client_state import make_client_store
from repro_torch.core.server import init_server_state
from repro_torch.core.shrinkage import rho_l
from repro_torch.kernels import ops, ref
from repro_torch.launch.mesh import ProcessMesh
from repro_torch.models.model import init_params
from repro_torch.optim import get_optimizer

#: mesh name -> ("data", "model") extents
MESHES = {"2x2": (2, 2), "1x2": (1, 2)}
DPS = ("batch", "streaming")
#: atol of the params after the burn-in round and after the FedPA round
ATOLS = (1e-6, 1e-5)
#: seconds the groups may take after the parent's own work
JOIN_S = 150.0
#: One round of each other algorithm from ``_fedlm_params`` with
#: ``ROUND_TOKENS[1]``: SCAFFOLD on the host store's slice, FedEP and
#: FedLoRA (identity codec, error feedback) on the device store. The
#: starting states are ``_stateful_inputs``' draws (SCAFFOLD's also give
#: MIME its server momentum and FedLoRA its residuals).
ALGO_KW = {
    "fedpa_precision": dict(ROUND_KW, algorithm="fedpa_precision"),
    "fedprox": dict(ROUND_KW, algorithm="fedprox"),
    "mime": dict(ROUND_KW, algorithm="mime"),
    "scaffold": STATEFUL_KW["scaffold"],
    "fedep": dict(STATEFUL_KW["fedep"], client_state_placement="device"),
    "fedlora": dict(ROUND_KW, algorithm="fedlora",
                    client_state_placement="device"),
    "fedlora_lowrank": dict(ROUND_KW, algorithm="fedlora",
                            payload_codec="lowrank",
                            client_state_placement="device"),
    "fedlora_lowrank_int8": dict(ROUND_KW, algorithm="fedlora",
                                 payload_codec="lowrank+int8",
                                 client_state_placement="device"),
    "fedlora_int8": dict(ROUND_KW, algorithm="fedlora",
                         payload_codec="int8", error_feedback=False),
}
#: the algorithms whose round runs the DP
DP_ALGOS = ("fedpa_precision", "fedep", "fedlora", "fedlora_lowrank",
            "fedlora_lowrank_int8", "fedlora_int8")
#: the cases that quantize their payloads: held to the flip-derived bound
#: (``_assert_int8_round``) instead of the round's tolerance
INT8_ALGOS = ("fedlora_lowrank_int8", "fedlora_int8")
#: the case whose state and store the 2 x 2 group's ranks checkpoint
CKPT_ALGO = "fedep"
#: The 1 x 2 mesh's ``RoundEngine`` run: FedEP at window 2 over 3 clients,
#: 3 rounds whose cohorts overlap, so the CAS drops the second round's
#: write of client 1 and the third's of client 2; the stale rounds are
#: discounted
ENGINE_KW = dict(STATEFUL_KW["fedep"], client_state_placement="device",
                 async_rounds=True, max_staleness=1, staleness_discount=0.9,
                 burn_in_rounds=0)
#: The engine runs of the 1 x 2 mesh: FedEP, and FedLoRA ``lowrank+int8``
#: with error feedback under the same window, ids and tokens (a stale
#: cohort's sketch is its dispatch-time round's)
ENGINE_RUNS = {"engine": ENGINE_KW,
               "engine_fedlora": {**ENGINE_KW,
                                  **ALGO_KW["fedlora_lowrank_int8"],
                                  "async_rounds": True,
                                  "burn_in_rounds": 0}}
ENGINE_IDS = np.array([[0, 1], [1, 2], [0, 2]])
ENGINE_TOKENS = _tokens((3, 2, 8, 2, 17), seed=30)


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


def _inputs(engine: bool) -> dict:
    """A group's ``inputs.npz``: the params (``p/``), both rounds' tokens,
    the ``FedConfig`` kwargs, each other algorithm's kwargs and starting
    states (``c/``, ``m/``, ``cs/<algorithm>/``), and with ``engine`` the
    engine run's."""
    stack, c = _stateful_inputs("scaffold")
    sites, _ = _stateful_inputs("fedep")
    trees = {"p": _fedlm_params(), "c": c, "m": c, "cs/scaffold": stack,
             "cs/fedep": sites, "cs/fedlora": stack}
    out = dict(round_kw=json.dumps(ROUND_KW), algo_kw=json.dumps(ALGO_KW),
               tokens0=ROUND_TOKENS[0], tokens1=ROUND_TOKENS[1],
               ckpt_algo=CKPT_ALGO)
    for prefix, tree in trees.items():
        out.update({f"{prefix}/{k}": v for k, v in _by_path(tree).items()})
    if engine:
        out.update(engine_kw=json.dumps(ENGINE_RUNS), engine_ids=ENGINE_IDS,
                   engine_tokens=ENGINE_TOKENS)
    return out


def _jax_lowrank_round():
    """The JAX package's one-device ``sequential`` FedLoRA ``lowrank``
    round (error feedback, the host store's slice) from the FSDP cases'
    params and residuals: ``(params, new residuals, losses)``, each
    tree as ``(key path, array)`` pairs."""
    kw = dict(ALGO_KW["fedlora_lowrank"], client_state_placement="host")
    fed = JaxFedConfig(**kw)
    opt = jax_get_optimizer(fed.server_opt, fed.server_lr,
                            fed.server_momentum)
    state = jax_init_server_state(
        jax.tree_util.tree_map(jnp.asarray, _fedlm_params()), opt,
        algorithm=jax_get_algorithm(fed))
    fn = jax.jit(jax_make_fed_round(jax_configs.get_smoke(ARCH), fed,
                                    placement="sequential",
                                    compute_dtype=jnp.float32, q_chunk=8))
    residuals, _ = _stateful_inputs("scaffold")
    state, metrics, new = fn(state, {"tokens": ROUND_TOKENS[1]}, None,
                             residuals)
    return (_jax_leaves(state.params), _jax_leaves(new),
            {k: float(v) for k, v in metrics.items()})


def _jax_lowrank_child(path: str) -> None:
    """``_jax_lowrank_round`` in a spawned child: its params and residuals
    by path (``params/``, ``states/``) and losses into ``path``."""
    jax.config.update("jax_enable_x64", False)
    params, states, metrics = _jax_lowrank_round()
    np.savez(path, **metrics, **{f"{prefix}/{mpt.path_key(k)}": v
                                 for prefix, pairs in (("params", params),
                                                       ("states", states))
                                 for k, v in pairs})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{"jax": ..., "jax_state": {alg: ...}, "one": {dp: ...},
    "one_algo": {alg: ...}, "one_engine": ..., mesh: {dp or alg or
    "engine": [rank npz]}}``."""
    groups = {}
    for name, shape in MESHES.items():
        out = str(tmp_path_factory.mktemp(f"fsdp_{name}"))
        np.savez(os.path.join(out, "inputs.npz"), **_inputs(name == "1x2"))
        groups[name] = (out, math.prod(shape),
                        mpt.start_group(mpt.fsdp_rank, math.prod(shape),
                                        (out, shape)))
    # the JAX lowrank round (mostly XLA compiling) in a spawned child
    lowrank = os.path.join(str(tmp_path_factory.mktemp("jax_lowrank")),
                           "round.npz")
    child = mp.get_context("spawn").Process(target=_jax_lowrank_child,
                                            args=(lowrank,))
    child.start()
    found = {"jax": _jax_rounds("sequential"),
             "jax_state": {a: _jax_stateful_round(a)
                           for a in ("fedep", "scaffold")},
             "one": {dp: _one_process(dp) for dp in DPS}}
    inputs = np.load(os.path.join(groups["1x2"][0], "inputs.npz"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)      # the ranks' own count
    try:
        found["one_algo"] = {a: mpt.algo_round(kw, inputs)
                             for a, kw in ALGO_KW.items()}
        found["one_engine"] = {name: mpt.engine_run(kw, inputs)
                               for name, kw in ENGINE_RUNS.items()}
    finally:
        torch.set_num_threads(threads)
    mpt.join_group([child], JOIN_S)
    found["jax_lowrank"] = dict(np.load(lowrank))
    for name, (out, world, procs) in groups.items():
        mpt.join_group(procs, JOIN_S)
        cases = [*DPS, *ALGO_KW] + (list(ENGINE_RUNS) if name == "1x2"
                                    else [])
        found[name] = {case: [dict(np.load(os.path.join(
            out, f"{case}.rank{r}.npz"))) for r in range(world)]
            for case in cases}
        found[name]["ckpt"] = os.path.join(out, "ckpt")
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


def _state(kw=ROUND_KW):
    fed = FedConfig(**kw)
    opt = get_optimizer(fed.server_opt, fed.server_lr, fed.server_momentum)
    return init_server_state(lm_params_from_jax(_fedlm_params(), "cpu"),
                             opt, algorithm=get_algorithm(fed))


def _params_of(got: dict, prefix: str) -> dict:
    """``{key: array}`` of a run's entries under ``prefix/``."""
    return {k: v for k, v in got.items() if k.startswith(prefix + "/")}


def _trees(got: dict) -> dict:
    """A run's gathered params, ``c`` and client states."""
    return {k: v for p in ("params", "c", "states")
            for k, v in _params_of(got, p).items()}


def _c_atol(atol: float) -> float:
    """A SCAFFOLD control variate's atol from the params': ``c`` is
    ``(theta_0 - theta_K) / (K lr)`` plus exact terms."""
    kw = ALGO_KW["scaffold"]
    return atol / (kw["local_steps"] * kw["client_lr"])


#: The codes' scales (``max |x| / qmax`` of each client's leaf) of the
#: ranks against one process: the payloads they are cut from differ by
#: the rounds' fp32 noise (1e-5 of the params after a DP round on 2 x 2,
#: carried into deltas some 100x smaller than the params)
SCALE_RTOL = 1e-3


def _int8_bounds(got: dict, want: dict, algorithm: str):
    """The int8 codes of every client's delta and precision on a rank
    (``got``) against one process's (``want``): each code the same or one
    apart (a flip: the two inputs straddle a half quantum), the scales
    within ``SCALE_RTOL``. Returns the flips, and per leaf (``a/b``) the
    bound they put on the params and on each client's residual.

    The bound: the server's pseudo-gradient is the precision-weighted mean
    ``g = sum_i w_i p_i d_i / sum_i w_i p_i`` in the accumulator space (the
    params' for ``int8``, the sketch's for ``lowrank+int8``). A flip of
    ``d_i`` moves ``g`` by at most the delta's scale ``s`` (``w_i p_i``
    is at most the denominator); a flip of ``p_i`` leaves ``g`` a convex
    combination of the ``d_i``, each moved by at most ``s``, so it moves
    by at most the spread ``max_i d_i - min_i d_i`` plus ``2 s``. The
    sketch lifts a factor row by ``V.T``, whose rows have norm at most 1,
    so an element moves by at most ``sqrt(r)`` times its row's largest
    change. The server's first SGD-momentum step from zero momentum moves
    the params by ``server_lr`` times ``g``. A client's residual ``c -
    decode(Q(c))`` moves by ``sqrt(r) s`` (``s`` without the sketch)
    where its delta's codes flipped; its fp32 noise is taken relative to
    the largest ``|c|``, at most ``max |residual| + sqrt(r) qmax s`` (the
    decoded part lifts codes of at most ``qmax``)."""
    kw = ALGO_KW[algorithm]
    fed = FedConfig(**kw)
    r = fed.lora_rank
    lowrank = "lowrank" in fed.payload_codec
    qmax = float(2 ** (fed.quant_bits - 1) - 1)
    C = fed.clients_per_round
    flips, params, states = 0, {}, {}
    for path, leaf in _jax_leaves(_fedlm_params()):
        path = mpt.path_key(path)
        grow = math.sqrt(r) if (lowrank and leaf.ndim >= 2
                                and leaf.shape[-1] > r) else 1.0
        f, sc, dec = {}, {}, []
        for part in ("delta", "prec"):
            for k in range(C):
                key = f"wire/{k}/{part}/{path}"
                qg, qo = got[key + "/q"], want[key + "/q"]
                sg, so = got[key + "/scale"], want[key + "/scale"]
                np.testing.assert_allclose(sg, so, rtol=SCALE_RTOL,
                                           err_msg=key)
                dq = np.abs(qg - qo)
                assert dq.max() <= 1, key
                f[part, k] = int(dq.sum())
                sc[part, k] = float(max(sg, so))
                if part == "delta":
                    dec.append(qo * so)
        flips += sum(f.values())
        s = max(sc["delta", k] for k in range(C))
        spread = float((np.max(dec, axis=0) - np.min(dec, axis=0)).max())
        moved = (s * any(f["delta", k] for k in range(C))
                 + (spread + 2 * s) * any(f["prec", k] for k in range(C)))
        params[path] = kw["server_lr"] * grow * moved
        states[path] = [(grow * sc["delta", k] * (f["delta", k] > 0),
                         grow * qmax * sc["delta", k]) for k in range(C)]
    return flips, params, states


def _assert_int8_round(got: dict, want: dict, algorithm: str, tol: float,
                       relative: bool) -> int:
    """A rank's params and residuals after an int8 round within the fp32
    noise (``tol``: absolute with ``rtol`` ``tol``, or ``relative`` to
    each leaf's largest entry) plus ``_int8_bounds``' flip bound of one
    process's; returns the flips."""
    flips, params, states = _int8_bounds(got, want, algorithm)
    for k, w in _trees(want).items():
        prefix, path = k.split("/", 1)
        if prefix == "params":
            noise = tol * np.abs(w).max() if relative else tol
            np.testing.assert_allclose(got[k], w, rtol=0 if relative
                                       else tol, atol=noise + params[path],
                                       err_msg=k)
            continue
        for c, (flip, cover) in enumerate(states[path]):
            noise = tol * (np.abs(w[c]).max() + cover)
            np.testing.assert_allclose(got[k][c], w[c], rtol=0,
                                       atol=noise + flip, err_msg=k)
    return flips


@pytest.mark.parametrize("algorithm", sorted(ALGO_KW))
def test_fsdp_2x2_algorithm_equals_one_process(runs, algorithm,
                                               record_property):
    """At the DP algorithms' tolerance (rtol 1e-5, atol 1e-5; 1e-6
    without the DP), the int8 cases within ``_int8_bounds``' flip bound
    (the flips recorded); the ranks equal bit for bit."""
    want = runs["one_algo"][algorithm]
    atol = 1e-5 if algorithm in DP_ALGOS else 1e-6
    first = runs["2x2"][algorithm][0]
    assert _trees(want).keys() == _trees(first).keys()
    for got in runs["2x2"][algorithm]:
        for k in ("loss_first", "loss_last"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
        if algorithm in INT8_ALGOS:
            flips = _assert_int8_round(got, want, algorithm, atol, False)
            record_property("int8_flips", flips)
            for k, w in _trees(want).items():
                np.testing.assert_array_equal(got[k], first[k], err_msg=k)
            continue
        for k, w in _trees(want).items():
            scaffold_cv = algorithm == "scaffold" and k.split("/")[0] in (
                "c", "states")
            np.testing.assert_allclose(
                got[k], w, rtol=1e-5,
                atol=_c_atol(atol) if scaffold_cv else atol, err_msg=k)
            np.testing.assert_array_equal(got[k], first[k], err_msg=k)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("algorithm", ["fedep", "scaffold"])
def test_fsdp_stateful_round_vs_jax(runs, mesh, algorithm):
    """The params, SCAFFOLD's ``c`` and the clients' new states, gathered
    back, against the JAX package's round from the same states, at
    ``test_stateful_fed_round_vs_jax``'s tolerances."""
    want_params, want_c, want_states, want_metrics = runs["jax_state"][
        algorithm]
    kw = ALGO_KW[algorithm]
    theta = dict(_jax_leaves(_fedlm_params()))
    delta_scale = kw["local_steps"] * kw["client_lr"]
    for got in runs[mesh][algorithm]:
        for k, v in want_metrics.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5)
        for prefix, want, of_delta in (
                ("params", want_params, False), ("c", want_c, True),
                ("states", want_states, algorithm == "scaffold")):
            assert len(_params_of(got, prefix)) == len(want)
            for path, w in want:
                key = "/".join([prefix] + [k.strip("'") for k in
                                           path.strip("[]").split("][")])
                if of_delta:
                    np.testing.assert_allclose(
                        got[key], w, rtol=1e-5,
                        atol=1e-5 * np.abs(theta[path]).max() / delta_scale,
                        err_msg=key)
                else:
                    np.testing.assert_allclose(
                        got[key], w, rtol=1e-5,
                        atol=1e-5 * np.abs(w).max(), err_msg=key)


@pytest.mark.parametrize("algorithm", sorted(ALGO_KW))
def test_fsdp_1x2_algorithm_within_one_process(runs, algorithm,
                                               record_property):
    """The losses bitwise (the local steps are the one-process steps);
    the trees bitwise without the DP, within 1e-6 of each leaf's largest
    entry with it, and for the int8 cases within that plus
    ``_int8_bounds``' flip bound (the flips recorded)."""
    want = runs["one_algo"][algorithm]
    for got in runs["1x2"][algorithm]:
        for k in ("loss_first", "loss_last"):
            np.testing.assert_array_equal(got[k], want[k])
        if algorithm in INT8_ALGOS:
            record_property("int8_flips", _assert_int8_round(
                got, want, algorithm, 1e-6, True))
            continue
        for k, w in _trees(want).items():
            if algorithm in DP_ALGOS:
                np.testing.assert_allclose(got[k], w, rtol=0,
                                           atol=1e-6 * np.abs(w).max(),
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("algorithm", sorted(ALGO_KW))
def test_fsdp_algorithm_state_shards(runs, mesh, algorithm):
    """Each rank holds ``ceil(d / W)`` elements of the params and of each
    parameter-shaped state: ``c``, a client's row (``c_i``, the sites,
    the residual), MIME's broadcast momentum and the store's rows."""
    W = math.prod(MESHES[mesh])
    n = -(-1_312_256 // W)
    want = {"params": n}
    if algorithm == "scaffold":
        want.update(c=n, row=n)
    if algorithm == "mime":
        want.update(momentum=n)
    stored = get_algorithm(FedConfig(**ALGO_KW[algorithm])).stateful \
        and algorithm != "scaffold"
    if stored:
        want.update(row=n)
    for got in runs[mesh][algorithm]:
        held = {k.split("/")[1]: v for k, v in got.items()
                if k.startswith("held/")}
        rows = held.pop("store_rows", None)
        assert {k: int(v) for k, v in held.items()} == want
        if stored:
            C = ALGO_KW[algorithm]["clients_per_round"]
            assert rows.tolist() == [[C, n]] * (
                2 if algorithm == "fedep" else 1)


def _codec_traffic(kw: dict):
    """A round's codec all-reduces and the fp32 elements each rank sends
    in them to each other rank, by the formula: per client, one sum of
    the ``lowrank`` factors of every sketched leaf (``R x r`` each, for
    the delta and the precision) and one max of the ``int8`` maxima
    (one per leaf, for both); none for the identity codec."""
    fed = FedConfig(**kw)
    codec = fed.payload_codec if fed.algorithm == "fedlora" else "none"
    leaves = [x.shape for _, x in _jax_leaves(_fedlm_params())]
    r = fed.lora_rank
    factors = sum(math.prod(s[:-1]) * r for s in leaves
                  if len(s) >= 2 and s[-1] > r)
    C = fed.clients_per_round
    lowrank, int8 = "lowrank" in codec, "int8" in codec
    return (C * (lowrank + int8),
            C * 2 * (factors * lowrank + len(leaves) * int8))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("algorithm", sorted(ALGO_KW))
def test_fsdp_algorithm_gathers_per_client(runs, mesh, algorithm):
    """One params all-gather and one gradient reduce per gradient: ``K``
    a client, ``3K`` for MIME (the anchor pass, then ``g(theta_k)`` and
    ``g(theta_0)`` each step), each gather the shard to ``W - 1`` ranks;
    the codec's all-reduces by ``_codec_traffic``'s formula."""
    W = math.prod(MESHES[mesh])
    kw = ALGO_KW[algorithm]
    C, K = kw["clients_per_round"], kw["local_steps"]
    per = C * K * (3 if algorithm == "mime" else 1)
    calls, elements = _codec_traffic(kw)
    for got in runs[mesh][algorithm]:
        n = int(got["held/params"])
        assert got["traffic/param_gathers"] == per
        assert got["traffic/grad_reduces"] == per
        assert got["traffic/params"] == per * (W - 1) * n * 4
        assert got["traffic/grads"] == per * 2 * (W - 1) * n * 4
        assert got["traffic/codec_reduces"] == calls
        assert got["traffic/codec"] == elements * (W - 1) * 4


def test_fsdp_2x2_lowrank_equals_jax(runs):
    """FedLoRA ``lowrank`` (error feedback) on the 2 x 2 mesh against the
    JAX package's one-device ``sequential`` round from the same params
    and residuals: the params and the residuals at
    ``test_make_fed_round_vs_jax``'s tolerances (rtol 1e-5, atol 1e-5;
    a residual ``c - decode(encode(c))`` carries the corrected delta
    ``c``'s absolute error, which is the params' own), the losses to
    1e-5."""
    want = runs["jax_lowrank"]
    for got in runs["2x2"]["fedlora_lowrank"]:
        for k in ("loss_first", "loss_last"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
        assert _trees(got).keys() == _trees(want).keys()
        for k, w in _trees(want).items():
            np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-5,
                                       err_msg=k)


def _ckpt_like(layout, n_clients: int):
    """A FedEP checkpoint's template under ``layout``: the sharded server
    state and a store of ``n_clients`` made for the layout."""
    kw = ALGO_KW[CKPT_ALGO]
    state = layout.shard_state(_state(kw))
    store = make_client_store("device", n_clients, device="cpu",
                              fsdp=layout)
    store.ensure(get_algorithm(FedConfig(**kw)).init_client_state(
        state.params))
    return {"server": state, "clients": store.state_dict()}, store


def test_fsdp_checkpoint_restores_at_every_w(runs, tmp_path):
    """The FedEP state and store that the 2 x 2 group's four ranks wrote
    after their round (``save_checkpoint_fsdp``): each rank read its own
    back bitwise; restored at W = 1 on no mesh they equal the params and
    rows the ranks gathered; at W = 3 over simulated ranks each rank's
    shards and rows equal the layout's cut of that whole, bit for bit;
    and the whole tree, written by ``save_checkpoint``, reads back
    through the JAX package's ``restore_checkpoint``."""
    ckpt = runs["2x2"]["ckpt"]
    got = runs["2x2"][CKPT_ALGO]
    assert all(bool(g["ckpt/bitwise"]) for g in got)
    assert ckpt_io.latest_fsdp_checkpoint(ckpt) == 1
    C = ALGO_KW[CKPT_ALGO]["clients_per_round"]
    template = init_params(None, configs.get_smoke(ARCH), device="meta")
    one = fsdp.FlatShard(template)
    like, store = _ckpt_like(one, C)
    tree, step, _ = ckpt_io.restore_checkpoint_fsdp(ckpt, like, None, one)
    assert step == 1 and fsdp.in_flat_layout(tree["server"].params)
    whole = one.gather_state(tree["server"])
    rows = one.gather_rows(tm.tmap(torch.from_numpy,
                                   tree["clients"]["buffers"]))
    for k, w in _trees(got[0]).items():
        prefix, path = k.split("/", 1)
        mine = whole.params if prefix == "params" else rows
        for part in path.split("/"):
            mine = mine[part]
        np.testing.assert_array_equal(np.asarray(mine), w, err_msg=k)
    assert whole.round == 1 and whole.opt_state["step"] == 1
    store.load_state_dict(tree["clients"])
    # one write loading the starting states, one the round's write-back
    assert store.state_dict()["stamps"].tolist() == [2] * C
    for mesh in _meshes(3):
        lay = fsdp.FlatShard(template, mesh)
        like3, _ = _ckpt_like(lay, C)
        got3, _, _ = ckpt_io.restore_checkpoint_fsdp(ckpt, like3, 1, lay)
        want3 = lay.shard_state(whole)
        assert torch.equal(got3["server"].params, want3.params)
        assert torch.equal(got3["server"].opt_state["m"],
                           want3.opt_state["m"])
        for key, x in lay.shard_rows(rows).items():
            np.testing.assert_array_equal(
                got3["clients"]["buffers"][key], x.numpy())
    clients = {"buffers": rows, "stamps": tree["clients"]["stamps"]}
    ckpt_io.save_checkpoint(str(tmp_path), {"server": whole,
                                            "clients": clients}, 1)
    np_whole = tm.tmap(lambda x: x.numpy() if isinstance(x, torch.Tensor)
                       else x, whole)
    jax_like = {"server": JaxServerState(
                    np_whole.params, np_whole.opt_state, 0, ()),
                "clients": {"buffers": tm.tmap(lambda x: x.numpy(), rows),
                            "stamps": np.zeros(C, np.int64)}}
    back, step, _ = jax_restore(str(tmp_path), jax_like)
    assert step == 1 and int(back["server"].round) == 1
    for (path, w), (_, b) in zip(ckpt_io.leaves_with_paths(
            {"server": np_whole, "clients": clients}),
            ckpt_io.leaves_with_paths(back)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(w),
                                      err_msg=path)


def test_fsdp_engine_window_2_equals_one_process(runs):
    """FedEP through ``RoundEngine`` at window 2 on the 1 x 2 mesh: the
    same staleness and CAS drops as one process, the params and the
    store's rows gathered back within 1e-6 of each leaf's largest entry
    (the DP's dots summed over the shards)."""
    want = runs["one_engine"]["engine"]
    assert want["state_drops"].tolist() == [0, 1, 1]
    assert want["staleness"].tolist() == [0, 1, 1]
    for got in runs["1x2"]["engine"]:
        for k in ("state_drops", "staleness"):
            np.testing.assert_array_equal(got[k], want[k])
        for k, w in _trees(want).items():
            np.testing.assert_allclose(got[k], w, rtol=0,
                                       atol=1e-6 * np.abs(w).max(),
                                       err_msg=k)


def test_fsdp_engine_window_2_fedlora_lowrank_int8(runs, record_property):
    """FedLoRA ``lowrank+int8`` (error feedback, device store) through
    ``RoundEngine`` at window 2 on the 1 x 2 mesh: the same staleness and
    CAS drops as one process, the ranks bit for bit alike, and each
    cohort's wire payloads, in dispatch order, code for code within one
    of one process's, their scales within ``SCALE_RTOL`` (each stale
    cohort encoded against its dispatch-time round's sketch). Where no
    code flipped, the params are within 1e-6 of each leaf's largest entry
    and the residuals, differences of corrected deltas ``c``, within 1e-5
    of the largest ``|c|`` their codes cover (``_int8_bounds``' bound on
    it), as ``tests/test_torch_fedlora.py`` holds residuals; a flip's
    effect carries into the later rounds' starting points, so with flips
    (recorded) the trees are not compared."""
    want = runs["one_engine"]["engine_fedlora"]
    r = FedConfig(**ENGINE_RUNS["engine_fedlora"]).lora_rank
    assert want["staleness"].tolist() == [0, 1, 1]
    first = runs["1x2"]["engine_fedlora"][0]
    wires = sorted(k for k in want if k.startswith("wire/"))
    assert wires and wires == sorted(k for k in first if
                                     k.startswith("wire/"))
    for got in runs["1x2"]["engine_fedlora"]:
        for k in ("state_drops", "staleness"):
            np.testing.assert_array_equal(got[k], want[k])
        flips = 0
        for k in wires:
            if k.endswith("/scale"):
                np.testing.assert_allclose(got[k], want[k],
                                           rtol=SCALE_RTOL, err_msg=k)
            else:
                dq = np.abs(got[k] - want[k])
                assert dq.max() <= 1, k
                flips += int(dq.sum())
        record_property("int8_flips", flips)
        for k, w in _trees(want).items():
            np.testing.assert_array_equal(got[k], first[k], err_msg=k)
            if flips:
                continue
            tol, cover = 1e-6, 0.0
            if k.startswith("states/"):     # (C, *leaf) residuals
                grow = (math.sqrt(r) if w.ndim >= 3 and w.shape[-1] > r
                        else 1.0)
                tol, cover = 1e-5, grow * 127.0 * max(
                    float(want[s]) for s in wires if "/delta/" in s and
                    s.endswith(k[len("states"):] + "/scale"))
            np.testing.assert_allclose(
                got[k], w, rtol=0, atol=tol * (np.abs(w).max() + cover),
                err_msg=k)


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


def _meshes(W: int):
    return [ProcessMesh(("data",), (W,), r, torch.device("cpu"))
            for r in range(W)]


@pytest.mark.parametrize("pad", ["round", "garbage"])
def test_fedpa_precision_discount_over_three_shards(pad, monkeypatch):
    """``fedpa_precision``'s discounted server step on 3 simulated shards
    of the smoke params (d = 1,312,256, n = 437,419, one padded element)
    equals the one-process step: the mean precision sums exactly the d
    parameters, over the ranks. The padding holds what a sharded round
    leaves there (``1 / rho_l``: zero samples, zero variance) or garbage;
    either way it stays out of the mean."""
    kw = ALGO_KW["fedpa_precision"]
    fed = FedConfig(**kw)
    opt = get_optimizer(fed.server_opt, fed.server_lr, fed.server_momentum)
    state = _state(kw)
    r = np.random.default_rng(7)
    agg = {"num": tm.tmap(lambda p: torch.from_numpy(
               r.normal(size=p.shape).astype(np.float32)), state.params),
           "den": tm.tmap(lambda p: torch.from_numpy(
               (np.abs(r.normal(size=p.shape)) + 0.5).astype(np.float32)),
               state.params)}
    want = get_algorithm(fed).server_update(state, agg, opt, 0.8)
    template = init_params(None, configs.get_smoke(ARCH), device="meta")
    layouts = [fsdp.FlatShard(template, m) for m in _meshes(3)]
    d, n = layouts[0].d, layouts[0].n
    assert (d, n, 3 * n - d) == (1_312_256, 437_419, 1)
    fill = (1.0 / float(rho_l(3, fed.shrinkage_rho)) if pad == "round"
            else 1e30)
    aggs = [{k: lay.shard_tree(v) for k, v in agg.items()}
            for lay in layouts]
    aggs[-1]["den"][layouts[-1].real:] = fill
    parts = []
    monkeypatch.setattr(collective, "all_reduce_small",
                        lambda mesh, x: parts.append(x) or x)
    totals = [lay.param_total(a["den"]) for lay, a in zip(layouts, aggs)]
    assert all(count == d for _, count in totals)
    total = sum(parts)
    whole = sum(x.sum() for x in tm.tleaves(agg["den"]))
    torch.testing.assert_close(total[0], whole, rtol=1e-6, atol=0)
    monkeypatch.setattr(collective, "all_reduce_small",
                        lambda mesh, x: total)
    got = []
    for lay, a in zip(layouts, aggs):
        alg = get_algorithm(fed)
        alg.layout = lay
        got.append(alg.server_update(lay.shard_state(state), a, opt, 0.8))
    one = fsdp.FlatShard(template)
    for part in (lambda s: s.params, lambda s: s.opt_state["m"]):
        flat = torch.cat([part(g) for g in got])[:d]
        torch.testing.assert_close(flat, one.shard_tree(part(want)),
                                   rtol=1e-6, atol=1e-7)


def _small_template():
    return {"b": torch.zeros(3, 2, device="meta"),
            "a": {"y": torch.zeros(5, device="meta"),
                  "x": torch.zeros(1, device="meta")}}


def _small_tree(start: float, lead=()):
    """A tree shaped like ``_small_template`` (plus ``lead`` axes) in the
    JAX package's sorted key order, counting up from ``start``."""
    k = math.prod(lead)
    vals = torch.arange(start, start + 12 * k).reshape(*lead, 12)
    return {"a": {"x": vals[..., 0:1], "y": vals[..., 1:6]},
            "b": vals[..., 6:12].reshape(*lead, 3, 2)}


def test_layout_shards_and_gathers_state_by_path():
    """``shard_state`` of a state whose params, momentum and
    ``algo_state`` are in another key order, over 5 simulated ranks: each
    part's shards put together are its ravel in the template's order, the
    shards are marked as the flat layout's; ``gather_state`` gives the
    trees back."""
    state = init_server_state(_small_tree(1.0), get_optimizer("sgdm", 0.1))
    state = state._replace(opt_state={"step": 3, "m": _small_tree(20.0)},
                           algo_state=_small_tree(40.0))
    shards = [fsdp.FlatShard(_small_template(), m).shard_state(state)
              for m in _meshes(5)]
    for part, start in ((lambda s: s.params, 1.0),
                        (lambda s: s.opt_state["m"], 20.0),
                        (lambda s: s.algo_state, 40.0)):
        flat = torch.cat([part(s) for s in shards])
        order = (6, 7, 8, 9, 10, 11, 1, 2, 3, 4, 5, 0)
        assert flat.tolist() == [start + i for i in order] + [0.0] * 3
        assert all(fsdp.in_flat_layout(part(s)) for s in shards)
    assert shards[0].opt_state["step"] == 3
    assert not fsdp.in_flat_layout(state.params["b"])
    one = fsdp.FlatShard(_small_template())
    whole = one.shard_state(state)
    back = one.gather_state(whole)
    for got, want in ((back.params, state.params),
                      (back.opt_state["m"], state.opt_state["m"]),
                      (back.algo_state, state.algo_state)):
        for path, x in fsdp._paths(want):
            assert torch.equal(dict(fsdp._paths(got))[path], x)


def test_layout_shards_and_gathers_client_rows_by_path():
    """``shard_rows`` of stacked client states (a dict of two
    params-shaped stacks, numpy, in another key order) over 5 simulated
    ranks: each row's shards put together are its ravel; ``gather_rows``
    gives the stacks back."""
    sites = {"num": _small_tree(1.0, (2,)), "den": _small_tree(50.0, (2,))}
    host = tm.tmap(lambda x: x.numpy(), sites)
    rows = [fsdp.FlatShard(_small_template(), m).shard_rows(host)
            for m in _meshes(5)]
    for key, start in (("num", 1.0), ("den", 50.0)):
        flat = torch.cat([r[key] for r in rows], dim=-1)
        assert flat.shape == (2, 15)
        for c in (0, 1):
            s = start + 12 * c
            assert flat[c].tolist() == [s + i for i in (6, 7, 8, 9, 10, 11,
                                                        1, 2, 3, 4, 5, 0)
                                        ] + [0.0] * 3
    one = fsdp.FlatShard(_small_template())
    back = one.gather_rows(one.shard_rows(sites))
    for key in sites:
        for path, x in fsdp._paths(sites[key]):
            assert torch.equal(dict(fsdp._paths(back[key]))[path], x)


def test_fsdp_runs_every_algorithm():
    assert sorted(fsdp.ALGORITHMS) == sorted(algorithm_names())


@pytest.mark.parametrize("what", ["server state", "store"])
def test_fsdp_checkpoints_refused(tmp_path, what):
    """Neither a server state in the flat layout nor a store made for it
    is written by the whole-tree writers as if it were whole: the error
    names the FSDP writer, and nothing is written."""
    mesh = ProcessMesh(("data",), (2,), 1, torch.device("cpu"))
    layout = sharded_round.fsdp_layout(configs.get_smoke(ARCH), mesh)
    state = layout.shard_state(_state(ALGO_KW["scaffold"]))
    with pytest.raises(ValueError, match="save_checkpoint_fsdp"):
        if what == "server state":
            ckpt_io.save_checkpoint(str(tmp_path), {"server": state}, 1)
        else:
            store = make_client_store("device", 3, device="cpu",
                                      fsdp=layout)
            store.ensure(get_algorithm(FedConfig(**ALGO_KW["fedep"]))
                         .init_client_state(state.params))
            assert tuple(store.device_state()["buffers"]["num"].shape) == (
                3, layout.n)
            ckpt_io.save_store_sharded(str(tmp_path), store, 1)
    assert not os.listdir(tmp_path)
