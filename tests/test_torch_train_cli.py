"""The port's training entry point (``repro_torch.launch.train``) and its
example on the CPU at smoke size: the records carry exactly the JAX
entry point's keys, the phase flips from the burn-in to FedPA, the losses are
finite, the per-client state flags run and ``--ckpt-dir`` resumes,
``--async-rounds`` runs give the JAX entry point's records (FedLoRA's
``lowrank`` sketch among them), prefetching changes no number, the codec
flags parse as the JAX entry point parses them, the multi-process flags
raise the reference's errors for a bad launch while ``--shard-population``
runs in one process, and the per-client grad
runs the families the port trains since it trains them all.

Every run here builds its cohorts inline or on the thread prefetcher
(``--prefetch-backend thread``): no test process starts a child
(``tests/test_torch_prefetch.py`` runs the process backend in a
subprocess). Records of two runs on the CPU are compared with a
tolerance, not bit for bit: the port's LM path on the CPU is not bitwise
repeatable (threaded reductions). Against the JAX entry point, both in
fp32 compute from the same numpy weights: losses to 1e-4 relative (eight
local sgdm steps through two layers and the DP, summed in another order;
``tests/test_torch_lm_train.py`` holds one round's params to 1e-5).
"""
import dataclasses
import functools
import json
import math
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np

import pytest
import torch

from test_torch_archs import _setup
from test_torch_lm_grads import _batch
from test_torch_lm_train import _fedlm_params
from repro.core import sharded_round as jax_sharded_round
from repro.launch import train as jax_train
from repro.models import steps as jax_steps
from repro_torch import configs
from repro_torch.convert import lm_params_from_jax
from repro_torch.core import tree_math as tm
from repro_torch.examples import train_lm_federated
from repro_torch.launch import train
from repro_torch.launch.mesh import DEFAULT_TIMEOUT_S
from repro_torch.models import steps

#: The keys of one round's record in ``repro/launch/train.py``'s
#: ``run_rounds.on_round``.
JAX_RECORD_KEYS = {"round", "eval_loss", "client_loss_last",
                   "client_loss_first", "staleness", "phase", "sec",
                   "dropped", "straggled", "bytes_up", "bytes_down"}

SMOKE = ["--smoke", "--device", "cpu", "--clients", "2", "--local-steps",
         "6", "--burn-in-steps", "2", "--steps-per-sample", "2",
         "--burn-in-rounds", "1", "--batch", "2", "--seq-len", "24",
         "--prefetch-backend", "thread"]


@pytest.fixture(scope="module", autouse=True)
def _x32():
    """Other test modules turn on jax x64 at import; compare in fp32."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def test_train_main_records(tmp_path, capsys):
    log = tmp_path / "log.jsonl"
    res = train.main(SMOKE + ["--rounds", "2", "--log", str(log)])
    recs = res["records"]
    assert [set(r) for r in recs] == [JAX_RECORD_KEYS] * 2
    assert [r["phase"] for r in recs] == ["fedavg (burn-in)", "fedpa"]
    assert [r["round"] for r in recs] == [0, 1]
    for r in recs:
        assert all(math.isfinite(r[k]) for k in (
            "eval_loss", "client_loss_last", "client_loss_first"))
        assert (r["staleness"], r["dropped"], r["straggled"]) == (0, 0, 0)
        # one fp32 delta up and the fp32 params down per client
        assert r["bytes_up"] == r["bytes_down"] == \
            2 * 4 * res["cfg"].param_count()
    assert [json.loads(line) for line in log.read_text().splitlines()] == \
        recs
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=fedlm-100m-smoke params=1,312,256 ")
    assert [json.loads(line) for line in out[1:]] == recs
    assert len(res["history"]) == 2 and len(res["seconds"]) == 2
    assert all(torch.isfinite(p).all() for p in res["state"].params.values()
               if isinstance(p, torch.Tensor))


@pytest.mark.parametrize("arch", [None, "musicgen-medium"])
def test_example_runs_the_smoke_config_on_the_cpu(arch):
    """The example's fedlm-100m, or another arch through ``--arch``."""
    res = train_lm_federated.main(
        ["--device", "cpu", "--rounds", "1", "--batch", "1", "--seq-len",
         "16", "--prefetch-backend", "thread"]
        + ([] if arch is None else ["--arch", arch]))
    assert res["cfg"].name == f"{arch or 'fedlm-100m'}-smoke"
    assert [r["phase"] for r in res["records"]] == ["fedavg (burn-in)"]
    assert math.isfinite(res["records"][0]["eval_loss"])


#: The per-client state flags (ROADMAP.md queue 1, item 7) -> the phase
#: of the resumed round.
STATEFUL = [
    (["--client-state-placement", "device"], "fedpa"),
    (["--ckpt-every", "1"], "fedpa"),
    (["--algorithm", "scaffold", "--client-opt", "sgd"], "scaffold"),
    (["--algorithm", "fedep", "--client-state-placement", "device"],
     "fedep"),
    (["--algorithm", "fedlora", "--payload-codec", "lowrank+int8"],
     "fedlora"),
]


@pytest.mark.parametrize("flags,phase", STATEFUL,
                         ids=lambda v: " ".join(v) if isinstance(v, list)
                         else str(v))
def test_stateful_flags_run_and_resume(flags, phase, tmp_path, capsys):
    """Two rounds with ``--ckpt-dir``, then the same command with
    ``--rounds 3``: it resumes at round 2 ("restored checkpoint at round
    2"), with the reference's record keys. FedEP's resumed run, which reads
    back a site written before the checkpoint, ends where a straight
    3-round run ends (params, server state and sites to 1e-5 relative,
    1e-6 absolute: the CPU's threaded reductions are not bitwise
    repeatable from one run to the next, even in one process)."""
    jax_train.parse_args(flags + ["--ckpt-dir", "c"])   # the reference's
    ckpt = str(tmp_path / "ckpt")
    argv = SMOKE + flags + ["--ckpt-dir", ckpt]
    first = train.main(argv + ["--rounds", "2"])
    capsys.readouterr()
    resumed = train.main(argv + ["--rounds", "3"])
    assert "restored checkpoint at round 2" in capsys.readouterr().out
    shutil.rmtree(ckpt)       # the checkpoints are large; all is read
    recs = first["records"] + resumed["records"]
    assert [set(r) for r in recs] == [JAX_RECORD_KEYS] * 3
    assert [r["round"] for r in recs] == [0, 1, 2]
    assert recs[2]["phase"] == phase
    assert all(math.isfinite(r["eval_loss"]) for r in recs)
    assert (resumed["store"] is None) == (phase == "fedpa")
    if phase != "fedep":
        return
    straight = train.main(SMOKE + flags + ["--rounds", "3"])
    for a, b in zip(tm.tleaves(resumed["state"]), tm.tleaves(
            straight["state"])):
        torch.testing.assert_close(torch.as_tensor(a), torch.as_tensor(b),
                                   rtol=1e-5, atol=1e-6)
    for a, b in zip(tm.tleaves(resumed["store"].state_dict()),
                    tm.tleaves(straight["store"].state_dict())):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


#: Multi-process launches the reference refuses, with its errors: an
#: incomplete or out-of-range launch (``ValueError``, before any process
#: group forms), async rounds over processes and a host store sharded
#: for a stateful algorithm (``SystemExit``).
LAUNCH_ERRORS = [
    (["--num-processes", "2"], ValueError, "--coordinator"),
    (["--num-processes", "2", "--coordinator", "127.0.0.1:1"], ValueError,
     "--process-id"),
    (["--num-processes", "2", "--coordinator", "127.0.0.1:1",
      "--process-id", "2"], ValueError, "out of range"),
    (["--num-processes", "2", "--coordinator", "127.0.0.1:1",
      "--process-id", "0", "--async-rounds"], SystemExit, "single-host"),
    (["--shard-population", "--algorithm", "scaffold", "--client-opt",
      "sgd", "--burn-in-rounds", "0"], SystemExit, "device store"),
]


@pytest.mark.parametrize("flags,error,match", LAUNCH_ERRORS,
                         ids=lambda v: " ".join(v) if isinstance(v, list)
                         else None)
def test_multi_process_flags_raise_the_reference_errors(flags, error,
                                                        match):
    jax_train.parse_args(flags)          # flags the reference parses
    with pytest.raises(error, match=match):
        train.main(SMOKE + ["--rounds", "1"] + flags)


@pytest.mark.parametrize("flags", [
    [], ["--algorithm", "fedep", "--client-state-placement", "device"]],
    ids=["fedpa", "fedep device store"])
def test_shard_population_in_one_process(flags, capsys):
    """``--shard-population`` alone: one process is the whole mesh, the
    banner names it and the records equal the unsharded run's."""
    sharded = train.main(SMOKE + ["--rounds", "2", "--shard-population"]
                         + flags)
    assert "population_mesh=(1,)" in capsys.readouterr().out
    assert sharded["mesh"].size == 1
    plain = train.main(SMOKE + ["--rounds", "2"] + flags)
    for a, b in zip(sharded["records"], plain["records"]):
        for k in ("eval_loss", "client_loss_first", "client_loss_last"):
            assert math.isclose(a[k], b[k], rel_tol=1e-5), k


#: The families the port serves and, since it trains them all, trains:
#: train.main runs them in ``tests/test_torch_train_xlstm_frontends.py``
#: and ``tests/test_torch_train_rglru_moe.py``.
TRAINED_FAMILIES = ["xlstm-125m", "musicgen-medium", "internvl2-26b",
                    "recurrentgemma-9b", "qwen3-moe-30b-a3b",
                    "llama4-scout-17b-a16e"]


@pytest.mark.parametrize("arch", TRAINED_FAMILIES)
def test_lm_grad_fn_trains_every_family(arch):
    """The per-client grad of the federated round builds at full size and
    runs at smoke size under the round's ``vmap`` over two clients (their
    own params and batches, frontends among them): each client's loss
    equals the JAX package's ``lm_loss`` (1e-5 relative, fp32), and its
    loss and grads equal the unbatched ``lm_grad_fn``'s (1e-5 of each
    leaf's largest entry)."""
    steps.lm_grad_fn(configs.get_config(arch))
    jcfg, tcfg, params, tparams, _, _ = _setup(arch)
    cparams = tm.tmap(lambda t: torch.stack([t, 1.01 * t]), tparams)
    batch = _batch(tcfg, seed=3, clients=2)
    fn = steps.lm_grad_fn(tcfg, compute_dtype=torch.float32, q_chunk=16)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    losses, grads = torch.func.vmap(fn)(cparams, tb)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if "frontend" in jb:
        jb["frontend"] = jb["frontend"].astype(jnp.bfloat16)
    jparams = jax.tree_util.tree_map(lambda x: jnp.stack([x, 1.01 * x]),
                                     params)
    jlosses = jax.jit(jax.vmap(lambda p, b: jax_steps.lm_loss(
        p, b, jcfg, compute_dtype=jnp.float32, q_chunk=16,
        remat="none")[0]))(jparams, jb)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               rtol=1e-5)
    for c in range(2):
        loss, g = fn(tm.tmap(lambda t: t[c], cparams),
                     tm.tmap(lambda t: t[c], tb))
        assert float(loss) == pytest.approx(float(losses[c]), rel=1e-5)
        for a, b in zip(tm.tleaves(grads), tm.tleaves(g)):
            torch.testing.assert_close(
                a[c], b, rtol=0, atol=1e-5 * float(b.abs().max()))


#: The codec flags, which the port runs since ROADMAP.md queue 1, item 9.
CODEC_FLAGS = [
    ["--payload-codec", "int8"],
    ["--algorithm", "fedlora", "--payload-codec", "lowrank"],
    ["--algorithm", "fedlora", "--payload-codec", "lowrank+int8",
     "--lora-rank", "2", "--quant-bits", "16", "--no-error-feedback"],
]


@pytest.mark.parametrize("flags", CODEC_FLAGS, ids=lambda v: " ".join(v))
def test_codec_flags_parse_like_jax(flags):
    """The flags parse to the JAX entry point's values (the port adds only
    ``--device``, ``--dist-backend``, ``--dist-timeout`` and
    ``--model-parallel``), and the configs they build agree: fedlora's
    constructs, a codec on FedPA raises ValueError in both packages."""
    got = vars(train.parse_args(flags))
    want = vars(jax_train.parse_args(flags))
    assert got.pop("device") is None and got.pop("dist_backend") is None
    assert got.pop("model_parallel") == 1
    assert got.pop("dist_timeout") == DEFAULT_TIMEOUT_S and got == want
    args = train.parse_args(flags)
    if args.algorithm == "fedlora":
        assert dataclasses.asdict(train.build_fed(args)) == \
            dataclasses.asdict(jax_train.build_fed(jax_train.parse_args(
                flags)))
        return
    for build, parse in ((train.build_fed, train.parse_args),
                         (jax_train.build_fed, jax_train.parse_args)):
        with pytest.raises(ValueError, match="payload_codec"):
            build(parse(flags))


def test_prefetch_default_and_device_guard(monkeypatch):
    assert train.parse_args([]).prefetch_rounds == 2
    assert jax_train.parse_args([]).prefetch_rounds == 2
    assert train.parse_args([]).prefetch_backend == \
        jax_train.parse_args([]).prefetch_backend == "process"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--smoke", "--rounds", "1"])


def _close_records(got, want, keys=("eval_loss", "client_loss_first",
                                    "client_loss_last"), rel=1e-4):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for k in set(JAX_RECORD_KEYS) - set(keys) - {"sec"}:
            assert a[k] == b[k], k
        for k in keys:
            assert a[k] == pytest.approx(b[k], rel=rel), k


def _jax_train_records(argv, monkeypatch, capsys, params=None):
    """The JAX entry point's printed records for ``argv`` (its main reads
    ``sys.argv``), in fp32 compute from numpy ``params`` (default:
    ``_fedlm_params``)."""
    params = _fedlm_params() if params is None else params
    f32 = dict(compute_dtype=jnp.float32)
    monkeypatch.setattr(jax_train, "init_params", lambda key, cfg:
                        jax.tree_util.tree_map(jnp.asarray, params))
    for name in ("make_fed_round", "make_fed_round_split"):
        monkeypatch.setattr(jax_train, name, functools.partial(
            getattr(jax_sharded_round, name), **f32))
    monkeypatch.setattr(jax_train, "lm_loss",
                        functools.partial(jax_steps.lm_loss, **f32))
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    capsys.readouterr()
    jax_train.main()
    lines = capsys.readouterr().out.splitlines()
    return [json.loads(line) for line in lines[1:]]


#: Async runs against the JAX entry point: FedPA with a window of 3,
#: FedEP on the device store with a window of 2 and stragglers, and
#: FedLoRA's ``lowrank`` sketch (continuous; ``lowrank+int8`` could flip a
#: quantization step) with a window of 3 on the LM tree, whose leaves the
#: two packages flatten in different orders.
ASYNC = [
    ["--async-rounds", "--max-staleness", "2", "--rounds", "4"],
    ["--async-rounds", "--algorithm", "fedep", "--client-state-placement",
     "device", "--num-clients", "3", "--straggler-rate", "0.5",
     "--rounds", "4"],
    ["--async-rounds", "--max-staleness", "2", "--algorithm", "fedlora",
     "--payload-codec", "lowrank", "--lora-rank", "2", "--rounds", "4"],
]


@pytest.mark.parametrize("flags", ASYNC, ids=lambda v: " ".join(v))
def test_async_records_equal_jax_train(flags, monkeypatch, capsys):
    # the JAX entry point has no --device
    argv = [a for a in SMOKE if a not in ("--device", "cpu")] + flags
    want = _jax_train_records(argv + ["--prefetch-rounds", "0"],
                              monkeypatch, capsys)
    monkeypatch.setattr(train, "init_params", lambda gen, cfg, device:
                        lm_params_from_jax(_fedlm_params(), device))
    res = train.main(SMOKE + flags, compute_dtype=torch.float32)
    got = res["records"]
    _close_records(got, want)
    assert [r["staleness"] for r in got][:3] == [0, 1, 2] or \
        "--straggler-rate" in flags
    if "--straggler-rate" in flags:
        assert sum(r["straggled"] for r in got) > 0


def test_thread_prefetch_changes_no_number():
    """``--prefetch-rounds 2 --prefetch-backend thread`` against inline
    cohorts, sync and async."""
    for flags in ([], ["--async-rounds"]):
        base = SMOKE + flags + ["--rounds", "3"]
        inline = train.main(base + ["--prefetch-rounds", "0"])
        ahead = train.main(base + ["--prefetch-rounds", "2"])
        _close_records(ahead["records"], inline["records"], rel=1e-5)
        assert [r["staleness"] for r in ahead["records"]] == (
            [0, 1, 1] if flags else [0, 0, 0])
