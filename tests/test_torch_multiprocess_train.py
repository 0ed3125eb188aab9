"""The port's multi-process training entry point on the CPU, the
counterpart of ``tests/test_population_sharding.py``'s
``test_two_process_train_matches_single_process``: the same command
(``--smoke`` fedlm-100m, 2 rounds, 4 clients of 8, device store,
``--ckpt-every 2``) for scaffold and fedep, once on 2 gloo ranks
(``--coordinator 127.0.0.1:<port> --num-processes 2 --process-id r``)
and once as one process with ``--shard-population``.

The server checkpoints agree within rtol 1e-5, atol 1e-6 (the tolerance
of ``tests/test_torch_train_cli.py``'s resume test; the sharded sum is the
one-process sum, so they agree bit for bit), the store shards
``shard0of2`` and ``shard1of2`` concatenate to ``shard0of1``, rank 0 logs
the rounds and rank 1 none. Then both runs go on to round 3 from their
checkpoints (the sharded restore) and agree again.

Every child is a fresh interpreter (``subprocess``, never a fork of this
process) with one thread, a 60 s limit to reach its peers, and a deadline
at which the test kills it.
"""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from _torch_mp import free_port

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
#: A hang guard: an unloaded run of the three takes ~7 s.
DEADLINE_S = 240


def _cmd(algorithm, rounds, extra):
    return [sys.executable, "-m", "repro_torch.launch.train",
            "--arch", "fedlm-100m", "--smoke", "--rounds", str(rounds),
            "--clients", "4", "--num-clients", "8",
            "--local-steps", "3", "--burn-in-steps", "2",
            "--steps-per-sample", "1", "--burn-in-rounds", "1",
            "--algorithm", algorithm, "--client-opt", "sgd",
            "--client-state-placement", "device",
            "--prefetch-rounds", "0", "--seed", "0",
            "--ckpt-every", "2", "--device", "cpu"] + extra


def _launch(algorithm, rounds, two, one):
    """Both ranks of the 2-rank run into ``two`` and the one-process run
    into ``one``, at once; returns ``[rank 0, rank 1, one process]``'s
    output, each checked to exit 0."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    dist = ["--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
            "--dist-backend", "gloo", "--dist-timeout", "60",
            "--ckpt-dir", two]
    cmds = [_cmd(algorithm, rounds, dist + ["--process-id", str(r)])
            for r in (0, 1)]
    cmds.append(_cmd(algorithm, rounds,
                     ["--shard-population", "--ckpt-dir", one]))
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for c in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DEADLINE_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-4000:]
    return outs


@pytest.fixture(scope="module", params=["scaffold", "fedep"])
def runs(request, tmp_path_factory):
    """The two runs to round 2, then on to round 3 from their
    checkpoints; the checkpoints removed when the module's tests are
    done."""
    base = tmp_path_factory.mktemp(request.param)
    two, one = str(base / "two"), str(base / "one")
    first = _launch(request.param, 2, two, one)
    resumed = _launch(request.param, 3, two, one)
    yield {"two": two, "one": one, "first": first, "resumed": resumed}
    shutil.rmtree(base)


def _server_equal(a_dir, b_dir, step):
    a = np.load(os.path.join(a_dir, f"ckpt_{step:08d}.npz"))
    b = np.load(os.path.join(b_dir, f"ckpt_{step:08d}.npz"))
    assert set(a.files) == set(b.files)
    for k in a.files:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-6,
                                   err_msg=f"server {k}")


def _shards_concatenate(two, one, step):
    s0 = np.load(os.path.join(two, f"ckpt_{step:08d}.shard0of2.npz"))
    s1 = np.load(os.path.join(two, f"ckpt_{step:08d}.shard1of2.npz"))
    r = np.load(os.path.join(one, f"ckpt_{step:08d}.shard0of1.npz"))
    assert set(r.files) == set(s0.files) == set(s1.files)
    for k in r.files:
        np.testing.assert_allclose(np.concatenate([s0[k], s1[k]]), r[k],
                                   rtol=1e-5, atol=1e-6,
                                   err_msg=f"store {k}")


def test_two_ranks_match_one_process(runs):
    _server_equal(runs["two"], runs["one"], 2)
    _shards_concatenate(runs["two"], runs["one"], 2)


def test_rank_zero_logs_alone(runs):
    rank0, rank1, one = runs["first"]
    rounds = [json.loads(line)["round"] for line in rank0.splitlines()
              if line.startswith('{"round"')]
    assert rounds == [0, 1]
    assert '"round"' not in rank1
    assert "processes=2 backend=gloo population_mesh=(2,)" in rank0
    assert "population_mesh=(1,)" in one
    summaries = [json.loads(line)["rank_summary"]
                 for out in (rank0, rank1) for line in out.splitlines()
                 if line.startswith('{"rank_summary"')]
    assert [s["rank"] for s in summaries] == [0, 1]
    # each rank holds 4 of the 8 rows, and the ranks exchanged bytes
    assert all(s["store_rows"] == 4 for s in summaries)
    assert all(sum(s["sent_bytes"]) > 0 for s in summaries)


def test_sharded_restore(runs):
    rank0, rank1, one = runs["resumed"]
    assert "restored checkpoint at round 2" in rank0
    assert "restored checkpoint" not in rank1
    assert [json.loads(line)["round"] for line in rank0.splitlines()
            if line.startswith('{"round"')] == [2]
    _server_equal(runs["two"], runs["one"], 3)
    _shards_concatenate(runs["two"], runs["one"], 3)


# -- --model-parallel: FSDP over the ranks, tensor-parallel over "model" ----

#: ``main`` in fp32 (the CLI computes in bf16, whose roundings flip
#: between summation orders)
_FP32_MAIN = ("import sys, torch; from repro_torch.launch import train; "
              "train.main(sys.argv[1:], compute_dtype=torch.float32)")


def _tp_cmd(rounds, extra):
    return [sys.executable, "-c", _FP32_MAIN, "--arch", "fedlm-100m",
            "--smoke", "--rounds", str(rounds), "--clients", "2",
            "--local-steps", "4", "--burn-in-steps", "2",
            "--steps-per-sample", "1", "--burn-in-rounds", "1",
            "--algorithm", "fedpa", "--prefetch-rounds", "0", "--seed", "0",
            "--ckpt-every", "2", "--device", "cpu"] + extra


def _tp_launch(rounds, two, one):
    """The two ranks of a ``--model-parallel 2`` run into ``two`` and the
    one-process run into ``one``, at once; returns their outputs."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    dist = ["--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
            "--dist-backend", "gloo", "--dist-timeout", "60",
            "--model-parallel", "2", "--ckpt-dir", two]
    cmds = [_tp_cmd(rounds, dist + ["--process-id", str(r)])
            for r in (0, 1)] + [_tp_cmd(rounds, ["--ckpt-dir", one])]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for c in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DEADLINE_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-4000:]
    return outs


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """A FedAvg burn-in round and a FedPA round on a 1 x 2 ``("data",
    "model")`` mesh and in one process, then a third round from their
    checkpoints (removed when the module's tests are done)."""
    base = tmp_path_factory.mktemp("model_parallel")
    two, one = str(base / "two"), str(base / "one")
    yield {"two": two, "one": one, "first": _tp_launch(2, two, one),
           "resumed": _tp_launch(3, two, one)}
    shutil.rmtree(base)


def _records(out):
    return [json.loads(line) for line in out.splitlines()
            if line.startswith('{"round"')]


def _params_close(two, one, step):
    """The ranks' FSDP checkpoint restored at W = 1 against the one-process
    server checkpoint: the params and the server momentum within rtol
    1e-5, atol 1e-5 (a DP round's tolerance: the placements and the
    tensor-parallel sums differ in fp32 rounding)."""
    import torch

    from repro_torch import configs
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.core import fsdp
    from repro_torch.core.server import init_server_state
    from repro_torch.models.model import init_params
    from repro_torch.optim import get_optimizer

    cfg = configs.get_smoke("fedlm-100m")
    like = init_server_state(init_params(torch.Generator().manual_seed(0),
                                         cfg, device="cpu"),
                             get_optimizer("sgdm", 0.5, 0.9))
    want, got_step, _ = ckpt_io.restore_checkpoint(one, like, step)
    layout = fsdp.FlatShard(init_params(None, cfg, device="meta"))
    got, _, _ = ckpt_io.restore_checkpoint_fsdp(
        two, layout.shard_state(like), step, layout)
    got = layout.gather_state(got)
    assert got_step == step and got.round == want.round
    for part in ("params", "opt_state"):
        for (path, g), (_, w) in zip(fsdp._paths(getattr(got, part)),
                                     fsdp._paths(getattr(want, part))):
            np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"{part} {path}")


def test_model_parallel_ranks_match_one_process(tp_runs):
    """``--model-parallel 2`` on two ranks: the banner names the 1 x 2
    mesh, rank 0 alone logs the records, which meet the one-process run's
    to rtol 1e-5; every local step ran tensor-parallel (activation
    all-reduces in each rank's summary); the params and momentum after
    round 2 meet the one process's."""
    rank0, rank1, one = tp_runs["first"]
    assert "fsdp_mesh={'data': 1, 'model': 2}" in rank0
    assert '"round"' not in rank1
    got, want = _records(rank0), _records(one)
    assert [r["round"] for r in got] == [r["round"] for r in want] == [0, 1]
    for g, w in zip(got, want):
        assert g["phase"] == w["phase"]
        for k in ("eval_loss", "client_loss_first", "client_loss_last"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
    for out in (rank0, rank1):
        summary = [json.loads(line)["rank_summary"] for line in
                   out.splitlines() if line.startswith('{"rank_summary"')]
        assert summary[0]["traffic"]["activation_reduces"] > 0
    _params_close(tp_runs["two"], tp_runs["one"], 2)


def test_model_parallel_restore(tp_runs):
    """Both runs go on to round 3 from their checkpoints: the ranks read
    their FSDP set back (rank 0 reports it) and still meet the one
    process."""
    rank0, rank1, one = tp_runs["resumed"]
    assert "restored checkpoint at round 2" in rank0
    assert "restored checkpoint at round 2" in one
    assert [r["round"] for r in _records(rank0)] == [2]
    _params_close(tp_runs["two"], tp_runs["one"], 3)


@pytest.mark.parametrize("extra,match", [
    ([], "needs a multi-process run"),
    (["--shard-population"], "needs a multi-process run")])
def test_model_parallel_refused_in_one_process(extra, match):
    """``--model-parallel`` above 1 needs ranks to lay the model axis
    over: one process is refused before any round."""
    from repro_torch.launch import train

    with pytest.raises(SystemExit, match=match):
        train.main(["--smoke", "--device", "cpu", "--rounds", "1",
                    "--model-parallel", "2", "--prefetch-rounds", "0"]
                   + extra)
