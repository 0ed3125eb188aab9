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
    checkpoints."""
    base = tmp_path_factory.mktemp(request.param)
    two, one = str(base / "two"), str(base / "one")
    first = _launch(request.param, 2, two, one)
    resumed = _launch(request.param, 3, two, one)
    return {"two": two, "one": one, "first": first, "resumed": resumed}


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
