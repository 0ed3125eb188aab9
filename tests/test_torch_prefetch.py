"""The port's cohort prefetchers (``repro_torch.data.prefetch``) on the
CPU, mirroring the reference's ``tests/test_async_engine.py`` (the thread
backend) and ``tests/test_cohort_source.py`` (the process backend).

The thread backend runs in the test process: order, error propagation, a
prompt close, and a hung builder that ``close()`` reports. The factory's
checks run in the test process too, because none of them starts a child:
an unknown backend, the fallback to threads on tensor leaves, and an
unpicklable ``build_fn``, which raises before anything is spawned.

The process backend runs only inside ``subprocess.run([sys.executable,
this file, case], timeout=...)``: no pytest worker starts a child (a
forked child of a multithreaded process is what hangs the JAX package's
tier-1 run, ROADMAP.md queue 3). Each case prints ``MARKER`` lines that
the test reads: in-order delivery with owned copies across slot regrowth,
builder errors, an idempotent close, the child started by ``spawn`` (its
command line is ``multiprocessing.spawn``'s, not the parent's), a hung
builder terminated by ``close()``, a killed child reported by ``get``,
the factory's probe cohort handed to the first ``get``, no
shared-memory segment left in ``/dev/shm`` and no resource-tracker
complaint on stderr; and ``FedSim`` and ``launch.train`` runs whose
cohorts come through the arena equal the thread backend's (FedSim bit
for bit; the LM records within 1e-5 relative, since the port's LM path
on the CPU is not bitwise repeatable).
"""
import os
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.configs.base import FedConfig
from repro_torch.core.round import FedSim
from repro_torch.data.prefetch import (Cohort, CohortPrefetcher,
                                       ProcessCohortPrefetcher,
                                       make_prefetcher)
from repro_torch.data.synthetic_lsq import lsq_batches, make_federated_lsq

HERE = pathlib.Path(__file__).resolve()
SRC = HERE.parents[1] / "src"
#: Each subprocess case's time limit: two torch imports and a few small
#: runs take ~20 s alone, several times that beside a loaded test run.
CASE_TIMEOUT = 300


# -- builders (module level: the spawned child unpickles them by name) ------

def _np_cohort(r):
    n = 3 + r  # growing leaves force arena slot regrowth
    return Cohort(r, np.arange(n), {"x": np.full((n, 2), r, np.float32)},
                  None, np.ones(n, np.float32), 0, 0)


def _failing_cohort(r):
    if r == 1:
        raise ValueError("boom-1")
    return _np_cohort(r)


def _pid_cohort(r):
    """A cohort whose ids name the process that built it."""
    return Cohort(r, np.array([os.getpid()]), {"x": np.zeros((1, 2))})


def _hanging_cohort(r):
    if r >= 1:
        time.sleep(3600)
    return _np_cohort(r)


class LsqBatches:
    """FedSim's ``batch_fn`` on the federated least-squares problem of the
    engine goldens (4 clients, d = 3), numpy leaves; picklable."""

    def __init__(self):
        """Draw the problem's data."""
        _, self.data = make_federated_lsq(4, 50, 3, heterogeneity=20.0,
                                          seed=0)

    def __call__(self, cid, r, steps):
        """One client's ``{"x", "y"}`` batches for round ``r``."""
        X, y = self.data[cid]
        return lsq_batches(X, y, 10, steps, seed=r * 131 + cid)


def _lsq_grad_fn(p, batch):
    def loss(q, b):
        res = b["x"] @ q - b["y"]
        return 0.5 * (res * res).mean() * 50

    g, value = torch.func.grad_and_value(loss)(p, batch)
    return value, g


# -- the thread backend and the factory, in the test process ----------------

def test_thread_prefetcher_preserves_order_and_contents():
    built = []

    def build(r):
        built.append(r)
        return Cohort(r, None, {"x": np.full((2,), r)}, None)

    with CohortPrefetcher(build, 0, 8, depth=3) as pf:
        for r in range(8):
            c = pf.get(r)
            assert c.round_idx == r
            np.testing.assert_array_equal(c.batches["x"], np.full((2,), r))
    assert built == list(range(8))


def test_thread_prefetcher_propagates_builder_errors():
    def build(r):
        if r == 2:
            raise RuntimeError("boom at round 2")
        return Cohort(r, None, {}, None)

    with CohortPrefetcher(build, 0, 5, depth=2) as pf:
        pf.get(0)
        pf.get(1)
        with pytest.raises(RuntimeError, match="boom at round 2"):
            pf.get(2)


def test_thread_prefetcher_close_is_prompt():
    """close() mid-stream neither deadlocks nor needs draining, stops the
    worker, and leaves no re-enqueued cohort behind."""
    pf = CohortPrefetcher(lambda r: Cohort(r, None, {}, None), 0, 1000,
                          depth=2)
    pf.get(0)
    pf.close()
    assert not pf._thread.is_alive()
    assert pf._q.empty()
    pf.close()  # idempotent


def test_thread_prefetcher_close_raises_on_hung_builder():
    release = threading.Event()
    entered = threading.Event()

    def build(r):
        if r >= 1:
            entered.set()
            release.wait()          # hangs until the test releases it
        return Cohort(r, None, {}, None)

    pf = CohortPrefetcher(build, 0, 10, depth=1, close_timeout=0.5)
    assert pf.get(0).round_idx == 0
    assert entered.wait(timeout=5.0)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="did not exit"):
        pf.close()
    assert time.monotonic() - t0 < 5.0
    release.set()
    pf._thread.join(timeout=5.0)
    assert not pf._thread.is_alive()
    pf.close()


def test_make_prefetcher_rejects_unknown_backend():
    with pytest.raises(ValueError, match="prefetch_backend"):
        make_prefetcher("greenlet", _np_cohort, 0, 1)


def test_make_prefetcher_falls_back_on_tensor_leaves():
    """A builder that makes tensors cannot ship through the arena: the
    factory probes one cohort and takes the thread backend, warning."""
    def build(r):
        return Cohort(r, np.arange(2), {"x": torch.zeros(2, 2)}, None)

    with pytest.warns(RuntimeWarning, match="falling back"):
        p = make_prefetcher("process", build, 0, 2)
    try:
        assert type(p) is CohortPrefetcher
        assert p.get(0).round_idx == 0
    finally:
        p.close()


def test_unpicklable_build_fn_raises_before_spawning():
    """No silent switch of backends: a closure raises ``ValueError`` naming
    the thread backend, from the factory and from the class, before a
    child exists."""
    def build(r):
        return _np_cohort(r)

    for make in (lambda: make_prefetcher("process", build, 0, 2),
                 lambda: ProcessCohortPrefetcher(build, 0, 2)):
        with pytest.raises(ValueError, match="prefetch_backend='thread'"):
            make()
    sim = FedSim(FedConfig(algorithm="fedavg", clients_per_round=2,
                           local_steps=2, prefetch_rounds=2),
                 _lsq_grad_fn, lambda cid, r, steps: LsqBatches()(cid, r,
                                                                  steps),
                 num_clients=4, device="cpu")
    with pytest.raises(ValueError, match="prefetch_backend='thread'"):
        sim.run(torch.zeros(3), 2)


# -- the process backend, in a subprocess -----------------------------------

def _run_case(case: str) -> str:
    # one thread per process: the runs are small, and the test run's
    # other workers already hold the cores
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
    proc = subprocess.run([sys.executable, str(HERE), case],
                          capture_output=True, text=True, env=env,
                          timeout=CASE_TIMEOUT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for bad in ("resource_tracker", "leaked", "Traceback"):
        assert bad not in proc.stderr, proc.stderr
    assert f"MARKER {case} done" in proc.stdout, proc.stdout
    return proc.stdout


def test_process_prefetcher_in_a_subprocess():
    out = _run_case("arena")
    for marker in ("order", "errors", "close", "spawn", "hung", "killed",
                   "probe", "no-segments"):
        assert f"MARKER {marker} ok" in out, out


def test_process_backend_runs_equal_thread_backend_in_a_subprocess():
    out = _run_case("runs")
    for marker in ("fedsim-sync", "fedsim-async", "train"):
        assert f"MARKER {marker} ok" in out, out


def _segments(pid: int):
    return sorted(p for p in os.listdir("/dev/shm")
                  if p.startswith(f"coharena-{pid}-"))


def _child_cmdline(p: ProcessCohortPrefetcher) -> str:
    with open(f"/proc/{p._proc.pid}/cmdline", "rb") as f:
        return f.read().replace(b"\0", b" ").decode()


def _case_arena():
    with ProcessCohortPrefetcher(_np_cohort, 0, 4, depth=1) as p:
        first = p.get(0)
        assert "multiprocessing.spawn" in _child_cmdline(p)
        assert _child_cmdline(p) != " ".join(sys.argv)
        print("MARKER spawn ok", flush=True)
        for r in range(1, 4):
            c = p.get(r)
            assert c.round_idx == r
            np.testing.assert_array_equal(
                c.batches["x"], np.full((3 + r, 2), r, np.float32))
            np.testing.assert_array_equal(c.survivors,
                                          np.ones(3 + r, np.float32))
        np.testing.assert_array_equal(first.batches["x"],
                                      np.zeros((3, 2), np.float32))
    print("MARKER order ok", flush=True)

    with ProcessCohortPrefetcher(_failing_cohort, 0, 3, depth=2) as p:
        p.get(0)
        try:
            p.get(1)
        except RuntimeError as e:
            assert "boom-1" in str(e)
        else:
            raise AssertionError("the builder's error was not raised")
    print("MARKER errors ok", flush=True)

    p = ProcessCohortPrefetcher(_np_cohort, 0, 100, depth=2)
    p.get(0)
    p.close()
    p.close()
    assert not p._proc.is_alive()
    print("MARKER close ok", flush=True)

    p = ProcessCohortPrefetcher(_hanging_cohort, 0, 10, depth=1,
                                close_timeout=0.5)
    assert p.get(0).round_idx == 0
    t0 = time.monotonic()
    try:
        p.close()
    except RuntimeError as e:
        assert "did not exit" in str(e)
    else:
        raise AssertionError("close() did not report the hung builder")
    assert time.monotonic() - t0 < 5.0 and not p._proc.is_alive()
    print("MARKER hung ok", flush=True)

    p = ProcessCohortPrefetcher(_np_cohort, 0, 10, depth=1)
    p.get(0)
    # round 1 is reported: the child now waits for a free slot, holding
    # no segment that the parent has not been told of
    assert p._meta_r.poll(30)
    p._proc.kill()
    p._proc.join(timeout=10)
    try:
        for r in range(1, 10):
            p.get(r)
    except RuntimeError as e:
        assert "died" in str(e)
    else:
        raise AssertionError("a killed child was not reported")
    p.close()
    print("MARKER killed ok", flush=True)

    with make_prefetcher("process", _pid_cohort, 0, 3) as p:
        built_by = [int(p.get(r).client_ids[0]) for r in range(3)]
    # the factory's probe of round 0 is the first cohort, not rebuilt
    assert built_by[0] == os.getpid(), built_by
    assert built_by[1] == built_by[2] != os.getpid(), built_by
    print("MARKER probe ok", flush=True)

    assert _segments(os.getpid()) == [], _segments(os.getpid())
    print("MARKER no-segments ok", flush=True)


def _case_runs():
    fed_kw = dict(algorithm="fedpa", clients_per_round=3, local_steps=12,
                  burn_in_steps=4, steps_per_sample=2, shrinkage_rho=0.5,
                  burn_in_rounds=1, server_opt="sgd", server_lr=0.1,
                  client_opt="sgd", client_lr=0.01, dropout_rate=0.3,
                  prefetch_rounds=2)
    batch_fn = LsqBatches()
    for name, over in (("fedsim-sync", {}),
                       ("fedsim-async", dict(async_rounds=True,
                                             max_staleness=2,
                                             straggler_rate=0.5))):
        runs = {}
        for backend in ("thread", "process"):
            fed = FedConfig(**fed_kw, **over, prefetch_backend=backend)
            sim = FedSim(fed, _lsq_grad_fn, batch_fn, num_clients=4,
                         seed=7, device="cpu")
            runs[backend] = sim.run(torch.zeros(3), 5)
        assert torch.equal(runs["thread"][0].params,
                           runs["process"][0].params)
        assert runs["thread"][1] == runs["process"][1]
        print(f"MARKER {name} ok", flush=True)

    from repro_torch.launch import train

    argv = ["--smoke", "--device", "cpu", "--clients", "2", "--local-steps",
            "6", "--burn-in-steps", "2", "--steps-per-sample", "2",
            "--burn-in-rounds", "1", "--batch", "2", "--seq-len", "24",
            "--rounds", "3", "--async-rounds"]
    inline = train.main(argv + ["--prefetch-rounds", "0"])["records"]
    arena = train.main(argv + ["--prefetch-backend", "process"])["records"]
    for a, b in zip(arena, inline):
        for k in ("eval_loss", "client_loss_first", "client_loss_last"):
            assert abs(a[k] - b[k]) <= 1e-5 * abs(b[k]), (k, a, b)
        assert (a["round"], a["staleness"], a["phase"]) == \
            (b["round"], b["staleness"], b["phase"])
    assert len(arena) == len(inline) == 3
    print("MARKER train ok", flush=True)


if __name__ == "__main__":
    {"arena": _case_arena, "runs": _case_runs}[sys.argv[1]]()
    assert not torch.cuda.is_initialized()
    print(f"MARKER {sys.argv[1]} done", flush=True)
