"""The port's training entry point (``repro_torch.launch.train``) and its
example on the CPU at smoke size: the records carry exactly the JAX
entry point's keys, the phase flips from the burn-in to FedPA, the losses are
finite, the per-client state flags run and ``--ckpt-dir`` resumes, and each
flag whose path is not ported is refused with the ROADMAP.md item that
ports it, while the JAX package's ``parse_args`` accepts it.
"""
import json
import math

import numpy as np

import pytest
import torch

from repro.launch import train as jax_train
from repro_torch.core import tree_math as tm
from repro_torch.examples import train_lm_federated
from repro_torch.launch import train

#: The keys of one round's record in ``repro/launch/train.py``'s
#: ``run_rounds.on_round``.
JAX_RECORD_KEYS = {"round", "eval_loss", "client_loss_last",
                   "client_loss_first", "staleness", "phase", "sec",
                   "dropped", "straggled", "bytes_up", "bytes_down"}

SMOKE = ["--smoke", "--device", "cpu", "--clients", "2", "--local-steps",
         "6", "--burn-in-steps", "2", "--steps-per-sample", "2",
         "--burn-in-rounds", "1", "--batch", "2", "--seq-len", "24"]


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


def test_example_runs_the_smoke_config_on_the_cpu():
    res = train_lm_federated.main(["--device", "cpu", "--rounds", "1",
                                   "--batch", "1", "--seq-len", "16"])
    assert res["cfg"].name == "fedlm-100m-smoke"
    assert [r["phase"] for r in res["records"]] == ["fedavg (burn-in)"]


#: The per-client state flags (ROADMAP.md queue 1, item 7) -> the phase
#: of the resumed round.
STATEFUL = [
    (["--client-state-placement", "device"], "fedpa"),
    (["--ckpt-every", "1"], "fedpa"),
    (["--algorithm", "scaffold", "--client-opt", "sgd"], "scaffold"),
    (["--algorithm", "fedep", "--client-state-placement", "device"],
     "fedep"),
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


#: Flags valid in the reference whose paths the port lacks -> the
#: ROADMAP.md queue-1 item that ports them.
REFUSED = [
    (["--async-rounds"], 8), (["--prefetch-rounds", "2"], 8),
    (["--coordinator", "localhost:1234"], 10),
    (["--num-processes", "2"], 10), (["--process-id", "0"], 10),
    (["--shard-population"], 10),
    (["--payload-codec", "int8"], 9),
    (["--algorithm", "fedlora", "--payload-codec", "lowrank"], 9),
]


@pytest.mark.parametrize("flags,item", REFUSED,
                         ids=lambda v: " ".join(v) if isinstance(v, list)
                         else str(v))
def test_unported_flags_are_refused(flags, item):
    jax_train.parse_args(flags)          # valid in the reference
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP.md queue 1, item {item}"):
        train.main(SMOKE + ["--rounds", "1"] + flags)


def test_prefetch_default_and_device_guard(monkeypatch):
    assert train.parse_args([]).prefetch_rounds == 0
    assert jax_train.parse_args([]).prefetch_rounds == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--smoke", "--rounds", "1"])
