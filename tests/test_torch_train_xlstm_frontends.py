"""``launch.train.main`` on the archs that the port trains since it trains
every family it serves, against ``repro.launch.train.main`` on the same
numpy weights in fp32 compute, on the smoke configs: here xlstm-125m and
the audio and vision frontends (musicgen-medium, internvl2-26b);
``tests/test_torch_train_rglru_moe.py`` runs RG-LRU and the MoE archs
through ``check_records``. A burn-in FedAvg round, then a FedPA round.
The frontend archs' batches carry the stub frontend embeddings of each
client and local step, rounded to bf16 in both packages, before
``--seq-len`` minus ``frontend_tokens`` text tokens.

Records equal the JAX entry point's to 1e-4 relative, as
``tests/test_torch_train_cli.py`` holds fedlm-100m's. xlstm-125m takes
one FedPA round at client lr 0.01: at the CLI's 0.05 its smoke training
amplifies rounding, so that over the two rounds the JAX run itself moves
by up to 1.5e-2 relative when its weights move by 1e-6 relative (the
grads move by 3e-5 to 9e-5 of each leaf's largest entry at the first
step); over one FedPA round at 0.01 the port lands within 2e-6 of JAX.
Cohorts are built on the thread prefetcher: no test process starts a
child.
"""
import jax
import pytest
import torch

from test_torch_archs import _setup
from test_torch_train_cli import SMOKE, _close_records, _jax_train_records
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch import train

#: arch -> flags past ``SMOKE``
FLAGS = {
    "xlstm-125m": ["--rounds", "1", "--burn-in-rounds", "0",
                   "--client-lr", "0.01"],
    "musicgen-medium": ["--rounds", "2"],
    "internvl2-26b": ["--rounds", "2"],
}


@pytest.fixture(scope="module", autouse=True)
def _x32():
    """Other test modules turn on jax x64 at import; compare in fp32."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def check_records(arch, flags, monkeypatch, capsys):
    """``train.main`` against the JAX entry point on ``arch``'s smoke
    config with ``SMOKE + flags`` (40 tokens a sequence); returns the
    port's records."""
    params = _setup(arch)[2]
    flags = ["--arch", arch, "--seq-len", "40"] + flags
    argv = [a for a in SMOKE if a not in ("--device", "cpu")] + flags
    want = _jax_train_records(argv + ["--prefetch-rounds", "0"],
                              monkeypatch, capsys, params=params)
    monkeypatch.setattr(train, "init_params", lambda gen, cfg, device:
                        lm_params_from_jax(params, device))
    res = train.main(SMOKE + flags, compute_dtype=torch.float32)
    _close_records(res["records"], want)
    return res["records"]


@pytest.mark.parametrize("arch", list(FLAGS))
def test_train_records_equal_jax_train(arch, monkeypatch, capsys):
    recs = check_records(arch, FLAGS[arch], monkeypatch, capsys)
    assert [r["phase"] for r in recs] == (
        ["fedpa"] if arch == "xlstm-125m" else ["fedavg (burn-in)", "fedpa"])
