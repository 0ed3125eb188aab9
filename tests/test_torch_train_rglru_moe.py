"""``launch.train.main`` on recurrentgemma-9b (RG-LRU) and the two MoE
archs (qwen3-moe-30b-a3b, llama4-scout-17b-a16e: the router aux loss in
the local steps' loss) against ``repro.launch.train.main`` on the same
numpy weights in fp32 compute, on the smoke configs: a burn-in FedAvg
round, then a FedPA round; records to 1e-4 relative
(``tests/test_torch_train_xlstm_frontends.py`` says why and holds the
other three archs).
"""
import jax
import pytest

from test_torch_train_xlstm_frontends import check_records

ARCHS = ["recurrentgemma-9b", "qwen3-moe-30b-a3b", "llama4-scout-17b-a16e"]


@pytest.fixture(scope="module", autouse=True)
def _x32():
    """Other test modules turn on jax x64 at import; compare in fp32."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_records_equal_jax_train(arch, monkeypatch, capsys):
    recs = check_records(arch, ["--rounds", "2"], monkeypatch, capsys)
    assert [r["phase"] for r in recs] == ["fedavg (burn-in)", "fedpa"]
