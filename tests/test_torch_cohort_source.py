"""The port's ``CohortSource`` against the JAX package's: the same numpy
draws, so cohort ids, availability, survivors, budgets, the ``_active``
mask, weights and ``dropped`` must be equal, not close. Builds cohorts
inline: no prefetcher, no process.
"""
import jax
import numpy as np
import pytest

from repro.configs.base import FedConfig as JaxFedConfig
from repro.data.cohort_source import CohortSource as JaxCohortSource
from repro_torch.configs.base import FedConfig
from repro_torch.data.cohort_source import CohortSource
from repro_torch.data.prefetch import stack_host

N, M, K = 10, 6, 5
#: Fault configurations: none, dropout, diurnal availability (duty 0.4 of
#: 10 clients leaves fewer than 6 up in some rounds: conscripts), budgets,
#: and all at once.
FAULTS = {
    "none": dict(),
    "dropout": dict(dropout_rate=0.35),
    "diurnal": dict(availability="diurnal", availability_period=4,
                    availability_duty=0.4),
    "budgets": dict(client_opt="sgd", min_local_steps=2),
    "all": dict(availability="diurnal", availability_period=3,
                availability_duty=0.5, dropout_rate=0.25, client_opt="sgd",
                min_local_steps=1),
}
ROUNDS = 8


@pytest.fixture(scope="module", autouse=True)
def _x32():
    """Other test modules turn on jax x64 at import; keep it off here."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _stack(ids, round_idx):
    return stack_host([
        {"x": np.full((K, 2), 10.0 * c + round_idx, np.float32)}
        for c in ids])


def _sources(faults, seed, weights=None):
    kw = dict(algorithm="fedavg", clients_per_round=M, local_steps=K,
              **faults)
    return (CohortSource(FedConfig(**kw), N, _stack, weights, seed),
            JaxCohortSource(JaxFedConfig(**kw), N, _stack, weights, seed))


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("faults", sorted(FAULTS))
def test_draws_equal_jax(faults, seed):
    port, ref = _sources(FAULTS[faults], seed)
    assert port.mask_faults == ref.mask_faults
    seen_dropped = 0
    for r in range(ROUNDS):
        np.testing.assert_array_equal(port.available(r), ref.available(r))
        ids, f = port.draw(r)
        j_ids, jf = ref.draw(r)
        np.testing.assert_array_equal(ids, j_ids)
        assert ids.dtype == j_ids.dtype
        for a, b in ((f.survivors, jf.survivors), (f.budgets, jf.budgets)):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype
        assert f.dropped == jf.dropped
        assert f.extra_staleness == jf.extra_staleness == 0
        np.testing.assert_array_equal(port.sample(r), ref.sample(r))
        seen_dropped += f.dropped
    if faults in ("dropout", "diurnal", "all"):
        assert seen_dropped > 0


@pytest.mark.parametrize("faults", sorted(FAULTS))
def test_cohorts_equal_jax(faults):
    """Whole cohorts: batches with the injected ``_active`` (C, K) budget
    mask, per-client weights, survivors and ``dropped``."""
    weights = np.linspace(0.5, 2.0, N).astype(np.float32)
    port, ref = _sources(FAULTS[faults], 3, weights)
    for r in range(ROUNDS):
        c, jc = port.cohort(r), ref.cohort(r)
        assert c.round_idx == jc.round_idx == r
        np.testing.assert_array_equal(c.client_ids, jc.client_ids)
        assert set(c.batches) == set(jc.batches)
        for k in c.batches:
            np.testing.assert_array_equal(c.batches[k],
                                          np.asarray(jc.batches[k]))
        np.testing.assert_array_equal(c.weights, jc.weights)
        if jc.survivors is None:
            assert c.survivors is None
        else:
            np.testing.assert_array_equal(c.survivors, jc.survivors)
        assert (c.extra_staleness, c.dropped) == (jc.extra_staleness,
                                                  jc.dropped)
        if "min_local_steps" in FAULTS[faults]:
            assert c.batches["_active"].shape == (M, K)


def test_zero_weights_raise_like_jax():
    weights = np.zeros(N, np.float32)
    port, ref = _sources({}, 0, weights)
    with pytest.raises(ValueError, match="positive total"):
        ref.cohort(0)
    with pytest.raises(ValueError, match="round 0: cohort weights"):
        port.cohort(0)


def test_budgets_need_dict_batches():
    kw = dict(algorithm="fedavg", clients_per_round=M, local_steps=K,
              **FAULTS["budgets"])
    port = CohortSource(FedConfig(**kw), N,
                        lambda ids, r: np.zeros((len(ids), K)), seed=0)
    with pytest.raises(TypeError, match="dict batch trees"):
        port.cohort(0)
