"""Client sampling for the cross-device setting: each round draws M of N
clients uniformly without replacement, deterministically per (seed, round) —
the stateless-clients regime the paper targets (the average client
participates in ~a single round)."""
from __future__ import annotations

import numpy as np


class ClientSampler:
    """Deterministic per-round cohort sampler (M of N, no replacement)."""

    def __init__(self, num_clients: int, clients_per_round: int, seed: int = 0):
        """Bind the population size, cohort size, and run seed.

        Bounds are validated eagerly and by name: a non-positive population
        or cohort size used to surface rounds later as an opaque numpy
        ``choice`` error.
        """
        if num_clients <= 0:
            raise ValueError(f"num_clients must be >= 1, got {num_clients}")
        if clients_per_round <= 0:
            raise ValueError(
                f"clients_per_round must be >= 1, got {clients_per_round}")
        if clients_per_round > num_clients:
            raise ValueError(
                f"clients_per_round ({clients_per_round}) > num_clients "
                f"({num_clients})")
        self.num_clients = num_clients
        self.clients_per_round = clients_per_round
        self.seed = seed

    def sample(self, round_idx: int) -> np.ndarray:
        """Round ``round_idx``'s cohort ids — a pure function of
        ``(seed, round_idx)``, so re-running a round resamples identically
        (the sampler never draws a client twice within one round)."""
        rng = np.random.default_rng(
            np.random.SeedSequence(entropy=self.seed, spawn_key=(round_idx,))
        )
        return rng.choice(self.num_clients, size=self.clients_per_round,
                          replace=False)

    def participation_counts(self, num_rounds: int) -> np.ndarray:
        """How many of the first ``num_rounds`` rounds each client joins.

        The per-round draws are unavoidable (each is its own rng stream),
        but the tally is one vectorized ``bincount`` over the stacked
        cohorts instead of ``num_rounds`` fancy-indexed increments.
        """
        if num_rounds <= 0:
            return np.zeros(self.num_clients, dtype=np.int64)
        cohorts = np.stack([self.sample(r) for r in range(num_rounds)])
        return np.bincount(cohorts.ravel(),
                           minlength=self.num_clients).astype(np.int64)
