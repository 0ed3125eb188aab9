"""Fault-injecting cohort source (port of ``repro/data/cohort_source.py``).

The cross-device regime made unreliable, on the host side of the round:

* **Diurnal availability** (``fed.availability="diurnal"``) — each client
  is up for an ``availability_duty`` fraction of an
  ``availability_period``-round cycle, with a per-client phase; cohorts
  draw only from the available set. If fewer than ``clients_per_round``
  are up, the cohort is topped up from the unavailable set so its shape
  stays fixed, and the conscripted clients are masked out as
  non-survivors.
* **Mid-round dropout** (``fed.dropout_rate``) — each sampled client drops
  with probability ``dropout_rate``; the cohort ships a (C,) float 0/1
  ``survivors`` mask that the round program applies to the weights before
  normalising (an all-dropped round degrades to a zero aggregate).
* **Heterogeneous local-step budgets** (``fed.min_local_steps``) — each
  sampled client runs a budget drawn uniformly from
  ``[min_local_steps, local_steps]``; the remaining steps are frozen by
  the round program's gradient mask, keyed off the ``"_active"`` (C, K)
  leaf this source injects into dict batch trees.

* **Stragglers** (``fed.straggler_rate``, async-only: ``FedConfig``
  refuses them without ``async_rounds``) — a cohort misses its deadline
  with probability ``straggler_rate`` and arrives ``1 ..
  straggler_max_lateness`` rounds late; the engine adds that lateness to
  the staleness exponent of its discount (``Cohort.extra_staleness``).

Every draw is the reference's numpy call on the same stream, a pure
function of ``(seed, round_idx)``: ids, availability, survivors, budgets,
lateness and ``dropped`` equal the JAX package's exactly. With every
fault knob at its default the draw is ``ClientSampler``'s and
``survivors`` is None.

Stream layout under one run seed (``np.random.SeedSequence`` spawn keys):
``(round,)`` the cohort draw, ``(round, k)`` the per-round fault streams,
``(0, 0, k)`` the run-static streams (per-client diurnal phases).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np

from repro_torch.core.server import check_weight_total
from repro_torch.data.prefetch import Cohort
from repro_torch.data.sampling import ClientSampler

#: Per-round fault streams: spawn key ``(round_idx, k)``.
_STREAM_DROPOUT = 1
_STREAM_STRAGGLER = 2
_STREAM_BUDGETS = 3
#: Run-static streams: spawn key ``(0, 0, k)``.
_STATIC_PHASES = 1


def _rng(seed: int, *key: int) -> np.random.Generator:
    """The deterministic generator for one ``(seed, *key)`` stream."""
    return np.random.default_rng(
        np.random.SeedSequence(entropy=seed, spawn_key=key))


class RoundFaults(NamedTuple):
    """One round's fault draw — a pure function of ``(seed, round_idx)``.

    ``survivors`` is the (C,) float 0/1 mask (None when this run has no
    mask faults); ``budgets`` the per-client local-step budgets (None =
    homogeneous); ``extra_staleness`` the straggler lateness in rounds (0 =
    on time); ``dropped`` the count of masked-out cohort slots.
    """

    survivors: Optional[np.ndarray]
    budgets: Optional[np.ndarray]
    extra_staleness: int
    dropped: int


class CohortSource:
    """Cohort source with deterministic fault injection.

    ``stack_batches(client_ids, round_idx)`` materializes the cohort's
    stacked (C, K, ...) batch tree (``FedSim.stack_cohort``); sampling,
    availability, dropout, budgets and per-client weights live here.
    """

    def __init__(self, fed, num_clients: int,
                 stack_batches: Callable[[np.ndarray, int], object],
                 client_weights: Optional[np.ndarray] = None, seed: int = 0):
        """Bind the config, population, batch builder, and run seed."""
        self.fed = fed
        self.num_clients = num_clients
        self.stack_batches = stack_batches
        self.client_weights = client_weights
        self.seed = seed
        # the zero-fault cohort draw IS ClientSampler's (same stream)
        self.sampler = ClientSampler(num_clients, fed.clients_per_round,
                                     seed)
        self._phases = (_rng(seed, 0, 0, _STATIC_PHASES).random(num_clients)
                        if fed.availability == "diurnal" else None)
        #: Whether cohorts carry a survivors mask at all (fixed per run).
        self.mask_faults = (fed.availability != "always"
                            or fed.dropout_rate > 0)

    def available(self, round_idx: int) -> np.ndarray:
        """(N,) bool availability mask for round ``round_idx``: client i is
        up iff ``(round_idx / period + phase_i) % 1 < duty``."""
        if self._phases is None:
            return np.ones(self.num_clients, bool)
        fed = self.fed
        pos = (round_idx / fed.availability_period + self._phases) % 1.0
        return pos < fed.availability_duty

    def sample(self, round_idx: int) -> np.ndarray:
        """Round ``round_idx``'s cohort ids (``ClientSampler`` API parity)."""
        return self.draw(round_idx)[0]

    def draw(self, round_idx: int):
        """``(client_ids, RoundFaults)`` — the replayable round draw, with
        no batches materialized."""
        fed = self.fed
        M = fed.clients_per_round
        if self._phases is None:
            ids = self.sampler.sample(round_idx)
            conscripted = np.zeros(M, bool)
        else:
            avail = self.available(round_idx)
            up = np.flatnonzero(avail)
            rng = _rng(self.seed, round_idx)
            if up.shape[0] >= M:
                ids = up[rng.choice(up.shape[0], size=M, replace=False)]
                conscripted = np.zeros(M, bool)
            else:
                # conscript the shortfall from the unavailable set (masked
                # out below) so the cohort's shape stays fixed
                down = np.flatnonzero(~avail)
                extra = down[rng.choice(down.shape[0],
                                        size=M - up.shape[0],
                                        replace=False)]
                ids = np.concatenate([up, extra])
                conscripted = np.concatenate(
                    [np.zeros(up.shape[0], bool),
                     np.ones(extra.shape[0], bool)])

        dead = conscripted
        if fed.dropout_rate > 0:
            drops = (_rng(self.seed, round_idx, _STREAM_DROPOUT).random(M)
                     < fed.dropout_rate)
            dead = dead | drops
        survivors = (1.0 - dead).astype(np.float32) if self.mask_faults \
            else None

        extra_staleness = 0
        if fed.straggler_rate > 0:
            srng = _rng(self.seed, round_idx, _STREAM_STRAGGLER)
            if srng.random() < fed.straggler_rate:
                extra_staleness = int(
                    srng.integers(1, fed.straggler_max_lateness + 1))

        budgets = None
        if fed.min_local_steps:
            budgets = _rng(self.seed, round_idx, _STREAM_BUDGETS).integers(
                fed.min_local_steps, fed.local_steps + 1, size=M)

        return ids, RoundFaults(survivors, budgets, extra_staleness,
                                int(dead.sum()))

    def cohort(self, round_idx: int) -> Cohort:
        """Materialize round ``round_idx``: stack the batches, inject the
        ``"_active"`` (C, K) budget mask into dict batch trees when budgets
        are on, resolve per-client weights (the raw, pre-mask weights must
        sum positive; the survivor mask is applied in the round program,
        where an all-zero sum degrades to zero weights), and attach the
        round's fault annotations."""
        ids, faults = self.draw(round_idx)
        batches = self.stack_batches(ids, round_idx)
        if faults.budgets is not None:
            if not isinstance(batches, dict):
                raise TypeError(
                    f"min_local_steps > 0 needs dict batch trees to carry "
                    f"the '_active' per-step budget mask; got "
                    f"{type(batches).__name__}")
            K = self.fed.local_steps
            active = np.arange(K)[None, :] < faults.budgets[:, None]
            batches = dict(batches)
            batches["_active"] = active.astype(np.float32)
        if self.client_weights is None:
            weights = None
        else:
            weights = np.asarray([self.client_weights[int(c)] for c in ids],
                                 np.float32)
            check_weight_total(float(weights.sum()), weights.shape,
                               context=f"round {round_idx}: ")
        return Cohort(round_idx, ids, batches, weights, faults.survivors,
                      faults.extra_staleness, faults.dropped)
