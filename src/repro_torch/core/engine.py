"""The round engine of the port (from ``repro/core/engine.py``): the fused
window-1 backend — one round program per round, applied in order — with
burn-in regime switching, eval cadence and history through
``RoundRecorder``. Each cohort's survivor mask (``data.cohort_source``) is
threaded into the round, and its ``dropped`` count rides the record.

Stateful algorithms (``stateful`` / ``burn_stateful`` with a
``client_store``): with the host store the cohort's state slice is
gathered before the round and CAS-scattered after it, at the round's
edges, and the returned drop count goes on the record's ``state_drops``;
with the device store the store's tensors and the cohort's ids are handed
to the round, which gathers and scatters on the device, and the store
adopts the result. A dropped client's (survivor mask) state never lands.

The reference's split backend (async windows, stragglers, the apply-order
write-back) and prefetchers wait for ROADMAP.md queue 1, item 8.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

from repro_torch.core.client_state import (BaseClientStateStore,
                                           DeviceClientStateStore)
from repro_torch.core.history import RoundRecorder
from repro_torch.core.server import ServerState
from repro_torch.data.prefetch import Cohort

#: build_cohort(round_idx) -> Cohort
BuildCohort = Callable[[int], Cohort]


@dataclasses.dataclass
class RoundEngine:
    """Drives ``num_rounds`` synchronous rounds (an in-flight window of 1).

    ``round_fn(state, batches, weights, survivors) -> (state, metrics)`` is
    the fused round of ``make_round_program``; ``burn_round_fn`` (optional)
    runs the first ``burn_in_rounds`` rounds (the FedAvg regime of a FedPA
    config).
    ``round_bytes`` / ``burn_round_bytes`` are stamped on every record.

    ``stateful`` / ``burn_stateful`` say whether the sampling and burn-in
    regimes carry per-client state (the algorithm's ``stateful`` /
    ``burn_stateful``); either needs ``client_store``.
    """

    round_fn: Callable
    burn_round_fn: Optional[Callable] = None
    burn_in_rounds: int = 0
    round_bytes: Optional[dict] = None
    burn_round_bytes: Optional[dict] = None
    client_store: Optional[BaseClientStateStore] = None
    stateful: bool = False
    burn_stateful: bool = False

    def __post_init__(self):
        """Check the store."""
        if (self.stateful or self.burn_stateful) and self.client_store is None:
            raise ValueError(
                "stateful=True requires a client-state store (client_store)")
        self._device_store = isinstance(self.client_store,
                                        DeviceClientStateStore)

    def _apply(self, state: ServerState, cohort: Cohort, t: int):
        """One round of the regime round ``t`` is in; returns ``(state,
        metrics, is_burn, state_drops)``."""
        is_burn = t < self.burn_in_rounds
        fn = (self.burn_round_fn if is_burn and self.burn_round_fn is not None
              else self.round_fn)
        stateful = self.burn_stateful if is_burn else self.stateful
        store, drops = self.client_store, 0
        if stateful and self._device_store:
            ids = store.prepare_ids(cohort.client_ids)
            state, metrics, new_store = fn(
                state, cohort.batches, cohort.weights, store.device_state(),
                ids, cohort.survivors)
            store.set_device_state(new_store)
        elif stateful:
            cstates, stamps = store.gather(cohort.client_ids)
            state, metrics, new_states = fn(state, cohort.batches,
                                            cohort.weights, cstates,
                                            cohort.survivors)
            # a dropped client's half-finished state must not land
            drops = store.scatter(cohort.client_ids, new_states, stamps,
                                  write_mask=cohort.survivors)
        else:
            state, metrics = fn(state, cohort.batches, cohort.weights,
                                cohort.survivors)
        return state, metrics, is_burn, drops

    def round(self, state: ServerState, cohort: Cohort, round_idx: int
              ) -> Tuple[ServerState, dict]:
        """One round; returns ``(state, record)`` with the record already
        converted to plain Python."""
        recorder = RoundRecorder(round_bytes=self.round_bytes,
                                 burn_round_bytes=self.burn_round_bytes)
        state, metrics, is_burn, drops = self._apply(state, cohort,
                                                     round_idx)
        recorder.record(round_idx=round_idx, metrics=metrics,
                        is_burn=is_burn, dropped=cohort.dropped,
                        state_drops=drops)
        return state, recorder.history()[0]

    def run(self, state: ServerState, build_cohort: BuildCohort,
            num_rounds: int, *, eval_fn: Optional[Callable] = None,
            eval_every: int = 1, on_round: Optional[Callable] = None
            ) -> Tuple[ServerState, List[dict]]:
        """Returns ``(state, history)``: one uniform-schema record per
        round, converted to Python once at the end. ``eval_fn(params)``
        metrics ride the records of rounds with ``t % eval_every == 0``
        (plus the last round).

        ``on_round(record, state)`` fires after each server update with the
        raw record (its metrics may still be on the device) and the
        post-update state, for live logging; forcing the metrics there
        costs one device sync per round."""
        if eval_fn is not None and eval_every < 1:
            raise ValueError(
                f"eval_every must be >= 1 when eval_fn is set, got "
                f"{eval_every} (evaluate every round with eval_every=1, or "
                f"pass eval_fn=None to disable evaluation)")
        recorder = RoundRecorder(round_bytes=self.round_bytes,
                                 burn_round_bytes=self.burn_round_bytes)
        for t in range(num_rounds):
            cohort = build_cohort(t)
            state, metrics, is_burn, drops = self._apply(state, cohort, t)
            ev = (eval_fn(state.params)
                  if eval_fn is not None and (t % eval_every == 0
                                              or t == num_rounds - 1)
                  else None)
            rec = recorder.record(round_idx=t, metrics=metrics,
                                  is_burn=is_burn, dropped=cohort.dropped,
                                  state_drops=drops, eval_metrics=ev)
            if on_round is not None:
                on_round(rec, state)
        return state, recorder.history()
