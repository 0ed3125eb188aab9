"""The staleness-general round engine of the port (from
``repro/core/engine.py``): ONE loop for sync and async.

The synchronous path is the async pipeline with an in-flight window of
one. ``RoundEngine`` owns that loop: cohort dispatch (up to
``max_staleness + 1`` cohorts in flight), delta application with the
``staleness_discount ** s`` down-weighting, the client-state gather and
CAS write-back for both store placements, burn-in regimes, eval cadence,
the prefetcher lifecycle, and history through ``RoundRecorder``.
``FedSim`` (``core/round.py``), ``launch.train`` and the
``AsyncRoundEngine`` alias (``core/async_engine.py``) are frontends over
it.

Every round runs as two stages, ``cohort_fn`` + ``server_fn`` from
``make_cohort_program`` / ``make_server_program``: cohort compute and
server update are separate calls, so cohort ``t+1`` is dispatched against
params version ``v`` before round ``t``'s update lands, and a delta
computed at ``v`` and applied at ``v + s`` is discounted by
``staleness_discount ** s`` (straggler lateness rides the same exponent).
A delta applied fresh (``s = 0``, every synchronous round) is passed no
discount, so the synchronous round is exactly ``make_round_program``'s.
The reference keeps a second, fused backend for its one jitted round
program with buffer donation; eager PyTorch has neither, so the port
keeps only the split stages.

A dispatched cohort runs eagerly: on the CPU it is done when ``_dispatch``
returns, on the GPU its kernels are queued on the stream ahead of the
server update that follows, so it reads the params it was dispatched
against in either case. That holds because nothing a cohort returns
aliases a tensor that a later step writes in place: the server update and
the optimizers build new tensors, ``device_gather`` copies
(``index_select``), and only the device store's ``device_scatter`` writes
in place, into the store's own buffers.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, List, NamedTuple, Optional, Tuple

from repro_torch.core.client_state import (BaseClientStateStore,
                                           DeviceClientStateStore,
                                           device_scatter)
from repro_torch.core.history import RoundRecorder
from repro_torch.core.server import ServerState
from repro_torch.data.prefetch import Cohort, close_prefetcher, make_prefetcher

#: build_cohort(round_idx) -> Cohort
BuildCohort = Callable[[int], Cohort]


class _InFlight(NamedTuple):
    """One dispatched-but-unapplied cohort.

    ``version`` is the params version the cohort saw when dispatched;
    ``client_ids`` / ``new_states`` / ``stamps`` carry the per-client
    state write-back (None when stateless): the gather-time stamps let the
    store drop a stale write from a cohort that overlapped an
    already-applied one on the same client. With the device store the
    three are device tensors (the ids of ``prepare_ids``, the stacked
    state updates, the stamp snapshot) and the write-back never touches
    the host. ``survivors`` / ``extra_staleness`` / ``dropped`` are the
    cohort's fault annotations (``data.cohort_source``): the survivor mask
    already went into the dispatched cohort and gates the write-back; the
    straggler lateness is added to the staleness exponent at apply time.
    """

    agg: object
    metrics: dict
    version: int
    round_idx: int
    is_burn: bool
    client_ids: object = None
    new_states: object = None
    stamps: object = None
    survivors: object = None
    extra_staleness: int = 0
    dropped: int = 0


class _Applied(NamedTuple):
    """What one applied round hands the recorder."""

    state: ServerState
    metrics: dict
    is_burn: bool
    staleness: int
    dropped: int
    straggled: int
    state_drops: object   # int, or the device store's CAS drop count


@dataclasses.dataclass
class RoundEngine:
    """Drives ``num_rounds`` staleness-aware rounds; window 1 is sync.

    ``cohort_fn(state, batches, weights, survivors) -> (agg, metrics)`` +
    ``server_fn(state, agg, discount) -> state`` (stateful signatures as
    in ``make_cohort_program``). ``burn_*`` variants (optional) run the
    first ``burn_in_rounds`` rounds — the burn regime of the config's
    algorithm (the FedAvg regime of a FedPA config); the burn server stage
    exists because a burn regime may aggregate in another payload space
    (``fedpa_precision`` burns in as fedavg). ``round_bytes`` /
    ``burn_round_bytes`` are stamped on every record.

    Stateful algorithms (``stateful`` / ``burn_stateful``, the
    algorithm's ``stateful`` / ``burn_stateful``, with a
    ``client_store``): each dispatched cohort gathers its clients' state
    and the write-back happens at APPLY time, in round order, tagged with
    the gather-time stamps — when two in-flight cohorts overlap on a
    client, the one applied second (which gathered before the first
    wrote) is dropped for that client. With the host store the write-back
    pulls ``new_states`` to the host; with the device store the gather
    happens inside the dispatched cohort and the write-back is
    ``device_scatter``, its drop count a device scalar until the
    recorder's one end-of-loop sync.

    ``prefetch_rounds > 0`` builds cohorts that many rounds ahead on a
    ``prefetch_backend`` prefetcher (``data/prefetch.py``).
    """

    cohort_fn: Callable
    server_fn: Callable
    max_staleness: int = 0
    staleness_discount: float = 1.0
    burn_cohort_fn: Optional[Callable] = None
    burn_server_fn: Optional[Callable] = None
    burn_in_rounds: int = 0
    prefetch_rounds: int = 0
    prefetch_backend: str = "thread"
    client_store: Optional[BaseClientStateStore] = None
    stateful: bool = False
    burn_stateful: bool = False
    round_bytes: Optional[dict] = None
    burn_round_bytes: Optional[dict] = None

    def __post_init__(self):
        """Validate the knobs."""
        if self.max_staleness < 0:
            raise ValueError("max_staleness must be >= 0")
        if not 0.0 <= self.staleness_discount <= 1.0:
            raise ValueError("staleness_discount must be in [0, 1]")
        if self.cohort_fn is None or self.server_fn is None:
            raise ValueError(
                "RoundEngine needs both stages (cohort_fn + server_fn)")
        if (self.stateful or self.burn_stateful) and self.client_store is None:
            raise ValueError(
                "stateful=True requires a client-state store (client_store)")
        self._device_store = isinstance(self.client_store,
                                        DeviceClientStateStore)
        self._burn = self.burn_cohort_fn or self.cohort_fn
        self._burn_server = self.burn_server_fn or self.server_fn

    # -- dispatch now, apply (discounted) later ----------------------------
    def _dispatch(self, state: ServerState, cohort: Cohort, t_next: int,
                  version: int) -> _InFlight:
        """Run one cohort and wrap its outputs as ``_InFlight``.

        Stateful regimes also carry the per-client write-back: with the
        device store the cohort gathers from the store's current tensors
        (its stamp snapshot tags the CAS); with the host store the gather
        is a host numpy slice."""
        is_burn = t_next < self.burn_in_rounds
        fn = self._burn if is_burn else self.cohort_fn
        surv = cohort.survivors
        fault = (surv, cohort.extra_staleness, cohort.dropped)
        if not (self.burn_stateful if is_burn else self.stateful):
            agg, metrics = fn(state, cohort.batches, cohort.weights, surv)
            return _InFlight(agg, metrics, version, t_next, is_burn,
                             None, None, None, *fault)
        store = self.client_store
        if self._device_store:
            ids = store.prepare_ids(cohort.client_ids)
            agg, metrics, new_states, stamps = fn(
                state, cohort.batches, cohort.weights, store.device_state(),
                ids, surv)
            return _InFlight(agg, metrics, version, t_next, is_burn,
                             ids, new_states, stamps, *fault)
        cstates, stamps = store.gather(cohort.client_ids)
        agg, metrics, new_states = fn(state, cohort.batches, cohort.weights,
                                      cstates, surv)
        return _InFlight(agg, metrics, version, t_next, is_burn,
                         cohort.client_ids, new_states, stamps, *fault)

    def _apply(self, state: ServerState, fl: _InFlight,
                         version: int) -> _Applied:
        """Apply one in-flight cohort: the staleness-discounted server
        update, then the apply-order client-state write-back."""
        # a straggling cohort is applied at its slot but discounted as if
        # it were extra_staleness rounds later
        staleness = version - fl.version + fl.extra_staleness
        server = self._burn_server if fl.is_burn else self.server_fn
        # a fresh delta takes no discount: the synchronous round's ops
        state = server(state, fl.agg, (self.staleness_discount ** staleness
                                       if staleness else None))
        drops = self._write_back_states(fl)
        return _Applied(state, fl.metrics, fl.is_burn, staleness,
                        int(fl.dropped), int(fl.extra_staleness), drops)

    def _write_back_states(self, fl: _InFlight):
        """Apply-order CAS write-back with the gather-time stamps: a client
        already updated by an overlapping cohort keeps that fresher value
        (the stale write is dropped), and a dropped client's half-finished
        state does not land. Returns the drop count (a device scalar with
        the device store: no per-round host sync)."""
        if fl.new_states is None:
            return 0
        store = self.client_store
        if self._device_store:
            new_store, drops = device_scatter(
                store.device_state(), fl.client_ids, fl.new_states,
                fl.stamps, fl.survivors)
            store.set_device_state(new_store)
            return drops
        return store.scatter(fl.client_ids, fl.new_states, fl.stamps,
                             write_mask=fl.survivors)

    def round(self, state: ServerState, cohort: Cohort, round_idx: int
              ) -> Tuple[ServerState, dict]:
        """One synchronous round (dispatch, then apply at once); returns
        ``(state, record)`` with the record already converted to plain
        Python."""
        recorder = RoundRecorder(round_bytes=self.round_bytes,
                                 burn_round_bytes=self.burn_round_bytes)
        out = self._apply(state, self._dispatch(state, cohort, round_idx, 0),
                          0)
        recorder.record(round_idx=round_idx, metrics=out.metrics,
                        is_burn=out.is_burn, staleness=out.staleness,
                        dropped=out.dropped, straggled=out.straggled,
                        state_drops=out.state_drops)
        return out.state, recorder.history()[0]

    def run(self, state: ServerState, build_cohort: BuildCohort,
            num_rounds: int, *, eval_fn: Optional[Callable] = None,
            eval_every: int = 1, on_round: Optional[Callable] = None
            ) -> Tuple[ServerState, List[dict]]:
        """Returns ``(state, history)``: one uniform-schema record per
        applied round, converted to Python once at the end. ``eval_fn``
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
        source = (make_prefetcher(self.prefetch_backend, build_cohort, 0,
                                  num_rounds, depth=self.prefetch_rounds)
                  if self.prefetch_rounds > 0 else None)
        get = source.get if source is not None else build_cohort
        pending: deque = deque()   # in dispatch (== apply) order
        version = 0                # server updates applied so far
        t_next = 0                 # next round to dispatch
        completed = False
        try:
            for t_apply in range(num_rounds):
                # keep up to max_staleness cohorts in flight beyond the one
                # being applied; each remembers the params version it saw
                while (t_next < num_rounds
                       and len(pending) <= self.max_staleness):
                    pending.append(self._dispatch(state, get(t_next), t_next,
                                                  version))
                    t_next += 1
                out = self._apply(state, pending.popleft(), version)
                state = out.state
                version += 1
                ev = (eval_fn(state.params)
                      if eval_fn is not None and (t_apply % eval_every == 0
                                                  or t_apply == num_rounds - 1)
                      else None)
                rec = recorder.record(
                    round_idx=t_apply, metrics=out.metrics,
                    is_burn=out.is_burn, staleness=out.staleness,
                    dropped=out.dropped, straggled=out.straggled,
                    state_drops=out.state_drops, eval_metrics=ev)
                if on_round is not None:
                    on_round(rec, state)
            completed = True
        finally:
            if source is not None:
                # a hung prefetch worker stays loud on a clean exit but
                # must not mask an exception unwinding out of the loop
                close_prefetcher(source, unwinding=not completed)
        return state, recorder.history()
