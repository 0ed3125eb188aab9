"""Deprecated alias (port of ``repro/core/async_engine.py``):
``AsyncRoundEngine`` is ``core.engine.RoundEngine``.

The double-buffered async pipeline — up to ``max_staleness`` cohorts in
flight, deltas down-weighted by ``staleness_discount ** s``, apply-order
CAS write-back of per-client state — lives in the staleness-general
``RoundEngine``, whose synchronous path is the same loop with an in-flight
window of one. Construct ``RoundEngine`` directly; only the
``max_staleness`` default differs (1 here, 0 there).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.engine import BuildCohort, RoundEngine  # noqa: F401

__all__ = ["AsyncRoundEngine", "BuildCohort"]


@dataclasses.dataclass
class AsyncRoundEngine(RoundEngine):
    """Thin alias of :class:`RoundEngine` with the historic async default
    ``max_staleness = 1``."""

    max_staleness: int = 1
