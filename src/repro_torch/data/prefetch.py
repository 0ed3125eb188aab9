"""One round's host-side inputs (port of the inline parts of
``repro/data/prefetch.py``: ``stack_host`` and ``Cohort``; the prefetchers
wait for ROADMAP.md queue 1, item 8, and the port never forks a process)."""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree


def stack_host(trees):
    """Stack identically-structured batch trees along a new leading
    (client) axis: numpy leaves with ``np.stack`` (they transfer to the
    device once, when the round consumes them), tensors with
    ``torch.stack``."""
    def stack(*xs):
        if isinstance(xs[0], np.ndarray):
            return np.stack(xs)
        return torch.stack(xs)

    return pytree.tree_map(stack, *trees)


class Cohort(NamedTuple):
    """One round's materialized inputs: ids are informational, ``batches``
    carries the (C, K, ...) stacked trees, ``weights`` is None for
    uniform.

    The trailing fields are the fault annotations of
    ``data.cohort_source.CohortSource``: ``survivors`` is the (C,) float
    0/1 mid-round dropout mask the round program threads into the
    aggregation (None = no mask faults this run), ``extra_staleness`` the
    straggler lateness (always 0 in the synchronous port) and ``dropped``
    the count of masked-out cohort slots (for the round history).
    """

    round_idx: int
    client_ids: object
    batches: object
    weights: Optional[object] = None
    survivors: Optional[object] = None
    extra_staleness: int = 0
    dropped: int = 0
