"""Per-round communicated bytes for dense payloads (the port's part of
``repro/compression/accounting.py``; codecs wait for ROADMAP.md queue 1,
item 9)."""
from __future__ import annotations

from typing import Dict

from repro_torch.algorithms import resolve_algorithm
from repro_torch.core import tree_math as tm


def round_bytes(fed, params, use_sampling: bool = True) -> Dict[str, int]:
    """Exact per-round wire bytes of ``fed`` on ``params``-shaped models:
    each client uploads a dense delta in ``delta_dtype`` and downloads the
    params. Per client and per round (x ``clients_per_round``)."""
    alg = resolve_algorithm(fed, use_sampling)
    up = tm.tree_size(params) * alg.delta_dtype.itemsize
    down = sum(x.numel() * x.element_size() for x in tm.tleaves(params))
    c = int(fed.clients_per_round)
    return {"bytes_up_per_client": up, "bytes_down_per_client": down,
            "bytes_up": c * up, "bytes_down": c * down}
