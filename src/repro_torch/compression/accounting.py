"""Exact per-round communicated bytes from abstract payloads (port of
``repro/compression/accounting.py``; codecs wait for ROADMAP.md queue 1,
item 9).

Everything runs on meta-device tensors, the port's stand-in for
``jax.eval_shape``: no allocation, exact for any model size. Uplink is
the algorithm's per-client payload (``FedAlgorithm.abstract_payload``:
``fedpa_precision`` and ``fedep`` ship two dense trees, ``scaffold`` its
delta and an fp32 ``dc``); downlink is the broadcast parameters plus the
algorithm's extras (``abstract_broadcast_extras``: MIME's server momentum,
SCAFFOLD's fp32 server control variate).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.algorithms import resolve_algorithm
from repro_torch.core import tree_math as tm


def tree_nbytes(tree) -> int:
    """Total bytes of a tree of tensors (meta-device tensors included)."""
    return sum(x.numel() * x.element_size() for x in tm.tleaves(tree))


def round_bytes(fed, params, use_sampling: bool = True) -> Dict[str, int]:
    """Exact per-round wire bytes of ``fed`` on ``params``-shaped models,
    per client and per round (x ``clients_per_round``);
    ``use_sampling=False`` accounts the burn-in regime's algorithm."""
    alg = resolve_algorithm(fed, use_sampling)
    abstract = tm.tmap(lambda p: torch.empty(p.shape, dtype=p.dtype,
                                             device="meta"), params)
    up = tree_nbytes(alg.abstract_payload(abstract))
    down = tree_nbytes(abstract) + tree_nbytes(
        alg.abstract_broadcast_extras(abstract))
    c = int(fed.clients_per_round)
    return {"bytes_up_per_client": up, "bytes_down_per_client": down,
            "bytes_up": c * up, "bytes_down": c * down}
