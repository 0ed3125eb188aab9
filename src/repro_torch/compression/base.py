"""Payload-codec specs (port of ``repro/compression/base.py``: ``parse_codec``
and ``codec_names``), without the codecs themselves.

A spec composes stages left to right with ``"+"`` (``"lowrank+int8"``).
Every linear stage must come before every nonlinear one: the linear
prefix defines the space the round accumulates in. The stages and their
``linear`` flags are the reference's registry: ``none`` and ``lowrank``
are linear, ``int8`` is not. Only ``"none"`` runs in this port; the codec
math waits for ROADMAP.md queue 1, item 9.
"""
from __future__ import annotations

from typing import Tuple

#: Registered stage name -> whether its encode is linear in its input.
CODEC_LINEAR = {"int8": False, "lowrank": True, "none": True}


def codec_names() -> Tuple[str, ...]:
    """Sorted names of every registered codec stage."""
    return tuple(sorted(CODEC_LINEAR))


def parse_codec(spec: str) -> Tuple[str, ...]:
    """Split and validate a ``"+"``-composed codec spec.

    Raises ``ValueError`` on unknown stages, on ``"none"`` composed with
    anything, on duplicates, and on a linear stage after a nonlinear one.
    """
    if not isinstance(spec, str) or not spec:
        raise ValueError(f"payload_codec must be a non-empty str, got {spec!r}")
    stages = tuple(s.strip() for s in spec.split("+"))
    for s in stages:
        if s not in CODEC_LINEAR:
            raise ValueError(
                f"unknown payload codec {s!r} in spec {spec!r}; "
                f"registered codecs: {codec_names()}")
    if "none" in stages and len(stages) > 1:
        raise ValueError(f"codec 'none' cannot be composed: {spec!r}")
    if len(set(stages)) != len(stages):
        raise ValueError(f"duplicate codec stage in spec {spec!r}")
    seen_nonlinear = False
    for s in stages:
        if CODEC_LINEAR[s] and seen_nonlinear:
            raise ValueError(
                f"linear codec {s!r} after a nonlinear stage in {spec!r}: "
                "linear stages must form a prefix (they define the "
                "accumulator space)")
        seen_nonlinear = seen_nonlinear or not CODEC_LINEAR[s]
    return stages
