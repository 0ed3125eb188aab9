"""Configs of the port: ``FedConfig``, the EMNIST CNN, and the LM registry
(``get_config(arch)`` / ``get_smoke(arch)``, from ``repro/configs``).

The registry knows every architecture id of the JAX package. Those copied
here (attention mixers with dense FFNs) return their config; the others
raise ``NotImplementedError`` naming ``ROADMAP.md`` queue 1, item 11: their
mixers, MoE FFNs or frontends are not ported, or their config is not copied
yet.
"""
from __future__ import annotations

import dataclasses
from typing import List

from repro_torch.configs import fedlm_100m, gemma3_27b, qwen3_32b
from repro_torch.configs.base import (  # noqa: F401 (public re-exports)
    LM_ITEM,
    FedConfig,
    LayerSpec,
    ModelConfig,
    MoEConfig,
    _not_ported,
    replace,
)

_MODULES = {
    "fedlm-100m": fedlm_100m,
    "gemma3-27b": gemma3_27b,
    "qwen3-32b": qwen3_32b,
}
#: Architecture ids of the JAX package not registered here yet.
PENDING_ARCHS = ("xlstm-125m", "minitron-4b", "musicgen-medium",
                 "internvl2-26b", "recurrentgemma-9b", "qwen3-moe-30b-a3b",
                 "granite-34b", "llama4-scout-17b-a16e")

ALL_ARCHS: List[str] = list(_MODULES) + list(PENDING_ARCHS)


def get_config(arch: str) -> ModelConfig:
    """Return the full-size ModelConfig registered under ``arch``."""
    if arch in PENDING_ARCHS:
        raise _not_ported(f"arch {arch!r}", LM_ITEM)
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ALL_ARCHS}")
    return _MODULES[arch].config()


def make_smoke(cfg: ModelConfig) -> ModelConfig:
    """Mechanically reduce a config as the JAX package does: 2 layers,
    d_model <= 256, 4 heads, head_dim 64, windows <= 32, vocab <= 512."""
    layers = cfg.layers()[: max(2, len(cfg.pattern))][:2]
    layers = tuple(
        dataclasses.replace(s, window=min(s.window, 32) if s.window else 0)
        for s in layers
    )
    num_kv_heads = (min(cfg.num_kv_heads, 2)
                    if cfg.num_kv_heads < cfg.num_heads else 4)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        d_model=min(cfg.d_model, 256),
        num_heads=4,
        num_kv_heads=num_kv_heads,
        head_dim=64,
        d_ff=min(cfg.d_ff, 512),
        vocab_size=min(cfg.vocab_size, 512),
        pattern=layers,
        repeats=1,
        tail=(),
        frontend_tokens=min(cfg.frontend_tokens, 8),
        lru_d=0,
    )


def get_smoke(arch: str) -> ModelConfig:
    """Return the mechanically shrunken smoke variant of ``arch``."""
    return make_smoke(get_config(arch))
