"""Configs of the port: ``FedConfig``, the EMNIST CNN, and the LM registry
(``get_config(arch)`` / ``get_smoke(arch)``, from ``repro/configs``).

The registry holds every architecture of the JAX package, copied field for
field. Smoke variants are derived mechanically from the full config (<= 2
layers, d_model <= 256, <= 4 experts), as the JAX package derives them.
"""
from __future__ import annotations

import dataclasses
from typing import List

from repro_torch.configs import (
    fedlm_100m,
    gemma3_27b,
    granite_34b,
    internvl2_26b,
    llama4_scout_17b_a16e,
    minitron_4b,
    musicgen_medium,
    qwen3_32b,
    qwen3_moe_30b_a3b,
    recurrentgemma_9b,
    xlstm_125m,
)
from repro_torch.configs.base import (  # noqa: F401 (public re-exports)
    FedConfig,
    LayerSpec,
    ModelConfig,
    MoEConfig,
    _not_ported,
    replace,
)

#: The ten assigned architectures and the framework's own LM, in the JAX
#: package's order.
_MODULES = {
    "xlstm-125m": xlstm_125m,
    "minitron-4b": minitron_4b,
    "musicgen-medium": musicgen_medium,
    "internvl2-26b": internvl2_26b,
    "recurrentgemma-9b": recurrentgemma_9b,
    "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b,
    "granite-34b": granite_34b,
    "llama4-scout-17b-a16e": llama4_scout_17b_a16e,
    "gemma3-27b": gemma3_27b,
    "qwen3-32b": qwen3_32b,
    "fedlm-100m": fedlm_100m,
}

ALL_ARCHS: List[str] = list(_MODULES)


def get_config(arch: str) -> ModelConfig:
    """Return the full-size ModelConfig registered under ``arch``."""
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ALL_ARCHS}")
    return _MODULES[arch].config()


def make_smoke(cfg: ModelConfig) -> ModelConfig:
    """Mechanically reduce a config as the JAX package does: 2 layers,
    d_model <= 256, 4 heads, head_dim 64, windows <= 32, vocab <= 512; an
    MoE keeps <= 4 experts, top-k <= 2, expert and shared d_ff <= 256 and
    chunks of 64 tokens."""
    layers = cfg.layers()[: max(2, len(cfg.pattern))][:2]
    layers = tuple(
        dataclasses.replace(s, window=min(s.window, 32) if s.window else 0)
        for s in layers
    )
    num_kv_heads = (min(cfg.num_kv_heads, 2)
                    if cfg.num_kv_heads < cfg.num_heads else 4)
    moe = cfg.moe
    if moe.enabled:
        moe = dataclasses.replace(
            moe,
            num_experts=min(moe.num_experts, 4),
            top_k=min(moe.top_k, 2),
            expert_d_ff=min(moe.expert_d_ff, 256),
            shared_expert_d_ff=min(moe.shared_expert_d_ff, 256),
            chunk_tokens=64,
        )
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
        moe=moe,
        frontend_tokens=min(cfg.frontend_tokens, 8),
        lru_d=0,
    )


def get_smoke(arch: str) -> ModelConfig:
    """Return the mechanically shrunken smoke variant of ``arch``."""
    return make_smoke(get_config(arch))
