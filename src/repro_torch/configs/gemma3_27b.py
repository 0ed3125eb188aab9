"""Gemma3-27B — 5:1 local:global attention, 128k context, qk-norm
[hf:google/gemma-3-1b-pt] (copy of ``repro/configs/gemma3_27b.py``).

62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144. Pattern unit =
5 sliding-window layers (w=1024) + 1 global layer, x10, plus a 2-layer local
tail.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

WINDOW = 1024


def config() -> ModelConfig:
    """Build the Gemma 3 27B ModelConfig."""
    local = LayerSpec(mixer="swa", ffn="dense", window=WINDOW)
    return ModelConfig(
        name="gemma3-27b",
        arch_type="dense",
        d_model=5376,
        num_heads=32,
        num_kv_heads=16,
        head_dim=128,
        d_ff=21_504,
        vocab_size=262_144,
        pattern=(local, local, local, local, local,
                 LayerSpec(mixer="attn", ffn="dense")),
        repeats=10,
        tail=(local, local),
        qk_norm=True,
        rope_theta=1_000_000.0,
        supports_long_decode=True,
        citation="hf:google/gemma-3-1b-pt",
    )
