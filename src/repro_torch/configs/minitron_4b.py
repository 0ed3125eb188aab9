"""Minitron-4B — width/depth-pruned Nemotron dense decoder [arXiv:2407.14679]
(copy of ``repro/configs/minitron_4b.py``).

32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000. Pure full attention:
long_500k decode is skipped (see DESIGN.md §Arch-applicability).
"""
from repro_torch.configs.base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    """Build the Minitron 4B ModelConfig."""
    return ModelConfig(
        name="minitron-4b",
        arch_type="dense",
        d_model=3072,
        num_heads=24,
        num_kv_heads=8,
        d_ff=9216,
        vocab_size=256_000,
        pattern=(LayerSpec(mixer="attn", ffn="dense"),),
        repeats=32,
        citation="arXiv:2407.14679",
    )
