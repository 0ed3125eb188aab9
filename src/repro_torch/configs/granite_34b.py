"""Granite-34B-Code — deep llama-architecture code model with MQA
[arXiv:2405.04324] (copy of ``repro/configs/granite_34b.py``).

88L d_model=6144 48H (GQA kv=1, i.e. multi-query) d_ff=24576 vocab=49152.
Pure full attention: long_500k skipped.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    """Build the Granite 34B ModelConfig."""
    return ModelConfig(
        name="granite-34b",
        arch_type="dense",
        d_model=6144,
        num_heads=48,
        num_kv_heads=1,
        d_ff=24_576,
        vocab_size=49_152,
        pattern=(LayerSpec(mixer="attn", ffn="dense"),),
        repeats=88,
        citation="arXiv:2405.04324",
    )
