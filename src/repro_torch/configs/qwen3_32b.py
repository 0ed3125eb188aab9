"""Qwen3-32B — dense decoder with qk-norm GQA [hf:Qwen/Qwen3-8B] (copy of
``repro/configs/qwen3_32b.py``).

64L d_model=5120 64H (GQA kv=8, head_dim=128) d_ff=25600 vocab=151936.
All layers are global attention.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    """Build the Qwen3 32B ModelConfig."""
    return ModelConfig(
        name="qwen3-32b",
        arch_type="dense",
        d_model=5120,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=25_600,
        vocab_size=151_936,
        pattern=(LayerSpec(mixer="attn", ffn="dense"),),
        repeats=64,
        qk_norm=True,
        rope_theta=1_000_000.0,
        citation="hf:Qwen/Qwen3-8B",
    )
