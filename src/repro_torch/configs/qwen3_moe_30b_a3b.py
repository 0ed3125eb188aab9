"""Qwen3-MoE-30B-A3B — 128 experts, top-8 routing, qk-norm GQA
[hf:Qwen/Qwen3-30B-A3B] (copy of ``repro/configs/qwen3_moe_30b_a3b.py``).

48L d_model=2048 32H (GQA kv=4) per-expert d_ff=768 vocab=151936.
Expert-parallel: experts shard over the `model` mesh axis (all-to-all
dispatch). Full attention: long_500k skipped.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig


def config() -> ModelConfig:
    """Build the Qwen3-MoE 30B-A3B ModelConfig."""
    return ModelConfig(
        name="qwen3-moe-30b-a3b",
        arch_type="moe",
        d_model=2048,
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        d_ff=768,
        vocab_size=151_936,
        pattern=(LayerSpec(mixer="attn", ffn="moe"),),
        repeats=48,
        moe=MoEConfig(
            num_experts=128,
            top_k=8,
            expert_d_ff=768,
            capacity_factor=1.25,
            chunk_tokens=8192,
        ),
        qk_norm=True,
        citation="hf:Qwen/Qwen3-30B-A3B",
    )
