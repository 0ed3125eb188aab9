"""Llama-4-Scout-17B-16E — MoE with 16 experts top-1 + shared expert, 3:1
chunked-local:full attention [hf:meta-llama/Llama-4-Scout-17B-16E]
(copy of ``repro/configs/llama4_scout_17b_a16e.py``).

48L d_model=5120 40H (GQA kv=8) expert d_ff=8192 vocab=202048, MoE 16e top-1.
Pattern unit = 3 chunked-local-attention layers (window 8192) + 1 full-
attention layer, x12. The chunked-local layers bound decode KV memory, and at
long_500k batch=1 the full layers' cache fits — long_500k runs.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig

CHUNK_WINDOW = 8192


def config() -> ModelConfig:
    """Build the Llama 4 Scout 17B-A16E ModelConfig."""
    return ModelConfig(
        name="llama4-scout-17b-a16e",
        arch_type="moe",
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=202_048,
        pattern=(
            LayerSpec(mixer="swa", ffn="moe", window=CHUNK_WINDOW),
            LayerSpec(mixer="swa", ffn="moe", window=CHUNK_WINDOW),
            LayerSpec(mixer="swa", ffn="moe", window=CHUNK_WINDOW),
            LayerSpec(mixer="attn", ffn="moe"),
        ),
        repeats=12,
        moe=MoEConfig(
            num_experts=16,
            top_k=1,
            expert_d_ff=8192,
            shared_expert_d_ff=8192,
            capacity_factor=1.25,
            chunk_tokens=8192,
        ),
        supports_long_decode=True,
        citation="hf:meta-llama/Llama-4-Scout-17B-16E",
    )
