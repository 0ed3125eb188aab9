"""InternVL2-26B — InternViT-6B vision encoder + InternLM2-20B decoder
[arXiv:2404.16821] (copy of ``repro/configs/internvl2_26b.py``).

We implement the LANGUAGE BACKBONE (48L d_model=6144 48H GQA kv=8 d_ff=16384
vocab=92553). The InternViT encoder + MLP projector is a STUB:
``input_specs()`` provides 256 precomputed patch embeddings (B, 256, d_model)
that the decoder consumes via early-fusion concatenation with the text tokens.
Full attention: long_500k skipped.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    """Build the InternVL2 26B ModelConfig."""
    return ModelConfig(
        name="internvl2-26b",
        arch_type="vlm",
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        d_ff=16_384,
        vocab_size=92_553,   # padded to 92_672 (multiple of 128) for sharding
        pattern=(LayerSpec(mixer="attn", ffn="dense"),),
        repeats=48,
        frontend="vision",
        frontend_tokens=256,
        citation="arXiv:2404.16821",
    )
