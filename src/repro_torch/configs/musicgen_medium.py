"""MusicGen-medium — decoder-only LM over EnCodec audio tokens [arXiv:2306.05284]
(copy of ``repro/configs/musicgen_medium.py``).

48L d_model=1536 24H (kv=24, i.e. MHA) d_ff=6144 vocab=2048 (EnCodec codebook).
The audio frontend (mel-spectrogram + EnCodec conv codec) is a STUB:
``input_specs()`` provides 64 precomputed text/melody-conditioning embeddings
of shape (B, 64, d_model) consumed via early fusion; the decoder itself
operates on codebook token ids. Full attention: long_500k skipped.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    """Build the MusicGen Medium ModelConfig."""
    return ModelConfig(
        name="musicgen-medium",
        arch_type="audio",
        d_model=1536,
        num_heads=24,
        num_kv_heads=24,
        d_ff=6144,
        vocab_size=2048,
        pattern=(LayerSpec(mixer="attn", ffn="dense"),),
        repeats=48,
        frontend="audio",
        frontend_tokens=64,
        citation="arXiv:2306.05284",
    )
