"""FedLM-100M — the framework's own ~100M-param dense decoder used by the
end-to-end federated-training example (copy of
``repro/configs/fedlm_100m.py``).

12L d_model=768 12H (GQA kv=4) d_ff=2048 vocab=32768, qk-norm, tied
embeddings: 100,684,032 parameters.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    """Build the ~100M-param FedLM dense decoder ModelConfig."""
    return ModelConfig(
        name="fedlm-100m",
        arch_type="dense",
        d_model=768,
        num_heads=12,
        num_kv_heads=4,
        d_ff=2048,
        vocab_size=32_768,
        pattern=(LayerSpec(mixer="attn", ffn="dense"),),
        repeats=12,
        qk_norm=True,
        citation="this framework",
    )
