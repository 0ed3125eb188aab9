"""RecurrentGemma-9B — Griffin: RG-LRU recurrent blocks + local attention,
2:1 recurrent:attention [arXiv:2402.19427]
(copy of ``repro/configs/recurrentgemma_9b.py``).

38L d_model=4096 16H (GQA kv=1 on the attention layers) d_ff=12288
vocab=256000. Pattern unit = (rglru, rglru, local-attn[w=2048]) x 12 plus a
2-layer recurrent tail. Recurrent state + bounded attention window give O(1)
decode memory: long_500k runs.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

WINDOW = 2048


def config() -> ModelConfig:
    """Build the RecurrentGemma 9B ModelConfig."""
    return ModelConfig(
        name="recurrentgemma-9b",
        arch_type="hybrid",
        d_model=4096,
        num_heads=16,
        num_kv_heads=1,
        d_ff=12_288,
        vocab_size=256_000,
        pattern=(
            LayerSpec(mixer="rglru", ffn="dense"),
            LayerSpec(mixer="rglru", ffn="dense"),
            LayerSpec(mixer="swa", ffn="dense", window=WINDOW),
        ),
        repeats=12,
        tail=(
            LayerSpec(mixer="rglru", ffn="dense"),
            LayerSpec(mixer="rglru", ffn="dense"),
        ),
        expansion=1.5,
        supports_long_decode=True,
        citation="arXiv:2402.19427",
    )
