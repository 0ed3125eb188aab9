"""xLSTM-125M — alternating sLSTM + mLSTM blocks [arXiv:2405.04517]
(copy of ``repro/configs/xlstm_125m.py``).

12L d_model=768 4H (GQA kv=4 — heads apply to the mLSTM matrix memory),
d_ff=0 (xLSTM blocks carry their own up/down projections), vocab 50304.
Attention-free: recurrent state gives O(1) decode memory, so long_500k runs.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    """Build the xLSTM 125M ModelConfig."""
    return ModelConfig(
        name="xlstm-125m",
        arch_type="ssm",
        d_model=768,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,
        vocab_size=50_304,
        pattern=(
            LayerSpec(mixer="slstm", ffn="none"),
            LayerSpec(mixer="mlstm", ffn="none"),
        ),
        repeats=6,
        expansion=2.0,
        supports_long_decode=True,
        citation="arXiv:2405.04517",
    )
