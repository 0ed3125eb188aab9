"""Payload compression (port of ``repro/compression``): the codec registry,
low-rank sketches drawn as ``jax.random`` draws them, quantization, and
exact communicated-bytes accounting."""
from repro_torch.compression import lowrank, quant  # noqa: F401 (register)
from repro_torch.compression.accounting import round_bytes, tree_nbytes
from repro_torch.compression.base import (
    CodecChain,
    PayloadCodec,
    build_codec,
    codec_names,
    parse_codec,
    register_codec,
)

__all__ = [
    "CodecChain",
    "PayloadCodec",
    "build_codec",
    "codec_names",
    "parse_codec",
    "register_codec",
    "round_bytes",
    "tree_nbytes",
]
