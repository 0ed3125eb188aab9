"""Symmetric per-leaf integer quantization of payload leaves (port of
``repro/compression/quant.py``).

Each leaf becomes ``{"q": intN, "scale": fp32}`` with ``scale = max(|x|) /
qmax``: 4x fewer wire bytes than fp32 at 8 bits (2x at 16). The scale is
one client's: on a stacked ``(C, ...)`` leaf the max runs over every axis
but the first, so ``scale`` has shape ``(C,)`` (a scalar for one client's
leaf). Quantization is nonlinear, so it sits at the end of a codec chain
and is undone per client (``CodecChain.to_accum``) before payloads are
summed. ``FedConfig.quant_bits`` selects 8 or 16 bits. Every op stays on
the leaf's device; nothing is read back to the host.

The scale is per leaf and per client. On an FSDP shard (``compression
.base``'s parts) a leaf may be cut over the ranks, so its scale is the max
over the ranks of each rank's ``max |piece|`` (``shard_amax``, every part
of a client in one call; a factor held whole on every rank gives every
rank the same max), then quantization is elementwise
(``shard_quantize``). The max is exact, so the sharded codes and scales
are the whole leaf's bit for bit.
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from repro_torch.compression.base import PayloadCodec, register_codec

#: guards the scale against an all-zero leaf (decode then yields zeros)
_SCALE_EPS = 1e-12


def is_qleaf(x) -> bool:
    """Whether ``x`` is one quantized leaf, ``{"q", "scale"}``."""
    return isinstance(x, dict) and set(x) == {"q", "scale"}


def _stacked(x: torch.Tensor, ref) -> bool:
    """Whether ``x`` carries a leading client axis beyond its template leaf
    ``ref``."""
    lead = x.dim() - len(ref.shape)
    if lead not in (0, 1):
        raise ValueError(f"leaf of shape {tuple(x.shape)} against a "
                         f"template of {tuple(ref.shape)}")
    return lead == 1


def _per_client(scale: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``scale`` (``()`` or ``(C,)``) shaped to broadcast against ``x``."""
    return scale.reshape(scale.shape + (1,) * (x.dim() - scale.dim()))


@register_codec("int8")
class QuantCodec(PayloadCodec):
    """Symmetric round-to-nearest quantizer; bit width from ``quant_bits``."""

    linear = False

    def __init__(self, fed):
        """Read the bit width (8 or 16) from ``fed.quant_bits``."""
        super().__init__(fed)
        bits = int(fed.quant_bits)
        if bits not in (8, 16):
            raise ValueError(f"quant_bits must be 8 or 16, got {bits}")
        self.qmax = float(2 ** (bits - 1) - 1)
        self.qdtype = torch.int8 if bits == 8 else torch.int16

    def encode(self, tree, round_idx, like=None):
        """Each leaf -> ``{"q": intN, "scale": fp32 per client}``."""
        del round_idx

        def leaf(x, ref):
            x32 = x.to(torch.float32)
            amax = (x32.abs().reshape(x.shape[0], -1).amax(1)
                    if _stacked(x, ref) else x32.abs().amax())
            return self._quantize(x32, amax)

        return pytree.tree_map(leaf, tree, tree if like is None else like)

    def _quantize(self, x32: torch.Tensor, amax: torch.Tensor) -> dict:
        """``{"q", "scale"}`` of fp32 ``x32`` against its clients' max
        magnitudes ``amax`` (``()`` or ``(C,)``)."""
        scale = torch.clamp(amax, min=_SCALE_EPS) / self.qmax
        q = torch.clamp(torch.round(x32 / _per_client(scale, x32)),
                        -self.qmax, self.qmax).to(self.qdtype)
        return {"q": q, "scale": scale}

    def shard_amax(self, parts, lead_dims: int) -> torch.Tensor:
        """Each part's ``max |x|`` per client on this rank (0 for an empty
        piece): ``(*lead, len(parts))`` fp32."""
        cols = []
        for x in parts:
            flat = x.to(torch.float32).abs().flatten(lead_dims)
            cols.append(flat.amax(-1) if flat.shape[-1] else
                        flat.new_zeros(flat.shape[:-1]))
        return torch.stack(cols, dim=-1)

    def shard_quantize(self, parts, amax: torch.Tensor, lead_dims: int):
        """Each part quantized against its max over the ranks (``amax``,
        ``shard_amax``'s shape)."""
        del lead_dims
        return [self._quantize(x.to(torch.float32), amax[..., i])
                for i, x in enumerate(parts)]

    def decode(self, tree, round_idx, like):
        """Dequantize every ``{"q", "scale"}`` leaf back to fp32."""
        del round_idx, like
        return pytree.tree_map(
            lambda d: d["q"].to(torch.float32) * _per_client(d["scale"],
                                                             d["q"]),
            tree, is_leaf=is_qleaf)
