"""The pattern decoder (port of ``repro/models/model.py``), for attention
mixers (``attn``, ``swa``) with dense or no FFNs: the training forward,
prefill and decode.

Parameters keep the JAX package's tree and layout: ``embed`` (V, d),
``final_norm``, ``pattern/pos_i/...`` stacked over repeats (leading axis R)
and ``tail/layer_i/...``, so a JAX tree converts by copying
(``convert.lm_params_from_jax``). The JAX ``lax.scan`` over repeats is a
Python loop over ``r`` that indexes the stacked params and caches.

Decode state mirrors the parameter layout: per-pattern-position caches
stacked over repeats. Its position ``pos`` is a host int, so a decode step
reads nothing back from the device, and the caches are updated in place
(clone the state to keep an earlier one). The JAX package's sharding
constraints (``repro.sharding.constrain``) have no counterpart on one
device and are dropped.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.utils.checkpoint as ckpt

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.core import tree_math as tm
from repro_torch.core.round import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.layers import rms_norm, swiglu

# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _initializers(generator, dtype, device):
    """``normal(shape, fan_in)``: N(0, 1/fan_in) drawn in ``dtype`` on
    ``device``, tensor by tensor; ``zeros(shape)``."""
    def normal(shape, fan_in):
        t = torch.empty(shape, dtype=dtype, device=device)
        if t.is_meta:             # shapes only (its normal_ is slow to load)
            return t
        return t.normal_(generator=generator).mul_(1.0 / math.sqrt(fan_in))

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return normal, zeros


def _init_ffn(normal, zeros, cfg: ModelConfig, spec: LayerSpec, lead):
    if spec.ffn == "none":
        return {}
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "norm": zeros((*lead, d)),
        "w_gate": normal((*lead, d, ff), d),
        "w_up": normal((*lead, d, ff), d),
        "w_down": normal((*lead, ff, d), ff),
    }


def _init_layer(normal, zeros, cfg: ModelConfig, spec: LayerSpec, lead=()):
    return {
        "norm": zeros((*lead, cfg.d_model)),
        "mixer": attn.init_attn_params(normal, zeros, cfg, lead),
        "ffn": _init_ffn(normal, zeros, cfg, spec, lead),
    }


def init_params(generator, cfg: ModelConfig, dtype=torch.float32, *,
                device=None) -> Dict[str, Any]:
    """Random decoder params: embed + stacked pattern/tail layers + norms.

    Each tensor is drawn directly in ``dtype`` on ``device`` (``cuda``
    unless given; raises without a GPU), so a bf16 tree never passes
    through fp32. ``generator`` must live on that device (``None`` on the
    meta device). The numbers differ from the JAX package's init; tests
    convert a JAX tree instead.
    """
    device = resolve_device(device)
    normal, zeros = _initializers(generator, dtype, device)
    V, d = cfg.padded_vocab, cfg.d_model
    params: Dict[str, Any] = {
        "embed": normal((V, d), d),
        "final_norm": zeros((d,)),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = normal((d, V), d)
    params["pattern"] = {
        f"pos_{i}": _init_layer(normal, zeros, cfg, spec, (cfg.repeats,))
        for i, spec in enumerate(cfg.pattern)
    }
    if cfg.tail:
        params["tail"] = {
            f"layer_{i}": _init_layer(normal, zeros, cfg, spec)
            for i, spec in enumerate(cfg.tail)
        }
    return params


def count_params(cfg: ModelConfig) -> int:
    """Exact parameter count from the shapes on the meta device."""
    return tm.tree_size(init_params(None, cfg, device="meta"))


def _cast(params, dtype):
    """Floating leaves in ``dtype`` (the same tensor where it already is)."""
    return tm.tmap(lambda t: t.to(dtype) if t.is_floating_point() else t,
                   params)


def _unit(tree, r: int):
    """Repeat ``r`` of a tree stacked over repeats (views)."""
    return tm.tmap(lambda t: t[r], tree)


def _unembed(cparams, x):
    if "unembed" in cparams:
        return x @ cparams["unembed"]
    return x @ cparams["embed"].T


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------

def _apply_layer(p, x, cfg: ModelConfig, spec: LayerSpec, q_chunk: int,
                 return_cache: bool):
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    y, cache = attn.attn_forward(p["mixer"], h, cfg, spec, q_chunk=q_chunk,
                                 return_cache=return_cache)
    x = x + y.to(x.dtype)
    if spec.ffn == "dense":
        f = p["ffn"]
        u = rms_norm(x, f["norm"], cfg.norm_eps)
        x = x + swiglu(u, f["w_gate"], f["w_up"], f["w_down"])
    return x, cache


def _save_matmuls(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat="dots"``: keep the products
    with the weights (``mm``; the attention einsums are batched ``bmm``),
    recompute the rest, as ``checkpoint_dots_with_no_batch_dims`` does."""
    del ctx, args, kwargs
    return (ckpt.CheckpointPolicy.MUST_SAVE if op is torch.ops.aten.mm.default
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def forward(params, tokens, cfg: ModelConfig, *, compute_dtype=torch.bfloat16,
            q_chunk: int = 1024, remat: str = "full",
            logits_slice: Optional[int] = None):
    """tokens: (B, S) int -> (logits (B, S_out, V), aux-loss scalar).

    ``logits_slice``: if given, only the logits of the last N positions are
    computed. The aux loss is the MoE router's in the JAX package; the
    port builds no MoE FFN (``ModelConfig`` refuses one), so it is 0.

    ``remat`` ("full" | "dots" | anything else: none) recomputes each
    repeat of the pattern in the backward pass, as the JAX package's
    ``jax.checkpoint`` does: ``torch.utils.checkpoint`` (non-reentrant),
    with ``"dots"`` keeping the weight products. It applies only where
    autograd records a graph. Under ``torch.func`` transforms (the
    federated round's ``vmap(grad)``) torch refuses checkpointing with a
    ``RuntimeError`` (saved-tensor hooks), so ``models.steps.lm_grad_fn``
    refuses a remat request before it gets here.
    """
    cparams = _cast(params, compute_dtype)
    x = cparams["embed"][tokens]                      # (B, S, d)

    def unit(x, unit_params):
        """Apply one repeat of the whole pattern."""
        for i, spec in enumerate(cfg.pattern):
            x, _ = _apply_layer(unit_params[f"pos_{i}"], x, cfg, spec,
                                q_chunk, False)
        return x

    recompute = remat in ("full", "dots") and torch.is_grad_enabled()
    context = (functools.partial(ckpt.create_selective_checkpoint_contexts,
                                 _save_matmuls) if remat == "dots"
               else ckpt.noop_context_fn)
    for r in range(cfg.repeats):
        unit_params = _unit(cparams["pattern"], r)
        x = (ckpt.checkpoint(unit, x, unit_params, use_reentrant=False,
                             context_fn=context) if recompute
             else unit(x, unit_params))
    for i, spec in enumerate(cfg.tail):
        x, _ = _apply_layer(cparams["tail"][f"layer_{i}"], x, cfg, spec,
                            q_chunk, False)
    x = rms_norm(x, cparams["final_norm"], cfg.norm_eps)
    if logits_slice is not None:
        x = x[:, -logits_slice:]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _unembed(cparams, x), aux


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

class DecodeState(NamedTuple):
    """All per-layer decode caches plus the current token position."""

    pattern: Dict[str, attn.AttnCache]   # per position: stacked over repeats
    tail: Dict[str, attn.AttnCache]
    pos: int                             # tokens already consumed


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      cache_dtype=torch.bfloat16, *,
                      device=None) -> DecodeState:
    """Empty decode caches for every layer (stacked over repeats), on
    ``device`` (``cuda`` unless given)."""
    device = resolve_device(device)
    pattern = {
        f"pos_{i}": attn.init_attn_cache(cfg, spec, batch, max_len,
                                         cache_dtype, device, (cfg.repeats,))
        for i, spec in enumerate(cfg.pattern)
    }
    tail = {
        f"layer_{i}": attn.init_attn_cache(cfg, spec, batch, max_len,
                                           cache_dtype, device)
        for i, spec in enumerate(cfg.tail)
    }
    return DecodeState(pattern, tail, 0)


def clone_state(state: DecodeState) -> DecodeState:
    """A copy of ``state`` that later decode steps on ``state`` leave as
    it is."""
    copy = lambda caches: {k: attn.AttnCache(*(t.clone() for t in c))
                           for k, c in caches.items()}
    return DecodeState(copy(state.pattern), copy(state.tail), state.pos)


def _decode_layer(p, x, cache, cfg: ModelConfig, spec: LayerSpec, pos: int,
                  use_kernel: bool = False):
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    y, cache = attn.attn_decode(p["mixer"], h, cache, cfg, spec, pos,
                                use_kernel=use_kernel)
    x = x + y.to(x.dtype)
    if spec.ffn == "dense":
        f = p["ffn"]
        u = rms_norm(x, f["norm"], cfg.norm_eps)
        x = x + swiglu(u, f["w_gate"], f["w_up"], f["w_down"])
    return x, cache


def decode_step(params, token, state: DecodeState, cfg: ModelConfig, *,
                compute_dtype=torch.bfloat16, use_kernel: bool = False):
    """One token for the whole batch. token: (B,) int. Returns
    (logits (B, V), new_state); the caches of ``state`` are updated in
    place."""
    cparams = _cast(params, compute_dtype)
    x = cparams["embed"][token][:, None, :]          # (B, 1, d)
    pos = state.pos
    for r in range(cfg.repeats):
        for i, spec in enumerate(cfg.pattern):
            c = state.pattern[f"pos_{i}"]
            x, _ = _decode_layer(
                _unit(cparams["pattern"][f"pos_{i}"], r), x,
                attn.AttnCache(c.k[r], c.v[r], c.slot_pos[r]), cfg, spec,
                pos, use_kernel=use_kernel)
    for i, spec in enumerate(cfg.tail):
        x, _ = _decode_layer(cparams["tail"][f"layer_{i}"], x,
                             state.tail[f"layer_{i}"], cfg, spec, pos,
                             use_kernel=use_kernel)
    x = rms_norm(x, cparams["final_norm"], cfg.norm_eps)
    logits = _unembed(cparams, x)[:, 0]
    return logits, state._replace(pos=pos + 1)


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------

def prefill(params, tokens, cfg: ModelConfig, max_len: int, *,
            compute_dtype=torch.bfloat16, q_chunk: int = 1024,
            cache_dtype=torch.bfloat16):
    """Run the full prompt (B, S), build the decode state on the tokens'
    device, return (last-token logits (B, V), state)."""
    cparams = _cast(params, compute_dtype)
    x = cparams["embed"][tokens]                      # (B, S, d)
    B, S = tokens.shape
    state = init_decode_state(cfg, B, max_len, cache_dtype,
                              device=tokens.device)

    def layer(p, x, spec, dst: attn.AttnCache):
        x, kv = _apply_layer(p, x, cfg, spec, q_chunk, True)
        cache = attn.cache_from_prefill(cfg, spec, kv, max_len, cache_dtype)
        for d, s in zip(dst, cache):
            d.copy_(s)
        return x

    for r in range(cfg.repeats):
        for i, spec in enumerate(cfg.pattern):
            c = state.pattern[f"pos_{i}"]
            x = layer(_unit(cparams["pattern"][f"pos_{i}"], r), x, spec,
                      attn.AttnCache(c.k[r], c.v[r], c.slot_pos[r]))
    for i, spec in enumerate(cfg.tail):
        x = layer(cparams["tail"][f"layer_{i}"], x, spec,
                  state.tail[f"layer_{i}"])
    x = rms_norm(x, cparams["final_norm"], cfg.norm_eps)
    logits = _unembed(cparams, x[:, -1:])[:, 0]
    return logits, state._replace(pos=S)
