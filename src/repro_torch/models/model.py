"""The pattern decoder (port of ``repro/models/model.py``): the training
forward, prefill and decode of every architecture of the JAX package.
Mixers: full/sliding-window GQA attention, mLSTM, sLSTM, RG-LRU. FFNs:
SwiGLU, MoE, none. A frontend arch (``cfg.frontend``) takes precomputed
frontend embeddings, put before the text tokens (early fusion).

Parameters keep the JAX package's tree and layout: ``embed`` (V, d),
``final_norm``, ``pattern/pos_i/...`` stacked over repeats (leading axis R)
and ``tail/layer_i/...``, so a JAX tree converts by copying
(``convert.lm_params_from_jax``). The JAX ``lax.scan`` over repeats is a
Python loop over ``r`` that indexes the stacked params and caches.

Decode state mirrors the parameter layout: per-pattern-position caches
(``AttnCache``, ``RGLRUState``, ``MLSTMState``, ``SLSTMState``) stacked
over repeats. Its position ``pos`` is a host int, so a decode step reads
nothing back from the device, and the caches are updated in place (clone
the state to keep an earlier one). The JAX package's sharding constraints
(``repro.sharding.constrain``) have no counterpart on one device and are
dropped; under tensor parallelism over ``model`` (a
``sharding.tensor_parallel.ModelGroup`` active around a local step) the
attention, dense-FFN and MoE blocks compute on the model rank's heads,
columns and experts, with Megatron's conjugate pair at their edges
(``_apply_layer``, ``_ffn``, ``models/moe.py``), and the training forward
is vocabulary-parallel: the embedding looks up the tokens of the rank's
rows and sums the lookups over the ranks (``_embed_inputs``), the
unembedding gives the rank's columns of the logits (``_unembed``) and
``models/steps.py``'s loss takes the vocabulary-parallel cross entropy.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.utils.checkpoint as ckpt
from torch.utils import _pytree as pytree

from repro_torch.configs.base import LayerSpec, ModelConfig, _not_ported
from repro_torch.core import tree_math as tm
from repro_torch.core.round import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import rms_norm, swiglu
from repro_torch.sharding import tensor_parallel

#: ROADMAP.md queue-1 item that brings ``remat="dots"`` (keep the weight
#: products, recompute the rest) under ``torch.func`` transforms.
REMAT_DOTS_ITEM = 13

# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


class Init(NamedTuple):
    """Tensor makers of one init, each in its dtype on its device:
    ``normal(shape, fan_in)`` draws N(0, 1/fan_in); ``zeros(shape)``;
    ``full(shape, value)``; ``linspace(shape, start, end)`` ramps along
    the last axis (the same ramp in every leading index)."""

    normal: Any
    zeros: Any
    full: Any
    linspace: Any


def _initializers(generator, dtype, device) -> Init:
    def normal(shape, fan_in):
        t = torch.empty(shape, dtype=dtype, device=device)
        if t.is_meta:             # shapes only (its normal_ is slow to load)
            return t
        return t.normal_(generator=generator).mul_(1.0 / math.sqrt(fan_in))

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    def linspace(shape, start, end):
        ramp = torch.linspace(start, end, shape[-1], dtype=torch.float32,
                              device=device).to(dtype)
        return ramp.expand(shape).clone()

    return Init(normal, zeros, full, linspace)


def _init_mixer(init: Init, cfg: ModelConfig, spec: LayerSpec, lead):
    if spec.mixer in ("attn", "swa"):
        return attn.init_attn_params(init, cfg, lead)
    if spec.mixer == "mlstm":
        return xlstm_mod.init_mlstm_params(init, cfg, lead)
    if spec.mixer == "slstm":
        return xlstm_mod.init_slstm_params(init, cfg, lead)
    if spec.mixer == "rglru":
        return rglru_mod.init_rglru_params(init, cfg, lead)
    raise ValueError(spec.mixer)


def _init_ffn(init: Init, cfg: ModelConfig, spec: LayerSpec, lead):
    if spec.ffn == "none":
        return {}
    d, ff = cfg.d_model, cfg.d_ff
    if spec.ffn == "moe":
        return {"norm": init.zeros((*lead, d)),
                "moe": moe_mod.init_moe_params(init, cfg, lead)}
    return {
        "norm": init.zeros((*lead, d)),
        "w_gate": init.normal((*lead, d, ff), d),
        "w_up": init.normal((*lead, d, ff), d),
        "w_down": init.normal((*lead, ff, d), ff),
    }


def _init_layer(init: Init, cfg: ModelConfig, spec: LayerSpec, lead=()):
    return {
        "norm": init.zeros((*lead, cfg.d_model)),
        "mixer": _init_mixer(init, cfg, spec, lead),
        "ffn": _init_ffn(init, cfg, spec, lead),
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
    init = _initializers(generator, dtype, device)
    V, d = cfg.padded_vocab, cfg.d_model
    params: Dict[str, Any] = {
        "embed": init.normal((V, d), d),
        "final_norm": init.zeros((d,)),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = init.normal((d, V), d)
    params["pattern"] = {
        f"pos_{i}": _init_layer(init, cfg, spec, (cfg.repeats,))
        for i, spec in enumerate(cfg.pattern)
    }
    if cfg.tail:
        params["tail"] = {
            f"layer_{i}": _init_layer(init, cfg, spec)
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


def _unembed(cparams, x, tp=None):
    """The logits of ``x``; under ``tp`` (a ``ModelGroup`` whose
    vocabulary splits) this model rank's columns of them, the input's
    gradient summed over the ranks."""
    if tp is not None and tp.vocab:
        x = tensor_parallel.copy_to_model(x)
    if "unembed" in cparams:
        return x @ cparams["unembed"]
    return x @ cparams["embed"].T


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------

_MIXER_FORWARD = {
    "mlstm": xlstm_mod.mlstm_forward,
    "slstm": xlstm_mod.slstm_forward,
    "rglru": rglru_mod.rglru_forward,
}
_MIXER_DECODE = {
    "mlstm": xlstm_mod.mlstm_decode,
    "slstm": xlstm_mod.slstm_decode,
    "rglru": rglru_mod.rglru_decode,
}


def _ffn(p, x, cfg: ModelConfig, spec: LayerSpec):
    """The layer's FFN with its residual; returns (x, MoE aux loss or
    None)."""
    if spec.ffn == "none":
        return x, None
    f = p["ffn"]
    u = rms_norm(x, f["norm"], cfg.norm_eps)
    if spec.ffn == "moe":
        y, aux = moe_mod.moe_ffn(f["moe"], u, cfg)
        return x + y, aux
    tp = tensor_parallel.active()
    if tp is not None and tp.ffn:
        # this model rank's d_ff / M columns, the output summed over them
        y = swiglu(tensor_parallel.copy_to_model(u), f["w_gate"],
                   f["w_up"], f["w_down"])
        return x + tensor_parallel.reduce_from_model(y), None
    return x + swiglu(u, f["w_gate"], f["w_up"], f["w_down"]), None


def _apply_layer(p, x, cfg: ModelConfig, spec: LayerSpec, q_chunk: int,
                 return_cache: bool):
    """One layer over the sequence; returns (x, aux or None, the mixer's
    cache: raw (k, v) for attention, else its decode state)."""
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    if spec.mixer in ("attn", "swa"):
        tp = tensor_parallel.active()
        split = tp is not None and tp.attn
        # split: this model rank's heads, the output projection summed
        y, cache = attn.attn_forward(
            p["mixer"], tensor_parallel.copy_to_model(h) if split else h,
            cfg, spec, q_chunk=q_chunk, return_cache=return_cache)
        if split:
            y = tensor_parallel.reduce_from_model(y)
    else:
        y, cache = _MIXER_FORWARD[spec.mixer](p["mixer"], h, cfg,
                                              return_cache=return_cache)
    x, aux = _ffn(p, x + y.to(x.dtype), cfg, spec)
    return x, aux, cache


def _embed_inputs(cparams, cfg: ModelConfig, tokens, frontend,
                  compute_dtype):
    """Token embeddings (B, S_text, d), after the frontend embeddings
    (B, F, d) when the config has a frontend. Under a model group whose
    vocabulary splits, this rank's ``embed`` holds rows ``[g V/M, (g + 1)
    V/M)``: a token outside them looks up zeros, and the lookups are
    summed over the ranks (one nonzero term each: exact)."""
    tp = tensor_parallel.active()
    if tp is not None and tp.vocab:
        rows = cparams["embed"].shape[0]
        local = tokens - tp.index * rows
        inside = (local >= 0) & (local < rows)
        x = cparams["embed"][torch.where(inside, local, 0)]
        x = tensor_parallel.reduce_from_model(
            torch.where(inside[..., None], x, 0))
    else:
        x = cparams["embed"][tokens]
    if cfg.frontend:
        if frontend is None:
            raise ValueError(f"{cfg.name} requires frontend embeddings")
        x = torch.cat([frontend.to(compute_dtype), x], dim=1)
    return x


def _save_matmuls(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat="dots"``: keep the products
    with the weights (``mm``; the attention einsums are batched ``bmm``),
    recompute the rest, as ``checkpoint_dots_with_no_batch_dims`` does."""
    del ctx, args, kwargs
    return (ckpt.CheckpointPolicy.MUST_SAVE if op is torch.ops.aten.mm.default
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


class _Recompute(torch.autograd.Function):
    """``fn(*tree)``'s outputs, with nothing of ``fn`` kept for the
    backward pass but its inputs: the backward recomputes ``fn`` through
    ``torch.func.vjp``. Unlike ``torch.utils.checkpoint`` it composes with
    ``torch.func`` transforms (``generate_vmap_rule``: under ``vmap`` each
    pass runs batched).

    The backward runs under ``no_grad``, so it is differentiable once:
    ``torch.func.grad`` takes its gradient with ``create_graph=True``,
    which would otherwise keep every recomputed activation (and without a
    recompute, every backward intermediate) alive until the end of the
    call.

    The forward's model group (``sharding.tensor_parallel.active()``) is
    kept in the context and made active again around the replay: autograd
    runs a CUDA backward on its own device thread, where no model group is
    active, and a replay without it would compute the split blocks with
    none of their all-reduces."""

    generate_vmap_rule = True

    @staticmethod
    def forward(fn, spec, *flat):
        with torch.no_grad():
            return fn(*pytree.tree_unflatten(list(flat), spec))

    @staticmethod
    def setup_context(ctx, inputs, output):
        fn, spec, *flat = inputs
        ctx.fn, ctx.spec = fn, spec
        ctx.model = tensor_parallel.active()
        ctx.save_for_backward(*flat)

    @staticmethod
    def backward(ctx, *grads):
        def fn(*flat):
            return ctx.fn(*pytree.tree_unflatten(list(flat), ctx.spec))

        with torch.no_grad(), tensor_parallel.model_parallel(ctx.model):
            _, vjp_fn = torch.func.vjp(fn, *ctx.saved_tensors)
            return (None, None, *vjp_fn(grads))


def recompute(fn, *args):
    """``fn(*args)`` (a tree of tensors in, a tuple of tensors out),
    recomputed in the backward pass under autograd or ``torch.func``."""
    flat, spec = pytree.tree_flatten(args)
    return _Recompute.apply(fn, spec, *flat)


def forward(params, tokens, cfg: ModelConfig, *, frontend=None,
            compute_dtype=torch.bfloat16, q_chunk: int = 1024,
            remat: str = "full", logits_slice: Optional[int] = None):
    """tokens: (B, S_text) int -> (logits (B, S_out, V), aux-loss scalar,
    the sum of the MoE layers' router losses, fp32). Under a model group
    whose vocabulary splits, the logits are this rank's ``V / M`` columns.

    ``frontend`` (B, F, d): the frontend embeddings of a frontend arch,
    put before the text. ``logits_slice``: if given, only the logits of
    the last N positions are computed.

    ``remat`` ("full" | "dots" | anything else: none) recomputes each
    repeat of the pattern in the backward pass, as the JAX package's
    ``jax.checkpoint`` does. ``"full"`` goes through ``recompute``, under
    plain autograd and under ``torch.func`` transforms (the federated
    round's ``vmap(grad)``) alike. ``"dots"`` keeps the weight products
    through ``torch.utils.checkpoint`` (non-reentrant, selective) under
    plain autograd; under ``torch.func`` transforms, where torch refuses
    checkpointing (saved-tensor hooks), it raises ``NotImplementedError``
    (ROADMAP.md queue 1, item 13).
    """
    cparams = _cast(params, compute_dtype)
    x = _embed_inputs(cparams, cfg, tokens, frontend, compute_dtype)
    auxs = []

    def unit(x, unit_params):
        """Apply one repeat of the whole pattern; returns (x, its aux)."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, spec in enumerate(cfg.pattern):
            x, a, _ = _apply_layer(unit_params[f"pos_{i}"], x, cfg, spec,
                                   q_chunk, False)
            if a is not None:
                aux = aux + a
        return x, aux

    run = unit
    if remat == "full" and torch.is_grad_enabled():
        run = functools.partial(recompute, unit)
    elif remat == "dots" and torch.is_grad_enabled():
        if torch._C._are_functorch_transforms_active():
            raise _not_ported("remat='dots' under torch.func transforms",
                              REMAT_DOTS_ITEM)
        run = functools.partial(
            ckpt.checkpoint, unit, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _save_matmuls))
    for r in range(cfg.repeats):
        x, a = run(x, _unit(cparams["pattern"], r))
        auxs.append(a)
    aux = torch.stack(auxs).sum()
    for i, spec in enumerate(cfg.tail):
        x, a, _ = _apply_layer(cparams["tail"][f"layer_{i}"], x, cfg, spec,
                               q_chunk, False)
        if a is not None:
            aux = aux + a
    x = rms_norm(x, cparams["final_norm"], cfg.norm_eps)
    if logits_slice is not None:
        x = x[:, -logits_slice:]
    return _unembed(cparams, x, tensor_parallel.active()), aux


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

class DecodeState(NamedTuple):
    """All per-layer decode caches plus the current token position."""

    pattern: Dict[str, Any]   # per position: its cache stacked over repeats
    tail: Dict[str, Any]
    pos: int                  # tokens already consumed


def _init_layer_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                      max_len: int, cache_dtype, device, lead=()):
    """An empty cache of one layer: the KV cache in ``cache_dtype``, the
    recurrent states in fp32 (as the JAX package's)."""
    if spec.mixer in ("attn", "swa"):
        return attn.init_attn_cache(cfg, spec, batch, max_len, cache_dtype,
                                    device, lead)
    init_state = {"mlstm": xlstm_mod.init_mlstm_state,
                  "slstm": xlstm_mod.init_slstm_state,
                  "rglru": rglru_mod.init_rglru_state}[spec.mixer]
    return init_state(cfg, batch, device=device, lead=lead)


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      cache_dtype=torch.bfloat16, *,
                      device=None) -> DecodeState:
    """Empty decode caches for every layer (stacked over repeats), on
    ``device`` (``cuda`` unless given)."""
    device = resolve_device(device)
    pattern = {
        f"pos_{i}": _init_layer_cache(cfg, spec, batch, max_len, cache_dtype,
                                      device, (cfg.repeats,))
        for i, spec in enumerate(cfg.pattern)
    }
    tail = {
        f"layer_{i}": _init_layer_cache(cfg, spec, batch, max_len,
                                        cache_dtype, device)
        for i, spec in enumerate(cfg.tail)
    }
    return DecodeState(pattern, tail, 0)


def _map_cache(fn, cache):
    """The same kind of cache with ``fn`` applied to each tensor."""
    return type(cache)(*(fn(t) for t in cache))


def clone_state(state: DecodeState) -> DecodeState:
    """A copy of ``state`` that later decode steps on ``state`` leave as
    it is."""
    copy = lambda caches: {k: _map_cache(torch.clone, c)
                           for k, c in caches.items()}
    return DecodeState(copy(state.pattern), copy(state.tail), state.pos)


def _write(dst, src) -> None:
    """Copy a cache into ``dst`` in place (a no-op for tensors that are
    already ``dst``'s, as attention's in-place cache writes return)."""
    for d, s in zip(dst, src):
        if d is not s:
            d.copy_(s)


def _decode_layer(p, x, cache, cfg: ModelConfig, spec: LayerSpec, pos: int,
                  use_kernel: bool = False):
    """One layer for one token; ``cache`` is updated in place."""
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    if spec.mixer in ("attn", "swa"):
        y, new = attn.attn_decode(p["mixer"], h, cache, cfg, spec, pos,
                                  use_kernel=use_kernel)
    else:
        y, new = _MIXER_DECODE[spec.mixer](p["mixer"], h, cache, cfg)
    _write(cache, new)
    x, _ = _ffn(p, x + y.to(x.dtype), cfg, spec)
    return x


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
            cache = _map_cache(lambda t: t[r], state.pattern[f"pos_{i}"])
            x = _decode_layer(_unit(cparams["pattern"][f"pos_{i}"], r), x,
                              cache, cfg, spec, pos, use_kernel=use_kernel)
    for i, spec in enumerate(cfg.tail):
        x = _decode_layer(cparams["tail"][f"layer_{i}"], x,
                          state.tail[f"layer_{i}"], cfg, spec, pos,
                          use_kernel=use_kernel)
    x = rms_norm(x, cparams["final_norm"], cfg.norm_eps)
    logits = _unembed(cparams, x)[:, 0]
    return logits, state._replace(pos=pos + 1)


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------

def prefill(params, tokens, cfg: ModelConfig, max_len: int, *, frontend=None,
            compute_dtype=torch.bfloat16, q_chunk: int = 1024,
            cache_dtype=torch.bfloat16):
    """Run the full prompt (B, S_text) (after ``frontend``'s embeddings for
    a frontend arch), build the decode state on the tokens' device, return
    (last-token logits (B, V), state).

    The state holds what the layers leave: KV caches in ``cache_dtype``,
    recurrent states in the dtypes the JAX package's prefill gives them
    (fp32 RG-LRU and mLSTM memories, the sLSTM state and the conv tails in
    ``compute_dtype``)."""
    cparams = _cast(params, compute_dtype)
    x = _embed_inputs(cparams, cfg, tokens, frontend, compute_dtype)
    S = x.shape[1]

    def layer(p, x, spec):
        x, _, cache = _apply_layer(p, x, cfg, spec, q_chunk, True)
        if spec.mixer in ("attn", "swa"):
            cache = attn.cache_from_prefill(cfg, spec, cache, max_len,
                                            cache_dtype)
        return x, cache

    pattern = {}
    for r in range(cfg.repeats):
        for i, spec in enumerate(cfg.pattern):
            x, cache = layer(_unit(cparams["pattern"][f"pos_{i}"], r), x,
                             spec)
            if r == 0:          # one buffer per position, stacked over R
                pattern[f"pos_{i}"] = _map_cache(
                    lambda t: t.new_empty((cfg.repeats, *t.shape)), cache)
            _write(_map_cache(lambda t: t[r], pattern[f"pos_{i}"]), cache)
            del cache
    tail = {}
    for i, spec in enumerate(cfg.tail):
        x, tail[f"layer_{i}"] = layer(cparams["tail"][f"layer_{i}"], x, spec)
    x = rms_norm(x, cparams["final_norm"], cfg.norm_eps)
    logits = _unembed(cparams, x[:, -1:])[:, 0]
    return logits, DecodeState(pattern, tail, S)
