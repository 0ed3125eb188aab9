"""Mixture-of-Experts FFN (port of ``repro/models/moe.py``): GShard-style
one-hot dispatch, or sort-based routing, chunked over tokens.

The one-hot route keeps the JAX package's dense dispatch and combine
einsums over a (T, E, C) tensor per chunk (2 T E C d products each); the
sort route replaces them with a stable argsort, a gather into expert slots
and a scatter-add back. Capacity overflow drops tokens (the residual passes
them through), and the router returns the switch-transformer
load-balancing aux loss. Plain torch: the JAX package leaves this to XLA.

Three JAX primitives need care to give the same experts and slots:

* ``jax.lax.top_k`` puts the lower index first among equal values, and
  ``torch.topk`` promises no order among ties (router logits from a bf16
  product tie often): ``_top_k`` takes a stable descending sort.
* ``jax.nn.one_hot`` gives a zero row for an index outside [0, n), where
  ``F.one_hot`` raises: ``_one_hot`` compares against ``arange(n)``, so an
  out-of-range position never lands in a real slot.
* ``.at[slot].add(..., mode="drop")`` drops the bucket ``E*C``, where
  ``index_add_`` would raise: the buffer gets one extra row, sliced off.

Under expert parallelism over ``model`` (a ``sharding.tensor_parallel
.ModelGroup`` active with ``experts``), model rank ``g`` holds experts
``[g E/M, (g + 1) E/M)`` of each bank. Every model rank computes the same
routing from the same input: the router, top-k, the capacity positions,
every drop decision and the aux loss are the unsplit layer's. Rank ``g``
then runs only its experts' ``(E/M, C, d)`` slots: the one-hot route
slices ``combine`` and ``dispatch`` to its experts, the sort route sends
the slots of other experts to the drop bucket. The experts read
``copy_to_model`` of the input and the combine reads ``copy_to_model`` of
the gate values (each rank's gradient of them is a partial sum), while the
router and the aux loss read the input and the probabilities directly, so
their gradient is a replicated leaf's, whole on every rank. A shared
expert split over ``tp`` (``shared``) takes its ``d_ff / M`` columns; one
``reduce_from_model`` sums the ranks' routed and shared partials.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.sharding import tensor_parallel


def init_moe_params(init, cfg: ModelConfig, lead=()):
    """Router + per-expert FFN stacks (and the shared expert if any), each
    with the leading dims ``lead``."""
    m = cfg.moe
    d, eff, E = cfg.d_model, m.expert_d_ff, m.num_experts
    p = {
        "router": init.normal((*lead, d, E), d),
        "w_gate": init.normal((*lead, E, d, eff), d),
        "w_up": init.normal((*lead, E, d, eff), d),
        "w_down": init.normal((*lead, E, eff, d), eff),
    }
    if m.shared_expert_d_ff:
        sf = m.shared_expert_d_ff
        p["ws_gate"] = init.normal((*lead, d, sf), d)
        p["ws_up"] = init.normal((*lead, d, sf), d)
        p["ws_down"] = init.normal((*lead, sf, d), sf)
    return p


def capacity(m: MoEConfig, chunk_tokens: int) -> int:
    """Per-expert token capacity for a chunk, rounded up to a multiple of 4."""
    c = int(chunk_tokens * m.top_k * m.capacity_factor / m.num_experts)
    return max(4, ((c + 3) // 4) * 4)


def _top_k(probs, k: int):
    """(values, indices) of the ``k`` largest along the last axis, the lower
    index first among equal values (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _one_hot(idx, n: int, dtype=torch.float32):
    """``jax.nn.one_hot``: a zero row where ``idx`` is outside [0, n)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _router(xc, p, m: MoEConfig):
    """Router probabilities (T, E) fp32, the renormalized top-k gates and
    their experts (T, K), and the load-balancing aux loss."""
    logits = (xc @ p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = _top_k(probs, m.top_k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    # switch-transformer load-balance loss (first-choice fractions)
    first = _one_hot(expert_idx[:, 0], m.num_experts)
    aux = m.num_experts * torch.sum(first.mean(0) * probs.mean(0))
    return gate_vals, expert_idx, aux


def _experts(expert_in, p):
    """The E expert FFNs on their slots: (E, C, d) -> (E, C, d)."""
    g = F.silu(torch.bmm(expert_in, p["w_gate"]))
    u = torch.bmm(expert_in, p["w_up"])
    return torch.bmm(g * u, p["w_down"])


def _combine(expert_idx, gate_vals, m: MoEConfig, C: int):
    """GShard position assignment, slot 0 first, then slot 1, ...: the
    (T, E, C) fp32 combine weights (0 where nothing lands)."""
    T, E = expert_idx.shape[0], m.num_experts
    combine = gate_vals.new_zeros((T, E, C))
    counts = gate_vals.new_zeros((E,))
    for s in range(m.top_k):
        onehot_e = _one_hot(expert_idx[:, s], E)                  # (T, E)
        pos = torch.cumsum(onehot_e, dim=0) - 1.0 + counts        # (T, E)
        keep = (pos < C) & (onehot_e > 0)
        counts = counts + onehot_e.sum(0)
        weight = gate_vals[:, s, None] * keep.float()             # (T, E)
        combine += weight[..., None] * _one_hot(pos.to(torch.int32), C)
    return combine


def _route_chunk(xc, p, m: MoEConfig, xe=None, lo: int = 0):
    """One chunk of tokens, GShard one-hot dispatch. xc: (T, d). Returns
    (y (T, d), aux scalar). With ``xe`` (the experts' input,
    ``copy_to_model(xc)``) only the experts ``[lo, lo + E_local)`` of the
    local banks run: ``y`` is their partial sum."""
    gate_vals, expert_idx, aux = _router(xc, p, m)
    if xe is not None:
        gate_vals = tensor_parallel.copy_to_model(gate_vals)
    combine = _combine(expert_idx, gate_vals, m, capacity(m, xc.shape[0]))
    if xe is not None:
        combine = combine[:, lo:lo + p["w_gate"].shape[-3]]
    else:
        xe = xc
    dispatch = (combine > 0).to(xc.dtype)                         # (T, E, C)
    expert_in = torch.einsum("tec,td->ecd", dispatch, xe)         # (E, C, d)
    h = _experts(expert_in, p)
    y = torch.einsum("tec,ecd->td", combine.to(xc.dtype), h)
    return y, aux


def _assign_sorted(expert_idx, m: MoEConfig, C: int):
    """The sort route's assignment of the (token, k-slot) pairs: their
    stable order by expert, source tokens, whether each is kept (within
    its expert's first C in token order) and its slot (``E*C``: dropped).
    Returns (order, tokens, kept, slots), all in sorted order."""
    T, K = expert_idx.shape
    E, dev = m.num_experts, expert_idx.device
    flat_e = expert_idx.reshape(-1)                               # (T*K,)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    st = torch.arange(T * K, device=dev)[order] // K          # source tokens
    # position within each expert's run of the sorted assignment list
    first = torch.searchsorted(se, torch.arange(E, device=dev), side="left")
    pos = torch.arange(T * K, device=dev) - first[se]
    keep = pos < C
    return order, st, keep, torch.where(keep, se * C + pos, E * C)


def _route_chunk_sort(xc, p, m: MoEConfig, xe=None, lo: int = 0):
    """Sort-based routing: a stable argsort of the (token, slot) pairs by
    expert, a gather into expert slots and a scatter-add back. Tokens are
    dropped per expert in token order across all k-slots (GShard drops
    slot-major); with ample capacity the two routes agree. With ``xe``
    (``copy_to_model(xc)``) only the experts ``[lo, lo + E_local)`` run:
    the other experts' slots go to the drop bucket."""
    T, d = xc.shape
    E, C = m.num_experts, capacity(m, T)
    gate_vals, expert_idx, aux = _router(xc, p, m)
    order, st, keep, slot = _assign_sorted(expert_idx, m, C)
    if xe is not None:
        gate_vals = tensor_parallel.copy_to_model(gate_vals)
        E = p["w_gate"].shape[-3]
        slot = slot - lo * C
        keep = keep & (slot >= 0) & (slot < E * C)
        slot = torch.where(keep, slot, E * C)
    else:
        xe = xc
    sg = gate_vals.reshape(-1)[order]

    gathered = xe[st] * keep[:, None].to(xc.dtype)                # (T*K, d)
    buf = xc.new_zeros((E * C + 1, d)).index_add_(0, slot, gathered)
    h = _experts(buf[:E * C].reshape(E, C, d), p).reshape(E * C, d)

    contrib = h[torch.clamp(slot, max=E * C - 1)] * (
        sg * keep.float())[:, None].to(xc.dtype)
    y = xc.new_zeros((T, d)).index_add_(0, st, contrib)
    return y, aux


def kept_pairs(gate_vals, expert_idx, m: MoEConfig):
    """(T, E) bool: which experts each token reaches under ``m.routing``
    after the capacity drops of its chunk of T tokens, from the router's
    (T, K) gates and experts."""
    T, E = expert_idx.shape[0], m.num_experts
    C = capacity(m, T)
    if m.routing != "sort":
        return (_combine(expert_idx, gate_vals, m, C) > 0).any(dim=-1)
    order, st, keep, _ = _assign_sorted(expert_idx, m, C)
    mask = torch.zeros((T, E), dtype=torch.bool, device=expert_idx.device)
    mask[st[keep], expert_idx.reshape(-1)[order][keep]] = True
    return mask


def kept_assignments(xc, p, m: MoEConfig):
    """(T, E) bool: which experts each token of the chunk ``xc`` (T, d)
    reaches under ``m.routing`` after capacity drops (its top-k experts
    where nothing overflowed)."""
    gate_vals, expert_idx, _ = _router(xc, p, m)
    return kept_pairs(gate_vals, expert_idx, m)


def _shared_expert(p, x):
    """The shared expert's SwiGLU on ``x``."""
    g = F.silu(x @ p["ws_gate"])
    return (g * (x @ p["ws_up"])) @ p["ws_down"]


def moe_ffn(p, x, cfg: ModelConfig):
    """x: (B, S, d) -> (y (B, S, d), aux-loss scalar, the mean over chunks).

    Tokens are padded to a whole number of chunks of ``chunk_tokens`` (the
    padding is dropped on output) and routed chunk by chunk. Under an
    active model group the experts (``experts``) and the shared expert
    (``shared``) compute on this model rank's part and their partial
    outputs are summed over the group (the module's docstring)."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    tp = tensor_parallel.active()
    ep = tp is not None and tp.experts
    sp = tp is not None and tp.shared and bool(m.shared_expert_d_ff)
    xe = tensor_parallel.copy_to_model(x) if ep or sp else x
    xf, xef = x.reshape(T, d), xe.reshape(T, d)
    chunk = min(m.chunk_tokens, T)
    if T % chunk:
        pad = xf.new_zeros((chunk - T % chunk, d))
        xf, xef = torch.cat([xf, pad]), torch.cat([xef, pad])
    route = _route_chunk_sort if m.routing == "sort" else _route_chunk
    lo = tp.index * p["w_gate"].shape[-3] if ep else 0
    ys, auxs = zip(*(route(xc, p, m, xec if ep else None, lo)
                     for xc, xec in zip(xf.split(chunk), xef.split(chunk))))
    y = torch.cat(ys)[:T].reshape(B, S, d)
    aux = torch.stack(auxs).mean()
    if m.shared_expert_d_ff and sp != ep:
        # one part splits: the other's whole output joins after the sum
        if ep:
            return (tensor_parallel.reduce_from_model(y)
                    + _shared_expert(p, x)), aux
        return y + tensor_parallel.reduce_from_model(
            _shared_expert(p, xe)), aux
    if m.shared_expert_d_ff:
        y = y + _shared_expert(p, xe)
    return (tensor_parallel.reduce_from_model(y) if ep else y), aux
