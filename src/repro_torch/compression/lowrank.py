"""Low-rank sketch codec (port of ``repro/compression/lowrank.py``): project
2-D+ deltas onto rank-r factors.

Each eligible leaf (``ndim >= 2`` and trailing dim ``> lora_rank``, read
from one client's shape) is right-multiplied by an orthonormal basis ``V``
of shape ``(last_dim, rank)``: clients ship the rank-r factor ``x @ V``
instead of the dense delta. The basis is a deterministic function of
``(seed, round, leaf_index)`` that both sides rebuild, so it never
travels; the leaf index is the leaf's place in JAX's flatten order, and
the draw is ``jax.random``'s (``threefry.py``), so a cohort encoded by
either package decodes in the other. Rotating the sketch every round lets
the error-feedback residual (``algorithms/fedlora.py``) escape any fixed
subspace over rounds.

Where the sketch is built: on the host, once per ``(round, leaf, last_dim,
rank)``, with numpy Threefry and ``torch.linalg.qr`` on a CPU fp32 tensor,
then copied to the payload's device (from pinned memory, without a sync)
and cached there. A deterministic host-seeded ``(last_dim, rank)`` basis
is a few KB that the card would only wait on; built on the host, the CPU
run and the card run use the same basis bit for bit. Every encode,
decode and projection runs on the payload's device. On the meta device
(``compression.accounting``) the basis is a meta tensor: shapes only, no
Threefry, no QR.

The projection is linear, so the round accumulator lives in the sketch
image (``accum_like``) and diagonal precisions push through it by the
variance rule ``var_enc = var @ (V * V)`` (``project_precision``).

On an FSDP shard (``compression.base``'s parts) a rank holds a piece of a
matrix leaf that may start and end mid-row. ``x @ V`` sums over a row's
columns, so each rank writes its piece into zero rows covering the rows
it touches, multiplies them by ``V`` (``V * V`` and ``1 / p`` for a
precision) in fp32 into a zero ``(*lead, R, r)`` factor, and the chain sums
the factors over the ranks; the sum is cast to the payload dtype once
(``shard_finish``), so no rank's partial is rounded before the sum. A
decode lifts only the rows of this rank's piece and keeps its elements.
"""
from __future__ import annotations

import math
from collections import OrderedDict

import torch
from torch.utils import _pytree as pytree

from repro_torch.compression import threefry
from repro_torch.compression.base import (PayloadCodec, jax_leaf_index,
                                          register_codec)

#: fixed root seed for basis generation, shared by clients and server;
#: per-round variation comes from folding in the round index
_BASIS_SEED = 0x10A4

_EPS = 1e-12

#: Rounds whose bases stay cached, oldest dropped first: a round's bases
#: serve every cohort dispatched against it (at an async window, several
#: cohorts share a dispatch-time round), and rounds come in order.
_CACHED_ROUNDS = 8


def host_basis(last_dim: int, rank: int, round_idx: int,
               leaf_idx: int) -> torch.Tensor:
    """The orthonormal ``(last_dim, rank)`` basis of one leaf and round, on
    the CPU: ``qr(normal(fold_in(fold_in(PRNGKey(seed), round), leaf)))``,
    as the reference draws it."""
    key = threefry.fold_in(threefry.fold_in(
        threefry.prng_key(_BASIS_SEED), int(round_idx)), int(leaf_idx))
    g = torch.from_numpy(threefry.normal(key, (last_dim, rank)))
    q, _ = torch.linalg.qr(g)
    return q


@register_codec("lowrank")
class LowRankCodec(PayloadCodec):
    """Deterministic per-(round, leaf) Gaussian sketch, orthonormalized."""

    linear = True

    def __init__(self, fed):
        """Read the rank from ``fed.lora_rank``; no basis is built yet."""
        super().__init__(fed)
        self.rank = int(fed.lora_rank)
        # round -> {(leaf, last_dim, device): (basis, pinned host copy)}
        self._cache: "OrderedDict[int, dict]" = OrderedDict()

    def _eligible(self, shape) -> bool:
        return len(shape) >= 2 and shape[-1] > self.rank

    def _basis(self, last_dim: int, round_idx, leaf_idx: int,
               device) -> torch.Tensor:
        """Orthonormal ``(last_dim, rank)`` basis for one leaf and round on
        ``device``, built once on the host and cached."""
        device = torch.device(device)
        if device.type == "meta":
            return torch.empty((last_dim, self.rank), device="meta")
        r = int(round_idx)
        bases = self._cache.get(r)
        if bases is None:
            bases = self._cache[r] = {}
            while len(self._cache) > _CACHED_ROUNDS:
                self._cache.popitem(last=False)
        key = (leaf_idx, last_dim, device)
        if key not in bases:
            q = host_basis(last_dim, self.rank, r, leaf_idx)
            if device.type == "cuda":
                # the pinned source stays in the cache beside its copy, so
                # it outlives the asynchronous transfer
                pinned = q.pin_memory()
                bases[key] = (pinned.to(device, non_blocking=True), pinned)
            else:
                bases[key] = (q.to(device), None)
        return bases[key][0]

    def _map_leaves(self, tree, like, fn):
        """Apply ``fn(leaf_idx, leaf, ref)`` per leaf: ``ref`` is the
        template leaf (``like``'s, or the leaf itself) with one client's
        shape, ``leaf_idx`` its place in JAX's flatten order."""
        leaves, spec = pytree.tree_flatten(tree)
        template = tree if like is None else like
        refs = pytree.tree_leaves(template)
        index = jax_leaf_index(template)
        out = [fn(index[i], x, ref)
               for i, (x, ref) in enumerate(zip(leaves, refs))]
        return pytree.tree_unflatten(out, spec)

    def encode(self, tree, round_idx, like=None):
        """Right-project eligible leaves: ``x -> x @ V`` (fp32 matmul)."""

        def leaf(i, x, ref):
            if not self._eligible(ref.shape):
                return x
            v = self._basis(ref.shape[-1], round_idx, i, x.device)
            return (x.to(torch.float32) @ v).to(x.dtype)

        return self._map_leaves(tree, like, leaf)

    def decode(self, tree, round_idx, like):
        """Lift back: ``y -> y @ V.T`` using ``like`` for original shapes."""

        def leaf(i, y, ref):
            if not self._eligible(ref.shape):
                return y
            v = self._basis(ref.shape[-1], round_idx, i, y.device)
            return (y.to(torch.float32) @ v.T).to(y.dtype)

        return self._map_leaves(tree, like, leaf)

    def accum_like(self, tree):
        """Encoded-shaped fp32 zeros without any sketch or QR."""

        def leaf(i, x, ref):
            del i, ref
            shape = (x.shape if not self._eligible(x.shape)
                     else x.shape[:-1] + (self.rank,))
            return torch.zeros(shape, dtype=torch.float32, device=x.device)

        return self._map_leaves(tree, None, leaf)

    def project_precision(self, prec, round_idx, like=None):
        """Diagonal precision -> sketch space by the variance rule: a
        diagonal Gaussian of variance ``1/p`` projected by ``V`` has
        coordinate variances ``(1/p) @ (V * V)`` (exact for orthonormal
        ``V`` up to the dropped off-diagonal terms); the encoded precision
        is its reciprocal."""

        def leaf(i, p, ref):
            if not self._eligible(ref.shape):
                return p
            v = self._basis(ref.shape[-1], round_idx, i, p.device)
            var = 1.0 / torch.clamp(p.to(torch.float32), min=_EPS)
            var_enc = var @ (v * v)
            return (1.0 / torch.clamp(var_enc, min=_EPS)).to(p.dtype)

        return self._map_leaves(prec, like, leaf)

    # -- on an FSDP shard (``compression.base``) ------------------------------
    def replicates(self, shape) -> bool:
        """An eligible leaf's factor is held whole on every rank."""
        return self._eligible(shape)

    @staticmethod
    def _rows(p, last: int):
        """The leaf rows ``[lo, hi)`` that piece ``p`` touches, and where
        its first element sits in row ``lo``."""
        lo = p.a // last
        return lo, -(-p.b // last), p.a - lo * last

    def shard_partials(self, parts, round_idx, layout, precision: bool):
        """This rank's fp32 ``(*lead, R, r)`` factor of each eligible leaf:
        its piece (``1 / max(p, eps)`` for a precision) in zero rows
        times ``V`` (``V * V``), zero outside the rows it touches."""
        out = []
        for p, x in zip(layout.leaf_pieces(), parts):
            if not self._eligible(p.shape):
                out.append(None)
                continue
            last = p.shape[-1]
            lead = tuple(x.shape[:-1])
            f = torch.zeros(*lead, math.prod(p.shape) // last, self.rank,
                            dtype=torch.float32, device=x.device)
            if p.size:
                v = self._basis(last, round_idx, p.index, x.device)
                x32 = x.to(torch.float32)
                if precision:
                    x32 = 1.0 / torch.clamp(x32, min=_EPS)
                    v = v * v
                lo, hi, off = self._rows(p, last)
                rows = torch.zeros(*lead, (hi - lo) * last,
                                   dtype=torch.float32, device=x.device)
                rows[..., off:off + p.size] = x32
                f[..., lo:hi, :] = rows.reshape(*lead, hi - lo, last) @ v
            out.append(f)
        return out

    def shard_finish(self, parts, summed, layout, precision: bool):
        """Each eligible leaf's summed factor shaped ``(*lead,
        *shape[:-1], r)``, cast once to its piece's dtype (a precision
        through ``1 / max(var_enc, eps)`` first)."""
        out = []
        for p, x, f in zip(layout.leaf_pieces(), parts, summed):
            if f is None:
                out.append(x)
                continue
            if precision:
                f = 1.0 / torch.clamp(f, min=_EPS)
            out.append(f.to(x.dtype).reshape(*x.shape[:-1], *p.shape[:-1],
                                             self.rank))
        return out

    def shard_decode(self, parts, round_idx, layout):
        """Each eligible leaf's factor -> this rank's piece: the rows the
        piece touches lifted by ``V.T`` (fp32), its elements kept, in the
        factor's dtype."""
        out = []
        for p, y in zip(layout.leaf_pieces(), parts):
            if not self._eligible(p.shape):
                out.append(y)
                continue
            last = p.shape[-1]
            lead = tuple(y.shape[:y.dim() - len(p.shape)])
            if not p.size:
                out.append(torch.zeros(*lead, 0, dtype=y.dtype,
                                       device=y.device))
                continue
            v = self._basis(last, round_idx, p.index, y.device)
            lo, hi, off = self._rows(p, last)
            rows = y.to(torch.float32).reshape(*lead, -1, self.rank)[
                ..., lo:hi, :] @ v.T
            out.append(rows.reshape(*lead, -1)[..., off:off + p.size]
                       .to(y.dtype))
        return out

    def shard_accum_like(self, parts, layout):
        """fp32 zeros: an eligible leaf's ``(*shape[:-1], r)`` factor (with
        the pieces' leading axes), the others' pieces as they are."""
        return [torch.zeros(*x.shape[:-1], *p.shape[:-1], self.rank,
                            dtype=torch.float32, device=x.device)
                if self._eligible(p.shape) else x
                for p, x in zip(layout.leaf_pieces(), parts)]
