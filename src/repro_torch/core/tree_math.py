"""Vector-space operations on parameter trees (dicts of tensors, or a bare
tensor), plus the flat ``(C, d)`` fp32 view the Sherman-Morrison DP works on.

Port of ``repro/tree_math.py`` (re-exported by ``repro/core/tree_math.py``).
Trees are flattened with ``torch.utils._pytree``; dicts keep insertion
order, so ``flatten`` / ``unflatten`` agree as long as both see trees built
from the same template.
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree


def tmap(fn, *trees):
    """Apply ``fn`` leafwise across trees of the same structure."""
    return pytree.tree_map(fn, *trees)


def tleaves(tree):
    """The tree's leaves in flatten order."""
    return pytree.tree_leaves(tree)


def tsub(a, b):
    """a - b, leafwise."""
    return tmap(torch.sub, a, b)


def tscale(s, a):
    """s * a, leafwise."""
    return tmap(lambda x: s * x, a)


def tzeros_like(a, dtype=None):
    """Zeros with each leaf's shape (and dtype unless overridden)."""
    return tmap(lambda x: torch.zeros_like(x, dtype=dtype or x.dtype), a)


def tcast(a, dtype):
    """Cast every leaf to ``dtype``."""
    return tmap(lambda x: x.to(dtype), a)


def tbroadcast(tree, n: int):
    """A fresh copy of ``tree`` with a leading axis of size ``n``."""
    return tmap(lambda x: x.unsqueeze(0).expand(n, *x.shape).clone(), tree)


def tree_size(a) -> int:
    """Total element count across all leaves."""
    return sum(x.numel() for x in tleaves(a))


def flatten(tree, lead_dims: int = 1) -> torch.Tensor:
    """Ravel a tree into one contiguous fp32 tensor.

    The first ``lead_dims`` axes of every leaf (the client axis of a
    stacked cohort by default) are kept; the rest are concatenated in
    leaf order: leaves ``(C, *shape_i)`` give ``(C, d)`` with
    ``d = sum(prod(shape_i))``.
    """
    leaves = tleaves(tree)
    lead = leaves[0].shape[:lead_dims]
    return torch.cat([x.reshape(*lead, -1).to(torch.float32) for x in leaves],
                     dim=lead_dims)


def unflatten(flat: torch.Tensor, like, dtype=None):
    """Inverse of :func:`flatten`: split the last axis of ``flat`` into
    leaves shaped like ``like``'s (an unstacked template), keeping the
    leading axes of ``flat``; each leaf is cast to ``dtype`` (default: the
    template leaf's dtype)."""
    leaves, spec = pytree.tree_flatten(like)
    size = sum(x.numel() for x in leaves)
    if size != flat.shape[-1]:
        raise ValueError(f"flat vector has {flat.shape[-1]} entries, the "
                         f"template {size}")
    lead = flat.shape[:-1]
    out, off = [], 0
    for x in leaves:
        n = x.numel()
        out.append(flat[..., off:off + n].reshape(*lead, *x.shape)
                   .to(dtype or x.dtype))
        off += n
    return pytree.tree_unflatten(out, spec)
