"""Tree checkpoints as an npz payload + a json manifest (port of
``repro/checkpoint/io.py``), in the reference's format, so each package
reads the other's files.

``save_checkpoint`` writes ``ckpt_<step:08d>.npz`` (leaves ``leaf_<i>``)
and ``ckpt_<step:08d>.json`` (``{"step", "metadata", "manifest"}``, one
``{key, path, shape, dtype}`` per leaf). Each ``path`` is the leaf's key
path written as ``jax.tree_util.keystr`` writes it — ``['name']`` for a
dict key, ``.field`` for a NamedTuple field, ``[i]`` for a tuple or list
index, ``<root>`` for a bare leaf — from the port's own walk of its trees
(dicts in sorted key order, as the reference flattens them; ``None`` and
empty containers hold no leaf). A Python ``int`` (``ServerState.round``,
an optimizer's ``step``) is written as an int32 scalar, a ``float`` as
fp32, and a dtype numpy cannot store (bf16) widened to fp32 with its
dtype recorded. Restore casts each leaf back to the template's type,
dtype and device, checked by path and shape, with the reference's
``ValueError`` / ``KeyError`` / ``FileNotFoundError``.

The reference's shard-local family (``save_checkpoint_shard``,
``save_store_sharded``, ``restore_store_sharded``,
``latest_sharded_checkpoint``) waits for ROADMAP.md queue 1, item 10.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

#: dtypes npz stores as they are (the reference's list); others widen.
_NPZ_DTYPES = ("float64", "float32", "float16", "int64", "int32", "int16",
               "int8", "uint8", "uint16", "uint32", "uint64", "bool")


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(keystr path, leaf)`` pairs of ``tree`` in the reference's flatten
    order (dict keys sorted); a bare leaf's path is ``<root>``."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in leaves_with_paths(tree[k], f"{prefix}[{k!r}]")]
    if _is_namedtuple(tree):
        return [pair for f in tree._fields
                for pair in leaves_with_paths(getattr(tree, f),
                                              f"{prefix}.{f}")]
    if isinstance(tree, (tuple, list)):
        return [pair for i, x in enumerate(tree)
                for pair in leaves_with_paths(x, f"{prefix}[{i}]")]
    if tree is None:
        return []
    return [(prefix or "<root>", tree)]


def _rebuild(fn, tree, prefix: str = ""):
    """``tree`` with each leaf replaced by ``fn(path, leaf)`` (the
    template's own key order kept)."""
    if isinstance(tree, dict):
        return {k: _rebuild(fn, v, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(fn, getattr(tree, f), f"{prefix}.{f}")
                            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(fn, x, f"{prefix}[{i}]")
                          for i, x in enumerate(tree))
    if tree is None:
        return None
    return fn(prefix or "<root>", tree)


def _to_array(leaf) -> Tuple[np.ndarray, str]:
    """A leaf -> (the array npz stores, the dtype name to record)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        dtype = str(t.dtype).removeprefix("torch.")
        if dtype not in _NPZ_DTYPES:
            return t.to(torch.float32).numpy(), dtype
        return t.numpy(), dtype
    if isinstance(leaf, bool):
        arr = np.asarray(leaf)
    elif isinstance(leaf, int):
        arr = np.asarray(leaf, np.int32)
    elif isinstance(leaf, float):
        arr = np.asarray(leaf, np.float32)
    else:
        arr = np.asarray(leaf)
    dtype = str(arr.dtype)
    if dtype not in _NPZ_DTYPES:
        # ml_dtypes (bf16, fp8) from numpy: store widened
        arr = arr.astype(np.float32)
    return arr, dtype


def _from_array(arr: np.ndarray, like):
    """A stored array cast back to the template leaf's type, dtype and
    device."""
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(device=like.device,
                                                  dtype=like.dtype)
    if isinstance(like, bool):
        return bool(arr)
    if isinstance(like, int):
        return int(arr)
    if isinstance(like, float):
        return float(arr)
    return np.asarray(arr).astype(np.asarray(like).dtype)


def save_checkpoint(ckpt_dir: str, state: Any, step: int,
                    metadata: Optional[dict] = None) -> str:
    """Write ``state`` as ``ckpt_<step>.npz`` + a ``.json`` path/dtype
    manifest; returns the npz path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays, manifest = {}, []
    for i, (path, leaf) in enumerate(leaves_with_paths(state)):
        arr, dtype = _to_array(leaf)
        key = f"leaf_{i}"
        arrays[key] = arr
        manifest.append({"key": key, "path": path,
                         "shape": list(arr.shape), "dtype": dtype})
    base = os.path.join(ckpt_dir, f"ckpt_{step:08d}")
    np.savez(base + ".npz", **arrays)
    with open(base + ".json", "w") as f:
        json.dump({"step": step, "metadata": metadata or {},
                   "manifest": manifest}, f, indent=1)
    return base + ".npz"


def latest_checkpoint(ckpt_dir: str) -> Optional[int]:
    """The highest checkpoint step in ``ckpt_dir`` (None if there is none)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for fn in os.listdir(ckpt_dir)
             if (m := re.match(r"ckpt_(\d+)\.npz$", fn))]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, like: Any,
                       step: Optional[int] = None) -> Tuple[Any, int, dict]:
    """Restore into the structure of ``like`` (paths and shapes checked,
    each leaf cast to the template's); returns ``(tree, step,
    metadata)``."""
    if step is None:
        step = latest_checkpoint(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    base = os.path.join(ckpt_dir, f"ckpt_{step:08d}")
    with open(base + ".json") as f:
        meta = json.load(f)
    template = leaves_with_paths(like)
    if len(template) != len(meta["manifest"]):
        raise ValueError(
            f"leaf count mismatch: template {len(template)} vs "
            f"checkpoint {len(meta['manifest'])}")
    by_path = {m["path"]: m for m in meta["manifest"]}
    with np.load(base + ".npz") as data:
        def restore(path, leaf):
            if path not in by_path:
                raise KeyError(f"checkpoint missing leaf {path}")
            arr = data[by_path[path]["key"]]
            if tuple(arr.shape) != tuple(np.shape(leaf)):
                raise ValueError(f"{path}: shape {arr.shape} != template "
                                 f"{tuple(np.shape(leaf))}")
            return _from_array(arr, leaf)

        tree = _rebuild(restore, like)
    return tree, meta["step"], meta["metadata"]
