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

The shard-local family checkpoints a population-sharded client store the
reference's way: each rank writes only the rows it owns as
``ckpt_<step>.shard<k>of<n>.npz`` + ``.json`` (the manifest plus ``{"shard":
{"index", "count", "row_offset"}}``) beside rank 0's server checkpoint.
``latest_sharded_checkpoint`` skips a step whose set is incomplete, and
``restore_store_sharded`` loads the shard whose rows match the rank's, or,
when the topology changed, reads every shard and concatenates them.

The FSDP family checkpoints a state in the flat layout (``core/fsdp.py``:
a server state's ``(n,)`` shards of the params' ravel, a store's ``(N,
n)`` rows): every rank writes its own file,
``ckpt_<step>.fsdp<k>of<W>.npz`` + ``.json``, holding its part of each
flat leaf (``fsdp.in_flat_layout``) under the state's key path and every
other leaf (the round, the optimizers' steps, a store's stamps) whole.
The json adds ``{"fsdp": {"d", "n", "W", "rank", "template"}}``, the
template's leaf paths and shapes, and marks the flat leaves.
``restore_checkpoint_fsdp`` reads the rank's own file when the layout has
the set's W; at another W (W = 1 on no mesh included) it reads every file,
puts each flat leaf's d elements back in order and cuts them for the new
layout, and the leaves held whole must agree across the files. A layout
whose d or template differs raises ``ValueError``; ``latest_fsdp_checkpoint``
skips an incomplete set. ``save_checkpoint`` refuses a flat leaf, since
a shard written as if it were whole would restore as the wrong tree; a
whole state gathered from the shards (``FlatShard.gather_state``) is an
ordinary tree in the reference's format.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import fsdp

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


def _pack_leaves(state: Any, layout=None):
    """``state`` -> (the arrays npz stores, the path/dtype manifest). A
    leaf in the FSDP flat layout raises ``ValueError`` unless ``layout``
    is given; then its entry is marked ``"flat"`` and its last axis must
    be the layout's ``n``."""
    arrays, manifest = {}, []
    for i, (path, leaf) in enumerate(leaves_with_paths(state)):
        flat = fsdp.in_flat_layout(leaf)
        if flat and layout is None:
            raise ValueError(
                f"{path} is a shard in the FSDP flat layout, not a whole "
                f"leaf: write it with save_checkpoint_fsdp (or gather the "
                f"whole tree first)")
        arr, dtype = _to_array(leaf)
        if flat and (arr.ndim == 0 or arr.shape[-1] != layout.n):
            raise ValueError(f"{path}: a flat leaf of shape {arr.shape} is "
                             f"not the layout's (..., {layout.n})")
        key = f"leaf_{i}"
        arrays[key] = arr
        manifest.append({"key": key, "path": path,
                         "shape": list(arr.shape), "dtype": dtype,
                         **({"flat": True} if flat else {})})
    return arrays, manifest


def _write_base(base: str, arrays: dict, payload: dict) -> str:
    np.savez(base + ".npz", **arrays)
    with open(base + ".json", "w") as f:
        json.dump(payload, f, indent=1)
    return base + ".npz"


def save_checkpoint(ckpt_dir: str, state: Any, step: int,
                    metadata: Optional[dict] = None) -> str:
    """Write ``state`` as ``ckpt_<step>.npz`` + a ``.json`` path/dtype
    manifest; returns the npz path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays, manifest = _pack_leaves(state)
    return _write_base(os.path.join(ckpt_dir, f"ckpt_{step:08d}"), arrays,
                       {"step": step, "metadata": metadata or {},
                        "manifest": manifest})


def latest_checkpoint(ckpt_dir: str) -> Optional[int]:
    """The highest checkpoint step in ``ckpt_dir`` (None if there is none)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for fn in os.listdir(ckpt_dir)
             if (m := re.match(r"ckpt_(\d+)\.npz$", fn))]
    return max(steps) if steps else None


def _restore_leaves(like: Any, meta: dict, data, *,
                    rows_free: bool = False) -> Any:
    """``like``'s structure rebuilt from a manifest and its npz payload
    (paths and shapes checked, each leaf cast to the template's); with
    ``rows_free`` the leading (row) axis is exempt from the shape check."""
    template = leaves_with_paths(like)
    if len(template) != len(meta["manifest"]):
        raise ValueError(
            f"leaf count mismatch: template {len(template)} vs "
            f"checkpoint {len(meta['manifest'])}")
    by_path = {m["path"]: m for m in meta["manifest"]}

    def restore(path, leaf):
        if path not in by_path:
            raise KeyError(f"checkpoint missing leaf {path}")
        arr = data[by_path[path]["key"]]
        got, want = tuple(arr.shape), tuple(np.shape(leaf))
        if (got[1:] != want[1:]) if rows_free else (got != want):
            raise ValueError(f"{path}: shape {arr.shape} != template "
                             f"{want}")
        return _from_array(arr, leaf)

    return _rebuild(restore, like)


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
    with np.load(base + ".npz") as data:
        tree = _restore_leaves(like, meta, data)
    return tree, meta["step"], meta["metadata"]


# -- shard-local client-store checkpoints -----------------------------------

_SHARD_RE = re.compile(r"ckpt_(\d+)\.shard(\d+)of(\d+)\.npz$")


def _shard_base(ckpt_dir: str, step: int, index: int, count: int) -> str:
    return os.path.join(ckpt_dir, f"ckpt_{step:08d}.shard{index}of{count}")


def save_checkpoint_shard(ckpt_dir: str, state: Any, step: int, *,
                          row_offset: int, shard_index: int,
                          num_shards: int,
                          metadata: Optional[dict] = None) -> str:
    """Write one rank's slice of a row-sharded state tree as
    ``ckpt_<step>.shard<k>of<n>.npz`` (a family ``latest_checkpoint``
    never picks up); the json records ``row_offset``, where the slice's
    rows sit in the population."""
    if not 0 <= shard_index < num_shards:
        raise ValueError(f"shard_index {shard_index} out of range for "
                         f"{num_shards} shards")
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays, manifest = _pack_leaves(state)
    return _write_base(
        _shard_base(ckpt_dir, step, shard_index, num_shards), arrays,
        {"step": step, "metadata": metadata or {}, "manifest": manifest,
         "shard": {"index": shard_index, "count": num_shards,
                   "row_offset": row_offset}})


def _latest_complete(ckpt_dir: str, pattern) -> Optional[int]:
    """The highest step whose files named by ``pattern`` (groups: step,
    index, count) form a complete set, all ``count`` of them."""
    if not os.path.isdir(ckpt_dir):
        return None
    found: dict = {}
    for fn in os.listdir(ckpt_dir):
        m = pattern.match(fn)
        if m:
            step, idx, count = (int(g) for g in m.groups())
            found.setdefault((step, count), set()).add(idx)
    complete = [step for (step, count), idxs in found.items()
                if len(idxs) == count]
    return max(complete) if complete else None


def latest_sharded_checkpoint(ckpt_dir: str) -> Optional[int]:
    """The highest step with a complete shard set (all n of n files): a
    save some ranks had not finished is skipped."""
    return _latest_complete(ckpt_dir, _SHARD_RE)


def _read_shard(ckpt_dir: str, step: int, index: int, count: int):
    """One shard's ``(manifest json, npz payload)``."""
    base = _shard_base(ckpt_dir, step, index, count)
    with open(base + ".json") as f:
        meta = json.load(f)
    return meta, np.load(base + ".npz")


def _shard_metas(ckpt_dir: str, step: int) -> list:
    """Every shard manifest of ``step`` (json only), checked complete."""
    metas = []
    for fn in sorted(os.listdir(ckpt_dir)):
        m = _SHARD_RE.match(fn)
        if m and int(m.group(1)) == step:
            with open(os.path.join(ckpt_dir, fn[:-len(".npz")]
                                   + ".json")) as f:
                metas.append(json.load(f))
    if not metas:
        raise FileNotFoundError(
            f"no shard checkpoints for step {step} in {ckpt_dir}")
    count = metas[0]["shard"]["count"]
    if len(metas) != count:
        raise FileNotFoundError(
            f"step {step} has {len(metas)}/{count} shards in {ckpt_dir}")
    return metas


def _concat_rows(trees: list):
    """Trees of the same structure, each leaf concatenated along rows."""
    leaves = [dict(leaves_with_paths(t)) for t in trees]
    return _rebuild(lambda path, _: np.concatenate(
        [np.asarray(lv[path]) for lv in leaves], axis=0), trees[0])


def _rank_and_count() -> Tuple[int, int]:
    """This process's rank and the world size (0 and 1 with no group)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def save_store_sharded(ckpt_dir: str, store, step: int,
                       metadata: Optional[dict] = None) -> str:
    """Checkpoint a client-state store shard-locally: every rank calls
    this and writes the rows it owns (``local_state_dict``), as shard
    ``rank`` of ``world size``; a store without that API (the host store)
    writes its whole state, as the reference's."""
    if hasattr(store, "local_state_dict"):
        state, row_offset = store.local_state_dict()
    else:
        state, row_offset = store.state_dict(), 0
    index, count = _rank_and_count()
    return save_checkpoint_shard(ckpt_dir, state, step,
                                 row_offset=row_offset, shard_index=index,
                                 num_shards=count, metadata=metadata)


def restore_store_sharded(ckpt_dir: str, store,
                          step: Optional[int] = None) -> int:
    """Restore a client-state store from its shard files, in place;
    returns the step. The shard whose rows are the rank's own is loaded
    alone (``load_local_state_dict``); when the topology changed between
    save and restore, every shard is read and concatenated in row order
    and loaded through ``load_state_dict``."""
    if step is None:
        step = latest_sharded_checkpoint(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no shard checkpoints in {ckpt_dir}")
    metas = _shard_metas(ckpt_dir, step)
    count = metas[0]["shard"]["count"]
    sharded = hasattr(store, "local_state_dict")
    if sharded:
        local, row_offset = store.local_state_dict()
    else:
        local, row_offset = store.state_dict(), 0
    local_rows = int(np.asarray(local["stamps"]).shape[0])
    match = next(
        (m for m in metas
         if m["shard"]["row_offset"] == row_offset
         and m["manifest"] and m["manifest"][0]["shape"][0] == local_rows),
        None)
    if match is not None:
        meta, data = _read_shard(ckpt_dir, step, match["shard"]["index"],
                                 count)
        with data:
            tree = _restore_leaves(local, meta, data)
        if sharded:
            store.load_local_state_dict(tree, row_offset)
        else:
            store.load_state_dict(tree)
        return step
    # the topology changed: every shard's rows, in population order
    parts = []
    for m in sorted(metas, key=lambda m: m["shard"]["row_offset"]):
        meta, data = _read_shard(ckpt_dir, step, m["shard"]["index"], count)
        with data:
            parts.append((m["shard"]["row_offset"],
                          _restore_leaves(local, meta, data,
                                          rows_free=True)))
    offsets = [off for off, _ in parts]
    rows = [np.asarray(t["stamps"]).shape[0] for _, t in parts]
    if offsets[0] != 0:
        raise ValueError(f"first shard starts at row {offsets[0]}, not 0")
    for (off, r), nxt in zip(zip(offsets, rows), offsets[1:] + [None]):
        if nxt is not None and off + r != nxt:
            raise ValueError(
                f"shard rows are not contiguous: [{off}, {off + r}) then "
                f"{nxt} — cannot reassemble the population")
    full = _concat_rows([t for _, t in parts])
    total = int(np.asarray(full["stamps"]).shape[0])
    if total != store.num_clients:
        raise ValueError(
            f"reassembled population has {total} rows, store expects "
            f"{store.num_clients}")
    store.load_state_dict(full)
    return step


# -- FSDP checkpoints: each rank's part of a state in the flat layout --------

_FSDP_RE = re.compile(r"ckpt_(\d+)\.fsdp(\d+)of(\d+)\.npz$")


def _fsdp_base(ckpt_dir: str, step: int, rank: int, count: int) -> str:
    return os.path.join(ckpt_dir, f"ckpt_{step:08d}.fsdp{rank}of{count}")


def _layout_record(layout) -> dict:
    """The json's record of an FSDP layout."""
    return {"d": layout.d, "n": layout.n, "W": layout.W,
            "rank": layout.rank,
            "template": [{"path": p, "shape": list(s)}
                         for p, s in zip(layout.paths, layout.shapes)]}


def save_checkpoint_fsdp(ckpt_dir: str, state: Any, step: int, layout,
                         metadata: Optional[dict] = None) -> str:
    """Write this rank's part of ``state`` (a tree whose flat-layout leaves
    are ``layout``'s shards or rows) as ``ckpt_<step>.fsdp<k>of<W>.npz``
    + ``.json``; every rank of the layout calls it. Returns the npz
    path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays, manifest = _pack_leaves(state, layout)
    return _write_base(
        _fsdp_base(ckpt_dir, step, layout.rank, layout.W), arrays,
        {"step": step, "metadata": metadata or {}, "manifest": manifest,
         "fsdp": _layout_record(layout)})


def latest_fsdp_checkpoint(ckpt_dir: str) -> Optional[int]:
    """The highest step with a complete FSDP set (all W of W files): a
    save some ranks had not finished is skipped."""
    return _latest_complete(ckpt_dir, _FSDP_RE)


def _fsdp_metas(ckpt_dir: str, step: int) -> list:
    """Every json of ``step``'s FSDP set in rank order, checked
    complete."""
    metas = {}
    for fn in os.listdir(ckpt_dir) if os.path.isdir(ckpt_dir) else ():
        m = _FSDP_RE.match(fn)
        if m and int(m.group(1)) == step:
            with open(os.path.join(ckpt_dir, fn[:-len(".npz")]
                                   + ".json")) as f:
                metas[int(m.group(2))] = json.load(f)
    if not metas:
        raise FileNotFoundError(
            f"no FSDP checkpoints for step {step} in {ckpt_dir}")
    count = next(iter(metas.values()))["fsdp"]["W"]
    if sorted(metas) != list(range(count)):
        raise FileNotFoundError(
            f"step {step} has FSDP files of ranks {sorted(metas)} of "
            f"{count} in {ckpt_dir}")
    return [metas[r] for r in range(count)]


def _check_layout(rec: dict, layout) -> None:
    """``ValueError`` unless a saved layout record has ``layout``'s d and
    template."""
    if rec["d"] != layout.d:
        raise ValueError(f"the checkpoint's layout has d = {rec['d']}, "
                         f"this layout d = {layout.d}")
    saved = [(t["path"], tuple(t["shape"])) for t in rec["template"]]
    if saved != list(zip(layout.paths, layout.shapes)):
        raise ValueError(
            f"the checkpoint's template {saved} is not this layout's "
            f"{list(zip(layout.paths, layout.shapes))}")


def _recut(parts: List[np.ndarray], d: int, layout) -> np.ndarray:
    """One flat leaf's ``(..., n_old)`` parts, in rank order -> this
    rank's ``(..., n)`` part of the same ``d`` elements under
    ``layout`` (zero padding past d)."""
    whole = np.concatenate(parts, axis=-1)[..., :d]
    out = np.zeros(whole.shape[:-1] + (layout.n,), whole.dtype)
    hi = min(layout.lo + layout.n, d)
    if hi > layout.lo:
        out[..., :hi - layout.lo] = whole[..., layout.lo:hi]
    return out


def restore_checkpoint_fsdp(ckpt_dir: str, like: Any, step: Optional[int],
                            layout) -> Tuple[Any, int, dict]:
    """Restore ``save_checkpoint_fsdp``'s set into the structure of
    ``like`` (its flat leaves ``layout``'s shards or rows); returns
    ``(tree, step, metadata)``, the flat leaves marked as the layout's.
    ``step=None`` takes ``latest_fsdp_checkpoint``."""
    if step is None:
        step = latest_fsdp_checkpoint(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no FSDP checkpoints in {ckpt_dir}")
    metas = _fsdp_metas(ckpt_dir, step)
    rec = metas[0]["fsdp"]
    _check_layout(rec, layout)
    if rec["W"] == layout.W:
        meta = metas[layout.rank]
        with np.load(_fsdp_base(ckpt_dir, step, layout.rank, layout.W)
                     + ".npz") as data:
            tree = _restore_leaves(like, meta, data)
    else:
        meta = metas[0]
        datas = [np.load(_fsdp_base(ckpt_dir, step, r, rec["W"]) + ".npz")
                 for r in range(rec["W"])]
        try:
            arrays = {}
            for i, m in enumerate(meta["manifest"]):
                parts = [data[metas[r]["manifest"][i]["key"]]
                         for r, data in enumerate(datas)]
                if m.get("flat"):
                    arrays[m["key"]] = _recut(parts, rec["d"], layout)
                elif any(not np.array_equal(parts[0], p) for p in parts):
                    raise ValueError(f"{m['path']} differs between the "
                                     f"ranks' files of step {step}")
                else:
                    arrays[m["key"]] = parts[0]
        finally:
            for data in datas:
                data.close()
        tree = _restore_leaves(like, meta, arrays)
    flat = {m["path"] for m in meta["manifest"] if m.get("flat")}
    fsdp.mark_flat([leaf for path, leaf in leaves_with_paths(tree)
                    if path in flat])
    return tree, meta["step"], meta["metadata"]
