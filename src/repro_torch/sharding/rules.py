"""Logical-axis rules and the tensor-parallel plan (port of
``repro/sharding/rules.py``'s rule table: ``DEFAULT_RULES``, the override
filtered to a mesh's axes, and the attention-and-FFN part of
``_PARAM_RULES``).

The reference names logical axes in its model code and maps them to mesh
axes through ``DEFAULT_RULES`` (``"tp"``, ``"vocab"`` and ``"experts"`` to
``"model"``), overridden per call (``axis_rules(mesh, rules)``) and
filtered to the axes a mesh has (``_resolve``): ``{"tp": ()}`` maps
``"tp"`` to no axis. Its ``_PARAM_RULES`` lay each parameter out by a regex
on its key path and ``_sanitize`` replicates a dimension that does not
divide; XLA computes correctly on any such layout.

Here the compute over ``model`` is written out (Megatron's conjugate pair,
``sharding/tensor_parallel.py``), so a split has to keep whole what the
model's code computes on, and the port decides per block, not per leaf.
Over ``M`` model ranks, by the logical axis each block's rule names:

  * ``"tp"``: an attention block splits only when ``num_kv_heads % M ==
    0``; model rank ``g`` then takes kv heads ``[g KV/M, (g + 1) KV/M)``
    and their query heads ``[g H/M, (g + 1) H/M)`` (head ``h`` reads kv
    head ``h // (H / KV)``): the columns ``[g q/M, (g + 1) q/M)`` of
    ``wq`` (``q = H dh``), those of ``wk`` and ``wv`` (``KV dh``), and
    the same rows of ``wo``;
  * ``"tp"``: a dense FFN block splits only when ``d_ff % M == 0``:
    columns ``[g f/M, (g + 1) f/M)`` of ``w_gate`` and ``w_up``, the same
    rows of ``w_down``; an MoE's shared expert the same way when
    ``shared_expert_d_ff % M == 0`` (``ws_gate``, ``ws_up``, ``ws_down``);
  * ``"vocab"``: ``embed`` (``(V, d)``, ``V`` the padded vocabulary)
    splits its rows ``[g V/M, (g + 1) V/M)`` when ``V % M == 0``, an
    untied ``unembed`` (``(d, V)``) the same columns;
  * ``"experts"``: the MoE expert banks ``w_gate``, ``w_up`` (``(..., E,
    d, f)``) and ``w_down`` (``(..., E, f, d)``) split on dim -3 when ``E
    % M == 0``: model rank ``g`` takes experts ``[g E/M, (g + 1) E/M)``;
  * every other leaf is replicated: the norms, ``q_scale`` / ``k_scale``,
    the MoE ``router`` (top-k reads every expert's logit, so a split would
    gather them again), the xLSTM and RG-LRU projections and ``conv``
    (ROADMAP.md queue 1, item 10 part 4b part 2).

``TPPlan`` gives, for model rank ``g``, the compute tree's leaf shapes and
the indices of its elements in the template's ravel (the FSDP layout's
flat order, ``core/fsdp.py``) as contiguous runs: a block of dim ``k`` of
a leaf is one run of ``shape[k] / M`` times the trailing dims' elements
per leading index (a column block of ``(..., d, q)``: ``q/M`` per row; a
row block: ``q/M x d`` per leading index; an expert block: ``E/M x d x f``
per leading index). The runs are in ravel order, so the elements they
name, concatenated, are the compute leaves' ravels in the template's leaf
order.
"""
from __future__ import annotations

import math
import re
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
from torch.utils import _pytree as pytree

#: Logical axis -> mesh axes (the reference's table).
DEFAULT_RULES = {
    "clients": ("pod", "data"),
    "batch": ("pod", "data"),
    "tp": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
}

#: The parameter rules of the blocks that split: (regex on the leaf's
#: name, logical axes of its trailing dims) for the leaves of an attention
#: block, of a dense FFN block, of an MoE's shared expert and of its expert
#: banks, and for the vocabulary's leaves.
ATTN_RULES = ((r"^(wq|wk|wv)$", (None, "tp")),
              (r"^wo$", ("tp", None)))
FFN_RULES = ((r"^w_(gate|up)$", (None, "tp")),
             (r"^w_down$", ("tp", None)))
SHARED_RULES = ((r"^ws_(gate|up)$", (None, "tp")),
                (r"^ws_down$", ("tp", None)))
EXPERT_RULES = ((r"^w_(gate|up|down)$", ("experts", None, None)),)
VOCAB_RULES = ((r"^embed$", ("vocab", None)),
               (r"^unembed$", (None, "vocab")))

#: The logical axes the port splits compute over (each maps to "model").
LOGICAL = ("tp", "vocab", "experts")


def resolve(name: str, mesh, rules: Optional[dict] = None) -> Tuple[str, ...]:
    """The mesh axes a logical axis maps to under ``DEFAULT_RULES``
    overridden by ``rules``, filtered to the axes ``mesh`` has (none
    without a mesh)."""
    if mesh is None:
        return ()
    return tuple(a for a in {**DEFAULT_RULES, **(rules or {})}.get(name, ())
                 if a in mesh.axis_names)


def normalize_path(path: str) -> str:
    """``"['pattern']['pos_0']['mixer']['wq']"`` -> ``"pattern.pos_0.mixer
    .wq"``."""
    return re.sub(r"[\[\]'\"]+", ".", path).strip(".")


class LeafSplit(NamedTuple):
    """One template leaf under the plan: its key ``path``, whole
    ``shape`` and the dim split over the model ranks (``-1`` columns,
    ``-2`` rows, ``-3`` experts, None replicated)."""

    path: str
    shape: tuple
    dim: Optional[int]

    @property
    def size(self) -> int:
        """The leaf's elements."""
        return math.prod(self.shape)


def _block_spec(cfg, parts: List[str]):
    """The ``LayerSpec`` of the block a normalized path lies in (None for
    the leaves outside the layers)."""
    if len(parts) < 3:
        return None
    if parts[0] == "pattern":
        return cfg.pattern[int(parts[1][len("pos_"):])]
    if parts[0] == "tail":
        return cfg.tail[int(parts[1][len("layer_"):])]
    return None


class TPPlan:
    """The tensor-parallel plan of ``cfg``'s params (``template``: the
    params tree, shapes only) over ``M`` model ranks, the blocks of the
    logical axes ``logical`` (of ``LOGICAL``) eligible: whether attention
    (``attn``), the dense FFN (``ffn``), the shared expert (``shared``),
    the vocabulary (``vocab``) and the MoE experts (``experts``) split,
    and each leaf's ``LeafSplit`` in the template's order."""

    def __init__(self, cfg, template, M: int, logical=LOGICAL):
        if M < 1:
            raise ValueError(f"a model extent of {M}")
        self.M = M
        specs = list(cfg.pattern) + list(cfg.tail)
        tp, m = "tp" in logical, cfg.moe
        moe = m.enabled and any(s.ffn == "moe" for s in specs)
        self.attn = (tp and cfg.num_kv_heads % M == 0
                     and any(s.mixer in ("attn", "swa") for s in specs))
        self.ffn = (tp and cfg.d_ff % M == 0
                    and any(s.ffn == "dense" for s in specs))
        self.shared = (tp and moe and m.shared_expert_d_ff > 0
                       and m.shared_expert_d_ff % M == 0)
        self.vocab = "vocab" in logical and cfg.padded_vocab % M == 0
        self.experts = ("experts" in logical and moe
                        and m.num_experts % M == 0)
        self.leaves: List[LeafSplit] = []
        for key, x in pytree.tree_flatten_with_path(template)[0]:
            path = pytree.keystr(key)
            parts = normalize_path(path).split(".")
            spec, dim = _block_spec(cfg, parts), None
            rules = ()
            if len(parts) == 1 and self.vocab:
                rules = VOCAB_RULES
            elif spec is not None and parts[2] == "mixer" and self.attn \
                    and spec.mixer in ("attn", "swa"):
                rules = ATTN_RULES
            elif spec is not None and parts[2] == "ffn" and self.ffn \
                    and spec.ffn == "dense":
                rules = FFN_RULES
            elif spec is not None and parts[2:4] == ["ffn", "moe"]:
                rules = ((SHARED_RULES if self.shared else ())
                         + (EXPERT_RULES if self.experts else ()))
            for pattern, axes in rules:
                if re.search(pattern, parts[-1]):
                    dim = next(i - len(axes) for i, a in enumerate(axes)
                               if a is not None)
            shape = tuple(x.shape)
            if dim is not None and shape[dim] % M:
                raise ValueError(f"{path} of shape {shape} does not split "
                                 f"over {M} model ranks")
            self.leaves.append(LeafSplit(path, shape, dim))

    @property
    def splits(self) -> bool:
        """Whether any block splits."""
        return (self.attn or self.ffn or self.shared or self.vocab
                or self.experts)

    @property
    def split_elements(self) -> int:
        """The elements of the leaves that split (``T``)."""
        return sum(s.size for s in self.leaves if s.dim is not None)

    @property
    def replicated_elements(self) -> int:
        """The elements every model rank computes on (``R``)."""
        return sum(s.size for s in self.leaves if s.dim is None)

    @property
    def rank_elements(self) -> int:
        """The elements one model rank computes on: ``R + T / M``."""
        return self.replicated_elements + self.split_elements // self.M

    def local_shapes(self) -> List[tuple]:
        """Each leaf's shape on one model rank (the split dim over M)."""
        out = []
        for s in self.leaves:
            shape = list(s.shape)
            if s.dim is not None:
                shape[s.dim] //= self.M
            out.append(tuple(shape))
        return out

    def runs(self, g: int, split_only: bool = False
             ) -> Tuple[np.ndarray, np.ndarray]:
        """``(starts, lengths)`` (int64) of model rank ``g``'s elements in
        the template's ravel (``split_only``: of its split leaves' only), in
        ravel order, adjacent runs merged."""
        if not 0 <= g < self.M:
            raise ValueError(f"model rank {g} of {self.M}")
        starts, lens, off = [], [], 0
        for s in self.leaves:
            if s.dim is None:
                if not split_only:
                    starts.append(np.array([off]))
                    lens.append(np.array([s.size]))
            else:
                # one block of shape[dim] / M x the trailing elements per
                # leading index
                span = math.prod(s.shape[s.dim:])
                c = span // self.M
                lead = s.size // span
                starts.append(off + np.arange(lead, dtype=np.int64) * span
                              + g * c)
                lens.append(np.full(lead, c, np.int64))
            off += s.size
        if not starts:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        st = np.concatenate(starts).astype(np.int64)
        ln = np.concatenate(lens).astype(np.int64)
        # merge runs that continue one another
        new = np.ones(len(st), bool)
        new[1:] = st[1:] != st[:-1] + ln[:-1]
        first = np.flatnonzero(new)
        return st[first], np.add.reduceat(ln, first)


def tp_plan(cfg, template, mesh, rules: Optional[dict] = None
            ) -> Optional[TPPlan]:
    """The plan of ``cfg``'s params over the mesh axes ``"tp"``,
    ``"vocab"`` and ``"experts"`` map to under ``rules`` (the reference's
    ``DEFAULT_RULES`` by default: each to ``"model"``): the blocks of the
    logical axes that map to ``"model"`` are eligible, those that map to
    no axis (``{"tp": ()}``, ``{"vocab": ()}``, ``{"experts": ()}``) stay
    replicated. None when no logical axis maps to a mesh axis, when the
    ``"model"`` extent is 1, or when no block splits. The port splits
    compute over ``"model"`` only: a logical axis on another mesh axis is
    refused."""
    logical = []
    for name in LOGICAL:
        axes = resolve(name, mesh, rules)
        if axes and axes != ("model",):
            raise ValueError(f"{name!r} over the mesh axes {axes}: the port "
                             f"splits compute over 'model' only")
        if axes:
            logical.append(name)
    if not logical or mesh.shape["model"] == 1:
        return None
    plan = TPPlan(cfg, template, mesh.shape["model"], tuple(logical))
    return plan if plan.splits else None
