"""Pluggable payload codecs (port of ``repro/compression/base.py``): compress
client payloads before aggregation.

A :class:`PayloadCodec` maps a parameter-shaped tree (a client delta, or a
statistic such as a diagonal precision) to a compact wire form and back.
Codecs compose left to right with ``"+"`` (``"lowrank+int8"`` projects the
matrices onto rank-r factors, then quantizes the factors), and every
**linear** stage must come before every nonlinear one: the linear prefix
defines the *accumulator space* (encoded payloads sum there, so the
sequential and chunked folds stay cheap), while the nonlinear suffix
(quantization) is undone per client before the sum.

The port's client update works on a stack of clients, ``(C, ...)``, where
the reference's runs per client under ``vmap``. So every method that sees
client payloads takes ``like``, the unstacked parameter template: a leaf
with one more axis than its template carries a leading client axis, and
what the reference reads from a client's leaf (the low-rank eligibility
and basis, the quantizer's scale) comes from the per-client shape. With
``like=None`` the tree is one client's, unstacked, and its own template.
Leaves are numbered in JAX's flatten order of the template's key paths
(``jax_leaf_index``), since the sketch of a leaf is keyed by that number.

Under FSDP (``core/fsdp.py``) a payload is this rank's flat shard of the
params' ravel, ``(*lead, n)``, and every :class:`CodecChain` method takes
the layout (``layout=``). The chain then works on *parts*: one entry per
template leaf, in the layout's order, first the leaf's piece on this rank
(``FlatShard.split``, ``(*lead, b - a)``). A linear stage that mixes a
leaf's elements (the ``lowrank`` sketch) turns its pieces into factors
replicated on every rank: each rank's partial factors (``shard_partials``)
are summed over the ranks in one call for every tree the chain encodes
together, then finished (``shard_finish``). A nonlinear stage whose
statistic runs over a leaf (the ``int8`` scale) takes the max over the
ranks of each part's local max (``shard_amax``), in one call, then
quantizes elementwise (``shard_quantize``). Decoding needs no collective:
a factor lifts back to this rank's piece (``shard_decode``), and
``FlatShard.join`` makes the pieces a shard again. Without a layout every
path is the whole-tree one.

The registry mirrors ``algorithms``: codecs register by name, and
``FedConfig.payload_codec`` is parsed against it at config time.
"""
from __future__ import annotations

from typing import Dict, List, Tuple, Type

import torch
from torch.utils import _pytree as pytree

from repro_torch.core import tree_math as tm


def jax_leaf_index(tree) -> List[int]:
    """For each leaf of ``tree`` in the port's flatten order, its index in
    JAX's: JAX sorts dict keys at every level, ``torch.utils._pytree``
    keeps insertion order."""
    paths = []
    for path, _ in pytree.tree_flatten_with_path(tree)[0]:
        keys = []
        for k in path:
            if isinstance(k, pytree.MappingKey):
                keys.append(k.key)
            elif isinstance(k, pytree.SequenceKey):
                keys.append(k.idx)
            else:
                raise TypeError(f"cannot order tree key {k!r} as JAX does")
        paths.append(tuple(keys))
    index = [0] * len(paths)
    for j, i in enumerate(sorted(range(len(paths)), key=paths.__getitem__)):
        index[i] = j
    return index


class PayloadCodec:
    """One compression stage; stateless but for caches, parameterized by the
    FedConfig.

    Subclasses set ``name`` (registry key) and ``linear``. Linear stages
    satisfy ``encode(a*x + b*y) == a*encode(x) + b*encode(y)`` so the round
    accumulator can live in their image; nonlinear stages are undone per
    client before accumulation.
    """

    name: str = "?"
    #: True when encode is linear in the input tree (accumulation-safe)
    linear: bool = False

    def __init__(self, fed):
        """Bind the stage to a ``FedConfig``."""
        self.fed = fed

    def encode(self, tree, round_idx, like=None):
        """Parameter-shaped (or upstream-encoded) tree -> wire form."""
        raise NotImplementedError

    def decode(self, tree, round_idx, like):
        """Inverse of :meth:`encode`; ``like`` is the unstacked template with
        the pre-encode leaf shapes (nonlinear codecs may ignore it)."""
        raise NotImplementedError

    def accum_like(self, tree):
        """A pre-encode-shaped fp32 zeros tree -> encoded-shaped fp32 zeros
        (linear stages only; no sketch is built)."""
        raise NotImplementedError

    def project_precision(self, prec, round_idx, like=None):
        """Push a diagonal precision through the stage's projection;
        identity for stages that keep leaf shapes."""
        del round_idx, like
        return prec

    # -- the sharded forms (parts of an FSDP shard; ``CodecChain``) -----------
    def replicates(self, shape) -> bool:
        """Whether the stage turns a leaf of ``shape`` into a part held
        whole on every rank (a ``lowrank`` factor)."""
        del shape
        return False

    def shard_partials(self, parts, round_idx, layout, precision: bool):
        """A linear stage's fp32 partials, one per part (None for a part
        the stage keeps elementwise), to be summed over the ranks: of the
        encode, or with ``precision`` of ``project_precision``."""
        del round_idx, layout, precision
        return [None] * len(parts)

    def shard_finish(self, parts, summed, layout, precision: bool):
        """The encoded (or projected) parts from the summed partials."""
        del summed, layout, precision
        return parts

    def shard_decode(self, parts, round_idx, layout):
        """Encoded parts -> this rank's pieces."""
        return self.decode(parts, round_idx, None)

    def shard_accum_like(self, parts, layout):
        """fp32 zero pieces -> the stage's encoded fp32 zero parts."""
        del layout
        return parts


_REGISTRY: Dict[str, Type[PayloadCodec]] = {}


def register_codec(name: str, *, override: bool = False):
    """Class decorator: register a codec under ``name`` (sets ``cls.name``).

    Re-registering an existing name raises unless ``override=True``: a
    silent swap would change what every spec using it decodes to.
    """

    def wrap(cls: Type[PayloadCodec]) -> Type[PayloadCodec]:
        if not override and name in _REGISTRY and _REGISTRY[name] is not cls:
            raise ValueError(
                f"codec {name!r} is already registered to "
                f"{_REGISTRY[name]!r}; pass override=True to replace it")
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return wrap


def codec_names() -> Tuple[str, ...]:
    """Sorted names of every registered codec stage."""
    return tuple(sorted(_REGISTRY))


def parse_codec(spec: str) -> Tuple[str, ...]:
    """Split and validate a ``"+"``-composed codec spec.

    Raises ``ValueError`` on unknown stages, on ``"none"`` composed with
    anything, on duplicates, and on a linear stage after a nonlinear one.
    """
    if not isinstance(spec, str) or not spec:
        raise ValueError(f"payload_codec must be a non-empty str, got {spec!r}")
    stages = tuple(s.strip() for s in spec.split("+"))
    for s in stages:
        if s not in _REGISTRY:
            raise ValueError(
                f"unknown payload codec {s!r} in spec {spec!r}; "
                f"registered codecs: {codec_names()}")
    if "none" in stages and len(stages) > 1:
        raise ValueError(f"codec 'none' cannot be composed: {spec!r}")
    if len(set(stages)) != len(stages):
        raise ValueError(f"duplicate codec stage in spec {spec!r}")
    seen_nonlinear = False
    for s in stages:
        if _REGISTRY[s].linear and seen_nonlinear:
            raise ValueError(
                f"linear codec {s!r} after a nonlinear stage in {spec!r}: "
                "linear stages must form a prefix (they define the "
                "accumulator space)")
        seen_nonlinear = seen_nonlinear or not _REGISTRY[s].linear
    return stages


class CodecChain:
    """An ordered codec pipeline split into linear prefix + nonlinear suffix.

    ``encode`` / ``decode`` run the whole pipeline (the client wire form);
    ``to_accum`` undoes only the nonlinear suffix (per client, before the
    sum); ``decode_accum`` undoes only the linear prefix (on the server,
    once per round, on the summed accumulator). Each takes ``layout``, an
    FSDP layout whose shards the trees are (the module's docstring).
    """

    def __init__(self, fed):
        """Build the stages of ``fed.payload_codec``, in order."""
        names = parse_codec(fed.payload_codec)
        self.stages = tuple(_REGISTRY[n](fed) for n in names)
        self.prefix = tuple(s for s in self.stages if s.linear)
        self.suffix = tuple(s for s in self.stages if not s.linear)

    @property
    def is_identity(self) -> bool:
        """True when the chain is a no-op (the ``none`` codec)."""
        return all(s.name == "none" for s in self.stages)

    def _sharded(self, layout) -> bool:
        return layout is not None and not self.is_identity

    def encode(self, tree, round_idx, like=None, layout=None):
        """Whole pipeline: parameter-shaped tree -> wire form."""
        if self._sharded(layout):
            return self._encode_shards([(tree, False)], round_idx, layout,
                                       True)[0]
        for s in self.stages:
            tree = s.encode(tree, round_idx, like)
        return tree

    def encode_payload(self, delta, prec, round_idx, like=None,
                       layout=None):
        """A client's ``(encode(delta), encode_aux(project_precision(
        prec)))``; under a layout both trees share each stage's collective
        (one sum of the sketches' partials, one max of the scales')."""
        if self._sharded(layout):
            return tuple(self._encode_shards(
                [(delta, False), (prec, True)], round_idx, layout, True))
        return (self.encode(delta, round_idx, like),
                self.encode_aux(self.project_precision(prec, round_idx,
                                                       like),
                                round_idx, like))

    def decode(self, tree, round_idx, like, layout=None):
        """Whole inverse pipeline; ``like`` is the unstacked template."""
        if self._sharded(layout):
            for s in reversed(self.stages):
                tree = s.shard_decode(tree, round_idx, layout)
            return layout.join(tree)
        for s in reversed(self.stages):
            tree = s.decode(tree, round_idx, like)
        return tree

    def to_accum(self, tree):
        """Undo the nonlinear suffix only: wire form -> accumulator space."""
        for s in reversed(self.suffix):
            tree = s.decode(tree, None, None)
        return tree

    def encode_aux(self, tree, round_idx, like=None, layout=None):
        """Apply the nonlinear suffix only (for already-projected stats)."""
        if self._sharded(layout):
            return self._suffix_shards([tree], layout)[0]
        for s in self.suffix:
            tree = s.encode(tree, round_idx, like)
        return tree

    def decode_accum(self, tree, round_idx, like, layout=None):
        """Undo the linear prefix: accumulator space -> parameter space."""
        if self._sharded(layout):
            for s in reversed(self.prefix):
                tree = s.shard_decode(tree, round_idx, layout)
            return layout.join(tree)
        for s in reversed(self.prefix):
            tree = s.decode(tree, round_idx, like)
        return tree

    def project_precision(self, prec, round_idx, like=None, layout=None):
        """Parameter-shaped diagonal precision -> accumulator space."""
        if self._sharded(layout):
            return self._encode_shards([(prec, True)], round_idx, layout,
                                       False)[0]
        for s in self.prefix:
            prec = s.project_precision(prec, round_idx, like)
        return prec

    def accum_zeros(self, params, layout=None):
        """Fresh fp32 zeros of the accumulator (linear-prefix image) space
        (under a layout: ``params`` is this rank's shard)."""
        z = tm.tzeros_like(params, torch.float32)
        if self._sharded(layout):
            z = layout.split(z)
            for s in self.prefix:
                z = s.shard_accum_like(z, layout)
            return z
        for s in self.prefix:
            z = s.accum_like(z)
        return z

    # -- under a layout ------------------------------------------------------
    def _encode_shards(self, jobs, round_idx, layout, suffix: bool):
        """``[(shard, precision)]`` -> each shard's encoded parts: split,
        the prefix projected (``precision``: the variance rule) with one
        sum over the ranks per stage for all the jobs, then with
        ``suffix`` the suffix (precisions too: ``encode_aux``)."""
        jobs = [(layout.split(x), prec) for x, prec in jobs]
        for s in self.prefix:
            partials = [s.shard_partials(parts, round_idx, layout, prec)
                        for parts, prec in jobs]
            flat = [p for ps in partials for p in ps if p is not None]
            if flat:
                summed = iter(layout.sum_over_ranks(torch.cat(
                    [p.reshape(-1) for p in flat])).split(
                        [p.numel() for p in flat]))
                partials = [[None if p is None else
                             next(summed).reshape(p.shape) for p in ps]
                            for ps in partials]
            jobs = [(s.shard_finish(parts, ps, layout, prec), prec)
                    for (parts, prec), ps in zip(jobs, partials)]
        parts = [parts for parts, _ in jobs]
        return self._suffix_shards(parts, layout) if suffix else parts

    def _lead_dims(self, parts, layout) -> int:
        """How many leading (client) axes the parts carry."""
        p = layout.leaf_pieces()[0]
        whole = any(s.replicates(p.shape) for s in self.prefix)
        return parts[0].dim() - (len(p.shape) if whole else 1)

    def _suffix_shards(self, jobs, layout):
        """Each job's parts through the nonlinear suffix: per stage, every
        part's local maxima, one max over the ranks for all the jobs, then
        the elementwise encode."""
        for s in self.suffix:
            lead = self._lead_dims(jobs[0], layout)
            amax = [s.shard_amax(parts, lead) for parts in jobs]
            total = layout.max_over_ranks(torch.cat(
                [a.reshape(-1) for a in amax]))
            amax = [t.reshape(a.shape) for t, a in zip(
                total.split([a.numel() for a in amax]), amax)]
            jobs = [s.shard_quantize(parts, a, lead)
                    for parts, a in zip(jobs, amax)]
        return jobs


def build_codec(fed) -> CodecChain:
    """The :class:`CodecChain` selected by ``fed.payload_codec``."""
    return CodecChain(fed)


@register_codec("none")
class IdentityCodec(PayloadCodec):
    """The identity chain: dense payloads, no compression."""

    linear = True

    def encode(self, tree, round_idx, like=None):
        """Identity."""
        del round_idx, like
        return tree

    def decode(self, tree, round_idx, like):
        """Identity."""
        del round_idx, like
        return tree

    def accum_like(self, tree):
        """Identity (the tree is already fp32 zeros)."""
        return tree
