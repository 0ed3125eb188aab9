"""Configs of the port (from ``repro/configs/base.py``): ``FedConfig``, the
LM's ``LayerSpec``, ``MoEConfig`` and ``ModelConfig``, and the logical
process mesh ``MeshConfig`` (``SINGLE_POD``, ``MULTI_POD``).

Same field names, defaults and eager validation as the JAX package, so the
two accept and reject the same keyword arguments; every mixer, FFN and
frontend of the JAX package builds. Paths that are not ported yet raise
``NotImplementedError`` where they are asked for, naming the ``ROADMAP.md``
item (queue 1) that will port them (``_not_ported``); they are never
silently ignored. ``ShapeConfig`` is not ported (item 12).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch

from repro_torch.algorithms import get_algorithm
from repro_torch.compression.base import parse_codec
from repro_torch.optim import get_optimizer

#: Client-state placements the JAX engine knows (``core.client_state.STORES``).
STATE_PLACEMENTS = ("host", "device")

#: Mixer kinds the pattern decoder understands.
MIXERS = ("attn", "swa", "mlstm", "slstm", "rglru")
#: FFN kinds.
FFNS = ("dense", "moe", "none")


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md queue 1, "
        f"item {item})")


@dataclass(frozen=True)
class LayerSpec:
    """One decoder layer: a sequence mixer followed by an (optional) FFN."""

    mixer: str = "attn"          # one of MIXERS
    ffn: str = "dense"           # one of FFNS
    window: int = 0              # sliding-window size; only used by mixer="swa"

    def __post_init__(self):
        """Reject unknown mixer/ffn names and window-less swa layers."""
        if self.mixer not in MIXERS:
            raise ValueError(f"unknown mixer {self.mixer!r}")
        if self.ffn not in FFNS:
            raise ValueError(f"unknown ffn {self.ffn!r}")
        if self.mixer == "swa" and self.window <= 0:
            raise ValueError("swa mixer requires window > 0")


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN configuration (GShard-style one-hot dispatch,
    or sort-based routing with ``routing="sort"``)."""

    num_experts: int = 0
    top_k: int = 1
    expert_d_ff: int = 0
    shared_expert_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 1e-2
    chunk_tokens: int = 8192
    routing: str = "onehot"

    @property
    def enabled(self) -> bool:
        """True when this config actually routes through experts."""
        return self.num_experts > 0


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description for the pattern decoder: ``pattern`` of
    layers repeated ``repeats`` times, then ``tail``. Fields as in the JAX
    package."""

    name: str
    arch_type: str                 # dense | moe | ssm | hybrid | audio | vlm
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    pattern: Tuple[LayerSpec, ...]
    repeats: int
    tail: Tuple[LayerSpec, ...] = ()
    head_dim: int = 0              # 0 -> d_model // num_heads
    moe: MoEConfig = field(default_factory=MoEConfig)
    qk_norm: bool = False
    norm_eps: float = 1e-6
    rope_theta: float = 10_000.0
    tie_embeddings: bool = True
    frontend: Optional[str] = None
    frontend_tokens: int = 0
    supports_long_decode: bool = False
    tp_out_constraint: bool = False
    conv_width: int = 4
    lru_d: int = 0
    expansion: float = 2.0
    citation: str = ""

    def __post_init__(self):
        """Derive head_dim and check head/layer-count consistency as the JAX
        package does."""
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_heads % self.num_kv_heads != 0:
            raise ValueError("num_heads must be divisible by num_kv_heads")
        if len(self.layers()) != self.num_layers:
            raise ValueError(
                f"{self.name}: pattern({len(self.pattern)})x{self.repeats}"
                f"+tail({len(self.tail)}) != derived num_layers"
            )

    @property
    def num_layers(self) -> int:
        """Total decoder layers: pattern x repeats + tail."""
        return len(self.pattern) * self.repeats + len(self.tail)

    def layers(self) -> Tuple[LayerSpec, ...]:
        """The concrete per-layer spec sequence (pattern unrolled + tail)."""
        return self.pattern * self.repeats + self.tail

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 128 (the JAX package's layout)."""
        return _round_up(self.vocab_size, 128)

    @property
    def q_dim(self) -> int:
        """Query projection width (num_heads x head_dim)."""
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        """Key/value projection width (num_kv_heads x head_dim)."""
        return self.num_kv_heads * self.head_dim

    @property
    def lru_width(self) -> int:
        """RG-LRU recurrent width (lru_d, defaulting to d_model)."""
        return self.lru_d or self.d_model

    def param_count(self) -> int:
        """Exact parameter count from the shapes ``init_params`` makes on the
        meta device (no allocation; late import avoids a configs<->models
        cycle)."""
        from repro_torch.models.model import count_params  # noqa: PLC0415
        return count_params(self)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts) — the N in the
        6ND MODEL_FLOPS roofline term."""
        if not self.moe.enabled:
            return self.param_count()
        m = self.moe
        n_moe_layers = sum(1 for s in self.layers() if s.ffn == "moe")
        inactive = (n_moe_layers * (m.num_experts - m.top_k) * 3
                    * self.d_model * m.expert_d_ff)
        return self.param_count() - inactive


def replace(cfg, **kw):
    """dataclasses.replace re-export for convenience."""
    return dataclasses.replace(cfg, **kw)


@dataclass(frozen=True)
class FedConfig:
    """One federated round = ``clients_per_round`` clients x ``local_steps``.

    Field meanings are those of ``repro.configs.base.FedConfig``.
    """

    algorithm: str = "fedpa"
    clients_per_round: int = 16
    local_steps: int = 8
    burn_in_steps: int = 4
    steps_per_sample: int = 2
    shrinkage_rho: float = 0.1
    server_opt: str = "sgdm"
    server_lr: float = 0.5
    server_momentum: float = 0.9
    client_opt: str = "sgdm"
    client_lr: float = 0.01
    client_momentum: float = 0.9
    burn_in_rounds: int = 0
    delta_dtype: str = "float32"
    payload_codec: str = "none"
    lora_rank: int = 4
    quant_bits: int = 8
    error_feedback: bool = True
    streaming_dp: bool = False
    mime_beta: float = 0.9
    fedprox_mu: float = 0.1
    scaffold_c_scale: float = 1.0
    fedep_damping: float = 0.5
    qffl_q: float = 0.0
    round_placement: str = "parallel"
    round_chunk_size: int = 0
    async_rounds: bool = False
    max_staleness: int = 1
    staleness_discount: float = 1.0
    prefetch_rounds: int = 0
    prefetch_backend: str = "process"
    availability: str = "always"
    availability_period: int = 24
    availability_duty: float = 0.5
    dropout_rate: float = 0.0
    straggler_rate: float = 0.0
    straggler_max_lateness: int = 2
    min_local_steps: int = 0
    client_state_placement: str = "host"

    def __post_init__(self):
        """Validate as the JAX package does (``ValueError``): every
        registered algorithm and codec of the reference is ported."""
        if self.round_placement not in ("parallel", "sequential", "chunked"):
            raise ValueError(
                f"unknown round_placement {self.round_placement!r}")
        if self.client_state_placement not in STATE_PLACEMENTS:
            raise ValueError(
                f"unknown client_state_placement "
                f"{self.client_state_placement!r}; known: {STATE_PLACEMENTS}")
        if self.round_chunk_size < 0:
            raise ValueError("round_chunk_size must be >= 0")
        if self.max_staleness < 0:
            raise ValueError("max_staleness must be >= 0")
        if not 0.0 <= self.staleness_discount <= 1.0:
            raise ValueError("staleness_discount must be in [0, 1]")
        if self.prefetch_rounds < 0:
            raise ValueError("prefetch_rounds must be >= 0")
        if self.prefetch_backend not in ("process", "thread"):
            raise ValueError(
                f"unknown prefetch_backend {self.prefetch_backend!r}; "
                f"known: ('process', 'thread')")
        self._validate_round()
        self._validate_faults()
        self._validate_payload()
        get_algorithm(self).validate()

    def _validate_round(self):
        """Range-check the round shape and both optimizer stacks by name."""
        if self.clients_per_round < 1:
            raise ValueError(
                f"clients_per_round must be >= 1, got "
                f"{self.clients_per_round}")
        if self.burn_in_rounds < 0:
            raise ValueError(
                f"burn_in_rounds must be >= 0, got {self.burn_in_rounds}")
        if not 0.0 < self.shrinkage_rho <= 1.0:
            raise ValueError(
                f"shrinkage_rho must be in (0, 1] (Theorem 3's shrinkage "
                f"coefficient; 0 divides by zero in the DP recursion), got "
                f"{self.shrinkage_rho}")
        if self.server_lr <= 0:
            raise ValueError(f"server_lr must be > 0, got {self.server_lr}")
        if self.client_lr <= 0:
            raise ValueError(f"client_lr must be > 0, got {self.client_lr}")
        if not 0.0 <= self.server_momentum <= 1.0:
            raise ValueError(
                f"server_momentum must be in [0, 1], got "
                f"{self.server_momentum}")
        if not 0.0 <= self.client_momentum <= 1.0:
            raise ValueError(
                f"client_momentum must be in [0, 1], got "
                f"{self.client_momentum}")
        if not (isinstance(self.qffl_q, (int, float))
                and math.isfinite(self.qffl_q) and self.qffl_q >= 0.0):
            raise ValueError(
                f"qffl_q must be a finite float >= 0 (q-FFL's fairness "
                f"exponent; 0 disables the loss tilt), got {self.qffl_q!r}")
        if not isinstance(self.error_feedback, bool):
            raise ValueError(
                f"error_feedback must be a bool (it gates the residual "
                f"slot in the client store), got {self.error_feedback!r}")
        try:
            get_optimizer(self.server_opt, self.server_lr,
                          self.server_momentum)
            get_optimizer(self.client_opt, self.client_lr,
                          self.client_momentum)
        except KeyError as e:
            raise ValueError(str(e)) from e

    def _validate_payload(self):
        """``delta_dtype`` must name a torch floating dtype; the codec spec
        is parsed against the codec registry and the codec knobs are
        range-checked, as the reference does."""
        dt = getattr(torch, str(self.delta_dtype), None)
        if not isinstance(dt, torch.dtype):
            raise ValueError(
                f"unknown delta_dtype {self.delta_dtype!r}: not a torch "
                f"dtype name")
        if not dt.is_floating_point:
            raise ValueError(
                f"delta_dtype must be a floating dtype (it carries deltas "
                f"and posterior statistics), got {self.delta_dtype!r}")
        parse_codec(self.payload_codec)
        if self.lora_rank < 1:
            raise ValueError(f"lora_rank must be >= 1, got {self.lora_rank}")
        if self.quant_bits not in (8, 16):
            raise ValueError(
                f"quant_bits must be 8 or 16, got {self.quant_bits}")

    def _validate_faults(self):
        """Range-check the fault-injection knobs."""
        if self.availability not in ("always", "diurnal"):
            raise ValueError(
                f"unknown availability {self.availability!r}; "
                f"known: ('always', 'diurnal')")
        if self.availability_period <= 0:
            raise ValueError("availability_period must be >= 1")
        if not 0.0 < self.availability_duty <= 1.0:
            raise ValueError("availability_duty must be in (0, 1]")
        if not 0.0 <= self.dropout_rate <= 1.0:
            raise ValueError("dropout_rate must be in [0, 1]")
        if not 0.0 <= self.straggler_rate <= 1.0:
            raise ValueError("straggler_rate must be in [0, 1]")
        if self.straggler_rate > 0 and not self.async_rounds:
            raise ValueError(
                "straggler_rate > 0 requires async_rounds=True: a straggling "
                "cohort is handed to the async engine as an extra-stale "
                "delta; the synchronous engine has no late-application path")
        if self.straggler_max_lateness < 1:
            raise ValueError("straggler_max_lateness must be >= 1")
        if self.min_local_steps < 0 or self.min_local_steps > self.local_steps:
            raise ValueError(
                f"min_local_steps must be in [0, local_steps="
                f"{self.local_steps}], got {self.min_local_steps}")
        if self.min_local_steps and self.client_opt != "sgd":
            raise ValueError(
                "min_local_steps > 0 freezes a client's idle steps by "
                "masking gradients, which is exact only under plain "
                f"client_opt='sgd' (got {self.client_opt!r}: a stateful "
                "optimizer would keep moving the params from its buffers)")

    @property
    def num_samples(self) -> int:
        """l: posterior samples per client per round (one per IASG window);
        0 for algorithms without a sampling phase."""
        return get_algorithm(self).num_samples


@dataclass(frozen=True)
class MeshConfig:
    """Logical mesh: per-axis extents and their axis names (``launch.mesh``
    lays it over the ranks of a process group)."""

    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")

    @property
    def num_devices(self) -> int:
        """Total devices (ranks) in the mesh: the product of the extents."""
        return math.prod(self.shape)

    @property
    def data_extent(self) -> int:
        """Total client-parallel extent (pod x data)."""
        n = 1
        for ax, s in zip(self.axes, self.shape):
            if ax in ("pod", "data"):
                n *= s
        return n

    @property
    def model_extent(self) -> int:
        """Extent of the "model" axis (1 if the mesh has none)."""
        for ax, s in zip(self.axes, self.shape):
            if ax == "model":
                return s
        return 1


SINGLE_POD = MeshConfig((16, 16), ("data", "model"))
MULTI_POD = MeshConfig((2, 16, 16), ("pod", "data", "model"))
