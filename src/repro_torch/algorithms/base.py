"""The ``FedAlgorithm`` strategy API of the port (from
``repro/algorithms/base.py``): one class per federated algorithm, resolved
by name through a registry.

The hooks are the reference's, with the client axis written out: the
client update takes the server params, the cohort's ``(C, K, ...)``
batches and the broadcast extras, and returns a ``ClientResult`` whose
payload and metrics carry a leading client axis (the reference ``vmap``s
a per-client update instead; a raw CUDA kernel has no batching rule). The
round program calls it on the whole cohort (``parallel``), on one client
at a time (``sequential``, C = 1) or on one chunk at a time (``chunked``).

*Stateful* algorithms (``stateful = True``: SCAFFOLD's control variates,
FedEP's sites) take one more argument and fill one more field:
``update(params, batches, client_states, *extras) -> ClientResult(payload,
metrics, state_update)``. The reference's update is per client under
``vmap``; the port's is per stack, so ``client_states`` is the stack's
``(C, ...)`` slice of the per-client store (``core/client_state.py``) and
``state_update`` the stack's ``(C, ...)`` new states.

Aggregation lives in a linear fp32 accumulator space: ``accumulate`` folds
one client, ``reduce_stacked`` folds a stack client by client in cohort
order, ``payload_accum`` maps a payload into the space, and ``finalize``
casts once. Every placement folds the cohort's clients in cohort order, so
all three sum the same terms in the same order, and a cohort split over
ranks (``core/round_program.py``) hands the accumulator from rank to rank
in that order: the sharded sum is the one-process sum, bit for bit. Every
payload map is elementwise, so it applies to a stacked payload as it is.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple, Type

import torch

from repro_torch.core import server as server_lib
from repro_torch.core import tree_math as tm
from repro_torch.optim import Optimizer


class ClientResult(NamedTuple):
    """What a cohort sends back: ``payload`` (a tree with a leading client
    axis), ``metrics`` (``loss_first`` / ``loss_last``, each ``(C,)``) and,
    for a stateful algorithm, ``state_update``: the stack's new persistent
    per-client states, ``(C, ...)`` (``None`` when stateless)."""

    payload: Any
    metrics: Dict[str, Any]
    state_update: Any = None


_REGISTRY: Dict[str, Type["FedAlgorithm"]] = {}


def register_algorithm(name: str, *,
                       override: bool = False) -> Callable[[type], type]:
    """Class decorator: register a :class:`FedAlgorithm` under ``name``;
    re-registering a name raises unless ``override=True``."""

    def deco(cls: type) -> type:
        if not (isinstance(cls, type) and issubclass(cls, FedAlgorithm)):
            raise TypeError(f"{cls!r} must subclass FedAlgorithm")
        if not override and name in _REGISTRY and _REGISTRY[name] is not cls:
            raise ValueError(
                f"algorithm {name!r} is already registered to "
                f"{_REGISTRY[name]!r}; pass override=True to replace it")
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def algorithm_names() -> Tuple[str, ...]:
    """Sorted names of every registered algorithm."""
    return tuple(sorted(_REGISTRY))


def get_algorithm_class(name: str) -> Type["FedAlgorithm"]:
    """Look up a registered algorithm class by name (ValueError if absent)."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown algorithm {name!r}; registered: {algorithm_names()}"
        ) from None


def get_algorithm(fed) -> "FedAlgorithm":
    """Instantiate the registered algorithm for ``fed.algorithm``."""
    return get_algorithm_class(fed.algorithm)(fed)


def resolve_algorithm(fed, use_sampling: bool = True) -> "FedAlgorithm":
    """The registered algorithm, or its burn-in regime when
    ``use_sampling=False``."""
    alg = get_algorithm(fed)
    return alg if use_sampling else alg.burn_algorithm()


def phase_name(fed, round_idx: int) -> str:
    """Display name for round ``round_idx``, e.g. ``"fedavg (burn-in)"``."""
    alg = get_algorithm(fed)
    if round_idx < fed.burn_in_rounds and alg.has_burn_regime:
        return f"{alg.burn_algorithm().name} (burn-in)"
    return alg.name


class FedAlgorithm:
    """Base class: subclasses implement :meth:`make_client_update`; the
    rest defaults to the weighted-mean-delta template."""

    name: str = "?"
    supports_streaming_dp: bool = False
    has_burn_regime: bool = False
    supports_step_budgets: bool = False
    supports_codec: bool = False
    #: Whether clients carry persistent per-client state; a stateful update
    #: takes the stack's state slice and returns ``state_update``.
    stateful: bool = False
    #: The Sherman-Morrison step of an algorithm that runs the DP:
    #: ``kernels.ops.dp_step`` when None; an FSDP round sets the sharded
    #: step before it builds the client update (``core/fsdp.py``).
    dp_step = None

    def __init__(self, fed):
        """Bind the algorithm to a ``FedConfig`` (stored as ``self.fed``)."""
        self.fed = fed
        self.delta_dtype = getattr(torch, fed.delta_dtype)

    def validate(self) -> None:
        """Eager config checks (``ValueError``), as the reference's."""
        if self.fed.streaming_dp and not self.supports_streaming_dp:
            raise ValueError(
                f"streaming_dp=True requires algorithm='fedpa' (the online "
                f"DP of Appendix C); {self.fed.algorithm!r} has no streaming "
                f"client — it would be silently ignored")
        if self.fed.min_local_steps and not self.supports_step_budgets:
            raise ValueError(
                f"min_local_steps > 0 (heterogeneous local-step budgets) is "
                f"not supported by algorithm {self.fed.algorithm!r}")
        if self.fed.payload_codec != "none" and not self.supports_codec:
            raise ValueError(
                f"payload_codec={self.fed.payload_codec!r} requires an "
                f"algorithm with compressed payloads (algorithm='fedlora'); "
                f"{self.fed.algorithm!r} ships dense payloads and would "
                f"silently ignore the codec")

    @property
    def num_samples(self) -> int:
        """Posterior samples per client per round (0 for non-sampling)."""
        return 0

    def burn_algorithm(self) -> "FedAlgorithm":
        """Algorithm run during the first ``fed.burn_in_rounds`` rounds."""
        return self

    @property
    def burns_in(self) -> bool:
        """Whether the first ``fed.burn_in_rounds`` rounds run a burn-in
        regime of their own (:meth:`burn_algorithm`)."""
        return self.has_burn_regime and self.fed.burn_in_rounds > 0

    @property
    def burn_stateful(self) -> bool:
        """Whether the burn-in rounds carry per-client state. FedEP burns
        in as stateless FedAvg; without a burn-in regime of their own they
        run this algorithm."""
        return (self.burn_algorithm() if self.burns_in else self).stateful

    # -- persistent state ----------------------------------------------------
    def init_client_state(self, params):
        """One client's zero persistent state (consulted only when
        ``stateful``); the store stacks it into its ``(N, ...)`` buffers."""
        del params
        return ()

    def init_algo_state(self, params):
        """Persistent server-side state (``ServerState.algo_state``), ``()``
        by default; checkpointed with the server state and updated, where
        an algorithm has one, by its ``server_update``."""
        del params
        return ()

    def broadcast(self, state, server_opt: Optimizer) -> tuple:
        """Server statistics shipped to every client with the params; they
        become trailing arguments of the client update, unstacked (the
        same for the whole cohort). Default: none."""
        del state, server_opt
        return ()

    def make_client_update(self, grad_fn: Callable,
                           client_opt: Optimizer) -> Callable:
        """Build ``update(params, batches, *extras) -> ClientResult`` for a
        cohort.

        ``params`` is the server's (unstacked) tree; ``batches`` carry
        ``(C, K, ...)``; ``grad_fn`` is batched over the client axis;
        ``extras`` are :meth:`broadcast`'s. A stateful update takes the
        stack's ``(C, ...)`` state slice after ``batches``.
        """
        raise NotImplementedError

    # -- aggregation (accumulator space) ------------------------------------
    def init_accum(self, params):
        """Zero element of the accumulator space: fp32 whatever
        ``fed.delta_dtype`` is, so the sequential and chunked folds never
        round in a low precision; :meth:`finalize` casts once."""
        return tm.tzeros_like(params, torch.float32)

    def payload_accum(self, payload):
        """Map a payload (one client's, or stacked) into the accumulator
        space (the linear part; anything nonlinear belongs in
        :meth:`finalize`)."""
        return payload

    def accumulate(self, acc, payload, weight):
        """Fold one client into the accumulator: ``acc + w * accum(p)``,
        the product formed in fp32."""
        return tm.tmap(lambda a, d: a + weight * d.to(a.dtype),
                       acc, self.payload_accum(payload))

    def reduce_stacked(self, stacked_payloads, weights, acc=None):
        """``acc`` (fp32 zeros when None) plus the weighted sum of a stack
        of payloads, folded client by client in stack order with
        :meth:`accumulate`; :meth:`finalize` owns the single cast."""
        for k in range(weights.shape[0]):
            row = tm.tmap(lambda x, k=k: x[k], stacked_payloads)
            if acc is None:
                acc = tm.tmap(
                    lambda x: torch.zeros_like(x, dtype=torch.float32),
                    self.payload_accum(row))
            acc = self.accumulate(acc, row, weights[k])
        return acc

    def finalize(self, agg):
        """Accumulator -> pseudo-gradient: the single cast out of fp32."""
        return tm.tcast(agg, self.delta_dtype)

    def finish_cohort(self, state, agg):
        """Epilogue on the summed accumulator, once per round, before it
        leaves the cohort stage. Default: identity."""
        del state
        return agg

    def map_components(self, fn: Callable, obj):
        """Apply ``fn`` to each parameter-shaped component of a payload or
        accumulator. Default: the object is one parameter-shaped tree."""
        return fn(obj)

    # -- communicated-bytes accounting --------------------------------------
    def abstract_payload(self, params):
        """One client's uplink payload as meta-device tensors (shapes and
        dtypes, no allocation; ``compression.accounting.round_bytes``)."""
        return tm.tmap(lambda p: torch.empty(p.shape, dtype=self.delta_dtype,
                                             device="meta"), params)

    def abstract_broadcast_extras(self, params):
        """Downlink extras beyond the params (:meth:`broadcast`) as
        meta-device tensors. Default: none."""
        del params
        return ()

    # -- server ------------------------------------------------------------
    def server_update(self, state, agg, server_opt: Optimizer,
                      discount=None):
        """Finalize the aggregate and take one server-optimizer step.

        ``discount`` (the async engine's ``staleness_discount ** s``; the
        synchronous round passes None) scales the pseudo-gradient in fp32
        and casts back.
        """
        pseudo_grad = self.finalize(agg)
        if discount is not None:
            d = float(discount)
            pseudo_grad = tm.tmap(
                lambda x: (d * x.to(torch.float32)).to(x.dtype), pseudo_grad)
        return server_lib.server_update(state, pseudo_grad, server_opt)
