"""The ``FedAlgorithm`` strategy API of the port (from
``repro/algorithms/base.py``): one class per federated algorithm, resolved
by name through a registry.

The hooks are the reference's, with the client axis written out: the
client update takes the server params and the cohort's ``(C, K, ...)``
batches and returns a ``ClientResult`` whose payload and metrics carry a
leading client axis (the reference ``vmap``s a per-client update instead;
a raw CUDA kernel has no batching rule). Aggregation reduces in fp32
(``reduce_stacked``) and casts once (``finalize``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple, Type

import torch

from repro_torch.core import server as server_lib
from repro_torch.core import tree_math as tm
from repro_torch.optim import Optimizer


class ClientResult(NamedTuple):
    """What a cohort sends back: ``payload`` (a tree with a leading client
    axis) and ``metrics`` (``loss_first`` / ``loss_last``, each ``(C,)``)."""

    payload: Any
    metrics: Dict[str, Any]


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

    def make_client_update(self, grad_fn: Callable,
                           client_opt: Optimizer) -> Callable:
        """Build ``update(params, batches) -> ClientResult`` for a cohort.

        ``params`` is the server's (unstacked) tree; ``batches`` carry
        ``(C, K, ...)``; ``grad_fn`` is batched over the client axis.
        """
        raise NotImplementedError

    def reduce_stacked(self, stacked_payloads, weights):
        """Weighted sum of the cohort's payloads in fp32 (the accumulator);
        :meth:`finalize` owns the single cast."""
        return server_lib.weighted_sum(stacked_payloads, weights, cast=False)

    def finalize(self, agg):
        """Accumulator -> pseudo-gradient: the single cast out of fp32."""
        return tm.tcast(agg, self.delta_dtype)

    def server_update(self, state, agg, server_opt: Optimizer):
        """Finalize the aggregate and take one server-optimizer step."""
        return server_lib.server_update(state, self.finalize(agg), server_opt)
