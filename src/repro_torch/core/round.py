"""Single-process federated simulation of the port (from
``repro/core/round.py``).

``FedSim`` resolves a ``FedConfig`` into the ``make_cohort_program`` /
``make_server_program`` stages, for the sampling regime and, with
``burn_in_rounds``, the burn-in regime, and hands them to the one
staleness-general ``RoundEngine``:

  * synchronous (default): an in-flight window of 1;
  * async (``fed.async_rounds=True``): up to ``fed.max_staleness`` cohorts
    in flight beyond the one being applied, deltas down-weighted by
    ``staleness_discount ** staleness`` (straggler lateness adds to the
    exponent); ``max_staleness=0`` is the synchronous path.

Cohorts come from the fault-injecting ``CohortSource`` (availability,
dropout, stragglers, step budgets), which samples client ids and stacks
their numpy batches on the host, inline or ``fed.prefetch_rounds`` ahead
on a prefetcher (``data/prefetch.py``); the rounds run on ``device`` in
the configured placement. A stateful algorithm (SCAFFOLD, FedEP) gets a
per-client store (``core/client_state.py``) placed per
``fed.client_state_placement``: host numpy buffers, or tensors on
``device``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.algorithms import get_algorithm
from repro_torch.compression.accounting import round_bytes
from repro_torch.configs.base import FedConfig
from repro_torch.core import tree_math as tm
from repro_torch.core.client_state import make_client_store
from repro_torch.core.engine import RoundEngine
from repro_torch.core.round_program import (make_cohort_program,
                                            make_server_program)
from repro_torch.core.server import ServerState, init_server_state
from repro_torch.data.cohort_source import CohortSource
from repro_torch.data.prefetch import Cohort, stack_host
from repro_torch.optim import get_optimizer


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else ``cuda``; with no GPU and no explicit
    device this raises — the port never falls back to the CPU silently."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: repro_torch runs on the GPU unless the caller "
            "passes device='cpu'")
    return torch.device("cuda")


@dataclasses.dataclass(frozen=True)
class StackCohort:
    """``CohortSource``'s batch builder for ``FedSim``: each client's
    ``batch_fn(client_id, round_idx, local_steps)`` stacked on the host. A
    plain object, so it pickles (to a spawned prefetch child) exactly when
    ``batch_fn`` does."""

    batch_fn: Callable
    local_steps: int

    def __call__(self, client_ids, round_idx: int):
        """The cohort's batches with a leading client axis."""
        return stack_host([self.batch_fn(int(cid), round_idx,
                                         self.local_steps)
                           for cid in client_ids])


@dataclasses.dataclass
class FedSim:
    """Generic federated simulation on one device.

    ``batch_fn(client_id, round_idx, num_steps)`` -> batch tree with a
    leading step axis (numpy leaves); ``grad_fn(params, batch) -> (loss,
    grads)`` for ONE client, written with ``torch.func`` so the round can
    ``vmap`` it over the cohort. ``params`` are a dict of tensors (or one
    tensor). ``device`` defaults to ``cuda`` and raises without a GPU.
    ``placement`` / ``chunk_size`` override ``fed.round_placement`` /
    ``fed.round_chunk_size``: the round math is the same in all three
    placements, only the stacks of clients the kernels see differ.
    """

    fed: FedConfig
    grad_fn: Callable
    batch_fn: Callable
    num_clients: int
    client_weights: Optional[np.ndarray] = None
    seed: int = 0
    device: Optional[object] = None
    placement: Optional[str] = None
    chunk_size: Optional[int] = None

    def __post_init__(self):
        """Resolve the device, the cohort source, the optimizers, the
        algorithm."""
        self.device = resolve_device(self.device)
        self.stack_cohort = StackCohort(self.batch_fn, self.fed.local_steps)
        self.source = CohortSource(self.fed, self.num_clients,
                                   self.stack_cohort, self.client_weights,
                                   self.seed)
        # ClientSampler API parity (the source draws on its stream)
        self.sampler = self.source.sampler
        self.server_opt = get_optimizer(self.fed.server_opt,
                                        self.fed.server_lr,
                                        self.fed.server_momentum)
        self._alg = get_algorithm(self.fed)
        self._has_burn_regime = self._alg.burns_in
        self.client_store = (
            make_client_store(self.fed.client_state_placement,
                              self.num_clients, device=self.device)
            if self._alg.stateful or self._alg.burn_stateful else None)
        self._engine: Optional[RoundEngine] = None
        self._round_bytes: Optional[dict] = None
        self._burn_round_bytes: Optional[dict] = None

    def init(self, params) -> ServerState:
        """Fresh server state with ``params`` moved to the device (and, for
        a stateful algorithm, a zeroed client store: each ``run`` starts
        from scratch)."""
        params = tm.tmap(lambda x: torch.as_tensor(x).to(self.device), params)
        if self.client_store is not None:
            self.client_store.ensure(
                self._alg.init_client_state(params)).reset()
        self._round_bytes = round_bytes(self.fed, params, use_sampling=True)
        self._burn_round_bytes = (
            round_bytes(self.fed, params, use_sampling=False)
            if self._has_burn_regime else self._round_bytes)
        return init_server_state(params, self.server_opt,
                                 algorithm=self._alg)

    def cohort(self, round_idx: int) -> Cohort:
        """Sample and materialize one round's inputs, with its fault
        annotations (``CohortSource.cohort``)."""
        return self.source.cohort(round_idx)

    def round(self, state: ServerState, round_idx: int,
              cohort: Optional[Cohort] = None):
        """One synchronous round; returns ``(state, record)``."""
        cohort = cohort if cohort is not None else self.cohort(round_idx)
        return self.engine.round(state, cohort, round_idx)

    def run(self, params, num_rounds: int,
            eval_fn: Optional[Callable] = None, eval_every: int = 1):
        """Drive ``num_rounds`` rounds from fresh state (sync or async per
        ``fed.async_rounds``); returns ``(final_state, history)``. The
        cohorts are built by ``self.source.cohort``, which pickles when
        ``batch_fn`` does (``prefetch_backend="process"``)."""
        state = self.init(params)
        return self.engine.run(state, self.source.cohort, num_rounds,
                               eval_fn=eval_fn, eval_every=eval_every)

    @property
    def engine(self) -> RoundEngine:
        """Built once, after ``init`` has seen a params template for the
        byte accounting."""
        if self._engine is None:
            self._engine = self._build_engine()
        return self._engine

    def _build_engine(self) -> RoundEngine:
        def split(use_sampling: bool):
            # a burn regime may aggregate in another payload space
            # (fedpa_precision burns in as fedavg): its own server stage
            return (make_cohort_program(self.grad_fn, self.fed,
                                        placement=self.placement,
                                        chunk_size=self.chunk_size,
                                        use_sampling=use_sampling,
                                        server_opt=self.server_opt),
                    make_server_program(self.fed, server_opt=self.server_opt,
                                        use_sampling=use_sampling))

        cohort_fn, server_fn = split(use_sampling=True)
        burn_cohort_fn = burn_server_fn = None
        if self._has_burn_regime:
            burn_cohort_fn, burn_server_fn = split(use_sampling=False)
        fed = self.fed
        return RoundEngine(
            cohort_fn=cohort_fn,
            server_fn=server_fn,
            burn_cohort_fn=burn_cohort_fn,
            burn_server_fn=burn_server_fn,
            burn_in_rounds=fed.burn_in_rounds,
            max_staleness=fed.max_staleness if fed.async_rounds else 0,
            staleness_discount=fed.staleness_discount,
            prefetch_rounds=fed.prefetch_rounds,
            prefetch_backend=fed.prefetch_backend,
            round_bytes=self._round_bytes,
            burn_round_bytes=self._burn_round_bytes,
            client_store=self.client_store,
            stateful=self._alg.stateful,
            burn_stateful=self._alg.burn_stateful)
