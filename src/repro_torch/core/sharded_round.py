"""The production federated round of the LM (port of
``repro/core/sharded_round.py``), on one device or over a mesh of ranks.

The reference builds one jitted SPMD program per placement and adds the
sharding hooks of the TPU mesh:

  * ``parallel`` — the cohort is a ``vmap`` whose client axis shards over
    the mesh's data axes;
  * ``sequential`` (>= 10B-param archs) — clients one after another, each
    on the whole mesh, with FSDP-sharded master state and a bf16
    all-gather at each client's compute boundary;
  * ``chunked`` — ``chunk`` clients batched at a time, chunks in turn.

Here ``parallel`` and ``chunked`` take a ``mesh`` (``launch.mesh``): the
cohort's rows split over its ranks, each rank runs its rows and folds
them onto the accumulator the rank before it hands on (``round_program``):
the only cross-client collective, as in the reference. ``sequential`` on
a ``mesh`` runs FSDP over its ranks (``core/fsdp.py``) for every
algorithm: every rank runs every client, each client's batch rows split
over the mesh's data axes, and every parameter-shaped state (the fp32
master, the server optimizer state, SCAFFOLD's server control variate,
the accumulator and the payloads, the broadcast extras, the client
iterate and its moments, the IASG samples and the DP vectors, and the
per-client states in a store made for the layout) is this rank's flat
shard, with one all-gather of the compute-dtype params at each gradient
(MIME takes three a local step). Its round takes and returns the sharded
``ServerState``: the layout (``fsdp_layout``) shards a whole state
(``shard_state``) and gathers it back (``gather_state``), and a store's
rows with ``shard_rows`` / ``gather_rows``. Both stages take the layout,
so ``make_fed_round_split`` runs under FSDP too. FedLoRA's payload codecs
run on the shards as well: the ``lowrank`` factors are summed over the
ranks and each leaf's ``int8`` scale maxed over them (``core/fsdp.py``),
where the reference's ``map_components`` passes the encoded payload by.
Compute is not split over ``model`` (the reference's ``tp_constrain``
computes on tensor-parallel params: ROADMAP.md queue 1, item 10 part 4).
Without a mesh every sharding hook is the identity (the
reference's ``prepare_params``, ``constrain_accum``, ``finalize_params``
and the payload constraint place nothing), so they are left out. Either
way the sequential placement's client wrapper casts the master params to
``compute_dtype`` before the client update: its clients step on params in
the compute dtype, as the reference's do.
The program structure and the client math live in
``round_program``; this module contributes the LM ``grad_fn`` and that
wrapper, for the whole round (``make_fed_round``, one cohort then one
server step) and for the engine's two stages (``make_fed_round_split``).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch.configs.base import FedConfig, ModelConfig
from repro_torch.core import fsdp
from repro_torch.core import tree_math as tm
from repro_torch.core.round_program import (make_cohort_program,
                                            make_round_program,
                                            make_server_program)
from repro_torch.models.model import init_params
from repro_torch.models.steps import lm_grad_fn


def fsdp_layout(cfg: ModelConfig, mesh) -> fsdp.FlatShard:
    """The flat FSDP layout of ``cfg``'s params over ``mesh``'s ranks
    (``core.fsdp.FlatShard``; the params' shapes from the meta device)."""
    return fsdp.FlatShard(init_params(None, cfg, device="meta"), mesh)


def _program_pieces(cfg: ModelConfig, fed: FedConfig, placement: str,
                    compute_dtype, q_chunk: int, remat: str,
                    use_sampling: bool, chunk_size: Optional[int],
                    mesh=None, spmd_axes=None):
    """Shared wiring: ``(grad_fn, round_kwargs)`` for a placement."""
    grad_fn = lm_grad_fn(cfg, compute_dtype=compute_dtype, q_chunk=q_chunk,
                         remat=remat)
    kw = dict(placement=placement, use_sampling=use_sampling)
    if placement in ("parallel", "chunked"):
        return grad_fn, dict(kw, chunk_size=chunk_size, mesh=mesh,
                             spmd_axes=spmd_axes)
    if placement != "sequential":
        raise ValueError(f"unknown placement {placement!r}")
    if mesh is not None:
        kw["fsdp"] = fsdp_layout(cfg, mesh)

    def wrap_client(client_update):
        def cast_client_update(master_params, batches, *extra):
            """One client on the master params cast to the compute dtype
            (the reference's all-gather boundary; under FSDP the cast
            shard, gathered at each local step). ``extra`` — a stateful
            algorithm's client-state slice and the broadcast extras
            (SCAFFOLD's ``c_i`` and ``c``, FedEP's sites) — passes uncast:
            that state stays fp32."""
            return client_update(tm.tcast(master_params, compute_dtype),
                                 batches, *extra)

        return cast_client_update

    return grad_fn, dict(kw, wrap_client=wrap_client)


def make_fed_round(cfg: ModelConfig, fed: FedConfig, *,
                   placement: str = "parallel",
                   compute_dtype=torch.bfloat16, q_chunk: int = 1024,
                   remat: str = "none", use_sampling: bool = True,
                   chunk_size: Optional[int] = None, mesh=None,
                   spmd_axes=None) -> Callable:
    """Build ``round_fn(server_state, client_batches, client_weights=None,
    survivor_mask=None) -> (state, metrics)``; a stateful algorithm's
    round takes and returns its client state as
    ``round_program.make_round_program`` describes, per
    ``fed.client_state_placement``.

    client_batches: ``{"tokens": (C, K, B_local, S+1) int}``, plus
    ``"frontend": (C, K, B_local, F, d)`` for a frontend arch (numpy or
    tensors). ``use_sampling=False`` gives the burn-in-round variant
    (FedAvg regime) of the same FedPA config. ``remat="full"`` recomputes
    each pattern repeat in the backward pass under the round's
    ``vmap(grad)`` (``models.model.recompute``), as the reference's
    default does; the port's default is ``"none"``, since its rounds are
    bound by the host's launches and the recompute adds device ops.
    ``"dots"`` raises (``models.model.forward``). At ``parallel`` and
    ``chunked`` a ``mesh`` splits the cohort's rows over its ranks
    (``client_batches`` are then this rank's rows), over the client axes
    of ``spmd_axes`` when given. At ``sequential`` a ``mesh`` shards the
    round's state over its ranks (the module's docstring):
    ``server_state`` is then this rank's shard (``fsdp_layout(cfg,
    mesh).shard_state``), a stateful algorithm's client states this
    rank's rows (``shard_rows``, or a store made with
    ``make_client_store(..., fsdp=layout)``), ``client_batches`` the
    whole cohort's, and the new state comes back sharded.
    """
    grad_fn, kw = _program_pieces(cfg, fed, placement, compute_dtype,
                                  q_chunk, remat, use_sampling, chunk_size,
                                  mesh, spmd_axes)
    return make_round_program(grad_fn, fed, **kw)


def make_fed_round_split(cfg: ModelConfig, fed: FedConfig, *,
                         placement: str = "parallel",
                         compute_dtype=torch.bfloat16, q_chunk: int = 1024,
                         remat: str = "none", use_sampling: bool = True,
                         chunk_size: Optional[int] = None, mesh=None,
                         spmd_axes=None) -> Tuple[Callable, Callable]:
    """Same wiring as ``make_fed_round``, split into the engine's two
    stages: ``(cohort_fn, server_fn)`` (``round_program``'s
    ``make_cohort_program`` / ``make_server_program``)."""
    grad_fn, kw = _program_pieces(cfg, fed, placement, compute_dtype,
                                  q_chunk, remat, use_sampling, chunk_size,
                                  mesh, spmd_axes)
    return (make_cohort_program(grad_fn, fed, **kw),
            make_server_program(fed, use_sampling=use_sampling,
                                fsdp=kw.get("fsdp")))


def default_placement(cfg: ModelConfig,
                      threshold: int = 10_000_000_000) -> str:
    """parallel for <10B-param archs (one client per data slice fits),
    sequential otherwise."""
    return "parallel" if cfg.param_count() < threshold else "sequential"
