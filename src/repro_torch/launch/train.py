"""Federated LM training entry point (port of ``repro/launch/train.py``), on
one device or on several processes, one device each.

  PYTHONPATH=src python -m repro_torch.launch.train --arch fedlm-100m \\
      --smoke --rounds 20 --algorithm fedpa --device cpu

Runs federated rounds of the selected architecture on ``cuda`` unless
``--device cpu`` is given, and raises without a GPU. The flags are the
reference's, plus ``--device``. Each round prints one JSON record with the
reference's keys. The weights are random, drawn on the CPU from ``--seed``
(so every device starts from the same ones) and moved to the device in
fp32; the local steps compute in bf16. On the card the DP steps of FedPA,
``fedpa_precision``, FedEP and FedLoRA run through the CUDA kernels
``dp_reduce`` / ``dp_map``.

``--algorithm fedlora`` ships its payloads through ``--payload-codec``
(``lowrank`` rank-``--lora-rank`` factors, ``int8`` quantization of
``--quant-bits``, or both) and keeps an error-feedback residual per client
unless ``--no-error-feedback``; each record's ``bytes_up`` /
``bytes_down`` are the round's wire bytes (``compression.round_bytes``).

The stateful algorithms (``--algorithm scaffold`` with ``--client-opt
sgd``, ``--algorithm fedep``, ``--algorithm fedlora``) keep per-client
state in a store placed by ``--client-state-placement``: host numpy
buffers, or tensors on the device. ``--ckpt-dir`` checkpoints every
``--ckpt-every`` rounds and at the last one, in the reference's npz format
(``{"server", "clients"}`` for a stateful algorithm, the bare server state
otherwise); a run whose directory holds a checkpoint resumes from it
("restored checkpoint at round N"). Each package reads the other's
checkpoints.

``--async-rounds`` widens the engine's in-flight window to
``--max-staleness + 1`` cohorts, each delta discounted by
``--staleness-discount ** staleness``; ``--straggler-rate`` adds late
cohorts (async only). Cohorts are built ``--prefetch-rounds`` ahead
(default 2) by a spawned child process (``--prefetch-backend process``,
the default) or a thread; prefetching changes no number, only when
cohorts are built.

Every arch trains: a frontend arch's batches carry the stub frontend
embeddings (rounded to bf16, as the reference's) before ``--seq-len``
minus ``frontend_tokens`` text tokens, and an MoE arch's loss adds its
router aux loss.

Multi-process runs (the reference's flags): every process is started
with ``--coordinator host:port --num-processes W --process-id r``; rank r
runs on ``cuda:{r % device_count}`` (or the CPU), the ranks form a
``("data",)`` mesh (``launch/mesh.py``) and a distributed run implies
``--shard-population``: the device store's population is sharded over
the ranks (a stateful algorithm needs ``--client-state-placement
device``), each rank builds and runs only its rows of each cohort and
folds them onto the accumulator of the ranks before it (so the aggregate
is the one-process aggregate bit for bit), and every rank takes the same
server step; a digest of the server state is compared across
ranks after every round. Rank 0 prints and logs the records and writes
the server checkpoint; every rank writes its own store shard
(``ckpt_<step>.shard<r>of<W>``) and a restore reads both. At the end each
rank prints one ``{"rank_summary": ...}`` line (its device, DP launches,
peak memory, store rows and bytes, host ms and bytes sent to other ranks
per round). ``--shard-population`` alone runs the sharded path in one
process. ``--async-rounds`` stays single-process, as in the reference.

``--model-parallel M`` (a multi-process run whose ``--num-processes`` W
it divides) lays the ranks out as a ``("data", "model")`` mesh of ``(W /
M, M)`` and runs every round at the ``sequential`` placement
(``core/sharded_round.py``): the server state, the client iterate and the
per-client states (a store made for the layout) are FSDP-sharded over
all W ranks, every rank runs every client of the cohort on its rows of
the client's batch, and the attention, dense-FFN and MoE blocks and the
vocabulary (embedding, unembedding, cross entropy) compute parallel over
"model" where they divide (``core/fsdp.py``, ``sharding/``); a recurrent
mixer stays replicated (ROADMAP.md queue 1, item 10 part 4b part 2). Every
rank writes its shards at a checkpoint (``save_checkpoint_fsdp``) and a
restore reads the set back; the eval loss is computed on the gathered
params, on every rank; rank 0 prints the records. This path is the
port's addition: the reference's entry point runs the ``parallel``
placement only.

The local steps recompute each pattern repeat in the backward pass by
default (``main(remat="full")``, the reference's default, through
``models.model.recompute`` under the round's ``vmap(grad)``);
``main(remat="none")`` keeps every activation.

Differences from the reference:

* ``--dist-backend {nccl,gloo}`` (default: nccl on CUDA, gloo on the
  CPU) stands for the reference's ``jax_cpu_collectives_implementation``
  setting; gloo on CUDA is how two ranks share one card, which NCCL
  refuses. ``--dist-timeout`` bounds the wait for the other ranks.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.algorithms import algorithm_names, get_algorithm, phase_name
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.checkpoint.io import (restore_checkpoint_fsdp,
                                       restore_store_sharded,
                                       save_checkpoint_fsdp,
                                       save_store_sharded)
from repro_torch.compression.accounting import round_bytes
from repro_torch.configs.base import FedConfig, MeshConfig
from repro_torch.core import collective
from repro_torch.core import tree_math as tm
from repro_torch.core.client_state import make_client_store
from repro_torch.core.engine import RoundEngine
from repro_torch.core.round import resolve_device
from repro_torch.core.round_program import to_device
from repro_torch.core.server import init_server_state
from repro_torch.core.sharded_round import fsdp_layout, make_fed_round_split
from repro_torch.data.cohort_source import CohortSource
from repro_torch.data.lm_synthetic import SyntheticLMData
from repro_torch.data.prefetch import (globalize_cohort_batches,
                                       local_row_range)
from repro_torch.kernels import fedpa_dp
from repro_torch.launch.mesh import (DEFAULT_TIMEOUT_S, init_distributed,
                                     make_host_mesh, mesh_from_config)
from repro_torch.models.model import init_params
from repro_torch.models.steps import lm_loss
from repro_torch.optim import get_optimizer

COMPUTE_DTYPE = torch.bfloat16


def build_fed(args) -> FedConfig:
    """CLI flags -> the run's ``FedConfig``."""
    return FedConfig(
        algorithm=args.algorithm,
        clients_per_round=args.clients,
        local_steps=args.local_steps,
        burn_in_steps=args.burn_in_steps,
        steps_per_sample=args.steps_per_sample,
        shrinkage_rho=args.rho,
        server_opt=args.server_opt, server_lr=args.server_lr,
        client_opt=args.client_opt, client_lr=args.client_lr,
        burn_in_rounds=args.burn_in_rounds,
        payload_codec=args.payload_codec,
        lora_rank=args.lora_rank,
        quant_bits=args.quant_bits,
        error_feedback=not args.no_error_feedback,
        async_rounds=args.async_rounds,
        max_staleness=args.max_staleness,
        staleness_discount=args.staleness_discount,
        prefetch_rounds=args.prefetch_rounds,
        prefetch_backend=args.prefetch_backend,
        client_state_placement=args.client_state_placement,
        availability=args.availability,
        availability_period=args.availability_period,
        availability_duty=args.availability_duty,
        dropout_rate=args.dropout_rate,
        straggler_rate=args.straggler_rate,
        straggler_max_lateness=args.straggler_max_lateness,
        min_local_steps=args.min_local_steps,
    )


def parse_args(argv=None):
    """CLI flags of the training entry point: the reference's, plus
    ``--device``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="fedlm-100m",
                    choices=configs.ALL_ARCHS)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-friendly)")
    ap.add_argument("--algorithm", default="fedpa",
                    choices=algorithm_names(),
                    help="registered federated algorithm")
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--num-clients", type=int, default=64,
                    help="population size")
    ap.add_argument("--local-steps", type=int, default=8)
    ap.add_argument("--burn-in-steps", type=int, default=4)
    ap.add_argument("--steps-per-sample", type=int, default=2)
    ap.add_argument("--burn-in-rounds", type=int, default=5)
    ap.add_argument("--rho", type=float, default=0.01)
    ap.add_argument("--server-opt", default="sgdm")
    ap.add_argument("--server-lr", type=float, default=0.5)
    ap.add_argument("--client-opt", default="sgdm",
                    help="client optimizer (scaffold requires 'sgd')")
    ap.add_argument("--client-lr", type=float, default=0.05)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--payload-codec", default="none",
                    help="client payload codec chain (repro_torch."
                         "compression): none | lowrank | int8 | "
                         "lowrank+int8; non-'none' requires --algorithm "
                         "fedlora")
    ap.add_argument("--lora-rank", type=int, default=4,
                    help="rank of the 'lowrank' codec's per-(round, leaf) "
                         "sketch")
    ap.add_argument("--quant-bits", type=int, default=8, choices=(8, 16),
                    help="bit width of the 'int8' codec's quantizer")
    ap.add_argument("--no-error-feedback", action="store_true",
                    help="disable fedlora's per-client compression-error "
                         "residual (no client-state store)")
    ap.add_argument("--async-rounds", action="store_true",
                    help="overlap cohort t+1's client compute with round "
                         "t's server update (max-staleness + 1 cohorts in "
                         "flight)")
    ap.add_argument("--max-staleness", type=int, default=1,
                    help="cohorts in flight beyond the one being applied")
    ap.add_argument("--staleness-discount", type=float, default=0.9,
                    help="a staleness-s delta is scaled by discount**s")
    ap.add_argument("--prefetch-rounds", type=int, default=2,
                    help="cohorts built ahead of the round loop (0 = "
                         "inline)")
    ap.add_argument("--prefetch-backend", default="process",
                    choices=("process", "thread"),
                    help="cohort prefetcher: a spawned child writing a "
                         "shared-memory arena, or a thread "
                         "(data/prefetch.py)")
    ap.add_argument("--availability", default="always",
                    choices=("always", "diurnal"))
    ap.add_argument("--availability-period", type=int, default=24)
    ap.add_argument("--availability-duty", type=float, default=0.5)
    ap.add_argument("--dropout-rate", type=float, default=0.0)
    ap.add_argument("--straggler-rate", type=float, default=0.0)
    ap.add_argument("--straggler-max-lateness", type=int, default=2)
    ap.add_argument("--min-local-steps", type=int, default=0)
    ap.add_argument("--client-state-placement", default="host",
                    choices=("host", "device"),
                    help="where stateful algorithms' per-client state "
                         "lives: host numpy buffers (one sync per round at "
                         "the scatter) or tensors on the device")
    ap.add_argument("--coordinator", default=None,
                    help="host:port where rank 0 listens (multi-process)")
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--shard-population", action="store_true",
                    help="shard the device store's population over the "
                         "ranks (implied by a multi-process run)")
    ap.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                    help="process-group backend (default: nccl on CUDA, "
                         "gloo on the CPU; gloo lets ranks share a card)")
    ap.add_argument("--dist-timeout", type=float, default=DEFAULT_TIMEOUT_S,
                    help="seconds to wait for the other ranks")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="ranks along the mesh's 'model' axis: above 1, "
                         "the ranks form a ('data', 'model') mesh and every "
                         "round runs at the sequential placement with its "
                         "state FSDP-sharded over all ranks and its "
                         "attention, FFN, MoE and vocabulary compute "
                         "parallel over 'model'")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--log", default=None, help="JSONL metrics path")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    return ap.parse_args(argv)


def bf16_values(x: np.ndarray) -> np.ndarray:
    """``x`` rounded to bfloat16, kept as float32 numpy (numpy has no
    bfloat16): the values the reference's ``astype(jnp.bfloat16)`` gives
    its frontend embeddings."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


@dataclasses.dataclass(frozen=True)
class RoundBatches:
    """The cohort batch function ``(ids, round) -> {"tokens": (C, K, B,
    S+1)}`` for ``CohortSource`` (numpy; the round moves it to the
    device), plus ``"frontend"`` (C, K, B, F, d) when ``frontend_tokens``
    is set: client ``c``'s stub embeddings of local step ``k`` of round
    ``r`` (salt ``r * 1000 + k``), rounded to bf16 as the reference's. A
    module-level class, so the process prefetcher's spawned child can
    unpickle it."""

    data: SyntheticLMData
    local_steps: int
    batch: int
    seq_len: int
    frontend_tokens: int = 0
    d_model: int = 0

    def __call__(self, ids, round_idx: int):
        """One cohort's batches."""
        batches = {"tokens": self.data.round_batches(
            ids, self.local_steps, self.batch, self.seq_len,
            round_idx=round_idx)}
        if self.frontend_tokens:
            batches["frontend"] = bf16_values(np.stack([np.stack([
                self.data.frontend_embeddings(
                    int(c), self.batch, self.frontend_tokens, self.d_model,
                    salt=round_idx * 1000 + k)
                for k in range(self.local_steps)]) for c in ids]))
        return batches


@dataclasses.dataclass(frozen=True)
class ShiftedCohorts:
    """``build_cohort(i)`` for a run that starts at ``start_round``: the
    engine counts from 0, the draw stays keyed to the absolute round, so a
    resumed run draws what an unbroken one would. Picklable, for the
    process prefetcher."""

    source: CohortSource
    start_round: int

    def __call__(self, i: int):
        """The cohort of absolute round ``start_round + i``, numbered
        ``i``."""
        return self.source.cohort(self.start_round + i)._replace(
            round_idx=i)


def make_eval_fn(args, cfg, data, s_text, q_chunk, device, compute_dtype):
    """Held-out eval loss on a batch from the unseen client
    ``num_clients + 1`` (with its frontend embeddings for a frontend
    arch), without a graph."""
    eval_batch = {"tokens": data.client_batches(
        args.num_clients + 1, 1, args.batch, s_text)[0]}
    if cfg.frontend:
        eval_batch["frontend"] = bf16_values(data.frontend_embeddings(
            args.num_clients + 1, args.batch, cfg.frontend_tokens,
            cfg.d_model))
    eval_batch = to_device(eval_batch, device)

    @torch.no_grad()
    def eval_fn(params):
        return lm_loss(params, eval_batch, cfg, compute_dtype=compute_dtype,
                       q_chunk=q_chunk, remat="none")[0]

    return eval_fn


def restore_if_present(args, state, store, ckpt_tree, verbose=True,
                       layout=None):
    """Resume from ``--ckpt-dir`` when it holds a checkpoint (under an FSDP
    ``layout``, a set of ``save_checkpoint_fsdp`` files); returns
    ``(state, start_round)`` and loads the client state into ``store`` in
    place."""
    start_round = 0
    if args.ckpt_dir and os.path.isdir(args.ckpt_dir):
        try:
            restored, start_round, _ = (
                restore_checkpoint(args.ckpt_dir, ckpt_tree(state))
                if layout is None else restore_checkpoint_fsdp(
                    args.ckpt_dir, ckpt_tree(state), None, layout))
        except FileNotFoundError:
            return state, 0
        if store is None:
            state = restored
        else:
            state = restored["server"]
            store.load_state_dict(restored["clients"])
        if verbose:
            print(f"restored checkpoint at round {start_round}")
    return state, start_round


@dataclasses.dataclass(frozen=True)
class RankRows:
    """The cohort batch function of one rank of a mesh: its
    ``local_row_range`` rows of each cohort, built by ``batches`` and
    placed on its device (``globalize_cohort_batches``)."""

    batches: RoundBatches
    mesh: object

    def __call__(self, ids, round_idx: int):
        """This rank's rows of the cohort ``ids``."""
        lo, hi = local_row_range(self.mesh, "data", len(ids))
        local = self.batches(np.asarray(ids)[lo:hi], round_idx)
        return globalize_cohort_batches(local, self.mesh, "data", len(ids),
                                        lo)


def run_rounds(args, cfg, fed, alg, state, store, start_round, source,
               eval_fn, emit, maybe_checkpoint, q_chunk, compute_dtype,
               remat, mesh=None, layout=None, params=None):
    """Drive the ``RoundEngine`` over the burn-in and sampling programs
    from ``start_round`` to ``args.rounds``; returns ``(state, history)``.
    Synchronous runs keep an in-flight window of one; ``--async-rounds``
    widens it to ``max_staleness + 1``. With a ``mesh`` the cohort splits
    over its ranks, and the ranks' server states are compared after every
    round (``collective.check_replicas``). With an FSDP ``layout``
    (``--model-parallel``) the rounds run at ``sequential`` on this rank's
    shards and ``params`` (the whole tree) gives the wire bytes."""
    has_burn = alg.burns_in
    kw = dict(placement="parallel", compute_dtype=compute_dtype,
              q_chunk=q_chunk, remat=remat, mesh=mesh)
    if layout is not None:
        kw.update(placement="sequential", mesh=layout.mesh, layout=layout)
    params = state.params if params is None else params

    def stages(use_sampling):
        return make_fed_round_split(cfg, fed, use_sampling=use_sampling,
                                    **kw)

    cohort_fn, server_fn = stages(True)
    burn_cohort_fn, burn_server_fn = (stages(False) if has_burn
                                      else (None, None))
    rb = round_bytes(fed, params)
    engine = RoundEngine(
        cohort_fn=cohort_fn,
        server_fn=server_fn,
        burn_cohort_fn=burn_cohort_fn,
        burn_server_fn=burn_server_fn,
        burn_in_rounds=max(0, fed.burn_in_rounds - start_round),
        max_staleness=fed.max_staleness if fed.async_rounds else 0,
        staleness_discount=fed.staleness_discount,
        prefetch_rounds=fed.prefetch_rounds,
        prefetch_backend=fed.prefetch_backend,
        round_bytes=rb,
        burn_round_bytes=(round_bytes(fed, params, use_sampling=False)
                          if has_burn else rb),
        client_store=store,
        stateful=alg.stateful,
        burn_stateful=alg.burn_stateful,
    )

    last_t = time.time()

    def on_round(rec, round_state):
        # one device sync per round, for live logging
        nonlocal last_t
        collective.check_replicas(mesh, round_state)
        r = start_round + rec["round"]
        out = {"round": r,
               "eval_loss": (float(rec["eval"]["eval_loss"])
                             if "eval" in rec else None),
               "client_loss_last": float(rec["metrics"]["loss_last"]),
               "client_loss_first": float(rec["metrics"]["loss_first"]),
               "staleness": rec["staleness"],
               "phase": phase_name(fed, r),
               "sec": round(time.time() - last_t, 2)}
        for k in ("dropped", "straggled", "bytes_up", "bytes_down"):
            out[k] = rec[k]
        emit(out, time.time() - last_t)
        maybe_checkpoint(round_state, r)
        last_t = time.time()

    return engine.run(state, ShiftedCohorts(source, start_round),
                      args.rounds - start_round,
                      eval_fn=(None if eval_fn is None
                               else lambda p: {"eval_loss": eval_fn(p)}),
                      on_round=on_round)


def main(argv=None, *, cfg=None, compute_dtype=COMPUTE_DTYPE,
         remat: str = "full") -> dict:
    """Parse flags, build the round programs, drive the training loop.

    ``cfg`` replaces the config that ``--arch`` / ``--smoke`` name,
    ``compute_dtype`` the bf16 compute of the local steps (a full-width
    model cut in depth, in fp32, for comparing devices) and ``remat`` the
    local steps' recompute (``"full"``: each pattern repeat recomputed in
    the backward pass, the default, as the reference's; ``"none"`` keeps
    every activation). Returns ``cfg``,
    the final ``state``, the per-client ``store`` (None when stateless),
    the engine's ``history``, the printed ``records``, each round's host
    ``seconds``, the ``mesh`` (None unless sharded) and each round's
    bytes ``sent`` to other ranks. A multi-process run leaves its process
    group when it ends.
    """
    args = parse_args(argv)
    if (args.num_processes or 0) > 1 and args.async_rounds:
        raise SystemExit("--async-rounds is single-host only (the async "
                         "engine's apply-order write-back has no "
                         "cross-process story yet); drop the flag")
    distributed = init_distributed(
        args.coordinator, args.process_id, args.num_processes,
        backend=args.dist_backend, device=args.device,
        timeout=args.dist_timeout)
    try:
        return _train(args, distributed, cfg, compute_dtype, remat)
    finally:
        if distributed:
            torch.distributed.destroy_process_group()


def _fsdp_mesh(args, distributed: bool, device):
    """The ``("data", "model")`` mesh of a ``--model-parallel`` run (None
    without one)."""
    M = args.model_parallel
    if M <= 1:
        return None
    if not distributed or args.num_processes % M:
        raise SystemExit(f"--model-parallel {M} needs a multi-process run "
                         f"whose --num-processes it divides")
    if args.shard_population:
        raise SystemExit("--model-parallel shards every client's state "
                         "over the ranks; drop --shard-population")
    return mesh_from_config(MeshConfig(shape=(args.num_processes // M, M),
                                       axes=("data", "model")), device)


def _train(args, distributed: bool, cfg, compute_dtype, remat) -> dict:
    """``main`` once the process group (if any) is up."""
    device = resolve_device(args.device)
    fsdp_mesh = _fsdp_mesh(args, distributed, device)
    shard_pop = (args.shard_population or distributed) and fsdp_mesh is None
    mesh = make_host_mesh(device) if shard_pop else None
    ranks = mesh or fsdp_mesh
    if ranks is not None:
        device = ranks.device
    is_main = ranks is None or ranks.rank == 0
    if cfg is None:
        cfg = (configs.get_smoke(args.arch) if args.smoke
               else configs.get_config(args.arch))
    fed = build_fed(args)
    if ranks is not None and fed.prefetch_backend == "process":
        # a rank's cohort builder places its rows on the rank's device,
        # which a spawned builder child must never touch
        fed = dataclasses.replace(fed, prefetch_backend="thread")
    if is_main:
        print(f"arch={cfg.name} params={cfg.param_count():,} "
              f"algorithm={fed.algorithm} rounds={args.rounds} "
              f"device={device}"
              + (f" processes={ranks.size} backend={ranks.backend}"
                 if distributed else "")
              + (f" population_mesh={tuple(mesh.sizes)}" if mesh else "")
              + (f" fsdp_mesh={fsdp_mesh.shape}" if fsdp_mesh else ""))

    data = SyntheticLMData(vocab_size=cfg.vocab_size,
                           num_clients=args.num_clients, seed=args.seed)
    s_text = args.seq_len - (cfg.frontend_tokens if cfg.frontend else 0)
    params = tm.tmap(lambda t: t.to(device), init_params(
        torch.Generator().manual_seed(args.seed), cfg, device="cpu"))
    server_opt = get_optimizer(fed.server_opt, fed.server_lr,
                               fed.server_momentum)
    alg = get_algorithm(fed)
    state = init_server_state(params, server_opt, algorithm=alg)
    layout = None
    if fsdp_mesh is not None:
        layout = fsdp_layout(cfg, fsdp_mesh)
        state = layout.shard_state(state)
    device_store = fed.client_state_placement == "device"
    stateful = alg.stateful or alg.burn_stateful
    if shard_pop and stateful and not device_store:
        raise SystemExit("population sharding needs the device store for "
                         "stateful algorithms: add "
                         "--client-state-placement device")
    store = (make_client_store(fed.client_state_placement, args.num_clients,
                               device=device,
                               mesh=mesh if device_store else None,
                               fsdp=layout)
             .ensure(alg.init_client_state(state.params))
             if stateful else None)
    # a sharded store never ships in the server checkpoint: each rank
    # writes its own rows (checkpoint.io.save_store_sharded)
    sharded_store = store is not None and mesh is not None

    def ckpt_tree(round_state):
        """The checkpoint tree: the bare server state, or ``{"server",
        "clients"}`` (the one place device client state reaches the
        host)."""
        if store is None or sharded_store:
            return round_state
        return {"server": round_state, "clients": store.state_dict()}

    def maybe_checkpoint(round_state, r):
        if args.ckpt_dir and ((r + 1) % args.ckpt_every == 0
                              or r == args.rounds - 1):
            meta = {"arch": cfg.name, "algorithm": fed.algorithm}
            if layout is not None:      # every rank writes its shards
                save_checkpoint_fsdp(args.ckpt_dir, ckpt_tree(round_state),
                                     r + 1, layout, meta)
                return
            if is_main:
                save_checkpoint(args.ckpt_dir, ckpt_tree(round_state), r + 1,
                                meta)
            if sharded_store:
                save_store_sharded(args.ckpt_dir, store, r + 1, meta)

    state, start_round = restore_if_present(
        args, state, None if sharded_store else store, ckpt_tree,
        verbose=is_main, layout=layout)
    if sharded_store and start_round:
        restore_store_sharded(args.ckpt_dir, store, step=start_round)
    q_chunk = min(64, s_text)
    batches = RoundBatches(data, fed.local_steps, args.batch, s_text,
                           cfg.frontend_tokens if cfg.frontend else 0,
                           cfg.d_model)
    source = CohortSource(fed, args.num_clients,
                          batches if mesh is None else RankRows(batches,
                                                                mesh),
                          seed=args.seed)
    eval_fn = (make_eval_fn(args, cfg, data, s_text, q_chunk, device,
                            compute_dtype)
               if is_main or layout is not None else None)
    if layout is not None:      # every rank gathers the whole params
        eval_whole = eval_fn

        def eval_fn(shard):
            return eval_whole(layout.gather_tree(shard))

    records, seconds, sent = [], [], []
    collective.reset_traffic()
    with (open(args.log, "a") if args.log and is_main
          else contextlib.nullcontext()) as logf:
        def emit(rec, sec):
            seconds.append(sec)
            sent.append(collective.sent_bytes() - sum(sent))
            if not is_main:
                return  # every rank computes the records; one reports
            print(json.dumps(rec), flush=True)
            if logf:
                logf.write(json.dumps(rec) + "\n")
                logf.flush()
            records.append(rec)

        state, history = run_rounds(args, cfg, fed, alg, state, store,
                                    start_round, source, eval_fn, emit,
                                    maybe_checkpoint, q_chunk,
                                    compute_dtype, remat, mesh, layout,
                                    params)
    if distributed:
        print(json.dumps({"rank_summary": rank_summary(
            ranks, device, store, seconds, sent)}), flush=True)
    return {"cfg": cfg, "state": state, "store": store, "history": history,
            "records": records, "seconds": seconds, "mesh": ranks,
            "sent": sent, "layout": layout}


def rank_summary(mesh, device, store, seconds, sent) -> dict:
    """What one rank of a multi-process run used: its device, its DP
    kernel launches, its peak memory (CUDA only), its store's rows and
    buffer bytes, its host ms per round, and the bytes it sent to other
    ranks per round, by kind in all, and staged through the host."""
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    bufs = (tm.tleaves(store.device_state()["buffers"])
            if store is not None and hasattr(store, "device_state") else [])
    return {"rank": mesh.rank, "world": mesh.size, "device": str(device),
            "backend": mesh.backend, "dp_launches": dict(fedpa_dp.launches),
            "peak_bytes": peak,
            "store_rows": getattr(store, "rows", None),
            "store_bytes": sum(b.numel() * b.element_size() for b in bufs),
            "host_ms": [x * 1e3 for x in seconds], "sent_bytes": sent,
            "traffic": dict(collective.traffic)}


if __name__ == "__main__":
    main()
