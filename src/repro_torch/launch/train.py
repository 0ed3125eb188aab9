"""Federated LM training entry point (port of ``repro/launch/train.py``), one
process on one device.

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

Differences from the reference:

* No remat: torch's checkpointing does not compose with the round's
  ``torch.func`` transforms (``models.steps.lm_grad_fn``), so every
  repeat's activations are kept.
* Flags whose paths are not ported raise ``NotImplementedError`` naming
  their ROADMAP.md queue-1 item (``refuse_unported``).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time

import torch

from repro_torch import configs
from repro_torch.algorithms import algorithm_names, get_algorithm, phase_name
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.compression.accounting import round_bytes
from repro_torch.configs.base import FedConfig, _not_ported
from repro_torch.core import tree_math as tm
from repro_torch.core.client_state import make_client_store
from repro_torch.core.engine import RoundEngine
from repro_torch.core.round import resolve_device
from repro_torch.core.round_program import to_device
from repro_torch.core.server import init_server_state
from repro_torch.core.sharded_round import make_fed_round_split
from repro_torch.data.cohort_source import CohortSource
from repro_torch.data.lm_synthetic import SyntheticLMData
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
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--shard-population", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--log", default=None, help="JSONL metrics path")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    return ap.parse_args(argv)


def refuse_unported(args) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP.md queue-1 item
    for the first flag whose path this port does not have."""
    pending = [
        (args.coordinator is not None, "--coordinator", 10),
        ((args.num_processes or 1) > 1, "--num-processes > 1", 10),
        (args.process_id is not None, "--process-id", 10),
        (args.shard_population, "--shard-population", 10),
    ]
    for bad, what, item in pending:
        if bad:
            raise _not_ported(what, item)


@dataclasses.dataclass(frozen=True)
class RoundBatches:
    """The cohort batch function ``(ids, round) -> {"tokens": (C, K, B,
    S+1)}`` for ``CohortSource`` (numpy; the round moves it to the
    device). A module-level class, so the process prefetcher's spawned
    child can unpickle it."""

    data: SyntheticLMData
    local_steps: int
    batch: int
    seq_len: int

    def __call__(self, ids, round_idx: int):
        """One cohort's token batches."""
        return {"tokens": self.data.round_batches(
            ids, self.local_steps, self.batch, self.seq_len,
            round_idx=round_idx)}


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
    ``num_clients + 1``, without a graph."""
    eval_batch = to_device({"tokens": data.client_batches(
        args.num_clients + 1, 1, args.batch, s_text)[0]}, device)

    @torch.no_grad()
    def eval_fn(params):
        return lm_loss(params, eval_batch, cfg, compute_dtype=compute_dtype,
                       q_chunk=q_chunk, remat="none")[0]

    return eval_fn


def restore_if_present(args, state, store, ckpt_tree):
    """Resume from ``--ckpt-dir`` when it holds a checkpoint; returns
    ``(state, start_round)`` and loads the client state into ``store`` in
    place."""
    start_round = 0
    if args.ckpt_dir and os.path.isdir(args.ckpt_dir):
        try:
            restored, start_round, _ = restore_checkpoint(args.ckpt_dir,
                                                          ckpt_tree(state))
        except FileNotFoundError:
            return state, 0
        if store is None:
            state = restored
        else:
            state = restored["server"]
            store.load_state_dict(restored["clients"])
        print(f"restored checkpoint at round {start_round}")
    return state, start_round


def run_rounds(args, cfg, fed, alg, state, store, start_round, source,
               eval_fn, emit, maybe_checkpoint, q_chunk, compute_dtype):
    """Drive the ``RoundEngine`` over the burn-in and sampling programs
    from ``start_round`` to ``args.rounds``; returns ``(state, history)``.
    Synchronous runs keep an in-flight window of one; ``--async-rounds``
    widens it to ``max_staleness + 1``."""
    has_burn = alg.burns_in
    kw = dict(placement="parallel", compute_dtype=compute_dtype,
              q_chunk=q_chunk)

    def stages(use_sampling):
        return make_fed_round_split(cfg, fed, use_sampling=use_sampling,
                                    **kw)

    cohort_fn, server_fn = stages(True)
    burn_cohort_fn, burn_server_fn = (stages(False) if has_burn
                                      else (None, None))
    rb = round_bytes(fed, state.params)
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
        burn_round_bytes=(round_bytes(fed, state.params, use_sampling=False)
                          if has_burn else rb),
        client_store=store,
        stateful=alg.stateful,
        burn_stateful=alg.burn_stateful,
    )

    last_t = time.time()

    def on_round(rec, round_state):
        # one device sync per round, for live logging
        nonlocal last_t
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
                      eval_fn=lambda p: {"eval_loss": eval_fn(p)},
                      on_round=on_round)


def main(argv=None, *, cfg=None, compute_dtype=COMPUTE_DTYPE) -> dict:
    """Parse flags, build the round programs, drive the training loop.

    ``cfg`` replaces the config that ``--arch`` / ``--smoke`` name, and
    ``compute_dtype`` the bf16 compute of the local steps (a full-width
    model cut in depth, in fp32, for comparing devices). Returns ``cfg``,
    the final ``state``, the per-client ``store`` (None when stateless),
    the engine's ``history``, the printed ``records`` and each round's
    host ``seconds``.
    """
    args = parse_args(argv)
    refuse_unported(args)
    device = resolve_device(args.device)
    if cfg is None:
        cfg = (configs.get_smoke(args.arch) if args.smoke
               else configs.get_config(args.arch))
    fed = build_fed(args)
    print(f"arch={cfg.name} params={cfg.param_count():,} "
          f"algorithm={fed.algorithm} rounds={args.rounds} device={device}")

    data = SyntheticLMData(vocab_size=cfg.vocab_size,
                           num_clients=args.num_clients, seed=args.seed)
    s_text = args.seq_len
    params = tm.tmap(lambda t: t.to(device), init_params(
        torch.Generator().manual_seed(args.seed), cfg, device="cpu"))
    server_opt = get_optimizer(fed.server_opt, fed.server_lr,
                               fed.server_momentum)
    alg = get_algorithm(fed)
    state = init_server_state(params, server_opt, algorithm=alg)
    store = (make_client_store(fed.client_state_placement, args.num_clients,
                               device=device)
             .ensure(alg.init_client_state(params))
             if alg.stateful or alg.burn_stateful else None)

    def ckpt_tree(round_state):
        """The checkpoint tree: the bare server state, or ``{"server",
        "clients"}`` (the one place device client state reaches the
        host)."""
        if store is None:
            return round_state
        return {"server": round_state, "clients": store.state_dict()}

    def maybe_checkpoint(round_state, r):
        if args.ckpt_dir and ((r + 1) % args.ckpt_every == 0
                              or r == args.rounds - 1):
            save_checkpoint(args.ckpt_dir, ckpt_tree(round_state), r + 1,
                            {"arch": cfg.name, "algorithm": fed.algorithm})

    state, start_round = restore_if_present(args, state, store, ckpt_tree)
    q_chunk = min(64, s_text)
    source = CohortSource(fed, args.num_clients,
                          RoundBatches(data, fed.local_steps, args.batch,
                                       s_text),
                          seed=args.seed)
    eval_fn = make_eval_fn(args, cfg, data, s_text, q_chunk, device,
                           compute_dtype)

    records, seconds = [], []
    with (open(args.log, "a") if args.log
          else contextlib.nullcontext()) as logf:
        def emit(rec, sec):
            print(json.dumps(rec), flush=True)
            if logf:
                logf.write(json.dumps(rec) + "\n")
                logf.flush()
            records.append(rec)
            seconds.append(sec)

        state, history = run_rounds(args, cfg, fed, alg, state, store,
                                    start_round, source, eval_fn, emit,
                                    maybe_checkpoint, q_chunk,
                                    compute_dtype)
    return {"cfg": cfg, "state": state, "store": store, "history": history,
            "records": records, "seconds": seconds}


if __name__ == "__main__":
    main()
