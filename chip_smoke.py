#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]

1. Prints the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions and the TF32 flags (both set off: the CPU comparison of
   phase 4 and the fp32 check of phase 6 need full fp32 matmuls and
   convolutions), then builds the CUDA kernels from
   ``src/repro_torch/kernels/csrc`` with ``nvcc``, one process per source,
   all at once.
2. Holds each DP kernel against its plain PyTorch twin on the card at the
   FedPA path's shapes (C=16 clients, d=428,350, lp in {1, 4}; C=1 and
   C=6, the stacks of the sequential and chunked placements), on a ragged
   d=1300, and with bf16 inputs; two calls must agree bit for bit, and at
   C=16 each client alone must equal its row of the stack bit for bit.
   Times kernel and one library call in turns (kernel, library, library,
   kernel) and the twin, with the inputs rotated through more memory than
   the L2 cache holds: ``ms`` by CUDA events over back-to-back calls (host
   time included) and, at C = 1, 6, 16 fp32 and C = 16 bf16, ``device_ms``
   (the calls replayed from a CUDA graph) and ``host_ms`` (the wrapper's
   host time per call); computes each kernel's bound from the bytes it
   must move. Then the whole ``ops.dp_step`` at C = 1, 6 and 16 against
   the twins' step and against the step through library calls (``bmm``,
   the coefficients, ``baddbmm``), with the device operations one step
   makes as ``torch.profiler`` counts them. Last, both DP kernels at the
   LM training path's d = 100,684,032 (fedlm-100m), lp 3: C = 4, the
   path's cohort, and C = 8, where ``V`` holds 2.42e9 elements (past
   2^31, so the 64-bit offsets are exercised), and C = 1 at half that
   d, the shard of each of phase 16c's two ranks; each case's buffers are
   freed after it.
3. Drives the FedPA path: ``FedSim(device="cuda").run`` for 3 FedPA rounds
   of the full-width EMNIST CNN (16 of 64 clients, l=5, one burn-in round),
   with batch and with streaming DP; each DP kernel must have been launched
   (rounds - burn_in_rounds) * (l - 1) * 2 runs = 16 times. Every card run
   of the CNN that is compared with the CPU (here and in phases 8, 10d
   and 11d) takes cuDNN's deterministic algorithms (``deterministic``):
   the default data-gradient kernel sums with atomics and moves the
   card's params from run to run (phase 4 lists the kernels); the timed
   rounds keep torch's defaults.
4. Runs the same rounds on the CPU (through the kernels' plain twins) from
   the same weights and data; final params must agree. Then, as a report,
   phase 3's batch-DP rounds on the card once with cuDNN's default
   algorithms and once under ``deterministic()``, each under
   ``torch.profiler``: the convolution kernels each mode launched and each
   run's distance from the CPU run.
5. Holds the decode-attention kernel ``swa_decode`` against its twin at
   gemma3-27b's serving shapes (B 4, 32 heads, 16 KV heads, head_dim 128: a
   wrapped ring of L=1024 with window 1024, a linear cache of L=1344) and
   qwen3-32b's (B 4, 64 heads, 8 KV heads: G 8, linear L=1344), in bf16 and
   fp32, and on the sweep of ``tests/test_kernels.py``, a ragged L=1000,
   L of 1 and 5 (fewer slots than CTAs in a cluster), G 16 at head_dim 256,
   and caches whose first slots (or all) are masked; two calls must agree
   bit for bit. Times kernel and ``scaled_dot_product_attention`` in turns
   (kernel, SDPA, SDPA, kernel) and the twin, with the K/V caches rotated
   through more memory than the L2 cache holds: ``ms`` by CUDA events over
   back-to-back calls (the wrapper's host time included), and at the
   serving shapes ``device_ms``, the same calls replayed from a CUDA graph
   (no host time between them), and ``host_ms``, the wrapper's host time
   per call.
6. fp32 wiring check: full-width gemma3-27b cut to one repeat (8 layers,
   both cache kinds), prompt 1100 (past the window), 8 decode steps; the
   kernel route's logits must equal the plain route's, teacher-forced from
   a copy of the same prefill state, within 2e-3.
7. The serving path itself: ``launch/serve.py``'s ``main`` on the full
   62-layer gemma3-27b in bf16, batch 4, prompt 1280, 32 generated
   tokens; ``swa_decode`` must have been launched 31 x 62 = 1922 times.
   The same
   decode is replayed through the plain route (0 launches) from a copy of
   the prefill state, teacher-forced on the kernel route's tokens; the max
   logit difference must stay within one bf16 rounding (2^-8) of the
   largest logit per layer, plus one for the bf16 logits themselves:
   (62 + 1) x 2^-8 x max |logit|.
8. The rest of the synchronous round on the full-width EMNIST CNN, with
   phase 3's settings (16 of 64 clients, 14 local steps, l=5, 3 rounds,
   one burn-in round), through ``FedSim.round``: FedPA at ``sequential``
   (one client per DP launch) and at ``chunked`` with chunk 6 (three
   chunks, two zero-weight padding clients), ``fedpa_precision`` at
   ``parallel``, and FedPA at ``chunked`` chunk 6 with ``dropout_rate``
   0.25 and ``qffl_q`` 1.0. Prints each run's round ms and its launches
   of each DP kernel against the count worked out from the code (FedPA
   rounds x (l - 1) DP steps x stacks per round); the FedPA params must
   agree with phase 3's ``parallel`` ones and every run with its CPU
   replay (phase 4's bound). Then the least-squares quickstart
   (``repro_torch.examples.quickstart``, cut to 10 of its 60 rounds) on
   the card and on the CPU: FedPA must end closer to the optimum than
   FedAvg, and the card's params must equal the CPU's.
9. LM training: ``repro_torch.launch.train.main`` on the full-width
   fedlm-100m (d = 100,684,032) in bf16 compute, FedPA with 4 of 64
   clients, 12 local steps (l = 4), batch 4 x 128 tokens, one burn-in
   round and two FedPA rounds. Prints each round's record and host ms
   beside the round's bound reckoned from the code, the peak memory,
   and the launches: each DP kernel must have been launched (rounds -
   burn-in rounds) x (l - 1) = 6 times, ``swa_decode`` never; a second,
   profiled run of one FedPA round gives the device time per round, its
   idle share and the kernels that take the most of it. Then the
   same path in fp32 compute on fedlm-100m cut to one layer (2 clients,
   6 local steps, l = 4, batch 2 x 64 tokens, one burn-in and one FedPA
   round) on the card and on the CPU from the same weights: the final
   params must agree (phase 4's bound).
10. Per-client state. (a) FedEP on the device store trains the full-width
   fedlm-100m through ``launch.train.main`` (phase 9's settings, the
   population cut from 64 to 16 for the store's 2 fp32 vectors of d per
   client): DP launches 6 each, ``swa_decode`` none, each stamp equal to
   the FedEP rounds its client was drawn in, the sites of clients never
   drawn exactly zero and of drawn ones finite and non-zero; FedEP round
   ms against the reckoned bound, peak memory, the store's bytes. (b)
   FedEP on one layer of it, fp32, client lr 0.01, with the host store
   and the device store on the card (bit for bit equal, with
   deterministic algorithms) and the device store on the CPU (phase 4's
   bound). (c) ``device_gather`` / ``device_scatter`` with a stale stamp
   and a write mask under ``torch.cuda.set_sync_debug_mode("error")``,
   against the host store. (d) SCAFFOLD on the host and the device store
   (bit for bit equal, cuDNN deterministic) and FedEP at ``parallel`` and
   ``chunked`` chunk 6 on the full-width CNN with phase 3's settings, each
   against its CPU replay, with their DP launches (0, 0, 8, 24). (e) The
   smoke fedlm-100m with FedEP checkpointed after 2 rounds and resumed to
   4 against a straight 4-round run. (f) Whether phase 3's rounds, and
   (b)'s device-store card run, repeat bit for bit in one process, with
   ``cudnn.deterministic`` off and on (a report, no check).
11. Async rounds (a window of cohorts in flight). (a) Async FedPA trains the
   full-width fedlm-100m through ``launch.train.main`` with phase 9's
   settings cut to 5 rounds, ``--async-rounds --max-staleness 2
   --staleness-discount 0.9`` and the reference's prefetcher (2 rounds
   ahead, a child process): staleness 0, 1, 2, 2, 2 on the records; each
   DP kernel launched 4 x (l - 1) = 12 times, the synchronous count; the
   prefetcher's child started by ``spawn`` while this process's CUDA
   context is live; host ms per round beside the same run with cohorts
   built inline, peak memory, and that inline run's cohort builds' host
   ms and, profiled over rounds 1-4, its device idle share.
   (b) Async FedEP on the device store, 4 of 16 clients, window 3: the
   records' ``state_drops`` and the store's stamps equal a host replay
   of the CAS from the draws (drops > 0), each write-back run under
   ``torch.cuda.set_sync_debug_mode("error")`` with its drop count a
   tensor. (c) The same on one layer, fp32, client lr 0.01, with the host
   store and the device store on the card (equal drops, bitwise equal
   under deterministic algorithms) and the device store on the CPU
   (phase 4's bound). (d) The CNN cell with the goldens' straggler spec
   (FedAvg, rate 0.5, lateness <= 2, window 3) and FedPA at window 3,
   card (cuDNN's deterministic algorithms) and CPU: ``staleness`` / ``straggled`` equal the CPU's and the
   draws, params within phase 4's bound, FedPA's DP launches 16 each; the
   card run's cohort builds' host ms.
12. FedLoRA and the payload codecs. (a) At fedlm-100m's leaf shapes, a
   stack of 4 clients' random deltas and precisions at rank 4: the wire
   bytes per client of ``lowrank``, ``lowrank+int8`` and ``int8`` equal
   ``round_bytes`` and the JAX package's numbers; the bases on the card
   equal the CPU's bit for bit; the low-rank factors card vs CPU within
   1e-5 relative; each int8 ``q`` the rounding of the card's own input
   and within one of the CPU's (the flips counted); encode, decode and
   dequantize raise nothing under ``set_sync_debug_mode("error")`` once
   the bases are cached; one round's codec work in host ms and by CUDA
   events. (b) FedLoRA ``lowrank+int8`` on the device store trains the
   full-width fedlm-100m through ``launch.train.main`` (phase 9's
   settings, population 16): DP launches 6 each, ``swa_decode`` none,
   every record's bytes exact (the burn-in round dense), the residuals of
   drawn clients non-zero and of the others zero, stamps equal to the
   draws; round host ms, peak memory, the store's bytes. (c) Its
   one-layer fp32 cut (client lr 0.01, 3 rounds) on the card and the
   CPU: ``lowrank`` within phase 4's bound (params and residuals),
   ``lowrank+int8`` as a report (largest differences, int8 flips between
   the runs), both at 2 rounds (one FedLoRA round), and ``lowrank`` at
   window 3, 3 rounds (staleness equal, within the bound).
13. Serving the rest of the LM stack on the card, bf16, each model freed
   before the next. (a) ``launch/serve.py``'s ``main`` on the full
   48-layer qwen3-moe-30b-a3b (128 experts, top-8, one-hot routing),
   batch 4, prompt 1024, 16 tokens; (b) on the full 38-layer
   recurrentgemma-9b (26 RG-LRU, 12 local attention layers at window
   2048), batch 4, prompt 3072 (the ring wraps in prefill), 16 tokens;
   (c) at the same batch, prompt 512, 16 tokens: internvl2-26b (256 vision
   frontend tokens), minitron-4b, musicgen-medium (64 audio frontend
   tokens), xlstm-125m, granite-34b cut from 88 to 40 repeats and
   llama4-scout-17b-a16e cut from 12 to 2 repeats (both too large for
   one card at full depth). Each prints prefill ms, warm decode ms per
   step beside the decode bound (every weight and the decode state read
   once per step over the HBM rate), tokens/s and the peak memory;
   ``swa_decode`` must have been launched (tokens - 1) x attention layers
   times (48 x 15, 12 x 15, 0 for xlstm-125m), and the decode replayed
   through the plain route from a copy of the prefill state must keep
   its logits within phase 7's bound, with greedy tokens equal wherever
   the kernel route's top two logits are further apart than twice the
   difference. (a) and (b) also profile their prefill and one decode step
   (device time, idle share, top kernels). (d) One-layer fp32 cuts at full
   width, card against the CPU from the same weights, prefill then 4
   decode steps within phase 4's bound: the MoE under ``onehot`` and
   ``sort`` routing, RG-LRU, mLSTM + sLSTM (two 256-token chunks) and
   musicgen's frontend; and the MoE layer at capacity factor 0.25 under
   both routings, whose kept (token, expert) pairs must be equal.
   (e) Phase 5's checks at the new archs' decode shapes (in
   ``SWA_CASES``).
14. Training the rest of the LM stack. (a) ``launch.train.main`` on the
   full-size xlstm-125m (d = 129,642,288: 6 sLSTM and 6 mLSTM layers)
   with phase 9's FedPA settings cut to one FedPA round, no burn-in
   round and 6 local steps (2 burn-in steps, a sample every step: l = 4):
   DP launches (rounds - burn-in rounds) x (l - 1) = 3 each,
   ``swa_decode`` none, finite records; round host ms
   against the reckoned bound, the peak memory against phase 9's
   reckoning, and a profiled local step (device ops and time, idle
   share, top kernels). Client lr 0.01: at 0.05 its local steps diverge. (b) One FedPA round of the full-width
   fedlm-100m in fp32 compute at 8 x 512 tokens a client step (6 local
   steps, l = 4, as 14a), from the same state, with ``remat="none"`` and ``"full"`` (each pattern repeat
   recomputed in the backward pass under the round's ``vmap(grad)``):
   params within phase 4's bound, the peak memory lower with the
   recompute; both peaks and round times.
   (c) ``vmap(grad)`` of the loss over 2 clients on one-layer fp32 cuts
   at full width, card against the CPU from the same weights, losses and
   grads within phase 4's bound: qwen3-moe-30b-a3b under one-hot and
   sort routing, llama4-scout-17b-a16e (one top-1 MoE layer),
   recurrentgemma-9b (one repeat of RG-LRU, RG-LRU, local attention),
   musicgen-medium and internvl2-26b with their frontend embeddings, and
   xlstm-125m (one sLSTM and one mLSTM layer). An MoE cut's CPU run is
   forced onto the experts the card chose, and the CPU router's flips
   are counted.
15. Multi-process training (``launch/mesh.py``, ``core/collective.py``,
   the population-sharded store). (a) Phase 10d's CNN FedEP rounds
   through ``FedSim(mesh=make_host_mesh())`` inside a one-rank NCCL
   group, against the same rounds with no mesh, both under
   ``deterministic()``: params and store bitwise equal (the NCCL calls
   are checked; NCCL between cards is not, on one card). (b) Phase 10a's
   command (FedEP, full-width fedlm-100m, 4 of 16 clients) on two ``python
   -m repro_torch.launch.train`` processes sharing the card over gloo
   (``--num-processes 2 --dist-backend gloo``, a checkpoint at round 3):
   both exit 0, rank 0 logs 3 records and rank 1 none, losses finite and
   ``client_loss_last`` within 2e-2 relative of 10a's, 6 DP launches of
   each kernel on each rank, 8 store rows (6,443,778,048 B) a rank, the
   replica digests equal after every round, and the two shard files' 16
   stamps equal to the draws; each rank's peak memory, host ms per round
   and bytes sent to the other rank per round (from its ``rank_summary``
   line). (c) 10b's one-layer fp32 FedEP replay on two ranks (spawned,
   one client each) against one process on the card: params and the
   store put together from the ranks within phase 4's bound, stamps
   exact.
16. The ``sequential`` placement's FSDP over ranks (``core/fsdp.py``):
   rounds through ``make_fed_round(..., placement="sequential",
   mesh=...)``, every parameter-shaped state a flat shard (the client
   stores' rows included), the compute params all-gathered at each
   gradient and the DP kernel pair on each rank's shard, its dots summed
   over the ranks. (a) The one-layer fp32 cut (9b's settings, 2 clients)
   through a one-rank NCCL mesh against no mesh, a burn-in and a FedPA
   round: the burn-in round bitwise, the FedPA round within 1e-6 of the
   largest entry (its coefficients come from the glue, not the reduce
   kernel's epilogue). (b) The same on two gloo ranks sharing the card
   (one row of each client a rank), spawned, then one round of each
   other algorithm from the burn-in state (fedpa_precision, fedprox,
   mime, scaffold on the host store, fedep and fedlora with the identity
   codec on the device store, then fedlora with ``lowrank+int8`` and with
   ``int8``, error feedback on the device store, each store made for the
   layout): each against the one-process card run and a CPU run made
   meanwhile (phase 4's bound, params and SCAFFOLD's ``c``), the ranks
   equal by digest (params, ``c``, client states), DP launches 6 of each
   kernel a rank for the five DP algorithms and 0 for the rest, a params
   all-gather per gradient (fedprox, mime and scaffold take 2 of the 6
   local steps: 12 gathers a round for MIME, 4 for the other two, 12 for
   the DP algorithms); the two int8 rounds count their codes flipped
   against one process on the card and against the CPU (a code more
   than one apart fails) and their wire bytes a client. (c) The full-width fedlm-100m in bf16 with phase 9's
   FedPA settings, STEPS_CUT's local steps and 2 clients on the two gloo
   ranks: each rank's peak
   memory, host ms a round, DP launches (6 each in the FedPA round),
   params all-gathers and bytes gathered and reduced against the layout's
   formula, and its state's bytes (master, server momentum, accumulator,
   ``v_hist``, batch-DP samples) against one process's, half each; the
   ranks' final params must have equal digests and the losses be finite.
   (e) One FedEP round at full width from 16c's state on the same ranks
   (a ``("data", "model")`` mesh of 1 x 2: 16c's shards, all of a
   client's rows on each rank), 2 of 16 clients' sites in a device store
   element-sharded over the ranks: each rank's host ms, peak memory, store
   bytes against ``16 x 2 x n x 4``, gathers and bytes by kind, 6 launches
   of each DP kernel; then the same round in one process on the card,
   after the ranks exit, whose params the ranks' meet to phase 4's bound.
   (f) One FedLoRA ``lowrank+int8`` round (rank 4, error feedback, a
   device store of the 2 clients) at full width from 16c's state on the
   same 1 x 2 mesh: each rank's host ms, peak memory, wire bytes a client
   (``round_bytes``' 903,144), the codec's all-reduces and bytes against
   the formula, 6 launches of each DP kernel; then the same round in one
   process on the card (phase 4's bound, the codes flipped counted).
   (g) FSDP checkpoints: each rank writes 16f's new server state with
   ``save_checkpoint_fsdp`` and reads it back bitwise, as it does 16b's
   FedEP store; after the ranks exit this process restores both at W = 1
   on the card, bitwise equal to the state the ranks gathered and to the
   store's rows put together (``gather_rows``).

Prints one JSON line with every kernel's numbers, the card's line, and last
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result, when
there is no CUDA device or the port's sources are missing, and when any
phase fails. The work stays under ``if __name__ == "__main__"``: phase
11's prefetcher child imports this file afresh (``spawn``).
"""
from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: HBM bandwidth (bytes/s) by card name, from NVIDIA's data sheets; an
#: H100 that is neither the PCIe nor the NVL part is the SXM one.
HBM_RATES = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12), ("H200", 4.8e12),
             ("H100", 3.35e12))
FP32_PEAK = 67e12          # H100 SXM, fp32 outside the tensor cores
BF16_PEAK = 989e12         # H100 SXM, bf16 tensor cores, dense

# the main path's configuration (ISSUE: one FedPA round of the EMNIST CNN)
FED_KW = dict(algorithm="fedpa", clients_per_round=16, local_steps=14,
              burn_in_steps=4, steps_per_sample=2, shrinkage_rho=0.01,
              burn_in_rounds=1, client_opt="sgdm", client_lr=0.01,
              server_opt="sgdm", server_lr=0.3)
NUM_CLIENTS, BATCH, ROUNDS = 64, 16, 3
# phase 8: (name, FedConfig overrides) of the rest of the round
ROUND_RUNS = (
    ("sequential", dict(round_placement="sequential")),
    ("chunked", dict(round_placement="chunked", round_chunk_size=6)),
    ("fedpa_precision", dict(algorithm="fedpa_precision")),
    ("chunked+dropout+qffl", dict(round_placement="chunked",
                                  round_chunk_size=6, dropout_rate=0.25,
                                  qffl_q=1.0)),
)
QUICKSTART_ROUNDS = 10
SOURCES = {"dp_reduce": "src/repro_torch/kernels/csrc/fedpa_dp.cu",
           "dp_map": "src/repro_torch/kernels/csrc/fedpa_dp.cu",
           "swa_decode": "src/repro_torch/kernels/csrc/swa_decode.cu"}
REPLACES = {"dp_reduce": "src/repro/kernels/fedpa_dp.py:69",
            "dp_map": "src/repro/kernels/fedpa_dp.py:97",
            "swa_decode": "src/repro/kernels/swa_decode.py:70"}

# phase 9: the LM training path at full width (the example's --full
# settings, cut to 3 rounds and 1 burn-in round, 12 local steps for l = 4)
TRAIN_ARGV = ["--arch", "fedlm-100m", "--algorithm", "fedpa", "--clients",
              "4", "--num-clients", "64", "--local-steps", "12",
              "--burn-in-steps", "4", "--steps-per-sample", "2",
              "--burn-in-rounds", "1", "--rounds", "3", "--batch", "4",
              "--seq-len", "128", "--server-lr", "0.3", "--prefetch-rounds",
              "0"]
# ... and its fp32 replay on one layer, card against CPU
# (6 local steps, 2 burn-in steps and a sample every step: l = 4 as at 12
# steps and a sample every 2, half the local steps for the script's time;
# its runs on the CPU in phases 9-12 took ~430 s at 12 on the H100
# machine)
REPLAY_ARGV = ["--arch", "fedlm-100m", "--algorithm", "fedpa", "--clients",
               "2", "--num-clients", "64", "--local-steps", "6",
               "--burn-in-steps", "2", "--steps-per-sample", "1",
               "--burn-in-rounds", "1", "--rounds", "2", "--batch", "2",
               "--seq-len", "64", "--server-lr", "0.3", "--prefetch-rounds",
               "0"]
# the local steps of phases 14a and 14b, cut from 12 for the script's
# time: 2 burn-in steps and a sample every step keep l = 4 (3 DP steps)
STEPS_CUT = ["--local-steps", "6", "--burn-in-steps", "2",
             "--steps-per-sample", "1"]
# phase 14a: the same command on the full-size xlstm-125m, at client lr
# 0.01: at the default 0.05 (momentum 0.9) its local steps diverge and
# reach NaN within the first round at full depth; one FedPA round and no
# burn-in round (cut from 1 + 2 for the script's time: 3 DP launches of
# each kernel, and the round's host ms includes its warm-up) of
# ``STEPS_CUT``'s local steps
XLSTM_ARGV = [("xlstm-125m" if a == "fedlm-100m" else a)
              for a in TRAIN_ARGV] + ["--client-lr", "0.01", "--rounds",
                                      "1", "--burn-in-rounds", "0"] \
    + STEPS_CUT
# phase 14b: phase 9's command at 8 x 512 tokens a client step, where the
# activations a recompute frees weigh against the DP's fp32 vectors
REMAT_ARGV = TRAIN_ARGV + ["--batch", "8", "--seq-len", "512", "--rounds",
                           "1", "--burn-in-rounds", "0"] + STEPS_CUT

# phase 10: the population of the full-width FedEP run (cut from 64: the
# device store holds 2 fp32 vectors of d per client) ...
FEDEP_CLIENTS = 16
# ... the one-layer FedEP replay's changes to phase 9b's command: a third
# round, so a site is read back, and a client lr at which the local steps
# train (the loss falls); at 9b's 0.05 the card-vs-CPU distance passed
# phase 4's bound
FEDEP_REPLAY = ["--rounds", "3", "--client-lr", "0.01"]
# ... and the stateful CNN runs (phase 3's settings)
STATE_RUNS = (
    ("scaffold host store", dict(algorithm="scaffold", client_opt="sgd",
                                 burn_in_rounds=0)),
    ("scaffold device store", dict(algorithm="scaffold", client_opt="sgd",
                                   burn_in_rounds=0,
                                   client_state_placement="device")),
    ("fedep device store", dict(algorithm="fedep",
                                client_state_placement="device")),
    ("fedep chunked chunk 6", dict(algorithm="fedep",
                                   client_state_placement="device",
                                   round_placement="chunked",
                                   round_chunk_size=6)),
)

# phase 11: async rounds. The reference's --async-rounds settings with a
# window of 3, and its default prefetcher (2 rounds ahead, a child
# process); the full-width runs cut to 5 rounds
ASYNC_ARGV = ["--async-rounds", "--max-staleness", "2",
              "--staleness-discount", "0.9"]
PREFETCH_ARGV = ["--prefetch-rounds", "2", "--prefetch-backend", "process"]
ASYNC_ROUNDS = 5
# ... and the CNN runs (phase 3's settings): the goldens' straggler spec
# (FedAvg, rate 0.5, lateness <= 2, window 3) and FedPA with their async2
# window
ASYNC_CNN_RUNS = (
    ("fedavg stragglers", dict(algorithm="fedavg", straggler_rate=0.5,
                               straggler_max_lateness=2, async_rounds=True,
                               max_staleness=2)),
    ("fedpa async2", dict(async_rounds=True, max_staleness=2,
                          staleness_discount=0.9)),
)

# phase 12: FedLoRA. The codec of the full-width run (rank 4), its
# population (cut from 64: the device store holds one fp32 residual of d
# per client) and the per-client wire bytes of fedlm-100m as the JAX
# package's ``round_bytes`` gives them
FEDLORA_CODEC = ["--payload-codec", "lowrank+int8", "--lora-rank", "4"]
FEDLORA_CLIENTS = 16
FEDLM_UP = {"fedpa_precision": 805_472_256, "lowrank": 3_612_160,
            "lowrank+int8": 903_144, "int8": 201_368_168}
FEDLM_DOWN, FEDLM_DENSE = 402_736_132, 402_736_128

# phase 15: multi-process training. Seconds a rank waits for its peers
# (and each collective), and for a rank to exit
MP_CONNECT_S = 300
MP_TIMEOUT_S = 600
# the serving path (gemma3-27b at full width): batch, prompt, generated
SERVE_B, SERVE_PROMPT, SERVE_GEN = 4, 1280, 32
# phase 13: the other architectures served at full width, bf16: (arch,
# prompt, generated tokens, repeats cut to or None); the first two
# profiled
SERVE_ARCHS = (
    ("qwen3-moe-30b-a3b", 1024, 16, None),
    ("recurrentgemma-9b", 3072, 16, None),
    ("internvl2-26b", 512, 16, None),
    ("minitron-4b", 512, 16, None),
    ("musicgen-medium", 512, 16, None),
    ("xlstm-125m", 512, 16, None),
    ("granite-34b", 512, 16, 40),
    ("llama4-scout-17b-a16e", 512, 16, 2),
)
PROFILED = ("qwen3-moe-30b-a3b", "recurrentgemma-9b")
# ... and the one-layer fp32 cuts, card vs CPU: (name, arch, config
# changes, batch, prompt); the prompt of a frontend arch includes its
# frontend tokens
CUT_STEPS = 4
# the fp32 wiring check: prompt and decode steps
WIRE_PROMPT, WIRE_STEPS = 1100, 8
L2_BYTES = 50 * 2**20      # H100 L2; timed inputs rotate through 3x this


def fail(msg: str) -> None:
    """Stop the run: exit non-zero with ``msg``, printing no result."""
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def hbm_rate(name: str) -> float:
    """The card's HBM bandwidth in bytes/s, by its name."""
    for key, rate in HBM_RATES:
        if key in name:
            return rate
    fail(f"no HBM rate known for {name!r}")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(*tensors) -> int:
    """Bytes held by ``tensors``."""
    return sum(t.numel() * t.element_size() for t in tensors)


def rotating(n: int, make):
    """``n`` copies made by ``make()`` and a function that hands them out in
    turn, so that timed calls find their inputs cold in the L2 cache."""
    copies = [make() for _ in range(n)]
    it = itertools.cycle(copies)
    return copies, lambda: next(it)


def copies_past_l2(nbytes_one: int) -> int:
    """How many copies of inputs of ``nbytes_one`` bytes make 3x the L2."""
    return max(1, min(8, math.ceil(3 * L2_BYTES / nbytes_one)))


def device_ops_per_call(fn, calls: int = 10, tries: int = 3):
    """Device operations (kernels, copies, memsets) per call of ``fn``, as
    ``torch.profiler`` sees them over ``calls`` calls; the profiler misses
    a record now and then, never adds one, so the most of ``tries`` tries
    is kept. Returns (ops per call, sorted names)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best, names = 0, set()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        if len(ev) > best:
            best, names = len(ev), {e.name for e in ev}
    return best / calls, sorted(names)


#: phase 2's DP cases (C, lp, d, dtype): the main path's shape (the
#: cohort at ``parallel``), lp 1, the stacks of ``sequential`` (1) and
#: ``chunked`` chunk 6, a ragged small d, bf16 inputs, the LM paths' d and
#: the FSDP shard of fedlm-100m over two ranks (phase 16c). The cases
#: marked timed also get device and host times.
DP_D = 428_350
#: d of the LM training path (fedlm-100m's parameter count)
LM_D = 100_684_032
#: d of xlstm-125m (``configs.get_config("xlstm-125m").param_count()``)
XLSTM_D = 129_642_288
DP_CASES = ((16, 4, DP_D, "float32", True), (16, 1, DP_D, "float32", False),
            (1, 4, DP_D, "float32", True), (6, 4, DP_D, "float32", True),
            (3, 4, 1300, "float32", False), (16, 4, DP_D, "bfloat16", True),
            (4, 3, LM_D, "float32", True), (8, 3, LM_D, "float32", True),
            (4, 3, XLSTM_D, "float32", True),
            (1, 3, LM_D // 2, "float32", True))
#: the outputs a CUDA graph of timed calls may hold (phase 2)
GRAPH_BYTES = 4 * 2**30
#: the ``ops.dp_step`` rows: stacks of 1, 6 and 16 clients
STEP_CS = (1, 6, 16)


def library_reduce(u, delta, V):
    """The reduce's dots as one library call (``bmm``), then ``uu``, ``ud``
    by two more: the library form of ``dp_step``'s reduce."""
    import torch

    return (torch.bmm(V, u[..., None])[..., 0], (u * u).sum(-1),
            (u * delta).sum(-1))


def library_map(w, s, u, delta, V):
    """The map's combine as one library call (``baddbmm``), then
    ``delta'``: the library form of ``dp_step``'s map."""
    import torch

    v = torch.baddbmm(u[:, None, :], w.to(u.dtype)[:, None, :], V,
                      alpha=-1)[:, 0]
    return v, delta - s[:, None].to(u.dtype) * v


def check_dp_case(C, lp, d, dtype_name, timed, rate):
    """One DP case of phase 2: both kernels against their twins, two calls
    bit for bit, at C = 16 every client alone against its row of the stack,
    and their times; returns {kernel: row}."""
    import torch

    from repro_torch.kernels import fedpa_dp, ref

    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(C * 1000 + lp)
    esize = torch.tensor([], dtype=dtype).element_size()
    n = copies_past_l2(C * (lp + 2) * d * esize)

    def make():
        u, delta = (torch.randn(C, d, device="cuda", generator=g).to(dtype)
                    for _ in range(2))
        V = torch.randn(C, lp, d, device="cuda", generator=g).to(dtype)
        return u, delta, V

    copies, nxt = rotating(n, make)
    u, delta, V = copies[0]
    w = torch.randn(C, lp, device="cuda", generator=g)
    s = torch.randn(C, device="cuda", generator=g)
    tag = f"C={C} lp={lp} d={d} {dtype_name}"

    got = fedpa_dp.dp_reduce(u, delta, V)
    again = fedpa_dp.dp_reduce(u, delta, V)
    want = ref.dp_reduce_ref(u, delta, V)
    torch.cuda.synchronize()
    red_err = max((a - b).abs().max().item() for a, b in zip(got, want))
    scale = max(b.abs().max().item() for b in want)
    # fp32 sums of d terms in another order: 1e-5 of the largest sum
    if not red_err <= 1e-5 * max(scale, 1.0):
        fail(f"dp_reduce {tag}: max err {red_err} (scale {scale})")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"dp_reduce {tag}: two calls differ")

    vout, dout = fedpa_dp.dp_map(w, s, u, delta, V)
    v2, d2 = fedpa_dp.dp_map(w, s, u, delta, V)
    v_ref, d_ref = ref.dp_map_ref(w, s, u, delta, V)
    torch.cuda.synchronize()
    map_err = max((vout.float() - v_ref.float()).abs().max().item(),
                  (dout.float() - d_ref.float()).abs().max().item())
    scale = max(v_ref.float().abs().max().item(),
                d_ref.float().abs().max().item())
    # fp32: an ulp or so of the largest entry; bf16 outputs: one bf16
    # rounding (2^-8 relative) of the largest entry
    tol = (2e-2 if dtype == torch.bfloat16 else 1e-6) * max(scale, 1.0)
    if not map_err <= tol:
        fail(f"dp_map {tag}: max err {map_err} (scale {scale})")
    if not (torch.equal(vout, v2) and torch.equal(dout, d2)):
        fail(f"dp_map {tag}: two calls differ")
    del again, want, v2, d2, v_ref, d_ref

    alone = ""
    if C == 16:
        for c in range(C):
            one = [x[c:c + 1].clone() for x in (u, delta, V)]
            red1 = fedpa_dp.dp_reduce(*one)
            map1 = fedpa_dp.dp_map(w[c:c + 1].clone(), s[c:c + 1].clone(),
                                   *one)
            if not all(torch.equal(a[0], b[c]) for a, b in zip(red1, got)):
                fail(f"dp_reduce {tag}: client {c} alone differs from its "
                     f"row of the stack")
            if not all(torch.equal(a[0], b[c])
                       for a, b in zip(map1, (vout, dout))):
                fail(f"dp_map {tag}: client {c} alone differs from its row "
                     f"of the stack")
        alone = "; each client alone == its row of the stack (bitwise)"

    red_bytes = nbytes(u, delta, V) + C * (lp + 2) * 4
    map_bytes = nbytes(w, s, u, delta, V) + nbytes(u, delta)
    rows = {
        "dp_reduce": dict(
            max_abs_err=red_err,
            kernel=lambda: fedpa_dp.dp_reduce(*nxt()),
            plain=lambda: ref.dp_reduce_ref(*nxt()),
            library=lambda: torch.bmm(nxt()[2], u[..., None]),
            bound_ms=max(red_bytes / rate,
                         2 * C * (lp + 2) * d / FP32_PEAK) * 1e3),
        "dp_map": dict(
            max_abs_err=map_err,
            kernel=lambda: fedpa_dp.dp_map(w, s, *nxt()),
            plain=lambda: ref.dp_map_ref(w, s, *nxt()),
            library=lambda: torch.baddbmm(
                u[:, None, :], w.to(dtype)[:, None, :], nxt()[2], alpha=-1),
            bound_ms=max(map_bytes / rate,
                         2 * C * (lp + 1) * d / FP32_PEAK) * 1e3),
    }
    for name, r in rows.items():
        kernel, library = r.pop("kernel"), r.pop("library")
        turns = [time_ms(fn) for fn in (kernel, library, library, kernel)]
        r.update(ms=(turns[0] + turns[3]) / 2,
                 library_ms=(turns[1] + turns[2]) / 2,
                 plain_ms=time_ms(r.pop("plain")))
        line = (f"kernel {name} [{tag}]: max_abs_err={r['max_abs_err']:.3g} "
                f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
                f"library_ms={r['library_ms']:.4f} "
                f"bound_ms={r['bound_ms']:.4f} (bytes; inputs rotated over "
                f"{n} copies); two calls equal bitwise{alone}")
        if timed:
            # 20 calls in a graph, or 2 where 20 calls' outputs would hold
            # more than GRAPH_BYTES (the map's (v, delta') at the LM's d)
            iters = 20 if 20 * nbytes(u, delta) <= GRAPH_BYTES else 2
            dev, lib_dev = device_ms_in_turns(kernel, library, iters=iters)
            r.update(device_ms=dev, library_device_ms=lib_dev,
                     host_ms=host_ms(kernel))
            line += (f"; device_ms={dev:.4f} library_device_ms="
                     f"{lib_dev:.4f} host_ms={r['host_ms']:.4f}; device "
                     f"share of bound {r['bound_ms'] / dev:.3f}")
        print(line, flush=True)
    return rows


def check_dp_step(C, rate, lp: int = 4, t: int = 5, rho: float = 0.01):
    """One ``ops.dp_step`` row of phase 2 (fp32, main d, all lp history rows
    live at t = lp + 1): the step against the twins' step, two calls bit for
    bit, its times against the step through library calls, and the device
    operations one step makes."""
    import torch

    from repro_torch.kernels import ops, ref

    d = DP_D
    g = torch.Generator(device="cuda").manual_seed(C * 7 + t)
    n = copies_past_l2(C * (lp + 2) * d * 4)

    def make():
        u, delta = (torch.randn(C, d, device="cuda", generator=g)
                    for _ in range(2))
        V = torch.randn(C, lp, d, device="cuda", generator=g)
        c_hist = torch.rand(C, lp, device="cuda", generator=g)
        return u, delta, V, c_hist

    copies, nxt = rotating(n, make)
    args = copies[0]
    got = ops.dp_step(*args, t, rho)
    again = ops.dp_step(*args, t, rho)
    want = ref.dp_step_ref(*args, t, rho)
    torch.cuda.synchronize()
    err = 0.0
    for a, b in zip(got, want):
        err = max(err, (a - b).abs().max().item())
        # the coefficients come from reduce sums in another order (1e-4
        # relative); entries that cancel keep an error of the largest's size
        tol = 1e-4 * max(b.abs().max().item(), 1.0)
        if not torch.allclose(a, b, rtol=1e-4, atol=tol):
            fail(f"dp_step C={C}: differs from the twins' step (max {err})")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"dp_step C={C}: two calls differ")

    def kernel():
        return ops.dp_step(*nxt(), t, rho)

    def library():
        return ref.dp_step_with(library_reduce, library_map, *nxt(), t, rho)

    u, delta, V, c_hist = args
    step_bytes = 2 * nbytes(u, delta, V) + nbytes(c_hist) + 2 * nbytes(u) \
        + 2 * C * 4
    turns = [time_ms(fn) for fn in (kernel, library, library, kernel)]
    dev, lib_dev = device_ms_in_turns(kernel, library)
    ops_per_step, names = device_ops_per_call(kernel)
    lib_ops, _ = device_ops_per_call(library)
    # two launches and no other device operation (the profiler may miss a
    # record, never add one)
    if not 0 < ops_per_step <= 2 or not all(
            "reduce_kernel" in k or "map_kernel" in k for k in names):
        fail(f"dp_step C={C}: {ops_per_step} device ops per step: {names}")
    row = dict(max_abs_err=err, ms=(turns[0] + turns[3]) / 2,
               library_ms=(turns[1] + turns[2]) / 2, device_ms=dev,
               library_device_ms=lib_dev, host_ms=host_ms(kernel),
               plain_ms=time_ms(lambda: ref.dp_step_ref(*nxt(), t, rho)),
               bound_ms=max(step_bytes / rate,
                            2 * C * (2 * lp + 3) * d / FP32_PEAK) * 1e3,
               device_ops=ops_per_step)
    print(f"ops.dp_step [C={C} lp={lp} d={d} float32 t={t}]: max_abs_err="
          f"{err:.3g} ms={row['ms']:.4f} device_ms={dev:.4f} host_ms="
          f"{row['host_ms']:.4f} plain_ms={row['plain_ms']:.4f} library_ms="
          f"{row['library_ms']:.4f} library_device_ms={lib_dev:.4f} "
          f"bound_ms={row['bound_ms']:.4f} (bytes, both passes; inputs "
          f"rotated over {n} copies); device ops per step "
          f"{ops_per_step:g} (library form {lib_ops:g}): "
          f"{', '.join(k[:60] for k in names)}", flush=True)
    return row


def check_kernels(card: str):
    """Phase 2: every DP kernel against its twin and its times, then the
    whole ``ops.dp_step``; returns the numbers of the main path's shape
    (fp32, C=16, lp=4) per kernel, with ``by_stack`` holding the timed
    cases' rows."""
    import torch

    rate = hbm_rate(card)
    main, by_stack = {}, {}
    for C, lp, d, dtype_name, timed in DP_CASES:
        rows = check_dp_case(C, lp, d, dtype_name, timed, rate)
        if timed:
            key = f"C={C} {dtype_name}" + (f" d={d}" if d != DP_D else "")
            for name, r in rows.items():
                by_stack.setdefault(name, {})[key] = r
        if (C, lp, d, dtype_name) == DP_CASES[0][:4]:
            main = rows
        torch.cuda.empty_cache()
    for C in STEP_CS:
        check_dp_step(C, rate)
    for name in main:
        main[name]["by_stack"] = {
            k: {key: r[key] for key in ("ms", "device_ms", "host_ms",
                                        "bound_ms", "library_ms",
                                        "library_device_ms")}
            for k, r in by_stack[name].items()}
    return main


def make_batch_fn(cfg, seed: int):
    """Numpy images and labels per (client, round), made from ``seed``."""
    import numpy as np

    s = cfg.image_size

    def batch_fn(cid, rnd, num_steps):
        r = np.random.default_rng([seed, cid, rnd])
        return {"x": r.random((num_steps, BATCH, s, s, 1), np.float32),
                "y": r.integers(0, cfg.num_classes, (num_steps, BATCH),
                                dtype=np.int32)}

    return batch_fn


def make_sim(device: str, seed: int, streaming: bool, mesh=None, **over):
    """The main path's ``FedSim`` on the full-width EMNIST CNN
    (``FED_KW`` with ``over`` on top; over ``mesh`` when given)."""
    from repro_torch.configs.base import FedConfig
    from repro_torch.configs.emnist_cnn import config
    from repro_torch.core.round import FedSim
    from repro_torch.models.cnn import cnn_grad_fn

    cfg = config()
    return FedSim(FedConfig(**{**FED_KW, **over}, streaming_dp=streaming),
                  cnn_grad_fn(cfg), make_batch_fn(cfg, seed), NUM_CLIENTS,
                  seed=seed, device=device, mesh=mesh)


def run_main_path(device: str, params, seed: int, streaming: bool):
    """3 FedPA rounds of the EMNIST CNN through ``FedSim.run``."""
    import torch

    state, history = make_sim(device, seed, streaming).run(params, ROUNDS)
    if device == "cuda":
        torch.cuda.synchronize()
    losses = [h[k] for h in history for k in ("loss_first", "loss_last")]
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite losses on {device} (streaming={streaming}): "
             f"{losses}")
    if not all(torch.isfinite(p).all() for p in state.params.values()):
        fail(f"non-finite params on {device} (streaming={streaming})")
    return state, history


def slot_positions(kind: str, L: int, pos: int):
    """(L,) int32 token position per cache slot after ``pos``: ``ring``
    puts position p in slot p % L (the newest L positions), ``linear`` in
    slot p; -1 marks an empty slot."""
    import numpy as np

    i = np.arange(L)
    if kind == "ring":
        p = (pos // L) * L + i
        p = np.where(p > pos, p - L, p)
    else:
        p = np.where(i <= pos, i, -1)
    return np.where(p >= 0, p, -1).astype(np.int32)


#: (name, B, H, KV, dh, L, window, pos, slots): the serving shapes first
#: (gemma3-27b's local layer: wrapped ring; its global layer: linear;
#: qwen3-32b's layer: linear, G 8), then the sweep of tests/test_kernels.py,
#: a ragged L, L below the cluster's 8 CTAs, the widest CTA (G 16, head_dim
#: 256), masked leading ranges and a cache masked everywhere (-> the mean
#: of V).
SWA_CASES = [
    ("local", 4, 32, 16, 128, 1024, 1024, 1300, "ring"),
    ("global", 4, 32, 16, 128, 1344, 0, 1300, "linear"),
    ("qwen3", 4, 64, 8, 128, 1344, 0, 1300, "linear"),
    *[("sweep", B, H, KV, dh, L, w, L - 50, "linear")
      for B, H, KV, dh, L in ((1, 4, 1, 64, 512), (2, 8, 2, 64, 1024),
                              (2, 4, 4, 128, 512)) for w in (0, 300)],
    ("ragged", 2, 8, 2, 64, 1000, 256, 1100, "ring"),
    ("L=1", 2, 8, 2, 64, 1, 0, 0, "linear"),
    ("L=5", 2, 8, 2, 64, 5, 0, 4, "linear"),
    ("widest", 2, 32, 2, 256, 700, 300, 699, "linear"),
    ("masked-head", 4, 32, 16, 128, 1344, 0, 1343, "masked-head"),
    ("all-masked", 4, 32, 16, 128, 1344, 0, 1343, "empty"),
    # phase 13's decode shapes: the cache of a 512-token prompt plus 16
    # tokens, of qwen3-moe's 1024 + 32, recurrentgemma's ring of 2048
    # (prompt 3072 + 32) and llama4-scout's chunked-local ring of 8192
    ("qwen3-moe", 4, 32, 4, 128, 1056, 0, 1054, "linear"),
    ("granite", 4, 48, 1, 128, 528, 0, 526, "linear"),
    ("minitron", 4, 24, 8, 128, 528, 0, 526, "linear"),
    ("internvl2", 4, 48, 8, 128, 528, 0, 526, "linear"),
    ("musicgen", 4, 24, 24, 64, 528, 0, 526, "linear"),
    ("recurrentgemma", 4, 16, 1, 256, 2048, 2048, 3102, "ring"),
    ("llama4", 4, 40, 8, 128, 8192, 8192, 9000, "ring"),
]
SERVING = ("local", "global", "qwen3", "qwen3-moe", "granite", "minitron",
           "internvl2", "musicgen", "recurrentgemma", "llama4")


def device_ms_in_turns(kernel, library, iters: int = 20):
    """Device time per call of ``kernel`` and of ``library``: each one's
    ``iters`` calls captured in a CUDA graph, the graphs replayed in turns
    (kernel, library, library, kernel) and timed with CUDA events, so no
    host time comes between the calls. Returns (kernel ms, library ms)."""
    import torch

    graphs = []
    for fn in (kernel, library):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
        graph.replay()
        graphs.append(graph)
    times = ([], [])
    for which in (0, 1, 1, 0):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        graphs[which].replay()
        end.record()
        torch.cuda.synchronize()
        times[which].append(start.elapsed_time(end) / iters)
    return sum(times[0]) / 2, sum(times[1]) / 2


def host_ms(fn, iters: int = 50) -> float:
    """Host time per call of ``fn`` (the enqueue, no sync inside)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e3


def check_swa_decode(card: str):
    """Phase 5: ``swa_decode`` against its twin on the card; returns the
    numbers of the local-layer bf16 shape (the JSON row)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels import swa_decode as swa

    rate = hbm_rate(card)
    rows = {}
    for (name, B, H, KV, dh, L, window, pos, kind), dtype in \
            itertools.product(SWA_CASES, (torch.bfloat16, torch.float32)):
        g = torch.Generator(device="cuda").manual_seed(L + H + window)
        G = H // KV
        q = torch.randn(B, KV, G, dh, device="cuda", generator=g).to(dtype)
        kv_bytes = 2 * B * L * KV * dh * q.element_size()
        # the serving shapes' caches rotate through 3x the L2, as in decode;
        # the small shapes stay in it
        copies = min(8, math.ceil(3 * L2_BYTES / kv_bytes))
        caches = [tuple(torch.randn(B, L, KV, dh, device="cuda",
                                    generator=g).to(dtype) for _ in range(2))
                  for _ in range(copies)]
        if kind == "masked-head":       # the first 320 slots are empty
            sp_np = slot_positions("linear", L, pos)
            sp_np[:320] = -1
        elif kind == "empty":
            sp_np = np.full(L, -1, np.int32)
        else:
            sp_np = slot_positions(kind, L, pos)
        sp = torch.from_numpy(sp_np).cuda()
        k, v = caches[0]
        got = swa.swa_decode_attention(q, k, v, sp, pos, window=window)
        again = swa.swa_decode_attention(q, k, v, sp, pos, window=window)
        want = ref.swa_decode_ref(q, k, v, sp, pos, window=window)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        # fp32: sums in another order; bf16: one rounding of the output
        tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
        tag = (f"{name} B={B} H={H} KV={KV} dh={dh} L={L} window={window} "
               f"pos={pos} {str(dtype).split('.')[-1]}")
        if not (diff <= tol + tol * want.float().abs()).all():
            fail(f"swa_decode {tag}: max err {err}")
        if not torch.equal(got, again):
            fail(f"swa_decode {tag}: two calls differ")
        if kind == "empty":
            mean_v = v.float().mean(dim=1)[:, :, None].expand(B, KV, G, dh)
            if not (got.float() - mean_v).abs().max().item() <= tol * 4:
                fail(f"swa_decode {tag}: masked row is not the mean of V")
        it = itertools.cycle(caches)
        valid = torch.from_numpy(
            (sp_np >= 0) & (sp_np <= pos)
            & ((window <= 0) | (sp_np > pos - window))).cuda()
        mask = valid[None, None, None, :]
        q4 = q.reshape(B, H, 1, dh)

        def kernel():
            return swa.swa_decode_attention(q, *next(it), sp, pos,
                                            window=window)

        def library():
            return F.scaled_dot_product_attention(
                q4, *(t.transpose(1, 2) for t in next(it)), attn_mask=mask,
                enable_gqa=True)

        out_bytes = nbytes(q) + 2 * nbytes(k) + nbytes(sp) + nbytes(got)
        turns = [time_ms(fn) for fn in (kernel, library, library, kernel)]
        row = dict(
            max_abs_err=err, ms=(turns[0] + turns[3]) / 2,
            plain_ms=time_ms(lambda: ref.swa_decode_ref(
                q, *next(it), sp, pos, window=window)),
            library_ms=(turns[1] + turns[2]) / 2,
            bound_ms=max(out_bytes / rate,
                         4 * B * H * L * dh / FP32_PEAK) * 1e3)
        line = (f"kernel swa_decode [{tag}]: max_abs_err={err:.3g} "
                f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                f"library_ms={row['library_ms']:.4f} "
                f"bound_ms={row['bound_ms']:.4f} (bytes, "
                f"{out_bytes / 1e6:.1f} MB; K/V rotated over {copies} "
                f"copies); turns kernel/SDPA/SDPA/kernel "
                f"{' '.join(f'{x:.4f}' for x in turns)}")
        if name in SERVING:
            dev, lib_dev = device_ms_in_turns(kernel, library)
            row.update(device_ms=dev, library_device_ms=lib_dev,
                       host_ms=host_ms(kernel))
            clusters = swa._check(q, k, v, sp, pos, window)[-1]
            line += (f"; device_ms={dev:.4f} library_device_ms={lib_dev:.4f} "
                     f"host_ms={row['host_ms']:.4f}; {clusters} clusters "
                     f"of 8 CTAs fit at once, this call has {B * KV}")
            line += f"; device share of bound {row['bound_ms'] / dev:.3f}"
        print(line, flush=True)
        rows[(name, dtype)] = row
    return rows[("local", torch.bfloat16)]


def wiring_check(seed: int) -> None:
    """Phase 6: fp32 decode logits of the kernel route equal the plain
    route's at full width, reduced depth."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels import swa_decode as swa
    from repro_torch.launch import serve
    from repro_torch.models.model import clone_state, init_params
    from repro_torch.models.steps import prefill_step

    f32 = torch.float32
    cfg = configs.replace(configs.get_config("gemma3-27b"), repeats=1)
    params = init_params(torch.Generator(device="cuda").manual_seed(seed),
                         cfg, f32, device="cuda")
    prompts = torch.from_numpy(serve.make_prompts(
        cfg, SERVE_B, WIRE_PROMPT, seed)).cuda()
    max_len = WIRE_PROMPT + WIRE_STEPS + 1
    logits, state = prefill_step(params, prompts, cfg, max_len,
                                 compute_dtype=f32, q_chunk=256,
                                 cache_dtype=f32)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    state0 = clone_state(state)
    swa.reset_launches()
    kern = serve.decode(params, tok, state, cfg, WIRE_STEPS, use_kernel=True,
                        compute_dtype=f32)
    n_kernel = swa.launches["swa_decode"]
    swa.reset_launches()
    plain = serve.decode(params, tok, state0, cfg, WIRE_STEPS,
                         use_kernel=False, forced=kern["tokens"],
                         compute_dtype=f32)
    n_plain = swa.launches["swa_decode"]
    print(f"fp32 wiring ({cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"prompt {WIRE_PROMPT}, {WIRE_STEPS} steps): launches kernel "
          f"route {n_kernel}, plain route {n_plain}")
    if n_kernel != WIRE_STEPS * cfg.num_layers or n_plain != 0:
        fail(f"fp32 wiring launches {n_kernel}, {n_plain}")
    err = 0.0
    for a, b in zip(kern["logits"], plain["logits"]):
        err = max(err, (a - b).abs().max().item())
        # tests/test_pallas_serving.py's tolerance for the two routes
        if not torch.allclose(a, b, rtol=2e-3, atol=2e-3):
            fail(f"fp32 wiring: kernel vs plain logits differ, max {err}")
    print(f"fp32 wiring: max logit diff kernel vs plain {err:.3g} "
          f"(rtol/atol 2e-3)", flush=True)


def profile_decode(res, cfg, step_ms: float, steps: int = 4) -> None:
    """Where a decode step's time goes: ``torch.profiler`` over ``steps``
    kernel-route steps from a copy of the prefill state. Prints the device
    time and kernel count per step, the time's share of the unprofiled warm step
    ``step_ms`` (the rest is the card waiting for the host), and the
    kernels that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import serve
    from repro_torch.models.model import clone_state

    state = clone_state(res["prefill_state"])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        serve.decode(res["params"], res["tok"], state, cfg, steps,
                     use_kernel=True)
    del state
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in events)
    if dev_us <= 0:
        print("decode profile: the profiler saw no device time (device "
              "share not measured)")
        return
    per_step = dev_us / steps / 1e3
    n_kernels = sum(e.count for e in events) / steps
    print(f"decode profile ({steps} steps): {n_kernels:.0f} kernels and "
          f"device time {per_step:.3f} ms per step, "
          f"{per_step / step_ms:.3f} of the warm step "
          f"({step_ms:.3f} ms); device idle share "
          f"{1 - per_step / step_ms:.3f}")
    ours = [e for e in events if "swa_decode" in e.key]
    print(f"  swa_decode: "
          f"{sum(e.self_device_time_total for e in ours) / steps / 1e3:.3f} "
          f"ms/step device time in {sum(e.count for e in ours) // steps} "
          f"launches/step")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"  {e.self_device_time_total / steps / 1e3:8.3f} ms/step "
              f"{e.count // steps:5d} calls/step  {e.key[:90]}")


def expected_dp_launches(over: dict) -> int:
    """Launches of each DP kernel in one ``ROUNDS``-round run of
    ``FED_KW`` with ``over``: FedPA rounds x (l - 1) DP steps x the stacks
    of clients a round hands the kernels (the cohort at ``parallel``, each
    client at ``sequential``, each chunk, padding included, at
    ``chunked``)."""
    fed = {**FED_KW, **over}
    C = fed["clients_per_round"]
    ell = (fed["local_steps"] - fed["burn_in_steps"]) \
        // fed["steps_per_sample"]
    place = fed.get("round_placement", "parallel")
    stacks = (C if place == "sequential"
              else -(-C // fed["round_chunk_size"]) if place == "chunked"
              else 1)
    return (ROUNDS - fed["burn_in_rounds"]) * (ell - 1) * stacks


def run_rounds(device: str, params, seed: int, over: dict):
    """``ROUNDS`` rounds of ``make_sim(..., **over)`` through
    ``FedSim.round``, each timed with a device sync; returns (state,
    records, round ms)."""
    import torch

    sim = make_sim(device, seed, False, **over)
    state = sim.init(params)
    records, ms = [], []
    for r in range(ROUNDS):
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, rec = sim.round(state, r)
        if device == "cuda":
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        records.append(rec)
    losses = [h[k] for h in records for k in ("loss_first", "loss_last")]
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite losses on {device} ({over}): {losses}")
    if not all(torch.isfinite(p).all() for p in state.params.values()):
        fail(f"non-finite params on {device} ({over})")
    return state, records, ms


#: substrings of the kernel names that belong to convolutions (forward,
#: data and weight gradients, split-K reductions)
CONV_KEYS = ("wgrad", "dgrad", "fprop", "conv", "splitk", "implicit",
             "bwd_filter", "bwd_data")


def conv_kernels(params, seed: int, cpu_params) -> None:
    """Phase 4, part 2 (a report): phase 3's batch-DP rounds on the card
    with cuDNN's default algorithms and under ``deterministic()``, each
    under ``torch.profiler``; prints each run's distance from the CPU run
    ``cpu_params`` and the convolution kernels it launched."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for det in (False, True):
        mode = "deterministic" if det else "default"
        with deterministic(det), \
                profile(activities=[ProfilerActivity.CUDA]) as prof:
            state, _ = run_main_path("cuda", params, seed, False)
            torch.cuda.synchronize()
        err = max((state.params[k].cpu() - v).abs().max().item()
                  for k, v in cpu_params.items())
        kernels = {e.key: e.count for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and any(k in e.key.lower() for k in CONV_KEYS)}
        print(f"conv kernels, {mode} cuDNN algorithms (phase 3's rounds, "
              f"batch DP): card vs CPU params max abs diff {err:.3g}; "
              f"{len(kernels) or 'no (not measured)'} convolution kernels "
              f"seen", flush=True)
        for key, count in sorted(kernels.items()):
            print(f"  {count:6d} x {key[:150]}", flush=True)


def params_close(got, want, what: str) -> None:
    """Phase 4's bound on two param trees (``got`` may be on the card):
    rtol 1e-3, atol 1e-4; prints the max abs difference."""
    import torch

    from repro_torch.core import tree_math as tm

    pairs = list(zip(tm.tleaves(got), tm.tleaves(want)))
    err = max((a.cpu() - b.cpu()).abs().max().item() for a, b in pairs)
    print(f"  {what}: max abs diff {err:.3g}", flush=True)
    for i, (a, b) in enumerate(pairs):
        if not torch.allclose(a.cpu(), b.cpu(), rtol=1e-3, atol=1e-4):
            fail(f"{what}: leaf {i} differs (max abs diff {err})")


def rest_of_round(params, parallel_params, seed: int) -> dict:
    """Phase 8, part 1: the placements, ``fedpa_precision`` and the faults
    on the full-width CNN; returns each run's DP launches."""
    from repro_torch.kernels import fedpa_dp

    by_run = {}
    for name, over in ROUND_RUNS:
        fedpa_dp.reset_launches()
        with deterministic():
            state, records, ms = run_rounds("cuda", params, seed, over)
        launches = dict(fedpa_dp.launches)
        expected = expected_dp_launches(over)
        dropped = [h["dropped"] for h in records]
        alg = over.get("algorithm", FED_KW["algorithm"])
        print(f"round run {name}: round ms {[round(x, 2) for x in ms]} "
              f"(round 0 the FedAvg burn-in, rounds 1-2 {alg}, round 2 "
              f"warm); DP launches {launches} (expected {expected} "
              f"each); dropped {dropped}; loss_last "
              f"{[round(h['loss_last'], 4) for h in records]}", flush=True)
        if any(n != expected for n in launches.values()):
            fail(f"{name}: DP launches {launches} != {expected} each")
        if over.get("dropout_rate") and not sum(dropped):
            fail(f"{name}: no client dropped, the mask path did not run")
        by_run[name] = launches
        if "algorithm" not in over and "dropout_rate" not in over:
            params_close(state.params, parallel_params,
                         f"{name} vs phase 3's parallel params")
        cpu_state, cpu_records, _ = run_rounds("cpu", params, seed, over)
        if [h["dropped"] for h in cpu_records] != dropped:
            fail(f"{name}: the CPU replay dropped other clients")
        params_close(state.params, cpu_state.params,
                     f"{name} vs its CPU replay")
    return by_run


def quickstart_check() -> dict:
    """Phase 8, part 2: the least-squares quickstart on the card and on the
    CPU; returns the card run's DP launches."""
    import numpy as np

    from repro_torch.examples import quickstart
    from repro_torch.kernels import fedpa_dp

    fedpa_dp.reset_launches()
    t0 = time.perf_counter()
    card = quickstart.run("cuda", QUICKSTART_ROUNDS)
    card_s = time.perf_counter() - t0
    launches = dict(fedpa_dp.launches)
    fed = quickstart.CONFIGS["fedpa"]
    ell = (fed.local_steps - fed.burn_in_steps) // fed.steps_per_sample
    expected = (QUICKSTART_ROUNDS * (ell - 1)
                * -(-fed.clients_per_round // fed.round_chunk_size))
    t0 = time.perf_counter()
    cpu = quickstart.run("cpu", QUICKSTART_ROUNDS)
    cpu_s = time.perf_counter() - t0
    print(f"quickstart ({QUICKSTART_ROUNDS} rounds of 60; D {quickstart.D}, "
          f"{fed.clients_per_round} of {quickstart.N_CLIENTS} clients, "
          f"{fed.local_steps} local steps, fedpa chunked chunk "
          f"{fed.round_chunk_size}): distance to the optimum on the card "
          f"fedavg {card['fedavg']['distance']:.4f}, fedpa "
          f"{card['fedpa']['distance']:.4f}; on the CPU fedavg "
          f"{cpu['fedavg']['distance']:.4f}, fedpa "
          f"{cpu['fedpa']['distance']:.4f}; {card_s:.1f} s on the card, "
          f"{cpu_s:.1f} s on the CPU; DP launches {launches} (expected "
          f"{expected} each)", flush=True)
    if any(n != expected for n in launches.values()):
        fail(f"quickstart: DP launches {launches} != {expected} each")
    if not card["fedpa"]["distance"] < card["fedavg"]["distance"]:
        fail("quickstart: FedPA did not end closer to the optimum than "
             "FedAvg")
    for name in card:
        if not np.allclose(card[name]["params"], cpu[name]["params"],
                           rtol=1e-3, atol=1e-4):
            fail(f"quickstart {name}: card params {card[name]['params']} "
                 f"!= CPU params {cpu[name]['params']}")
    return launches


def serve_path(seed: int) -> int:
    """Phase 7: the full 62-layer gemma3-27b served through
    ``launch/serve.py``; returns the kernel's launches on that run."""
    import torch

    from repro_torch.kernels import fedpa_dp
    from repro_torch.kernels import swa_decode as swa
    from repro_torch.launch import serve

    argv = ["--arch", "gemma3-27b", "--full", "--batch", str(SERVE_B),
            "--prompt-len", str(SERVE_PROMPT), "--gen", str(SERVE_GEN),
            "--seed", str(seed)]
    fedpa_dp.reset_launches()
    swa.reset_launches()
    res = serve.main(argv, keep_prefill_state=True)
    launches = swa.launches["swa_decode"]
    cfg, dec = res["cfg"], res["decode"]
    steps = SERVE_GEN - 1
    print(f"serve {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"heads {cfg.num_heads}/{cfg.num_kv_heads}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, params {cfg.param_count():,} bf16; batch "
          f"{SERVE_B}, prompt {SERVE_PROMPT}, {steps} decode steps: prefill "
          f"{res['prefill_ms']:.1f} ms, decode {res['decode_ms']:.3f} ms per "
          f"step (warm), {res['tokens_per_s']:.1f} tokens/s, peak memory "
          f"{res['peak_bytes'] / 2**30:.2f} GiB; swa_decode launches "
          f"{launches} (expected {steps * cfg.num_layers})", flush=True)
    if launches != steps * cfg.num_layers:
        fail(f"swa_decode launched {launches} times, expected "
             f"{steps * cfg.num_layers}")

    profile_decode(res, cfg, res["decode_ms"])

    swa.reset_launches()
    plain = serve.decode(res["params"], res["tok"], res["prefill_state"], cfg,
                         steps, use_kernel=False, forced=dec["tokens"])
    if swa.launches["swa_decode"] != 0:
        fail(f"plain route launched swa_decode {swa.launches['swa_decode']}x")
    V = cfg.vocab_size
    err = max((a[:, :V] - b[:, :V]).abs().max().item()
              for a, b in zip(dec["logits"], plain["logits"]))
    top = max(a[:, :V].abs().max().item() for a in dec["logits"])
    agree = (plain["tokens"][:, 1:] == dec["tokens"][:, 1:]).float()
    # one bf16 rounding (2^-8 relative) of the largest logit per layer,
    # and one more for the bf16 logits themselves
    bound = (cfg.num_layers + 1) * 2.0 ** -8 * top
    print(f"serve replay through the plain route (0 launches): max logit "
          f"diff {err:.4g} (bound {bound:.4g} = ({cfg.num_layers} + 1) x 2^-8 "
          f"x max |logit| {top:.4g}); greedy tokens agree "
          f"{agree.mean().item():.4f}", flush=True)
    if not err <= bound:
        fail(f"serve: kernel vs plain logits differ by {err} > {bound}")
    return launches


def state_bytes(state) -> int:
    """Bytes held by a decode state's caches."""
    return sum(nbytes(*c) for caches in (state.pattern, state.tail)
               for c in caches.values())


def moe_prefill_flops(cfg, tokens: int) -> float:
    """FLOPs of the one-hot route's dispatch and combine einsums over a
    prompt of ``tokens`` tokens: 2 T E C d each, per chunk and MoE layer."""
    from repro_torch.models import moe

    m = cfg.moe
    chunk = min(m.chunk_tokens, tokens)
    n_moe = sum(s.ffn == "moe" for s in cfg.layers())
    C = moe.capacity(m, chunk)
    return n_moe * -(-tokens // chunk) * 2 * (2 * chunk * m.num_experts * C
                                             * cfg.d_model)


def profile_prefill(res, cfg, prefill_ms: float) -> None:
    """Where a prefill's time goes: ``torch.profiler`` over one more
    prefill of the same prompt; device time against the unprofiled
    prefill ``prefill_ms``, and the kernels that take the most of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.steps import prefill_step

    S = res["prompts"].shape[1]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prefill_step(res["params"], res["prompts"], cfg,
                     res["prefill_state"].pos + 1, frontend=res["frontend"],
                     compute_dtype=torch.bfloat16, q_chunk=min(32, S))
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    if dev_ms <= 0:
        print("prefill profile: the profiler saw no device time (not "
              "measured)")
        return
    print(f"prefill profile: {sum(e.count for e in events)} kernels, device "
          f"time {dev_ms:.1f} ms, {dev_ms / prefill_ms:.3f} of the "
          f"unprofiled prefill ({prefill_ms:.1f} ms); device idle share "
          f"{max(0.0, 1 - dev_ms / prefill_ms):.3f}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms {e.count:6d} "
              f"calls  {e.key[:90]}")


def serve_arch(card: str, arch: str, prompt: int, gen: int, repeats,
               seed: int) -> int:
    """Phase 13a-c: ``launch/serve.py``'s ``main`` on ``arch`` at full
    width (its repeats cut to ``repeats`` if given), then the plain-route
    replay; returns the kernel's launches on the serve."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels import fedpa_dp
    from repro_torch.kernels import swa_decode as swa
    from repro_torch.launch import serve

    cfg = configs.get_config(arch)
    cut = ""
    if repeats is not None:
        cut = f" (repeats cut from {cfg.repeats} to {repeats})"
        cfg = configs.replace(cfg, repeats=repeats)
    argv = ["--arch", arch, "--full", "--batch", str(SERVE_B),
            "--prompt-len", str(prompt), "--gen", str(gen), "--seed",
            str(seed)]
    fedpa_dp.reset_launches()
    swa.reset_launches()
    res = serve.main(argv, cfg=cfg, keep_prefill_state=True)
    launches = swa.launches["swa_decode"]
    dec, steps = res["decode"], gen - 1
    n_attn = sum(s.mixer in ("attn", "swa") for s in cfg.layers())
    rate = hbm_rate(card)
    weights = 2 * cfg.param_count()
    state = state_bytes(res["prefill_state"])
    bound_ms = (weights + state) / rate * 1e3
    front = (f", {cfg.frontend_tokens} {cfg.frontend} frontend tokens"
             if cfg.frontend else "")
    print(f"serve {cfg.name}{cut}: {cfg.num_layers} layers ({n_attn} "
          f"attention), d_model {cfg.d_model}, heads {cfg.num_heads}/"
          f"{cfg.num_kv_heads}, vocab {cfg.vocab_size}, params "
          f"{cfg.param_count():,} bf16 ({weights / 2**30:.2f} GiB); batch "
          f"{SERVE_B}, prompt {prompt}{front}, {steps} decode steps: "
          f"prefill {res['prefill_ms']:.1f} ms, decode "
          f"{res['decode_ms']:.3f} ms per step (warm; bound "
          f"{bound_ms:.3f} ms: weights and {state / 2**30:.3f} GiB of decode "
          f"state over {rate / 1e12:.2f} TB/s), {res['tokens_per_s']:.1f} "
          f"tokens/s, peak memory {res['peak_bytes'] / 2**30:.2f} GiB; "
          f"swa_decode launches {launches} (expected {steps * n_attn})",
          flush=True)
    if launches != steps * n_attn:
        fail(f"{arch}: swa_decode launched {launches} times, expected "
             f"{steps * n_attn}")
    if any(fedpa_dp.launches.values()):
        fail(f"{arch}: DP kernels launched while serving")
    if cfg.moe.enabled and cfg.moe.routing == "onehot":
        T = SERVE_B * prompt
        flops = moe_prefill_flops(cfg, T)
        peak_ms = flops / BF16_PEAK * 1e3
        print(f"  one-hot MoE: dispatch and combine einsums "
              f"{flops / 1e12:.1f} TFLOP over the prompt ({peak_ms:.1f} ms "
              f"at the bf16 peak); every decode step multiplies all "
              f"{cfg.moe.num_experts} experts' weights", flush=True)
    if arch in PROFILED:
        profile_prefill(res, cfg, res["prefill_ms"])
        profile_decode(res, cfg, res["decode_ms"], steps=1)

    kern_logits, same, flips = dec["logits"], None, []
    if cfg.moe.enabled:
        # the routing is discontinuous: a router choice that falls the
        # other way moves the logits by far more than the attention's
        # rounding, so the plain replay is forced onto the experts a
        # recorded kernel replay chose (as its tokens are forced), and
        # the choices it would have made otherwise are counted
        from repro_torch.models.model import clone_state

        chosen = []
        swa.reset_launches()
        with routed(record=chosen):
            kern = serve.decode(res["params"], res["tok"],
                                clone_state(res["prefill_state"]), cfg,
                                steps, use_kernel=True, forced=dec["tokens"])
        if swa.launches["swa_decode"] != steps * n_attn:
            fail(f"{arch}: the recorded kernel replay launched "
                 f"{swa.launches['swa_decode']} times")
        same = all(torch.equal(a, b) for a, b in zip(kern["logits"],
                                                     kern_logits))
        kern_logits = kern["logits"]
        swa.reset_launches()
        with routed(force=chosen, flips=flips):
            plain = serve.decode(res["params"], res["tok"],
                                 res["prefill_state"], cfg, steps,
                                 use_kernel=False, forced=dec["tokens"])
    else:
        swa.reset_launches()
        plain = serve.decode(res["params"], res["tok"], res["prefill_state"],
                             cfg, steps, use_kernel=False,
                             forced=dec["tokens"])
    if swa.launches["swa_decode"] != 0:
        fail(f"{arch}: plain route launched swa_decode")
    V = cfg.vocab_size
    kern = torch.stack([a[:, :V] for a in kern_logits])       # (steps, B, V)
    err = max((a - b[:, :V]).abs().max().item()
              for a, b in zip(kern, plain["logits"]))
    top = kern.abs().max().item()
    bound = (cfg.num_layers + 1) * 2.0 ** -8 * top
    two = kern.topk(2, dim=-1).values
    margin = two[..., 0] - two[..., 1]
    differ = plain["tokens"][:, 1:].T != dec["tokens"][:, 1:].T
    clear = differ & (margin > 2 * err)
    moe_note = ""
    if cfg.moe.enabled:
        moe_note = (f"; experts forced to the kernel replay's choices, the "
                    f"plain route's own top-{cfg.moe.top_k} differing at "
                    f"{int(torch.stack(flips).sum())} of "
                    f"{sum(f.numel() for f in flips)} (step, layer, "
                    f"request) choices; the recorded kernel replay equals "
                    f"the serve bit for bit: {same}")
    print(f"  replay through the plain route (0 launches): max logit diff "
          f"{err:.4g} (bound {bound:.4g} = ({cfg.num_layers} + 1) x 2^-8 x "
          f"max |logit| {top:.4g}); greedy tokens differ at "
          f"{int(differ.sum())} of {differ.numel()} (step, request) pairs, "
          f"{int(clear.sum())} of them with a top-two margin above twice "
          f"the diff{moe_note}", flush=True)
    if not err <= bound:
        fail(f"{arch}: kernel vs plain logits differ by {err} > {bound}")
    if clear.any():
        fail(f"{arch}: greedy tokens differ where the margin is clear")
    return launches


@contextlib.contextmanager
def routed(record=None, force=None, flips=None):
    """While the block runs, append the router's top-k expert indices of
    every MoE call to ``record`` (device tensors, in call order), or
    replace them, call by call, with those of ``force`` (their gates read
    from the router's own probabilities), appending to ``flips`` where
    the router's own choice differed."""
    import torch

    from repro_torch.models import moe

    real = moe._top_k
    forced = iter(force) if force is not None else None

    def top_k(probs, k):
        vals, idx = real(probs, k)
        if record is not None:
            record.append(idx)
        if forced is not None:
            want = next(forced)
            flips.append((idx.sort(-1).values != want.sort(-1).values)
                         .any(-1))
            idx, vals = want, torch.gather(probs, -1, want)
        return vals, idx

    moe._top_k = top_k
    try:
        yield
    finally:
        moe._top_k = real


def cut_runs(seed: int) -> None:
    """Phase 13d: one-layer fp32 cuts at full width, card against CPU."""
    import torch

    from repro_torch import configs
    from repro_torch.core import tree_math as tm
    from repro_torch.launch import serve
    from repro_torch.models import model, moe

    LS = configs.LayerSpec
    moe_cfg = configs.replace(configs.get_config("qwen3-moe-30b-a3b"),
                              repeats=1)
    cuts = (
        ("moe onehot", moe_cfg, 2, 64),
        ("moe sort", configs.replace(moe_cfg, moe=configs.replace(
            moe_cfg.moe, routing="sort")), 2, 64),
        ("rglru", configs.replace(configs.get_config("recurrentgemma-9b"),
                                  pattern=(LS(mixer="rglru"),), repeats=1,
                                  tail=()), 2, 64),
        ("mlstm+slstm", configs.replace(configs.get_config("xlstm-125m"),
                                        repeats=1), 2, 512),
        ("frontend", configs.replace(configs.get_config("musicgen-medium"),
                                     repeats=1), 2, 96),
    )
    f32 = torch.float32
    params = None
    for name, cfg, B, prompt in cuts:
        t0 = time.perf_counter()
        if params is None or not name.startswith("moe sort"):
            params = model.init_params(
                torch.Generator().manual_seed(seed), cfg, f32, device="cpu")
        F = cfg.frontend_tokens if cfg.frontend else 0
        tokens = torch.from_numpy(serve.make_prompts(cfg, B, prompt - F,
                                                     seed))
        front = serve.make_frontend(cfg, B, seed)
        forced = torch.from_numpy(serve.make_prompts(cfg, B, CUT_STEPS + 1,
                                                     seed + 1))
        out = {}
        for dev in ("cuda", "cpu"):
            p = tm.tmap(lambda t: t.to(dev), params)
            logits, state = model.prefill(
                p, tokens.to(dev), cfg, prompt + CUT_STEPS,
                frontend=None if front is None else
                torch.from_numpy(front).to(dev), compute_dtype=f32,
                q_chunk=32, cache_dtype=f32)
            got = [logits.cpu()]
            for i in range(CUT_STEPS):
                logits, state = model.decode_step(
                    p, forced[:, i].to(dev), state, cfg, compute_dtype=f32,
                    use_kernel=True)
                got.append(logits.cpu())
            out[dev] = got
            del p, state
        err = max((a - b).abs().max().item()
                  for a, b in zip(out["cuda"], out["cpu"]))
        print(f"fp32 one-layer {name} ({cfg.name}, {cfg.layers()[0].mixer}/"
              f"{cfg.layers()[0].ffn}, batch {B}, prompt {prompt}, "
              f"{CUT_STEPS} decode steps), card vs CPU: max logit diff "
              f"{err:.3g} ({time.perf_counter() - t0:.1f} s)", flush=True)
        for a, b in zip(out["cuda"], out["cpu"]):
            if not torch.allclose(a, b, rtol=1e-3, atol=1e-4):
                fail(f"one-layer {name}: card vs CPU logits differ ({err})")
        if name == "moe sort":
            overflow_check(cfg, params["pattern"]["pos_0"], seed)
        torch.cuda.empty_cache()


def overflow_check(cfg, layer, seed: int) -> None:
    """Phase 13d, part 2: the full-width MoE layer at capacity factor 0.25
    on 256 tokens under both routings, card against CPU: the kept
    (token, expert) pairs equal, outputs within phase 4's bound."""
    import torch

    from repro_torch import configs
    from repro_torch.models import moe

    x = torch.randn(256, cfg.d_model,
                    generator=torch.Generator().manual_seed(seed + 2))
    p_cpu = {k: v[0] for k, v in layer["ffn"]["moe"].items()}
    p_card = {k: v.cuda() for k, v in p_cpu.items()}
    for routing in ("onehot", "sort"):
        m = configs.replace(cfg.moe, routing=routing, capacity_factor=0.25)
        route = moe._route_chunk_sort if routing == "sort" \
            else moe._route_chunk
        kept = [moe.kept_assignments(x.to(dev), p, m).cpu()
                for dev, p in (("cuda", p_card), ("cpu", p_cpu))]
        ys = [route(x.to(dev), p, m)[0].cpu()
              for dev, p in (("cuda", p_card), ("cpu", p_cpu))]
        C = moe.capacity(m, 256)
        err = (ys[0] - ys[1]).abs().max().item()
        print(f"  moe overflow {routing} (capacity {C} of 256 x "
              f"{m.top_k} / {m.num_experts}): kept pairs "
              f"{int(kept[0].sum())} of {256 * m.top_k}, card == CPU "
              f"{torch.equal(kept[0], kept[1])}; max abs diff {err:.3g}",
              flush=True)
        if not torch.equal(kept[0], kept[1]):
            fail(f"moe overflow {routing}: the kept pairs differ")
        if not int(kept[0].sum()) < 256 * m.top_k:
            fail(f"moe overflow {routing}: nothing was dropped")
        if not torch.allclose(ys[0], ys[1], rtol=1e-3, atol=1e-4):
            fail(f"moe overflow {routing}: card vs CPU differ ({err})")


def serve_rest(card: str, seed: int) -> dict:
    """Phase 13: every other architecture served on the card, then the
    one-layer cuts; returns each serve's ``swa_decode`` launches."""
    import gc

    import torch

    by_arch = {}
    for arch, prompt, gen, repeats in SERVE_ARCHS:
        by_arch[f"{arch} serve"] = serve_arch(card, arch, prompt, gen,
                                              repeats, seed)
        gc.collect()
        torch.cuda.empty_cache()
    cut_runs(seed)
    return by_arch


def token_weights(cfg) -> int:
    """The weights each token multiplies in a dense forward: every layer's
    matrices (a leaf with two or more axes per layer: projections, FFN,
    gates, convolution taps) and the unembedding, from the shapes on the
    meta device."""
    from torch.utils import _pytree as pytree

    from repro_torch.models.model import init_params

    n = cfg.padded_vocab * cfg.d_model
    for path, leaf in pytree.tree_leaves_with_path(
            init_params(None, cfg, device="meta")):
        key = pytree.keystr(path)
        if key.startswith(("['embed']", "['unembed']")):
            continue
        if leaf.dim() - key.startswith("['pattern']") >= 2:
            n += leaf.numel()
    return n


def train_round_bound_ms(cfg, args, rate: float, fedep: bool = False):
    """The least time the card could take for one FedPA (or, with
    ``fedep``, FedEP) round of the training path, reckoned from the port's
    code, operation by operation, each at the larger of its bytes over
    ``rate`` and its FLOPs over the bf16 peak. Returns ms of (total,
    matmuls, local-step elementwise work, DP, server and client state).
    Counts what the code does, not what a fused round would need:

    * matmuls: forward 2 x tokens x the weights each token multiplies
      (``token_weights``) plus attention 4 B H S^2 dh an attention layer
      (each q chunk scores every key; the mLSTM's chunk products and the
      sLSTM's recurrence count as their weights only), backward twice
      that; for C x K client steps and the eval forward;
    * per client step and element of d: the bf16 cast of the params (6 B),
      the fp32 cast of the bf16 grads (6 B), sgdm (momentum, scale, add:
      40 B); on a sampling step the IASG sum (12 B); per sample its scale,
      flatten and stack (24 B);
    * per DP step at t (rows = t - 1) and element: u (12 B), the reduce (4
      (2 + rows) B), the map (4 (4 + rows) B), the history row (8 B), the
      mean (20 B); then the delta's rescale and unflatten (16 B a client)
      and the server's sgdm (40 B, once);
    * FedEP, per client and element: the sites' gather from the device
      store (2 fp32 reads and writes, 16 B), the sample variance over l
      samples and the precision (4 l + 16 B), ``P * delta`` (12 B), the
      damping of ``num`` and ``den`` (56 B), the CAS scatter (read the
      current rows, ``where``, ``index_copy_``: 56 B), the second
      accumulator's sum (4 B); once, the ratio ``num / den`` (12 B).
    """
    d, C, K = cfg.param_count(), args.clients, args.local_steps
    B, S = args.batch, args.seq_len
    n_attn = sum(s.mixer in ("attn", "swa") for s in cfg.layers())
    fwd = 2 * B * S * token_weights(cfg) + n_attn * 4 * B * cfg.num_heads \
        * S * S * cfg.head_dim
    mm_ms = (3 * fwd * C * K + fwd) / BF16_PEAK * 1e3
    ell = (K - args.burn_in_steps) // args.steps_per_sample
    sampling = ell * args.steps_per_sample
    local = C * d * (52 * K + 12 * sampling + 24 * ell)
    dp = C * d * (sum(12 + 4 * (2 + t - 1) + 4 * (4 + t - 1) + 8 + 20
                      for t in range(2, ell + 1)) + 16) + 40 * d
    if fedep:
        dp += C * d * (16 + 4 * ell + 16 + 12 + 56 + 56 + 4) + 12 * d
    local_ms, dp_ms = local / rate * 1e3, dp / rate * 1e3
    return mm_ms + local_ms + dp_ms, mm_ms, local_ms, dp_ms


def train_path(card: str, seed: int, argv=TRAIN_ARGV, d_want=LM_D):
    """Phase 9, part 1 (and 14a with ``XLSTM_ARGV``): the full-width model
    of ``argv`` through ``launch.train.main``; returns the DP kernels'
    launches, the run's result, its flags and the FedPA rounds' host
    ms."""
    import torch

    from repro_torch.kernels import fedpa_dp
    from repro_torch.kernels import swa_decode as swa
    from repro_torch.launch import train

    args = train.parse_args(argv)
    ell = (args.local_steps - args.burn_in_steps) // args.steps_per_sample
    expected = (args.rounds - args.burn_in_rounds) * (ell - 1)
    fedpa_dp.reset_launches()
    swa.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    res = train.main(argv + ["--seed", str(seed)])
    torch.cuda.synchronize()
    launches = dict(fedpa_dp.launches)
    peak = torch.cuda.max_memory_allocated()
    cfg, recs = res["cfg"], res["records"]
    d = cfg.param_count()
    total, mm, local, dp = train_round_bound_ms(cfg, args, hbm_rate(card))
    # the DP's live vectors per client (samples 4, iterate and momentum 2,
    # history 3, mean, delta, u, v, new delta and mean 6) and the server's
    # params, momentum and anchor, in fp32
    reckoned = (15 * args.clients + 3) * 4 * d
    slstm = sum(s.mixer == "slstm" for s in cfg.layers())
    for rec, sec in zip(recs, res["seconds"]):
        print(f"  round {rec['round']} ({rec['phase']}): host ms "
              f"{sec * 1e3:.1f}; eval_loss {rec['eval_loss']:.4f}",
              flush=True)
    warm = [sec * 1e3 for rec, sec in zip(recs, res["seconds"])
            if rec["phase"] == "fedpa"]
    print(f"train {cfg.name}: d={d:,}, {cfg.num_layers} layers"
          + (f" ({slstm} sLSTM, each a {args.seq_len}-step time loop in the "
             f"forward and the backward of every client step: "
             f"{slstm * args.seq_len} steps a forward)" if slstm else "")
          + f", d_model {cfg.d_model}, vocab {cfg.vocab_size}; "
          f"{args.clients} clients x {args.local_steps} steps x "
          f"{args.batch}x{args.seq_len} tokens, l={ell}, client lr "
          f"{args.client_lr}: FedPA round host ms "
          f"{[round(x, 1) for x in warm]} (the first includes warm-up) "
          f"against a bound of {total:.1f} ms (matmuls {mm:.1f}, local-step "
          f"elementwise {local:.1f}, DP and server {dp:.1f}); peak memory "
          f"allocated {peak / 2**30:.2f} GiB (reckoned "
          f"{reckoned / 2**30:.2f} GiB of fp32 vectors); DP launches "
          f"{launches} (expected {expected} each); swa_decode launches "
          f"{swa.launches['swa_decode']} (expected 0)", flush=True)
    if d != d_want:
        fail(f"{cfg.name} has d={d}, expected {d_want}")
    if any(n != expected for n in launches.values()):
        fail(f"train {cfg.name}: DP launches {launches} != {expected} each")
    if swa.launches["swa_decode"] != 0:
        fail(f"swa_decode launched on the training path of {cfg.name}")
    losses = [r[k] for r in recs for k in ("eval_loss", "client_loss_first",
                                           "client_loss_last")]
    if len(recs) != args.rounds or not all(map(math.isfinite, losses)):
        fail(f"train {cfg.name}: records {recs}")
    return launches, res, args, warm


def profile_train(round_ms: float, seed: int, rounds: int = 1) -> None:
    """Where a FedPA round's time goes: ``torch.profiler`` over a second run
    of the path with every round in the FedPA regime (no burn-in). Prints
    the device time and kernel count per round, their share of the
    unprofiled warm round ``round_ms`` (the rest is the card waiting for
    the host), and the kernels that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import train

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        train.main(TRAIN_ARGV + ["--seed", str(seed), "--rounds",
                                 str(rounds), "--burn-in-rounds", "0"])
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    print(f"train profile: the profiled run and its analysis took "
          f"{time.perf_counter() - t0:.1f} s")
    dev_ms = sum(e.self_device_time_total for e in events) / rounds / 1e3
    if dev_ms <= 0:
        print("train profile: the profiler saw no device time (device "
              "share not measured)")
        return
    print(f"train profile ({rounds} FedPA rounds): "
          f"{sum(e.count for e in events) / rounds:.0f} device ops and "
          f"device time {dev_ms:.1f} ms per round, {dev_ms / round_ms:.3f} "
          f"of the warm round ({round_ms:.1f} ms); device idle share "
          f"{1 - dev_ms / round_ms:.3f}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / rounds / 1e3:8.2f} ms/round "
              f"{e.count // rounds:6d} calls/round  {e.key[:90]}")


def train_replay(seed: int) -> dict:
    """Phase 9, part 2: the training path in fp32 on fedlm-100m cut to one
    layer, on the card and on the CPU; returns the card run's DP
    launches."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels import fedpa_dp
    from repro_torch.launch import train

    cfg = configs.replace(configs.get_config("fedlm-100m"), repeats=1)
    argv = REPLAY_ARGV + ["--seed", str(seed)]
    fedpa_dp.reset_launches()
    t0 = time.perf_counter()
    card = train.main(argv, cfg=cfg, compute_dtype=torch.float32)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = dict(fedpa_dp.launches)
    t0 = time.perf_counter()
    cpu = train.main(argv + ["--device", "cpu"], cfg=cfg,
                     compute_dtype=torch.float32)
    print(f"train replay ({cfg.name} cut to {cfg.num_layers} layer, d="
          f"{cfg.param_count():,}, fp32): {card_s:.1f} s on the card, "
          f"{time.perf_counter() - t0:.1f} s on the CPU; eval_loss card "
          f"{[r['eval_loss'] for r in card['records']]}, CPU "
          f"{[r['eval_loss'] for r in cpu['records']]}; DP launches "
          f"{launches}", flush=True)
    params_close(card["state"].params, cpu["state"].params,
                 "fp32 one-layer train, card vs CPU")
    return launches


def fedep_argv(argv, num_clients: int) -> list:
    """``argv`` (a ``launch.train`` command) switched to FedEP on the
    device store with a population of ``num_clients``."""
    out = list(argv)
    out[out.index("--algorithm") + 1] = "fedep"
    out[out.index("--num-clients") + 1] = str(num_clients)
    return out + ["--client-state-placement", "device"]


def drawn_per_client(args, burn_in_rounds: int):
    """How many stateful rounds each client was drawn in: the draws of
    ``launch.train``'s ``CohortSource``, replayed from its seed."""
    import numpy as np

    from repro_torch.data.cohort_source import CohortSource
    from repro_torch.launch import train

    src = CohortSource(train.build_fed(args), args.num_clients,
                       lambda ids, r: None, seed=args.seed)
    want = np.zeros(args.num_clients, np.int64)
    for r in range(burn_in_rounds, args.rounds):
        want[np.asarray(src.draw(r)[0])] += 1
    return want


def check_sites(store, want_stamps, what: str) -> None:
    """The store after a run: each stamp equals the rounds its client was
    drawn in; the sites of clients never drawn are exactly zero, those of
    drawn clients finite and non-zero (read on the device, per client)."""
    import numpy as np
    import torch

    from repro_torch.core import tree_math as tm

    state = store.device_state()
    stamps = state["stamps"].cpu().numpy()
    leaves = tm.tleaves(state["buffers"])
    amax = torch.stack([b.flatten(1).abs().amax(1) for b in leaves]).amax(0)
    finite = torch.stack([torch.isfinite(b.flatten(1)).all(1)
                          for b in leaves]).all(0)
    amax, finite = amax.cpu().numpy(), finite.cpu().numpy()
    drawn = want_stamps > 0
    print(f"  {what}: stamps {stamps.tolist()} (drawn {want_stamps.tolist()},"
          f" sum {int(stamps.sum())}); sites' max |x| of drawn clients "
          f"{float(amax[drawn].min()):.3g}..{float(amax[drawn].max()):.3g},"
          f" of the others {float(amax[~drawn].max(initial=0.0)):.3g}",
          flush=True)
    if not np.array_equal(stamps, want_stamps):
        fail(f"{what}: stamps {stamps} != rounds drawn {want_stamps}")
    if amax[~drawn].any():
        fail(f"{what}: a client never drawn has a non-zero site")
    if not (finite[drawn].all() and amax[drawn].all()):
        fail(f"{what}: a drawn client's site is zero or not finite")


def fedep_train_path(card: str, seed: int):
    """Phase 10a: FedEP on the device store trains the full-width
    fedlm-100m through ``launch.train.main`` (phase 9's settings with the
    population cut from 64 to 16 for the store's memory); returns the DP
    kernels' launches and the run's records."""
    import torch

    from repro_torch.core import tree_math as tm
    from repro_torch.kernels import fedpa_dp
    from repro_torch.kernels import swa_decode as swa
    from repro_torch.launch import train

    argv = fedep_argv(TRAIN_ARGV, FEDEP_CLIENTS) + ["--seed", str(seed)]
    args = train.parse_args(argv)
    ell = (args.local_steps - args.burn_in_steps) // args.steps_per_sample
    expected = (args.rounds - args.burn_in_rounds) * (ell - 1)
    fedpa_dp.reset_launches()
    swa.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    res = train.main(argv)
    torch.cuda.synchronize()
    launches = dict(fedpa_dp.launches)
    peak = torch.cuda.max_memory_allocated()
    cfg, recs, store = res["cfg"], res["records"], res["store"]
    d = cfg.param_count()
    total, mm, local, dp = train_round_bound_ms(cfg, args, hbm_rate(card),
                                                fedep=True)
    store_bytes = sum(nbytes(b) for b in tm.tleaves(store.device_state()))
    # phase 9's FedPA reckoning (15 vectors per client, 3 on the server),
    # plus the store (2 per client of the population), the gathered sites
    # (2 per cohort client), the precision, P * delta and the damped pair
    # (6 per cohort client) and the second accumulator
    reckoned = (15 * args.clients + 3 + 2 * args.num_clients
                + 8 * args.clients + 1) * 4 * d
    for rec, sec in zip(recs, res["seconds"]):
        print(f"  round {rec['round']} ({rec['phase']}): host ms "
              f"{sec * 1e3:.1f}; eval_loss {rec['eval_loss']:.4f}",
              flush=True)
    warm = [sec * 1e3 for rec, sec in zip(recs, res["seconds"])
            if rec["phase"] == "fedep"]
    print(f"train fedep {cfg.name}: d={d:,}; {args.clients} of "
          f"{args.num_clients} clients (population cut from 64), "
          f"{args.local_steps} steps x {args.batch}x{args.seq_len} tokens, "
          f"l={ell}, device store: FedEP round host ms "
          f"{[round(x, 1) for x in warm]} (the first includes warm-up) "
          f"against a bound of {total:.1f} ms (matmuls {mm:.1f}, local-step "
          f"elementwise {local:.1f}, DP, server and client state {dp:.1f});"
          f" peak memory allocated {peak / 2**30:.2f} GiB (reckoned "
          f"{reckoned / 2**30:.2f} GiB of fp32 vectors); store "
          f"{store_bytes / 1e9:.2f} GB ({args.num_clients} x 2 x "
          f"{4 * d / 1e6:.1f} MB); DP launches {launches} (expected "
          f"{expected} each); swa_decode launches "
          f"{swa.launches['swa_decode']} (expected 0)", flush=True)
    if d != LM_D:
        fail(f"fedlm-100m has d={d}, expected {LM_D}")
    if any(n != expected for n in launches.values()):
        fail(f"train fedep: DP launches {launches} != {expected} each")
    if swa.launches["swa_decode"] != 0:
        fail("swa_decode launched on the FedEP training path")
    losses = [r[k] for r in recs for k in ("eval_loss", "client_loss_first",
                                           "client_loss_last")]
    if len(recs) != args.rounds or not all(map(math.isfinite, losses)):
        fail(f"train fedep: records {recs}")
    want = drawn_per_client(args, args.burn_in_rounds)
    if want.sum() != (args.rounds - args.burn_in_rounds) * args.clients:
        fail(f"train fedep: draws {want}")
    check_sites(store, want, "fedep store")
    return launches, recs


def equal_bitwise(a, b) -> bool:
    """Whether two trees of tensors or arrays are equal bit for bit."""
    import numpy as np

    from repro_torch.core import tree_math as tm

    la, lb = tm.tleaves(a), tm.tleaves(b)
    return len(la) == len(lb) and all(
        np.array_equal(np.asarray(x.cpu() if hasattr(x, "cpu") else x),
                       np.asarray(y.cpu() if hasattr(y, "cpu") else y))
        for x, y in zip(la, lb))


def store_close(got, want, what: str) -> None:
    """Phase 4's bound on two stores' state dicts; stamps exactly."""
    import numpy as np

    from repro_torch.core import tree_math as tm

    if not np.array_equal(got["stamps"], want["stamps"]):
        fail(f"{what}: stamps {got['stamps']} != {want['stamps']}")
    pairs = list(zip(tm.tleaves(got["buffers"]), tm.tleaves(want["buffers"])))
    err = max(float(np.abs(a - b).max()) for a, b in pairs)
    print(f"  {what}: store max abs diff {err:.3g}", flush=True)
    for a, b in pairs:
        if not np.allclose(a, b, rtol=1e-3, atol=1e-4):
            fail(f"{what}: store differs (max abs diff {err})")


def fedep_store_replay(seed: int) -> dict:
    """Phase 10b: FedEP on fedlm-100m cut to one layer, fp32, with the host
    store on the card, the device store on the card and the device store
    on the CPU (phase 9b's settings at client lr 0.01; at 9b's 0.05 the
    distance passed phase 4's bound). The
    card runs, with deterministic algorithms, must agree bit for bit
    (params, sites, stamps), the card and the CPU within phase 4's bound.
    Returns the device-store card run's DP launches."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels import fedpa_dp
    from repro_torch.launch import train

    cfg = configs.replace(configs.get_config("fedlm-100m"), repeats=1)
    argv = fedep_argv(REPLAY_ARGV, 4) + FEDEP_REPLAY + ["--seed", str(seed)]
    args = train.parse_args(argv)
    ell = (args.local_steps - args.burn_in_steps) // args.steps_per_sample
    expected = (args.rounds - args.burn_in_rounds) * (ell - 1)
    runs, launches, times = {}, {}, {}
    for name, extra in (("host store, card", ["--client-state-placement",
                                              "host"]),
                        ("device store, card", []),
                        ("device store, CPU", ["--device", "cpu"])):
        fedpa_dp.reset_launches()
        t0 = time.perf_counter()
        with deterministic():
            runs[name] = train.main(argv + extra, cfg=cfg,
                                    compute_dtype=torch.float32)
        if "card" in name:
            torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        launches[name] = dict(fedpa_dp.launches)
    host, dev, cpu = runs.values()
    stores = [r["store"].state_dict() for r in runs.values()]
    same = (equal_bitwise(host["state"], dev["state"])
            and equal_bitwise(stores[0], stores[1]))
    print(f"fedep store replay ({cfg.name} cut to {cfg.num_layers} layer, "
          f"d={cfg.param_count():,}, fp32, {args.clients} of "
          f"{args.num_clients} clients, {args.burn_in_rounds} burn-in + "
          f"{args.rounds - args.burn_in_rounds} FedEP rounds): "
          + "; ".join(f"{k} {v:.1f} s" for k, v in times.items())
          + f"; host-store and device-store card runs bitwise equal: "
          f"{same}; DP launches {launches} (expected {expected} each on "
          f"the card)", flush=True)
    for name in ("host store, card", "device store, card"):
        if any(n != expected for n in launches[name].values()):
            fail(f"fedep replay {name}: DP launches {launches[name]}")
    if not same:
        fail("fedep replay: the host-store and device-store card runs "
             "differ")
    params_close(dev["state"].params, cpu["state"].params,
                 "fedep one-layer, card vs CPU")
    store_close(stores[1], stores[2], "fedep one-layer, card vs CPU")
    want = drawn_per_client(args, args.burn_in_rounds)
    if not (want.max() == 2 and (stores[1]["stamps"] == want).all()):
        fail(f"fedep replay: no client's site was read back (draws {want},"
             f" stamps {stores[1]['stamps']})")
    return launches["device store, card"]


def store_sync_check() -> None:
    """Phase 10c: ``device_gather`` / ``device_scatter`` on the card, with
    the ids, stamps and write mask already there, raise nothing under
    ``torch.cuda.set_sync_debug_mode("error")``; their drop counts and the
    store after them equal the host store's for the same operations (a
    CNN-sized site, 64 clients)."""
    import numpy as np
    import torch

    from repro_torch.core import client_state as cs
    from repro_torch.core import tree_math as tm

    template = {"num": np.zeros(DP_D, np.float32),
                "den": np.zeros(DP_D, np.float32)}
    host = cs.ClientStateStore(NUM_CLIENTS).ensure(template)
    dev = cs.DeviceClientStateStore(NUM_CLIENTS, device="cuda").ensure(
        template)
    r = np.random.default_rng(0)
    a, b = (r.choice(NUM_CLIENTS, 16, replace=False) for _ in range(2))
    mask = (r.random(16) < 0.75).astype(np.float32)
    upd = {k: r.normal(size=(16, DP_D)).astype(np.float32) for k in template}
    # host: cohort a gathers, cohort b gathers, a writes (masked), b writes
    _, sa = host.gather(a)
    _, sb = host.gather(b)
    host_drops = [host.scatter(a, upd, sa, write_mask=mask),
                  host.scatter(b, upd, sb)]
    ids_a, ids_b = dev.prepare_ids(a), dev.prepare_ids(b)
    upd_d = tm.tmap(lambda x: torch.from_numpy(x).cuda(), upd)
    mask_d = torch.from_numpy(mask).cuda()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, sa_d = cs.device_gather(dev.device_state(), ids_a)
        _, sb_d = cs.device_gather(dev.device_state(), ids_b)
        _, da = cs.device_scatter(dev.device_state(), ids_a, upd_d, sa_d,
                                  write_mask=mask_d)
        _, db = cs.device_scatter(dev.device_state(), ids_b, upd_d, sb_d)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    dev_drops = [int(da), int(db)]
    same = equal_bitwise(host.state_dict(), dev.state_dict())
    print(f"store sync check (64 clients x 2 x {DP_D:,} fp32; two "
          f"overlapping cohorts of 16, the first masked to "
          f"{int(mask.sum())} survivors): no host sync under sync-debug "
          f"'error'; drops device {dev_drops}, host {host_drops}; stores "
          f"bitwise equal: {same}", flush=True)
    if dev_drops != host_drops or not same or not sum(host_drops):
        fail(f"store sync check: drops {dev_drops} vs {host_drops}, "
             f"stores equal {same}")


def stateful_cnn_rounds(params, seed: int) -> dict:
    """Phase 10d: SCAFFOLD (host and device store) and FedEP (parallel and
    chunk 6) on the full-width CNN with phase 3's settings, each against
    its CPU replay (the card under cuDNN's deterministic algorithms, as
    every card-vs-CPU CNN comparison); the two SCAFFOLD runs bit for bit.
    Returns each run's DP launches."""
    from repro_torch.kernels import fedpa_dp

    by_run, scaffold = {}, {}
    for name, over in STATE_RUNS:
        stateful_alg = over["algorithm"]
        pair = stateful_alg == "scaffold"
        fedpa_dp.reset_launches()
        with deterministic():
            state, records, ms = run_rounds("cuda", params, seed, over)
        launches = dict(fedpa_dp.launches)
        expected = (0 if stateful_alg == "scaffold"
                    else expected_dp_launches(over))
        print(f"round run {name}: round ms {[round(x, 2) for x in ms]} "
              f"(burn-in rounds {over.get('burn_in_rounds', 1)}); DP "
              f"launches {launches} (expected {expected} each); "
              f"state_drops {[h['state_drops'] for h in records]}; "
              f"loss_last {[round(h['loss_last'], 4) for h in records]}",
              flush=True)
        if any(n != expected for n in launches.values()):
            fail(f"{name}: DP launches {launches} != {expected} each")
        if any(h["state_drops"] for h in records):
            fail(f"{name}: a client-state write was dropped")
        by_run[name] = launches
        if pair:
            scaffold[name] = state
        cpu_state, _, _ = run_rounds("cpu", params, seed, over)
        params_close(state.params, cpu_state.params,
                     f"{name} vs its CPU replay")
    (a, b) = scaffold.values()
    same = equal_bitwise(a.params, b.params) and equal_bitwise(
        a.algo_state, b.algo_state)
    print(f"  scaffold host store vs device store on the card: bitwise "
          f"equal {same}", flush=True)
    if not same:
        fail("scaffold: the host-store and device-store runs differ")
    return by_run


def checkpoint_resume(seed: int) -> None:
    """Phase 10e: the smoke fedlm-100m, FedEP on the device store, on the
    card: two rounds with a checkpoint every round, then the same command
    to four rounds resumes at round 2; against a straight four-round run
    in the same process (phase 4's bound; bitwise equality printed)."""
    import io
    import shutil
    import tempfile

    from repro_torch.launch import train

    argv = ["--smoke", "--algorithm", "fedep", "--client-state-placement",
            "device", "--clients", "2", "--num-clients", "4",
            "--local-steps", "8", "--burn-in-steps", "2",
            "--steps-per-sample", "2", "--burn-in-rounds", "1", "--batch",
            "2", "--seq-len", "32", "--prefetch-rounds", "0", "--seed",
            str(seed)]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        ck = argv + ["--ckpt-dir", tmp, "--ckpt-every", "1"]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            train.main(ck + ["--rounds", "2"])
            resumed = train.main(ck + ["--rounds", "4"])
            straight = train.main(argv + ["--rounds", "4"])
        saved = sorted(f for f in os.listdir(tmp) if f.endswith(".npz"))
    finally:
        shutil.rmtree(tmp)
    restored = "restored checkpoint at round 2" in out.getvalue()
    same = (equal_bitwise(resumed["state"], straight["state"])
            and equal_bitwise(resumed["store"].state_dict(),
                              straight["store"].state_dict()))
    print(f"checkpoint resume ({resumed['cfg'].name}, fedep, device store):"
          f" checkpoints {saved}; 'restored checkpoint at round 2' printed:"
          f" {restored}; resumed == straight bitwise: {same}", flush=True)
    if not restored or len(saved) != 4:
        fail(f"checkpoint resume: restored {restored}, files {saved}")
    params_close(resumed["state"].params, straight["state"].params,
                 "resumed vs straight params")
    store_close(resumed["store"].state_dict(), straight["store"].state_dict(),
                "resumed vs straight")


def repeatability(params, seed: int) -> None:
    """Phase 10f (ROADMAP.md queue 3): phase 3's rounds (batch DP) twice in
    this process with ``torch.backends.cudnn.deterministic`` off and on,
    and 10b's device-store card run twice with torch's default algorithms;
    prints whether each pair's params are bitwise equal. A report: neither
    answer fails the run."""
    import torch

    from repro_torch import configs
    from repro_torch.launch import train

    cfg = configs.replace(configs.get_config("fedlm-100m"), repeats=1)
    argv = fedep_argv(REPLAY_ARGV, 4) + FEDEP_REPLAY + ["--seed", str(seed)]
    runs = [train.main(argv, cfg=cfg, compute_dtype=torch.float32)
            for _ in range(2)]
    same = (equal_bitwise(runs[0]["state"], runs[1]["state"])
            and equal_bitwise(runs[0]["store"].state_dict(),
                              runs[1]["store"].state_dict()))
    print(f"repeatability: 10b's device-store card run twice with torch's "
          f"default algorithms: params and store bitwise equal {same}",
          flush=True)
    prev = torch.backends.cudnn.deterministic
    try:
        for det in (False, True):
            torch.backends.cudnn.deterministic = det
            a, _ = run_main_path("cuda", params, seed, False)
            b, _ = run_main_path("cuda", params, seed, False)
            err = max((x - y).abs().max().item() for x, y in
                      zip(a.params.values(), b.params.values()))
            print(f"repeatability: phase 3's rounds twice with "
                  f"cudnn.deterministic={det}: params bitwise equal "
                  f"{equal_bitwise(a.params, b.params)} (max abs diff "
                  f"{err:.3g})", flush=True)
    finally:
        torch.backends.cudnn.deterministic = prev


@contextlib.contextmanager
def deterministic(on: bool = True):
    """cuDNN's deterministic algorithms and torch's deterministic mode
    (warnings only) inside the block, the previous settings after."""
    import torch

    prev = (torch.backends.cudnn.deterministic,
            torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    if on:
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev[0]
        torch.use_deterministic_algorithms(prev[1], warn_only=prev[2])


def per_client_state(card: str, params, seed: int):
    """Phase 10 (10a-10f); returns the DP launches of its runs and 10a's
    records."""
    import torch

    launches, records = fedep_train_path(card, seed)
    by_run = {"fedlm-100m fedep train (device store)": launches}
    torch.cuda.empty_cache()
    by_run["fedlm-100m 1 layer fp32 fedep (vs CPU)"] = \
        fedep_store_replay(seed)
    store_sync_check()
    by_run.update(stateful_cnn_rounds(params, seed))
    checkpoint_resume(seed)
    repeatability(params, seed)
    return by_run, records


def cas_replay(args, burn_in_rounds: int, max_staleness: int):
    """The engine's apply-order CAS replayed on the host from the draws of
    ``launch.train``'s ``CohortSource``: each round's cohort snapshots its
    clients' stamps when it is dispatched (up to ``max_staleness`` rounds
    ahead of the one applied) and writes where a stamp has not moved.
    Returns (final stamps, drops per round)."""
    import collections

    import numpy as np

    from repro_torch.data.cohort_source import CohortSource
    from repro_torch.launch import train

    src = CohortSource(train.build_fed(args), args.num_clients,
                       lambda ids, r: None, seed=args.seed)
    stamps = np.zeros(args.num_clients, np.int64)
    pending, drops, t_next = collections.deque(), [], 0
    for _ in range(args.rounds):
        while t_next < args.rounds and len(pending) <= max_staleness:
            ids = np.asarray(src.draw(t_next)[0])
            pending.append((ids, stamps[ids].copy()
                            if t_next >= burn_in_rounds else None))
            t_next += 1
        ids, snap = pending.popleft()
        if snap is None:
            drops.append(0)
            continue
        ok = stamps[ids] == snap
        stamps[ids[ok]] += 1
        drops.append(int((~ok).sum()))
    return stamps, drops


@contextlib.contextmanager
def watch_prefetchers(seen: list):
    """Inside the block, every prefetcher the engine makes is appended to
    ``seen`` as a dict: its class, its child's command line (a process
    backend) and whether this process's CUDA context is live, read as it
    starts, and the seconds from its start to the first cohort."""
    import torch

    from repro_torch.core import engine

    real = engine.make_prefetcher

    def make(*a, **kw):
        t0 = time.perf_counter()
        p = real(*a, **kw)
        entry = {"class": type(p).__name__, "cmdline": None,
                 "cuda_live": torch.cuda.is_initialized()}
        if hasattr(p, "_proc"):
            with open(f"/proc/{p._proc.pid}/cmdline", "rb") as f:
                entry["cmdline"] = f.read().replace(b"\0", b" ").decode()
        real_get = p.get

        def get(r):
            out = real_get(r)
            entry.setdefault("first_cohort_s",
                             round(time.perf_counter() - t0, 2))
            return out

        p.get = get
        seen.append(entry)
        return p

    engine.make_prefetcher = make
    try:
        yield
    finally:
        engine.make_prefetcher = real


@contextlib.contextmanager
def time_builds(seconds: list):
    """Inside the block, the host seconds of every cohort built in this
    process (``CohortSource.cohort``: the draw and the batches, what a
    prefetcher takes off the round loop) are appended to ``seconds``."""
    from repro_torch.data.cohort_source import CohortSource

    real = CohortSource.cohort

    def cohort(self, round_idx):
        t0 = time.perf_counter()
        out = real(self, round_idx)
        seconds.append(time.perf_counter() - t0)
        return out

    CohortSource.cohort = cohort
    try:
        yield
    finally:
        CohortSource.cohort = real


@contextlib.contextmanager
def profile_after_round_0(found: list):
    """Inside the block, ``launch.train``'s engine runs under
    ``torch.profiler`` (CUDA activity), recording from the end of round 0
    to the end of the run; the key averages of that window are appended to
    ``found``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.launch import train

    real = train.RoundEngine

    class Stepped(real):
        def run(self, state, build_cohort, num_rounds, **kw):
            on_round = kw.pop("on_round")

            def step(rec, round_state):
                on_round(rec, round_state)
                torch.cuda.synchronize()
                prof.step()

            with prof:
                return super().run(state, build_cohort, num_rounds,
                                   on_round=step, **kw)

    prof = None

    def make(*a, **kw):
        nonlocal prof
        engine = Stepped(*a, **kw)
        prof = profile(activities=[ProfilerActivity.CUDA],
                       schedule=schedule(wait=1, warmup=0,
                                         active=ASYNC_ROUNDS - 1),
                       on_trace_ready=lambda p: found.append(
                           p.key_averages()))
        return engine

    train.RoundEngine = make
    try:
        yield
    finally:
        train.RoundEngine = real


def async_train_path(card: str, seed: int) -> dict:
    """Phase 11a: async FedPA on the full-width fedlm-100m through
    ``launch.train.main`` with the reference's prefetcher (a spawned child,
    2 rounds ahead); then the same run with cohorts built inline, profiled
    over rounds 1-4 for its device idle share and timed for its cohort
    builds. Returns the DP launches."""
    import torch

    from repro_torch.kernels import fedpa_dp
    from repro_torch.kernels import swa_decode as swa
    from repro_torch.launch import train

    argv = (TRAIN_ARGV + ["--rounds", str(ASYNC_ROUNDS), "--seed", str(seed)]
            + ASYNC_ARGV)
    args = train.parse_args(argv + PREFETCH_ARGV)
    ell = (args.local_steps - args.burn_in_steps) // args.steps_per_sample
    expected = (args.rounds - args.burn_in_rounds) * (ell - 1)
    seen = []
    fedpa_dp.reset_launches()
    swa.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with watch_prefetchers(seen):
        res = train.main(argv + PREFETCH_ARGV)
    torch.cuda.synchronize()
    launches = dict(fedpa_dp.launches)
    peak = torch.cuda.max_memory_allocated()
    recs = res["records"]
    ms = [sec * 1e3 for sec in res["seconds"]]
    found, builds = [], []
    t0 = time.perf_counter()
    with profile_after_round_0(found), time_builds(builds):
        inline = train.main(argv + ["--prefetch-rounds", "0"])
    prof_s = time.perf_counter() - t0
    inline_ms = [sec * 1e3 for sec in inline["seconds"]]
    build_ms = [sec * 1e3 for sec in builds]
    staleness = [r["staleness"] for r in recs]
    if res["cfg"].param_count() != LM_D:
        fail(f"async train: d={res['cfg'].param_count()}, expected {LM_D}")
    for rec, t in zip(recs, ms):
        print(f"  round {rec['round']} ({rec['phase']}, staleness "
              f"{rec['staleness']}): host ms {t:.1f}; eval_loss "
              f"{rec['eval_loss']:.4f}", flush=True)
    print(f"async train {res['cfg'].name}: d={res['cfg'].param_count():,}; "
          f"window {args.max_staleness + 1}, discount "
          f"{args.staleness_discount}; staleness {staleness} (expected "
          f"[0, 1, 2, 2, 2]); host ms per round {[round(x, 1) for x in ms]}"
          f" (sum {sum(ms):.1f}) with the process prefetcher, "
          f"{[round(x, 1) for x in inline_ms]} (sum {sum(inline_ms):.1f}) "
          f"with cohorts built inline (profiled from round 1); peak memory "
          f"allocated {peak / 2**30:.2f} GiB; DP launches {launches} "
          f"(expected {expected} each, the synchronous count); swa_decode "
          f"launches {swa.launches['swa_decode']}; prefetchers {seen}",
          flush=True)
    print(f"async train cohort builds (inline run): host ms "
          f"{[round(x, 2) for x in build_ms]}, {sum(build_ms):.2f} of the "
          f"run's {sum(inline_ms):.1f} host ms (share "
          f"{sum(build_ms) / sum(inline_ms):.4f})", flush=True)
    if staleness != [0, 1, 2, 2, 2]:
        fail(f"async train: staleness {staleness}")
    if any(n != expected for n in launches.values()):
        fail(f"async train: DP launches {launches} != {expected} each")
    if swa.launches["swa_decode"] != 0:
        fail("swa_decode launched on the async training path")
    losses = [r[k] for r in recs + inline["records"]
              for k in ("eval_loss", "client_loss_first", "client_loss_last")]
    if len(recs) != args.rounds or not all(map(math.isfinite, losses)):
        fail(f"async train: records {recs}")
    if (len(seen) != 1 or seen[0]["class"] != "ProcessCohortPrefetcher"
            or "multiprocessing.spawn" not in (seen[0]["cmdline"] or "")
            or not seen[0]["cuda_live"]):
        fail(f"async train: the prefetcher was not a spawned child beside "
             f"a live CUDA context: {seen}")
    if len(builds) != args.rounds:
        fail(f"async train: {len(builds)} cohort builds in the inline run")
    # where the time goes: the inline run's device time over rounds 1-4
    # (dispatch, server steps, evals) against the same rounds' host time
    events = [e for e in (found[0] if found else [])
              if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    host_ms = sum(inline_ms[1:])
    if dev_ms <= 0:
        print("async train profile: the profiler saw no device time "
              "(idle share not measured)")
    else:
        print(f"async train profile (the inline run, rounds 1-"
              f"{args.rounds - 1}; the run took {prof_s:.1f} s): device "
              f"time {dev_ms:.1f} ms in {sum(e.count for e in events):.0f} "
              f"device ops against {host_ms:.1f} host ms: device idle "
              f"share {1 - dev_ms / host_ms:.3f}", flush=True)
    return launches


def async_state_path(card: str, seed: int) -> dict:
    """Phase 11b: async FedEP on the device store, full-width fedlm-100m,
    4 of 16 clients, window 3: overlapping in-flight cohorts make the CAS
    drop stale writes. The write-back runs under sync-debug "error" and
    returns its drop count as a device tensor; the records' drops and the
    store's stamps equal the host replay of the CAS from the draws.
    Returns the DP launches."""
    import torch

    from repro_torch.core import tree_math as tm
    from repro_torch.core.engine import RoundEngine
    from repro_torch.kernels import fedpa_dp
    from repro_torch.launch import train

    argv = (fedep_argv(TRAIN_ARGV, FEDEP_CLIENTS)
            + ["--rounds", str(ASYNC_ROUNDS), "--seed", str(seed)]
            + ASYNC_ARGV)
    args = train.parse_args(argv)
    ell = (args.local_steps - args.burn_in_steps) // args.steps_per_sample
    expected = (args.rounds - args.burn_in_rounds) * (ell - 1)
    want_stamps, want_drops = cas_replay(args, args.burn_in_rounds,
                                         args.max_staleness)
    kinds = []
    real = RoundEngine._write_back_states

    def write_back(self, fl):
        torch.cuda.set_sync_debug_mode("error")
        try:
            drops = real(self, fl)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if fl.new_states is not None:
            kinds.append(type(drops).__name__)
        return drops

    fedpa_dp.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    RoundEngine._write_back_states = write_back
    try:
        res = train.main(argv)
    finally:
        RoundEngine._write_back_states = real
    torch.cuda.synchronize()
    launches = dict(fedpa_dp.launches)
    peak = torch.cuda.max_memory_allocated()
    drops = [h["state_drops"] for h in res["history"]]
    store = res["store"]
    stamps = store.device_state()["stamps"].cpu().numpy()
    store_bytes = sum(nbytes(b) for b in tm.tleaves(store.device_state()))
    ms = [round(sec * 1e3, 1) for sec in res["seconds"]]
    drawn = (args.rounds - args.burn_in_rounds) * args.clients
    if res["cfg"].param_count() != LM_D:
        fail(f"async fedep: d={res['cfg'].param_count()}, expected {LM_D}")
    print(f"async fedep {res['cfg'].name}: {args.clients} of "
          f"{args.num_clients} clients, window {args.max_staleness + 1}, "
          f"device store; staleness "
          f"{[r['staleness'] for r in res['records']]}; state_drops "
          f"{drops} (host replay of the CAS {want_drops}); stamps sum "
          f"{int(stamps.sum())} = {drawn} drawn - {sum(drops)} dropped; "
          f"write-back drop counts {kinds} (no host sync under sync-debug "
          f"'error'); host ms per round {ms}; peak memory allocated "
          f"{peak / 2**30:.2f} GiB; store {store_bytes / 1e9:.2f} GB; DP "
          f"launches {launches} (expected {expected} each)", flush=True)
    if drops != want_drops or not sum(drops):
        fail(f"async fedep: state_drops {drops} != {want_drops}, or none")
    if kinds != ["Tensor"] * (args.rounds - args.burn_in_rounds):
        fail(f"async fedep: write-back drop counts {kinds}")
    if int(stamps.sum()) != drawn - sum(drops):
        fail(f"async fedep: stamps {stamps} != draws minus drops")
    if any(n != expected for n in launches.values()):
        fail(f"async fedep: DP launches {launches} != {expected} each")
    losses = [r[k] for r in res["records"]
              for k in ("eval_loss", "client_loss_first", "client_loss_last")]
    if not all(map(math.isfinite, losses)):
        fail(f"async fedep: records {res['records']}")
    check_sites(store, want_stamps, "async fedep store")
    return launches


def async_store_replay(seed: int) -> dict:
    """Phase 11c: async FedEP (window 3) on fedlm-100m cut to one layer,
    fp32, client lr 0.01 (10b's settings), with the host store and the
    device store on the card (deterministic algorithms) and the device
    store on the CPU: equal drops, bitwise equal card stores, the card
    within phase 4's bound of the CPU. Returns the DP launches of the
    device-store card run."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels import fedpa_dp
    from repro_torch.launch import train

    cfg = configs.replace(configs.get_config("fedlm-100m"), repeats=1)
    argv = (fedep_argv(REPLAY_ARGV, 4) + FEDEP_REPLAY + ASYNC_ARGV
            + ["--seed", str(seed)])
    args = train.parse_args(argv)
    _, want_drops = cas_replay(args, args.burn_in_rounds, args.max_staleness)
    runs, launches, times = {}, {}, {}
    for name, extra in (("host store, card", ["--client-state-placement",
                                              "host"]),
                        ("device store, card", []),
                        ("device store, CPU", ["--device", "cpu"])):
        fedpa_dp.reset_launches()
        t0 = time.perf_counter()
        with deterministic():
            runs[name] = train.main(argv + extra, cfg=cfg,
                                    compute_dtype=torch.float32)
        if "card" in name:
            torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        launches[name] = dict(fedpa_dp.launches)
    host, dev, cpu = runs.values()
    stores = [r["store"].state_dict() for r in runs.values()]
    drops = {k: [h["state_drops"] for h in r["history"]]
             for k, r in runs.items()}
    same = (equal_bitwise(host["state"], dev["state"])
            and equal_bitwise(stores[0], stores[1]))
    print(f"async fedep replay ({cfg.name} cut to {cfg.num_layers} layer, "
          f"fp32, {args.clients} of {args.num_clients} clients, window "
          f"{args.max_staleness + 1}): "
          + "; ".join(f"{k} {v:.1f} s" for k, v in times.items())
          + f"; state_drops {drops} (host replay {want_drops}); host-store "
          f"and device-store card runs bitwise equal: {same}; DP launches "
          f"{launches}", flush=True)
    if any(d != want_drops for d in drops.values()) or not sum(want_drops):
        fail(f"async fedep replay: drops {drops} != {want_drops}")
    if not same:
        fail("async fedep replay: the host-store and device-store card "
             "runs differ")
    params_close(dev["state"].params, cpu["state"].params,
                 "async fedep one-layer, card vs CPU")
    store_close(stores[1], stores[2], "async fedep one-layer, card vs CPU")
    return launches["device store, card"]


def async_cnn_rounds(params, seed: int) -> dict:
    """Phase 11d: the CNN cell (phase 3's settings, 5 rounds) with the
    goldens' straggler spec and FedPA at their async2 window, each on the
    card and the CPU: ``straggled`` / ``staleness`` equal the CPU run's and
    the draws, params within phase 4's bound, FedPA's DP launches the
    synchronous count. Returns each run's DP launches.

    The card runs with cuDNN's deterministic algorithms, as every
    card-vs-CPU CNN comparison: the default ones take a data-gradient
    kernel that sums with atomics (``cudnn::detail::dgrad_engine``), so
    the card's params vary from run to run (on an H100 the stragglers run
    landed 1.72e-4 from the CPU's in 2 of 6 tries, ~4e-5 in the
    others; phase 4 lists the kernels)."""
    import torch

    from repro_torch.kernels import fedpa_dp

    by_run = {}
    for name, over in ASYNC_CNN_RUNS:
        runs = {}
        builds = []
        for device in ("cuda", "cpu"):
            sim = make_sim(device, seed, False, **over)
            fedpa_dp.reset_launches()
            with time_builds(builds if device == "cuda" else []), \
                    deterministic(device == "cuda"):
                t0 = time.perf_counter()
                state, hist = sim.run(params, ASYNC_ROUNDS)
                if device == "cuda":
                    torch.cuda.synchronize()
            runs[device] = (state, hist, dict(fedpa_dp.launches),
                            time.perf_counter() - t0, sim)
        (state, hist, launches, secs, sim), cpu = runs["cuda"], runs["cpu"]
        build_ms = [x * 1e3 for x in builds]
        fed = sim.fed
        lateness = [sim.source.draw(r)[1].extra_staleness
                    for r in range(ASYNC_ROUNDS)]
        window = [min(r, fed.max_staleness) for r in range(ASYNC_ROUNDS)]
        keys = [(h["staleness"], h["straggled"]) for h in hist]
        cpu_keys = [(h["staleness"], h["straggled"]) for h in cpu[1]]
        ell = (fed.local_steps - fed.burn_in_steps) // fed.steps_per_sample
        expected = ((ASYNC_ROUNDS - fed.burn_in_rounds) * (ell - 1)
                    if fed.algorithm == "fedpa" else 0)
        print(f"async cnn {name}: {secs:.2f} s for {ASYNC_ROUNDS} rounds on "
              f"the card, {cpu[3]:.2f} s on the CPU; (staleness, straggled)"
              f" {keys} (CPU {cpu_keys}, draws' lateness {lateness}); DP "
              f"launches {launches} (expected {expected} each); cohort "
              f"builds on the card's run host ms "
              f"{[round(x, 2) for x in build_ms]} (share "
              f"{sum(build_ms) / (secs * 1e3):.4f} of the run)", flush=True)
        if len(builds) != ASYNC_ROUNDS:
            fail(f"async cnn {name}: {len(builds)} cohort builds")
        if keys != cpu_keys:
            fail(f"async cnn {name}: the CPU run's records differ")
        if keys != [(w + x, x) for w, x in zip(window, lateness)]:
            fail(f"async cnn {name}: records {keys} against the draws "
                 f"{lateness}")
        if fed.straggler_rate and not sum(lateness):
            fail(f"async cnn {name}: no cohort straggled")
        if any(n != expected for n in launches.values()):
            fail(f"async cnn {name}: DP launches {launches}")
        losses = [h[k] for h in hist for k in ("loss_first", "loss_last")]
        if not all(map(math.isfinite, losses)):
            fail(f"async cnn {name}: losses {losses}")
        params_close(state.params, cpu[0].params,
                     f"async cnn {name}, card vs CPU")
        by_run[f"cnn {name}"] = launches
    return by_run


def async_rounds(card: str, params, seed: int) -> dict:
    """Phase 11 (11a-11d); returns the DP launches of its runs."""
    import torch

    by_run = {"fedlm-100m async fedpa": async_train_path(card, seed)}
    torch.cuda.empty_cache()
    by_run["fedlm-100m async fedep (device store)"] = async_state_path(
        card, seed)
    torch.cuda.empty_cache()
    by_run["fedlm-100m 1 layer fp32 async fedep (vs CPU)"] = \
        async_store_replay(seed)
    by_run.update(async_cnn_rounds(params, seed))
    return by_run


def fedlora_argv(argv, num_clients: int, codec: str) -> list:
    """``argv`` (a ``launch.train`` command) switched to FedLoRA with
    ``codec`` at rank 4, on the device store with a population of
    ``num_clients``."""
    out = list(argv)
    out[out.index("--algorithm") + 1] = "fedlora"
    out[out.index("--num-clients") + 1] = str(num_clients)
    return out + ["--payload-codec", codec, "--lora-rank", "4",
                  "--client-state-placement", "device"]


def quant_flips(q_card, x_card, q_cpu, scale_card) -> int:
    """int8 ``q`` from the card: the CPU quantizer applied to the card's own
    input gives the same ``q`` except where ``x / scale`` lies within 1e-5
    of a half quantum; against the CPU's run on the CPU's input, ``q`` is
    off by at most one (a flip: the two inputs straddle a half quantum).
    Returns the flips."""
    import torch

    q_card, x_card = q_card.cpu(), x_card.cpu()
    s = scale_card.cpu().reshape(-1, *([1] * (x_card.dim() - 1)))
    t = x_card / s
    mine = torch.clamp(torch.round(t), -127, 127).to(torch.int8)
    near = ((t - torch.round(t)).abs() - 0.5).abs() <= 1e-5
    if ((mine != q_card) & ~near).any():
        fail("int8 q on the card is not its own input's rounding")
    diff = (q_card.long() - q_cpu.long()).abs()
    if diff.max() > 1:
        fail(f"int8 q on the card differs from the CPU's by {diff.max()}")
    return int(diff.sum())


def codec_check(card: str, seed: int) -> None:
    """Phase 12a: the codecs on the card at fedlm-100m's leaf shapes, a
    stack of 4 clients' random deltas and precisions, rank 4."""
    import torch
    from torch.utils import _pytree as pytree

    from repro_torch import configs
    from repro_torch.compression import build_codec, round_bytes, tree_nbytes
    from repro_torch.compression.lowrank import host_basis
    from repro_torch.compression.quant import is_qleaf
    from repro_torch.configs.base import FedConfig
    from repro_torch.core import tree_math as tm
    from repro_torch.models.model import init_params

    cfg = configs.get_config("fedlm-100m")
    C, rnd = 4, 1
    kw = dict(clients_per_round=C, local_steps=12, burn_in_steps=4,
              steps_per_sample=2, burn_in_rounds=1, lora_rank=4)
    meta = init_params(None, cfg, device="meta")
    feds = {name: FedConfig(algorithm="fedlora", payload_codec=name, **kw)
            for name in ("lowrank", "lowrank+int8", "int8")}
    feds["fedpa_precision"] = FedConfig(algorithm="fedpa_precision", **kw)
    for name, fed in feds.items():
        rb = round_bytes(fed, meta)
        burn = round_bytes(fed, meta, use_sampling=False)
        down = FEDLM_DOWN if name != "fedpa_precision" else FEDLM_DENSE
        if (rb["bytes_up_per_client"], rb["bytes_down_per_client"],
                burn["bytes_up_per_client"], burn["bytes_down_per_client"]) \
                != (FEDLM_UP[name], down, FEDLM_DENSE, FEDLM_DENSE):
            fail(f"round_bytes {name}: {rb}, burn {burn}")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    like = init_params(gen, cfg, device="cuda")
    delta = tm.tmap(lambda p: 1e-2 * torch.randn(
        (C, *p.shape), generator=gen, device="cuda"), like)
    prec = tm.tmap(lambda p: torch.rand(
        (C, *p.shape), generator=gen, device="cuda") + 0.5, like)
    wire_bytes = {}
    for name in ("lowrank", "lowrank+int8", "int8"):
        codec = build_codec(feds[name])
        wire = codec.encode(delta, rnd, like)
        pwire = codec.encode_aux(codec.project_precision(prec, rnd, like),
                                 rnd, like)
        wire_bytes[name] = (tree_nbytes(wire) + tree_nbytes(pwire)) // C
        del wire, pwire
    if any(wire_bytes[k] != FEDLM_UP[k] for k in wire_bytes):
        fail(f"encoded bytes per client {wire_bytes} != {FEDLM_UP}")
    codec = build_codec(feds["lowrank+int8"])
    cpu_codec = build_codec(feds["lowrank+int8"])
    wire = codec.encode(delta, rnd, like)
    bases = codec.stages[0]._cache[rnd]
    same = all(torch.equal(b.cpu(), host_basis(last_dim, 4, rnd, leaf))
               for (leaf, last_dim, _), (b, _) in bases.items())
    eligible = sum(p.dim() >= 2 and p.shape[-1] > 4 for p in tm.tleaves(like))
    if len(bases) != eligible or not same:
        fail(f"codec: {len(bases)} bases on the card for {eligible} "
             f"sketched leaves, equal to the CPU's: {same}")
    factors = codec.stages[0].encode(delta, rnd, like)
    like_cpu, delta_cpu = (tm.tmap(lambda t: t.cpu(), x)
                           for x in (like, delta))
    factors_cpu = cpu_codec.stages[0].encode(delta_cpu, rnd, like_cpu)
    wire_cpu = cpu_codec.stages[1].encode(factors_cpu, rnd, like_cpu)
    rel = max(float((a.cpu() - b).abs().max() / b.abs().max())
              for a, b in zip(tm.tleaves(factors), tm.tleaves(factors_cpu)))
    flips, n_q = 0, 0
    for w, x, wc in zip(pytree.tree_leaves(wire, is_leaf=is_qleaf),
                        tm.tleaves(factors),
                        pytree.tree_leaves(wire_cpu, is_leaf=is_qleaf)):
        flips += quant_flips(w["q"], x, wc["q"], w["scale"])
        n_q += w["q"].numel()
        if w["scale"].shape != (C,):
            fail(f"int8 scale of shape {tuple(w['scale'].shape)}")
    if rel > 1e-5:
        fail(f"low-rank factors card vs CPU: {rel:.3g} relative")
    del factors, factors_cpu, wire_cpu, delta_cpu
    mean = tm.tmap(lambda t: t[0], codec.to_accum(wire))

    def one_round():
        w = codec.encode(delta, rnd, like)
        p = codec.encode_aux(codec.project_precision(prec, rnd, like), rnd,
                             like)
        codec.decode(w, rnd, like)
        codec.to_accum(p)
        codec.decode_accum(mean, rnd, like)

    one_round()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        one_round()
        host = (time.perf_counter() - t0) * 1e3
    finally:
        torch.cuda.set_sync_debug_mode(0)
    ev = time_ms(one_round, iters=5, warmup=1)
    print(f"codec lowrank+int8 rank 4 on fedlm-100m's leaves ({C} clients, "
          f"d={sum(p.numel() for p in tm.tleaves(like)):,}): wire bytes per "
          f"client {wire_bytes} (round_bytes: equal); bases on the card "
          f"{len(bases)}, equal to the CPU's bit for bit; factors card vs "
          f"CPU {rel:.3g} relative; int8 q flips against the CPU "
          f"{flips} of {n_q}; one round's encode + precision + decode + "
          f"server decode: host ms {host:.2f} (enqueue, no sync under "
          f"sync-debug 'error'), ms by CUDA events {ev:.2f}", flush=True)


def fedlora_train_path(card: str, seed: int) -> dict:
    """Phase 12b: FedLoRA (lowrank+int8, rank 4) on the device store trains
    the full-width fedlm-100m through ``launch.train.main`` (phase 9's
    settings, population 16); returns the DP kernels' launches."""
    import torch

    from repro_torch.core import tree_math as tm
    from repro_torch.kernels import fedpa_dp
    from repro_torch.kernels import swa_decode as swa
    from repro_torch.launch import train

    argv = fedlora_argv(TRAIN_ARGV, FEDLORA_CLIENTS, "lowrank+int8") \
        + ["--seed", str(seed)]
    args = train.parse_args(argv)
    ell = (args.local_steps - args.burn_in_steps) // args.steps_per_sample
    expected = (args.rounds - args.burn_in_rounds) * (ell - 1)
    fedpa_dp.reset_launches()
    swa.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    res = train.main(argv)
    torch.cuda.synchronize()
    launches = dict(fedpa_dp.launches)
    peak = torch.cuda.max_memory_allocated()
    cfg, recs, store = res["cfg"], res["records"], res["store"]
    d = cfg.param_count()
    total, mm, local, dp = train_round_bound_ms(cfg, args, hbm_rate(card))
    store_bytes = sum(nbytes(b) for b in tm.tleaves(store.device_state()))
    C = args.clients
    for rec, sec in zip(recs, res["seconds"]):
        print(f"  round {rec['round']} ({rec['phase']}): host ms "
              f"{sec * 1e3:.1f}; eval_loss {rec['eval_loss']:.4f}; bytes up "
              f"{rec['bytes_up']:,} down {rec['bytes_down']:,}", flush=True)
    warm = [sec * 1e3 for rec, sec in zip(recs, res["seconds"])
            if rec["phase"] == "fedlora"]
    print(f"train fedlora {cfg.name}: d={d:,}; {C} of {args.num_clients} "
          f"clients (population cut from 64), lowrank+int8 rank 4, "
          f"{args.local_steps} steps x {args.batch}x{args.seq_len} tokens, "
          f"l={ell}, residuals on the device store: FedLoRA round host ms "
          f"{[round(x, 1) for x in warm]} (the first includes warm-up) "
          f"against FedPA's bound of {total:.1f} ms; peak memory allocated "
          f"{peak / 2**30:.2f} GiB; store {store_bytes / 1e9:.2f} GB "
          f"({args.num_clients} x {4 * d / 1e6:.1f} MB); DP launches "
          f"{launches} (expected {expected} each); swa_decode launches "
          f"{swa.launches['swa_decode']} (expected 0)", flush=True)
    if d != LM_D:
        fail(f"fedlm-100m has d={d}, expected {LM_D}")
    if any(n != expected for n in launches.values()):
        fail(f"train fedlora: DP launches {launches} != {expected} each")
    if swa.launches["swa_decode"] != 0:
        fail("swa_decode launched on the FedLoRA training path")
    for rec in recs:
        want = ((C * FEDLM_DENSE, C * FEDLM_DENSE) if rec["phase"] !=
                "fedlora" else (C * FEDLM_UP["lowrank+int8"],
                                C * FEDLM_DOWN))
        if (rec["bytes_up"], rec["bytes_down"]) != want:
            fail(f"train fedlora: record bytes {rec}, expected {want}")
    losses = [r[k] for r in recs for k in ("eval_loss", "client_loss_first",
                                           "client_loss_last")]
    if len(recs) != args.rounds or not all(map(math.isfinite, losses)):
        fail(f"train fedlora: records {recs}")
    want = drawn_per_client(args, args.burn_in_rounds)
    check_sites(store, want, "fedlora residuals")
    return launches


def fedlora_replay(seed: int) -> dict:
    """Phase 12c: FedLoRA on fedlm-100m cut to one layer, fp32, client lr
    0.01, card and CPU: ``lowrank`` (params and residuals within phase 4's
    bound), ``lowrank+int8`` (a report: largest differences and the int8
    flips between the runs), and ``lowrank`` at window 3 (staleness equal,
    params and residuals within the bound). Returns the ``lowrank`` card
    run's DP launches."""
    import torch
    from torch.utils import _pytree as pytree

    from repro_torch import configs
    from repro_torch.compression.quant import QuantCodec, is_qleaf
    from repro_torch.core import tree_math as tm
    from repro_torch.kernels import fedpa_dp
    from repro_torch.launch import train

    cfg = configs.replace(configs.get_config("fedlm-100m"), repeats=1)
    encode = QuantCodec.encode
    launches = None
    # the synchronous runs take 2 rounds (one FedLoRA round after the
    # burn-in; cut from 3 for the script's time), window 3 takes 3 for its
    # staleness 0, 1, 2
    for name, codec, extra in (("lowrank", "lowrank", ["--rounds", "2"]),
                               ("lowrank+int8", "lowrank+int8",
                                ["--rounds", "2"]),
                               ("lowrank window 3", "lowrank", ASYNC_ARGV)):
        argv = fedlora_argv(REPLAY_ARGV, 4, codec) + FEDEP_REPLAY + extra \
            + ["--seed", str(seed)]
        runs, qs, times = {}, {}, {}
        for device in ("cuda", "cpu"):
            seen = qs[device] = []

            def recording(self, tree, round_idx, like=None, seen=seen):
                out = encode(self, tree, round_idx, like)
                seen.extend(w["q"].cpu() for w in pytree.tree_leaves(
                    out, is_leaf=is_qleaf) if not w["q"].is_meta)
                return out

            fedpa_dp.reset_launches()
            QuantCodec.encode = recording
            t0 = time.perf_counter()
            try:
                runs[device] = train.main(argv + ["--device", device],
                                          cfg=cfg,
                                          compute_dtype=torch.float32)
            finally:
                QuantCodec.encode = encode
            if device == "cuda":
                torch.cuda.synchronize()
                if name == "lowrank":
                    launches = dict(fedpa_dp.launches)
            times[device] = time.perf_counter() - t0
        card, cpu = runs["cuda"], runs["cpu"]
        flips = sum(int((a != b).sum()) for a, b in zip(qs["cuda"],
                                                        qs["cpu"]))
        stale = [[r["staleness"] for r in x["records"]] for x in (card, cpu)]
        print(f"fedlora one-layer {name} ({cfg.name} cut to 1 layer, d="
              f"{cfg.param_count():,}, fp32, {len(card['records'])} rounds): "
              f"card {times['cuda']:.1f} s, CPU {times['cpu']:.1f} s; "
              f"staleness card {stale[0]}, CPU {stale[1]}; eval_loss card "
              f"{[r['eval_loss'] for r in card['records']]}, CPU "
              f"{[r['eval_loss'] for r in cpu['records']]}; int8 q flips "
              f"card vs CPU {flips} of {sum(q.numel() for q in qs['cpu'])}",
              flush=True)
        if stale[0] != stale[1] or [r["bytes_up"] for r in card["records"]] \
                != [r["bytes_up"] for r in cpu["records"]]:
            fail(f"fedlora one-layer {name}: records differ")
        if len(qs["cuda"]) != len(qs["cpu"]):
            fail(f"fedlora one-layer {name}: encodes differ in number")
        stores = [r["store"].state_dict() for r in (card, cpu)]
        if name == "lowrank+int8":
            err = max((a.cpu() - b).abs().max().item() for a, b in zip(
                tm.tleaves(card["state"].params),
                tm.tleaves(cpu["state"].params)))
            serr = max(float(abs(a - b).max()) for a, b in zip(
                tm.tleaves(stores[0]["buffers"]),
                tm.tleaves(stores[1]["buffers"])))
            losses = [r[k] for x in (card, cpu) for r in x["records"]
                      for k in ("eval_loss", "client_loss_last")]
            print(f"  {name}: params max abs diff {err:.3g}, residuals "
                  f"max abs diff {serr:.3g} (a report)", flush=True)
            if not all(map(math.isfinite, losses)):
                fail(f"fedlora one-layer {name}: a loss is not finite")
            continue
        params_close(card["state"].params, cpu["state"].params,
                     f"fedlora one-layer {name}, card vs CPU")
        store_close(stores[0], stores[1],
                    f"fedlora one-layer {name}, card vs CPU")
    return launches


def fedlora_rounds(card: str, seed: int) -> dict:
    """Phase 12 (12a-12c); returns the DP launches of its runs."""
    import torch

    codec_check(card, seed)
    torch.cuda.empty_cache()
    by_run = {"fedlm-100m fedlora train (lowrank+int8)":
              fedlora_train_path(card, seed)}
    torch.cuda.empty_cache()
    by_run["fedlm-100m 1 layer fp32 fedlora (vs CPU)"] = fedlora_replay(seed)
    return by_run


def profile_step(cfg, args, params, seed: int) -> None:
    """Where a local step's time goes (a whole round takes minutes under
    the profiler at xlstm-125m's ~10^6 device ops): one bf16
    ``vmap(lm_grad_fn)`` over the cohort from ``params`` on random tokens
    (not ``launch.train``'s round), timed unprofiled (host ms with a sync,
    warm), then once more under ``torch.profiler``: device ops and time,
    the top kernels. The idle share (the profiled call's device time over
    the unprofiled call's host ms) and the ops a round (the step's count
    times the local steps) are estimates across two calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import tree_math as tm
    from repro_torch.models import steps

    C, B, S = args.clients, args.batch, args.seq_len
    cohort = tm.tmap(lambda t: t.expand(C, *t.shape).clone(), params)
    batch = {"tokens": torch.randint(
        0, cfg.vocab_size, (C, B, S + 1), device="cuda",
        generator=torch.Generator("cuda").manual_seed(seed))}
    fn = torch.func.vmap(steps.lm_grad_fn(cfg, q_chunk=min(64, S)))
    host = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(cohort, batch)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(cohort, batch)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    ops = sum(e.count for e in events)
    print(f"step profile ({cfg.name}, one bf16 vmap(grad) local step of "
          f"{C} clients x {B}x{S} tokens): host ms {host[-1]:.1f} (warm; "
          f"first {host[0]:.1f}); {ops} device ops, device time "
          f"{dev_ms:.1f} ms (a second, profiled call); estimated device "
          f"idle share {1 - dev_ms / host[-1]:.3f} (the profiled call's "
          f"device time over the unprofiled call's host ms); estimated "
          f"device ops a round ~{ops * args.local_steps} (x "
          f"{args.local_steps} local steps)",
          flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:8.2f} ms {e.count:7d} "
              f"calls  {e.key[:90]}")


def remat_check(seed: int) -> dict:
    """Phase 14b: one FedPA round of the full-width fedlm-100m
    (``REMAT_ARGV``, fp32 compute) from the same state with
    ``remat="none"`` and ``"full"``: params within phase 4's bound, the
    peak lower with the recompute. Returns the DP launches of each
    run."""
    import torch

    from repro_torch.kernels import fedpa_dp
    from repro_torch.launch import train

    argv = REMAT_ARGV + ["--seed", str(seed)]
    args = train.parse_args(argv)
    runs, by_run = {}, {}
    for remat in ("none", "full"):
        fedpa_dp.reset_launches()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        res = train.main(argv, compute_dtype=torch.float32, remat=remat)
        torch.cuda.synchronize()
        runs[remat] = (res, torch.cuda.max_memory_allocated())
        by_run[f"fedlm-100m fp32 fedpa remat={remat}"] = dict(
            fedpa_dp.launches)
    (none, peak_none), (full, peak_full) = runs["none"], runs["full"]
    print(f"remat {none['cfg'].name} (d={none['cfg'].param_count():,}, "
          f"fp32, one FedPA round of {args.clients} clients x "
          f"{args.local_steps} steps x {args.batch}x{args.seq_len} tokens): "
          f"round host "
          f"ms none {none['seconds'][0] * 1e3:.1f}, full "
          f"{full['seconds'][0] * 1e3:.1f}; peak memory allocated none "
          f"{peak_none / 2**30:.2f} GiB, full {peak_full / 2**30:.2f} GiB; "
          f"DP launches {by_run}", flush=True)
    params_close(full["state"].params, none["state"].params,
                 "remat full vs none, fedlm-100m fp32")
    if not peak_full < peak_none:
        fail(f"remat: the recompute's peak {peak_full} is not below "
             f"{peak_none}")
    return by_run


def grad_cuts(seed: int) -> None:
    """Phase 14c: ``vmap(grad)`` of the loss over 2 clients (the same
    params, their own batches) on one-layer fp32 cuts at full width, card
    against the CPU from the same weights: losses and grads within phase
    4's bound. An MoE cut records the card's expert choices and forces
    the CPU onto them (``routed``), counting the CPU router's flips."""
    import torch

    from repro_torch import configs
    from repro_torch.core import tree_math as tm
    from repro_torch.launch.train import bf16_values
    from repro_torch.models import model, steps

    LS = configs.LayerSpec
    moe_cfg = configs.replace(configs.get_config("qwen3-moe-30b-a3b"),
                              repeats=1)
    llama = configs.get_config("llama4-scout-17b-a16e")
    cuts = (
        ("moe onehot", moe_cfg, 32),
        ("moe sort", configs.replace(moe_cfg, moe=configs.replace(
            moe_cfg.moe, routing="sort")), 32),
        ("llama4 moe", configs.replace(llama, pattern=llama.pattern[-1:],
                                       repeats=1), 32),
        ("rglru, rglru, swa", configs.replace(
            configs.get_config("recurrentgemma-9b"), repeats=1, tail=()), 32),
        ("audio frontend", configs.replace(
            configs.get_config("musicgen-medium"), repeats=1), 32),
        ("vision frontend", configs.replace(
            configs.get_config("internvl2-26b"), repeats=1), 32),
        ("slstm, mlstm", configs.replace(configs.get_config("xlstm-125m"),
                                         repeats=1), 128),
    )
    f32, B, C = torch.float32, 2, 2
    for name, cfg, S in cuts:
        t0 = time.perf_counter()
        params = model.init_params(
            torch.Generator("cuda").manual_seed(seed), cfg, f32,
            device="cuda")
        r = torch.Generator().manual_seed(seed + 1)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (C, B, S + 1),
                                         generator=r)}
        if cfg.frontend:
            batch["frontend"] = torch.from_numpy(bf16_values(
                (torch.randn((C, B, cfg.frontend_tokens, cfg.d_model),
                             generator=r) / math.sqrt(cfg.d_model)).numpy()))

        def client(p, b):
            """One client's (loss, grads, its router's top-k choices)."""
            def loss(p):
                seen = []
                with routed(record=seen, force=b.get("forced"), flips=[]):
                    value = steps.lm_loss(p, b, cfg, compute_dtype=f32,
                                          q_chunk=64, remat="none")[0]
                return value, tuple(seen)

            grads, (value, seen) = torch.func.grad_and_value(
                loss, has_aux=True)(p)
            return value, grads, seen

        out, secs = {}, {}
        for dev in ("cuda", "cpu"):
            t1 = time.perf_counter()
            p = tm.tmap(lambda t: t.to(dev), params)
            b = tm.tmap(lambda t: t.to(dev), batch)
            if dev == "cpu" and cfg.moe.enabled:
                b["forced"] = tuple(t.cpu() for t in out["cuda"][2])
            if cfg.moe.enabled:
                res = torch.func.vmap(client, in_dims=(None, 0))(p, b)
            else:
                res = torch.func.vmap(steps.lm_grad_fn(
                    cfg, compute_dtype=f32, q_chunk=64),
                    in_dims=(None, 0))(p, b) + ((),)
            if dev == "cuda":
                torch.cuda.synchronize()
            out[dev] = res        # the card's grads stay on the card
            secs[dev] = time.perf_counter() - t1
            del p, b, res
        (lc, gc, seen_card), (lp, gp, seen_cpu) = out["cuda"], out["cpu"]
        lc = lc.cpu()
        flips = sum(int((a.cpu().sort(-1).values != b.sort(-1).values)
                        .any(-1).sum()) for a, b in zip(seen_card, seen_cpu))
        choices = sum(a[..., 0].numel() for a in seen_card)
        # compared on the card, one leaf at a time
        pairs = list(zip(tm.tleaves(gc), tm.tleaves(gp)))
        err = max((a - b.cuda()).abs().max().item() for a, b in pairs)
        print(f"fp32 one-layer vmap(grad) {name} ({cfg.name}, "
              f"{'/'.join(f'{s.mixer}+{s.ffn}' for s in cfg.layers())}, d="
              f"{cfg.param_count():,}, {C} clients x batch {B} x {S} text "
              f"tokens{f' + {cfg.frontend_tokens} frontend' if cfg.frontend else ''}), "
              f"card vs CPU: losses {[round(float(x), 6) for x in lc]} vs "
              f"{[round(float(x), 6) for x in lp]}, grads max abs diff "
              f"{err:.3g}"
              + (f"; router flips on the CPU {flips} of {choices} token "
                 f"choices (forced onto the card's)" if cfg.moe.enabled
                 else "")
              + f"; card {secs['cuda']:.1f} s, CPU {secs['cpu']:.1f} s "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        if not torch.allclose(lc, lp, rtol=1e-3, atol=1e-4):
            fail(f"vmap(grad) {name}: card vs CPU losses differ")
        for i, (a, b) in enumerate(pairs):
            b = b.cuda()
            if not (torch.isfinite(a).all()
                    and torch.allclose(a, b, rtol=1e-3, atol=1e-4)):
                fail(f"vmap(grad) {name}: grad leaf {i} differs ({err})")
        del params, out, gc, gp, pairs
        torch.cuda.empty_cache()


def train_rest(card: str, seed: int) -> dict:
    """Phase 14 (14a-14c); returns the DP launches of its runs."""
    import torch

    launches, res, args, _ = train_path(card, seed, XLSTM_ARGV, XLSTM_D)
    by_run = {"xlstm-125m train": launches}
    profile_step(res["cfg"], args, res["state"].params, seed)
    del res
    torch.cuda.empty_cache()
    by_run.update(remat_check(seed))
    torch.cuda.empty_cache()
    grad_cuts(seed)
    return by_run


def free_port() -> int:
    """A free TCP port on the loopback interface."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def nccl_one_rank(params, seed: int) -> dict:
    """Phase 15a: phase 10d's CNN FedEP rounds (device store, phase 3's
    settings) through ``FedSim(mesh=make_host_mesh())`` inside a one-rank
    NCCL group, against the same rounds with no mesh, both under
    ``deterministic()``: params and store bitwise equal. The mesh's
    collectives (the accumulator's broadcast, the metrics' all-gather, the
    store rows' all-to-all, the replica digest) run through NCCL; one rank
    checks the calls, not NCCL between cards. Returns each run's DP
    launches."""
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.core import collective
    from repro_torch.kernels import fedpa_dp
    from repro_torch.launch.mesh import make_host_mesh

    over = dict(STATE_RUNS)["fedep device store"]
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=MP_CONNECT_S))
    try:
        mesh = make_host_mesh("cuda")
        runs, launches = {}, {}
        for name, m in (("no mesh", None), ("one-rank nccl mesh", mesh)):
            fedpa_dp.reset_launches()
            collective.reset_traffic()
            with deterministic():
                sim = make_sim("cuda", seed, False, mesh=m, **over)
                state = sim.init(params)
                for r in range(ROUNDS):
                    state, _ = sim.round(state, r)
                torch.cuda.synchronize()
            runs[name] = (state, sim.client_store.state_dict())
            launches[f"cnn fedep, {name}"] = dict(fedpa_dp.launches)
        calls, backend = collective.traffic["calls"], mesh.backend
        collective.check_replicas(mesh, state)
    finally:
        dist.destroy_process_group()
    (a, sa), (b, sb) = runs.values()
    same = equal_bitwise(a, b) and equal_bitwise(sa, sb)
    print(f"nccl one rank (phase 10d's cnn fedep, {ROUNDS} rounds, "
          f"{mesh.shape} mesh, backend {backend}): {calls} NCCL "
          f"collective calls; params and store bitwise equal to the run "
          f"with no mesh: {same}; DP launches {launches}", flush=True)
    if not same or not calls:
        fail("nccl one rank: the mesh run differs from the run with no "
             "mesh (or ran no collective)")
    return launches


def spawn_ranks(cmds, timeout: float):
    """Run ``cmds`` (one per rank) at once, each a fresh interpreter with
    the port on its path; returns their outputs, or fails (killing the
    rest) when one exits non-zero or outlives ``timeout``."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env,
                              cwd=ROOT) for c in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        fail(f"a rank outlived {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            fail(f"rank {r} exited {p.returncode}:\n{out[-3000:]}")
    return outs


def json_lines(out: str, head: str) -> list:
    """The JSON objects of ``out``'s lines that start with ``head``."""
    return [json.loads(line) for line in out.splitlines()
            if line.startswith(head)]


def two_rank_train(card: str, seed: int, want_records: list) -> dict:
    """Phase 15b: phase 10a's command (FedEP, full-width fedlm-100m, 4 of
    16 clients, 2 a rank) on two ranks sharing the card over gloo, each a
    ``python -m repro_torch.launch.train`` process, checkpointing at round
    3. Returns each rank's DP launches."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.launch import train

    argv = fedep_argv(TRAIN_ARGV, FEDEP_CLIENTS) + ["--seed", str(seed)]
    args = train.parse_args(argv)
    ell = (args.local_steps - args.burn_in_steps) // args.steps_per_sample
    expected = (args.rounds - args.burn_in_rounds) * (ell - 1)
    row_bytes = 2 * 4 * LM_D
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    try:
        dist = ["--num-processes", "2", "--coordinator",
                f"127.0.0.1:{free_port()}", "--dist-backend", "gloo",
                "--dist-timeout", str(MP_CONNECT_S), "--ckpt-dir", tmp,
                "--ckpt-every", "3", "--log", os.path.join(tmp, "log.jsonl")]
        t0 = time.perf_counter()
        outs = spawn_ranks([[sys.executable, "-m", "repro_torch.launch.train",
                             *argv, *dist, "--process-id", str(r)]
                            for r in (0, 1)], MP_TIMEOUT_S)
        wall = time.perf_counter() - t0
        recs = [json_lines(out, '{"round"') for out in outs]
        with open(os.path.join(tmp, "log.jsonl")) as f:
            logged = [json.loads(line) for line in f]
        sums = [json_lines(out, '{"rank_summary"')[0]["rank_summary"]
                for out in outs]
        shards = [np.load(os.path.join(
            tmp, f"ckpt_{args.rounds:08d}.shard{r}of2.npz")) for r in (0, 1)]
        metas = []
        for r in (0, 1):
            with open(os.path.join(
                    tmp, f"ckpt_{args.rounds:08d}.shard{r}of2.json")) as f:
                metas.append(json.load(f))
        stamp_key = [m["key"] for m in metas[0]["manifest"]
                     if m["path"] == "['stamps']"][0]
        stamps = np.concatenate([sh[stamp_key] for sh in shards])
        offsets = [m["shard"]["row_offset"] for m in metas]
        saved = sorted(os.listdir(tmp))
    finally:
        shutil.rmtree(tmp)
    print(f"two ranks train fedep {args.arch}: d={LM_D:,}; {args.clients} "
          f"of {args.num_clients} clients, 2 a rank, 2 ranks on one card "
          f"({card}) over gloo, {wall:.1f} s from the spawn to both exits; "
          f"files {saved}", flush=True)
    for s in sums:
        per_round = [round(b / 1e6, 1) for b in s["sent_bytes"]]
        peak = ("not measured" if s["peak_bytes"] is None
                else f"{s['peak_bytes'] / 2**30:.2f} GiB")
        print(f"  rank {s['rank']} on {s['device']}: peak memory allocated "
              f"{peak}; host ms per round "
              f"{[round(x, 1) for x in s['host_ms']]}; MB sent to the other "
              f"rank per round {per_round} (in all: store rows "
              f"{s['traffic']['rows'] / 1e6:.1f}, accumulator "
              f"{s['traffic']['accumulator'] / 1e6:.1f}, gathered "
              f"{s['traffic']['gathered'] / 1e6:.3f}; staged through the "
              f"host {s['traffic']['staged'] / 1e6:.1f}; host s inside the "
              f"collectives {s['traffic']['seconds']:.1f} of "
              f"{sum(s['host_ms']) / 1e3:.1f}); store "
              f"{s['store_rows']} rows, {s['store_bytes']:,} B; DP launches "
              f"{s['dp_launches']} (expected {expected} each); replica "
              f"digests equal after rounds 0..{len(s['host_ms']) - 1}",
              flush=True)
    got = [r["client_loss_last"] for r in recs[0]]
    want = [r["client_loss_last"] for r in want_records]
    print(f"  client_loss_last {got} against phase 10a's {want}; stamps of "
          f"the shards (rows from {offsets}) {stamps.tolist()}", flush=True)
    if len(recs[0]) != args.rounds or recs[1] or logged != recs[0]:
        fail(f"two ranks: rank 0 logged {len(recs[0])} records ("
             f"{len(logged)} in the log), rank 1 {len(recs[1])}")
    losses = [r[k] for r in recs[0] for k in ("eval_loss", "client_loss_first",
                                              "client_loss_last")]
    if not all(map(math.isfinite, losses)):
        fail(f"two ranks: records {recs[0]}")
    if any(abs(g - w) > 2e-2 * abs(w) for g, w in zip(got, want)):
        fail(f"two ranks: client_loss_last {got} vs phase 10a's {want}")
    for s in sums:
        if any(n != expected for n in s["dp_launches"].values()):
            fail(f"two ranks: rank {s['rank']} DP launches "
                 f"{s['dp_launches']} != {expected} each")
        if s["store_rows"] != 8 or s["store_bytes"] != 8 * row_bytes:
            fail(f"two ranks: rank {s['rank']} holds {s['store_rows']} rows,"
                 f" {s['store_bytes']} B (want 8, {8 * row_bytes})")
        if len(s["host_ms"]) != args.rounds:
            fail(f"two ranks: rank {s['rank']} checked replicas after "
                 f"{len(s['host_ms'])} rounds")
    want_stamps = drawn_per_client(args, args.burn_in_rounds)
    if offsets != [0, 8] or not np.array_equal(stamps, want_stamps):
        fail(f"two ranks: shard stamps {stamps} (offsets {offsets}) != "
             f"draws {want_stamps}")
    return {f"fedlm-100m fedep train, 2 gloo ranks: rank {s['rank']}":
            s["dp_launches"] for s in sums}


def replay_rank(rank: int, port: int, argv: list, out: str) -> None:
    """One rank of phase 15c (a spawned child): the one-layer fp32 FedEP
    replay through ``launch.train.main`` over gloo; writes its params, its
    store rows and its DP launches to ``out/rank<r>.npz``."""
    import contextlib as ctl

    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.core import tree_math as tm
    from repro_torch.kernels import fedpa_dp
    from repro_torch.launch import train

    cfg = configs.replace(configs.get_config("fedlm-100m"), repeats=1)
    dist = ["--num-processes", "2", "--process-id", str(rank),
            "--coordinator", f"127.0.0.1:{port}", "--dist-backend", "gloo",
            "--dist-timeout", str(MP_CONNECT_S)]
    with open(os.path.join(out, f"rank{rank}.log"), "w") as log, \
            ctl.redirect_stdout(log):
        res = train.main(argv + dist, cfg=cfg, compute_dtype=torch.float32)
    local, offset = res["store"].local_state_dict()
    np.savez(os.path.join(out, f"rank{rank}.npz"), offset=offset,
             stamps=local["stamps"],
             launches=np.array([fedpa_dp.launches["dp_reduce"],
                                fedpa_dp.launches["dp_map"]]),
             **{f"p{i}": t.cpu().numpy() for i, t in
                enumerate(tm.tleaves(res["state"].params))},
             **{f"s{i}": b for i, b in
                enumerate(tm.tleaves(local["buffers"]))})


def two_rank_replay(seed: int) -> dict:
    """Phase 15c: 10b's one-layer fp32 FedEP replay (client lr 0.01, 3
    rounds, 2 of 4 clients: one a rank) on two gloo ranks sharing the card
    (spawned children) and in one process on the card: params and the
    store put together from the ranks within phase 4's bound, stamps
    exact. Returns each rank's DP launches."""
    import multiprocessing as mp
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.core import tree_math as tm
    from repro_torch.launch import train

    cfg = configs.replace(configs.get_config("fedlm-100m"), repeats=1)
    argv = fedep_argv(REPLAY_ARGV, 4) + FEDEP_REPLAY + ["--seed", str(seed)]
    t0 = time.perf_counter()
    one = train.main(argv, cfg=cfg, compute_dtype=torch.float32)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    tmp = tempfile.mkdtemp(prefix="chip_smoke_replay_")
    try:
        ctx = mp.get_context("spawn")
        port = free_port()
        procs = [ctx.Process(target=replay_rank, args=(r, port, argv, tmp))
                 for r in (0, 1)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        for p in procs:
            p.join(MP_TIMEOUT_S)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
        two_s = time.perf_counter() - t0
        if alive or any(p.exitcode for p in procs):
            fail(f"two-rank replay: ranks exited "
                 f"{[p.exitcode for p in procs]}")
        ranks = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
                 for r in (0, 1)]
    finally:
        shutil.rmtree(tmp)
    want_params = tm.tleaves(one["state"].params)
    want_store = one["store"].state_dict()
    got = [torch.from_numpy(ranks[0][f"p{i}"]) for i in
           range(len(want_params))]
    ranks_equal = all(np.array_equal(ranks[0][k], ranks[1][k])
                      for k in ranks[0] if k.startswith("p"))
    store = {"buffers": [np.concatenate([r[f"s{i}"] for r in ranks])
                         for i in range(len(tm.tleaves(
                             want_store["buffers"])))],
             "stamps": np.concatenate([r["stamps"] for r in ranks])}
    launches = {f"fedlm-100m 1 layer fp32 fedep, 2 gloo ranks: rank {r}":
                {"dp_reduce": int(x["launches"][0]),
                 "dp_map": int(x["launches"][1])}
                for r, x in enumerate(ranks)}
    bitwise = equal_bitwise(got, want_params) and equal_bitwise(
        store["buffers"], tm.tleaves(want_store["buffers"]))
    print(f"two-rank replay ({cfg.name} cut to {cfg.num_layers} layer, fp32, "
          f"2 of 4 clients, one a rank): one process {one_s:.1f} s, two "
          f"ranks {two_s:.1f} s from the spawn; the ranks' params bitwise "
          f"equal {ranks_equal}; two ranks bitwise equal to one process "
          f"{bitwise}; DP launches {launches}", flush=True)
    if not ranks_equal:
        fail("two-rank replay: the ranks' params differ")
    params_close(got, want_params, "two ranks vs one process, params")
    store_close({"buffers": store["buffers"], "stamps": store["stamps"]},
                {"buffers": tm.tleaves(want_store["buffers"]),
                 "stamps": want_store["stamps"]},
                "two ranks vs one process")
    return launches


def multi_process(card: str, params, seed: int, fedep_records) -> dict:
    """Phase 15 (15a-15c); returns the DP launches of its runs."""
    import torch

    by_run = nccl_one_rank(params, seed)
    torch.cuda.empty_cache()
    by_run.update(two_rank_train(card, seed, fedep_records))
    by_run.update(two_rank_replay(seed))
    return by_run


# phase 16: the sequential placement's FSDP over ranks. The one-layer
# fp32 cut runs REPLAY_ARGV's FedPA settings (2 clients, 2 rows each), the
# full-width run TRAIN_ARGV's with STEPS_CUT's local steps, cut to 2 of 64
# clients; each one burn-in round and one FedPA round at ``sequential``.
# 16b then runs one round of each other algorithm from the one-layer
# burn-in state, 16e one FedEP round and 16f one FedLoRA round at full
# width from 16c's state, and 16g checks the FSDP checkpoints they write.
FSDP_CLIENTS = 2
#: 16b's other algorithms: (name, FedConfig changes). SCAFFOLD steps with
#: plain SGD on the host store's slice, FedEP and FedLoRA (identity codec,
#: error feedback) on the device store; each store is made for the layout.
#: The three without the DP take the first 2 of the 6 local steps (cut for
#: the script's time: each local step stages its gathers through the host,
#: MIME's three a step)
FSDP_ALGOS = (
    ("fedpa_precision", dict(algorithm="fedpa_precision")),
    ("fedprox", dict(algorithm="fedprox", local_steps=2)),
    ("mime", dict(algorithm="mime", local_steps=2)),
    ("scaffold", dict(algorithm="scaffold", client_opt="sgd",
                      local_steps=2)),
    ("fedep", dict(algorithm="fedep", client_state_placement="device")),
    ("fedlora", dict(algorithm="fedlora", client_state_placement="device",
                     payload_codec="none", error_feedback=True)),
    ("fedlora_lowrank_int8", dict(algorithm="fedlora",
                                  client_state_placement="device",
                                  payload_codec="lowrank+int8",
                                  lora_rank=4, error_feedback=True)),
    ("fedlora_int8", dict(algorithm="fedlora",
                          client_state_placement="device",
                          payload_codec="int8", error_feedback=True)),
)
#: the algorithms of FSDP_ALGOS whose round runs the DP
FSDP_DP_ALGOS = ("fedpa_precision", "fedep", "fedlora",
                 "fedlora_lowrank_int8", "fedlora_int8")
#: the algorithms of FSDP_ALGOS whose payloads are int8 codes (16b) and
#: 16f's full-width FedLoRA round
FSDP_INT8_ALGOS = ("fedlora_lowrank_int8", "fedlora_int8")
FSDP_LORA_FULL = "fedlora_lowrank_int8"
#: 16e: FedEP's population on the full-width ranks (each rank's device
#: store holds 2 fp32 vectors of its n elements a client) and the
#: cohort's ids
FSDP_STORE_CLIENTS, FSDP_STORE_IDS = 16, (5, 12)


def fsdp_inputs(argv: list, cfg, seed: int):
    """``(FedConfig, the two rounds' tokens (C, K, B, S + 1))`` of a
    ``launch.train`` command, cut to ``FSDP_CLIENTS`` clients; the tokens
    drawn from ``seed``."""
    import dataclasses

    import numpy as np

    from repro_torch.launch import train

    args = train.parse_args(argv)
    fed = dataclasses.replace(train.build_fed(args),
                              clients_per_round=FSDP_CLIENTS)
    r = np.random.default_rng(seed)
    toks = [r.integers(0, cfg.vocab_size, (FSDP_CLIENTS, args.local_steps,
                                           args.batch, args.seq_len + 1),
                       dtype=np.int32) for _ in range(2)]
    return fed, toks


@contextlib.contextmanager
def fsdp_probe(held: dict):
    """Record, inside the block, the elements of the accumulator, the
    batch-DP samples and the DP history each FSDP round holds per client
    (``held[name]``: a set), restoring the functions after."""
    from repro_torch.algorithms import base, fedpa
    from repro_torch.core import tree_math as tm
    from repro_torch.kernels import ops

    saved = (base.FedAlgorithm.accumulate, fedpa.dp_delta,
             ops.dp_step_sharded)

    def probe(key, fn, size):
        def wrapped(*a, **k):
            held.setdefault(key, set()).add(size(*a))
            return fn(*a, **k)
        return wrapped

    base.FedAlgorithm.accumulate = probe(
        "accumulator", saved[0], lambda self, acc, *_: tm.tree_size(acc))
    fedpa.dp_delta = probe("samples", saved[1],
                           lambda x0, samples, *_: samples[0].numel())
    ops.dp_step_sharded = probe("v_hist", saved[2],
                                lambda u, delta, V, *_: V[0].numel())
    try:
        yield held
    finally:
        (base.FedAlgorithm.accumulate, fedpa.dp_delta,
         ops.dp_step_sharded) = saved


def timed_round(fn, cuda: bool) -> tuple:
    """``(fn()'s result, host ms, peak memory allocated or None, DP
    launches, collective traffic)`` of one round, the counters zeroed
    first."""
    import torch

    from repro_torch.core import collective
    from repro_torch.kernels import fedpa_dp

    fedpa_dp.reset_launches()
    collective.reset_traffic()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        torch.cuda.synchronize()
    return (out, (time.perf_counter() - t0) * 1e3,
            torch.cuda.max_memory_allocated() if cuda else None,
            dict(fedpa_dp.launches), dict(collective.traffic))


def fsdp_rounds(cfg, fed, toks, device: str, compute_dtype, seed: int,
                mesh=None) -> dict:
    """A burn-in round then a FedPA round of ``make_fed_round`` at
    ``sequential`` from ``init_params`` at ``seed`` (sharded over ``mesh``
    when given). Returns per round the whole params after it (gathered),
    its losses, host ms, peak memory, DP launches and collective traffic;
    the state's elements a rank holds; the FSDP layout; and the (sharded)
    states after the burn-in round (``burn_state``) and after both
    (``state``)."""
    import torch

    from repro_torch.core import sharded_round
    from repro_torch.core import tree_math as tm
    from repro_torch.core.server import init_server_state
    from repro_torch.models.model import init_params
    from repro_torch.optim import get_optimizer

    cuda = torch.device(device).type == "cuda"
    params = tm.tmap(lambda x: x.to(device), init_params(
        torch.Generator().manual_seed(seed), cfg, device="cpu"))
    opt = get_optimizer(fed.server_opt, fed.server_lr, fed.server_momentum)
    state = init_server_state(params, opt)
    del params
    layout = None
    if mesh is not None:
        layout = sharded_round.fsdp_layout(cfg, mesh)
        state = layout.shard_state(state)
    out = {"rounds": [], "layout": layout}
    for use_sampling, t in zip((False, True), toks):
        fn = sharded_round.make_fed_round(
            cfg, fed, placement="sequential", compute_dtype=compute_dtype,
            use_sampling=use_sampling, mesh=mesh)
        (state, metrics), ms, peak, launches, traffic = timed_round(
            lambda: fn(state, {"tokens": t}), cuda)
        rec = dict(ms=ms, launches=launches, traffic=traffic,
                   losses={k: float(v) for k, v in metrics.items()},
                   peak=peak)
        if layout is not None:
            rec.update(master=state.params.numel(),
                       momentum=state.opt_state["m"].numel())
        rec["params"] = (layout.gather_state(state).params if layout
                         else state.params)
        out["rounds"].append(rec)
        if not use_sampling:
            out["burn_state"] = state
    out["state"] = state
    return out


@contextlib.contextmanager
def recording_wires(wires: list):
    """Append, inside the block, every client payload a FedLoRA round
    folds (``payload_accum``'s argument: its wire form) to ``wires``."""
    from repro_torch.algorithms import fedlora

    saved = fedlora.FedLoRA.payload_accum

    def recorded(self, payload):
        wires.append(payload)
        return saved(self, payload)

    fedlora.FedLoRA.payload_accum = recorded
    try:
        yield wires
    finally:
        fedlora.FedLoRA.payload_accum = saved


def wire_codes(wires: list, layout=None) -> dict:
    """Recorded int8 wire payloads -> ``{"<client>/<delta|prec>/<path>":
    (whole leaf's codes as int64 numpy, scale)}`` and their wire bytes.
    Under ``layout`` each rank's pieces are all-gathered into whole
    leaves (every rank calls this) and a factor held whole on every rank
    is taken as it is."""
    import torch
    from torch.utils import _pytree as pytree

    from repro_torch.compression.quant import is_qleaf
    from repro_torch.core import fsdp

    out, nbytes = {}, 0
    for k, payload in enumerate(wires):
        for part in ("delta", "prec"):
            wire = payload[part]
            if layout is None:
                pairs = [(pytree.keystr(p), w["q"], w["scale"]) for p, w in
                         pytree.tree_flatten_with_path(
                             wire, is_leaf=is_qleaf)[0]]
            else:
                pieces = layout.join([
                    torch.zeros(p.size, device=w["q"].device)
                    if w["q"].dim() > 1 else w["q"].to(torch.float32)
                    for p, w in zip(layout.leaf_pieces(), wire)])
                whole = dict(fsdp._paths(layout.gather_tree(pieces)))
                pairs = [(p.path, w["q"] if w["q"].dim() > 1 else
                          whole[p.path].to(w["q"].dtype), w["scale"])
                         for p, w in zip(layout.leaf_pieces(), wire)]
            for path, q, scale in pairs:
                out[f"{k}/{part}/{path}"] = (
                    q.reshape(-1).to(torch.int64).cpu().numpy(),
                    float(scale))
                nbytes += q.numel() * q.element_size() \
                    + scale.numel() * scale.element_size()
    return {"codes": out, "wire_bytes": nbytes // max(len(wires), 1)}


def code_flips(got: dict, want: dict, what: str) -> tuple:
    """``(flips, codes)``: int8 codes one apart between two runs' wire
    codes (``wire_codes``), out of all; fails where two codes are more
    than one apart (not a rounding boundary) or a leaf is missing."""
    import numpy as np

    if got.keys() != want.keys():
        fail(f"{what}: the wire payloads differ in their leaves")
    flips = total = 0
    for key, (q, _) in want.items():
        diff = np.abs(got[key][0] - q)
        if diff.max(initial=0) > 1:
            fail(f"{what}: codes of {key} differ by {diff.max()}")
        flips += int(diff.sum())
        total += q.size
    return flips, total


def fsdp_algo_round(cfg, fed, tokens, device: str, compute_dtype, state,
                    layout=None, mesh=None, num_clients: int = FSDP_CLIENTS,
                    ids=None, whole_states: bool = True,
                    ckpt=None) -> dict:
    """One round of ``fed``'s algorithm (``make_fed_round`` at
    ``sequential``) from ``state`` (this rank's shard under ``layout``,
    through FSDP over ``mesh``) on the first ``fed.local_steps`` steps of
    ``tokens`` (``(C, K, B, S + 1)``):
    SCAFFOLD's ``c`` starts at zero, a stateful algorithm's clients from a
    zero store of ``num_clients`` made for the layout, in the placement
    ``fed`` names, the cohort ``ids`` (default the first C). Returns the
    round's host ms, peak memory, DP launches, traffic and losses, the
    store's bytes, and the whole params after it (gathered), SCAFFOLD's
    ``c`` and, with ``whole_states``, the cohort's new client states; for
    a FedLoRA codec that quantizes, its clients' wire codes and bytes
    (``wire_codes``). ``ckpt=(directory, "server" | "clients")`` (under
    a layout) writes the new server state or the store with
    ``save_checkpoint_fsdp`` on every rank, reads it back at this W
    (``ckpt_bitwise``: equal by digest) and keeps the gathered whole
    state (``state``)."""
    import numpy as np
    import torch

    from repro_torch.algorithms import get_algorithm
    from repro_torch.core import collective, sharded_round
    from repro_torch.core import tree_math as tm
    from repro_torch.core.client_state import make_client_store

    alg = get_algorithm(fed)
    ids = np.arange(tokens.shape[0]) if ids is None else np.asarray(ids)
    if fed.algorithm == "scaffold":
        state = state._replace(algo_state=alg.init_algo_state(state.params))
    fn = sharded_round.make_fed_round(cfg, fed, placement="sequential",
                                      compute_dtype=compute_dtype, mesh=mesh)
    args, store = (), None
    device_store = fed.client_state_placement == "device"
    if alg.stateful:
        store = make_client_store(fed.client_state_placement, num_clients,
                                  device=device, fsdp=layout)
        store.ensure(alg.init_client_state(state.params))
        args = ((store.device_state(), store.prepare_ids(ids))
                if device_store else (store.gather(ids)[0],))
    batches = {"tokens": tokens[:, :fed.local_steps]}
    wires = []
    with (recording_wires(wires) if "int8" in fed.payload_codec
          and fed.algorithm == "fedlora" else contextlib.nullcontext()):
        res, ms, peak, launches, traffic = timed_round(
            lambda: fn(state, batches, None, *args),
            torch.device(device).type == "cuda")
    state, metrics = res[:2]
    rec = dict(ms=ms, peak=peak, launches=launches, traffic=traffic,
               losses={k: float(v) for k, v in metrics.items()},
               store_bytes=store.nbytes if store is not None else 0)
    if wires:
        rec.update(wire_codes(wires, layout))
        del wires
    if ckpt is not None:
        import torch.distributed as dist

        from repro_torch.checkpoint import io as ckpt_io

        path, what = ckpt
        if what == "clients":
            store.set_device_state(res[2])
        tree = {what: state if what == "server" else store.state_dict()}
        t0 = time.perf_counter()
        ckpt_io.save_checkpoint_fsdp(path, tree, 1, layout)
        rec["ckpt_write_s"] = time.perf_counter() - t0
        dist.barrier(group=mesh.group)
        t0 = time.perf_counter()
        back, step, _ = ckpt_io.restore_checkpoint_fsdp(path, tree, None,
                                                        layout)
        rec["ckpt_read_s"] = time.perf_counter() - t0
        rec["ckpt_bitwise"] = step == 1 and bool(torch.equal(
            collective.digest(back), collective.digest(tree)))
        del back
    whole = layout.gather_state(state) if layout is not None else state
    if ckpt is not None and ckpt[1] == "server":
        rec["state"] = whole
    rec["params"] = whole.params
    rec["c"] = whole.algo_state if fed.algorithm == "scaffold" else None
    rec["states"] = None
    if alg.stateful and whole_states:
        new = (tm.tmap(lambda b: b[torch.as_tensor(ids, device=b.device)],
                       res[2]["buffers"]) if device_store else res[2])
        rec["states"] = layout.gather_rows(new) if layout is not None \
            else new
    return rec


def fsdp_case(case: str):
    """``(cfg, launch.train command, compute dtype)`` of a phase-16 case:
    the one-layer fp32 cut (16a, 16b) or the full width (16c, 16e)."""
    import torch

    from repro_torch import configs

    if case == "full":
        return (configs.get_config("fedlm-100m"), TRAIN_ARGV + STEPS_CUT,
                torch.bfloat16)
    return (configs.replace(configs.get_config("fedlm-100m"), repeats=1),
            REPLAY_ARGV, torch.float32)


def fsdp_summary(rank: int, mesh, rec: dict, seconds: float) -> dict:
    """The JSON-ready numbers of one rank's round (``fsdp_algo_round``'s
    or one of ``fsdp_rounds``'), with the digests of what it gathered."""
    from repro_torch.core import collective

    out = {"rank": rank, "device": str(mesh.device), "seconds": seconds}
    out.update({k: rec[k] for k in ("ms", "peak", "launches", "traffic",
                                    "losses", "store_bytes", "wire_bytes",
                                    "ckpt_bitwise", "ckpt_write_s",
                                    "ckpt_read_s") if k in rec})
    for k in ("params", "c", "states"):
        if rec.get(k) is not None:
            out[f"digest_{k}"] = collective.digest(rec[k]).tolist()
    return out


def fsdp_rank(rank: int, port: int, seed: int, out: str) -> None:
    """One rank of phase 16b, 16c, 16e and 16f (a spawned child): two
    gloo ranks sharing the card on a ``("data",)`` mesh. 16b:
    ``fsdp_rounds`` on the one-layer cut, then ``fsdp_algo_round`` of each
    of ``FSDP_ALGOS`` from its burn-in state (FedEP's store written with
    the FSDP writer, 16g); 16c: ``fsdp_rounds`` at full width; 16e: a
    FedEP round from 16c's state with a device store of
    ``FSDP_STORE_CLIENTS``; 16f: a FedLoRA ``lowrank+int8`` round from
    16c's state, its new server state written with the FSDP writer (16g).
    Writes ``out/rank<r>.<case>.json`` (numbers, the elements held,
    digests, seconds) for the cases ``one-layer``, ``full``,
    ``fedep-full`` and ``fedlora-full`` and per algorithm
    ``rank<r>.algos.json``; rank 0 also writes the one-layer params
    (``one-layer.npz``, both rounds, and ``algos.npz``, each algorithm's
    params and ``c``, FedEP's gathered store rows and the int8 rounds'
    wire codes), 16c's whole state (``full-state.pt``), 16e's params
    (``fedep-full.pt``), 16f's gathered state
    (``fedlora-full-state.pt``) and wire codes
    (``fedlora-full-codes.npz``); the checkpoints go under ``out``."""
    sys.path.insert(0, str(SRC))
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import MeshConfig
    from repro_torch.core import collective, sharded_round
    from repro_torch.core import tree_math as tm
    from repro_torch.launch.mesh import init_distributed, mesh_from_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed(f"127.0.0.1:{port}", rank, 2, backend="gloo",
                     device="cuda", timeout=MP_CONNECT_S)

    def write(case, summary):
        with open(os.path.join(out, f"rank{rank}.{case}.json"), "w") as f:
            json.dump(summary, f)

    def rounds_summary(res, held, t0):
        rounds = res["rounds"]
        return {"rank": rank, "device": str(mesh.device),
                "n": res["layout"].n, "d": res["layout"].d,
                "held": {k: sorted(v) for k, v in held.items()},
                "digest": collective.digest(rounds[-1]["params"]).tolist(),
                "rounds": [{k: v for k, v in r.items() if k != "params"}
                           for r in rounds],
                "seconds": time.perf_counter() - t0}

    try:
        mesh = mesh_from_config(MeshConfig(shape=(2,), axes=("data",)),
                                "cuda")
        torch.cuda.set_device(mesh.device)
        # -- 16b: the one-layer cut, then the other algorithms ------------
        t0 = time.perf_counter()
        cfg, argv, dtype = fsdp_case("one-layer")
        fed, toks = fsdp_inputs(argv, cfg, seed)
        held = {}
        with fsdp_probe(held):
            res = fsdp_rounds(cfg, fed, toks, "cuda", dtype, seed, mesh)
        if rank == 0:
            np.savez(os.path.join(out, "one-layer.npz"),
                     **{f"r{i}_{j}": x.cpu().numpy() for i, r in
                        enumerate(res["rounds"]) for j, x in
                        enumerate(tm.tleaves(r["params"]))})
        write("one-layer", rounds_summary(res, held, t0))
        algos, arrays = {}, {}
        for name, change in FSDP_ALGOS:
            t0 = time.perf_counter()
            # 16g: the ranks write FedEP's store after its round
            ckpt = ((os.path.join(out, "ckpt-store"), "clients")
                    if name == "fedep" else None)
            rec = fsdp_algo_round(cfg, dataclasses.replace(fed, **change),
                                  toks[1], "cuda", dtype, res["burn_state"],
                                  res["layout"], mesh, ckpt=ckpt)
            algos[name] = fsdp_summary(rank, mesh, rec,
                                       time.perf_counter() - t0)
            if rank == 0:
                for k in ("params", "c") + (("states",) if ckpt else ()):
                    if rec[k] is not None:
                        arrays.update({f"{name}_{k}_{j}": x.cpu().numpy()
                                       for j, x in
                                       enumerate(tm.tleaves(rec[k]))})
                for key, (q, scale) in rec.get("codes", {}).items():
                    arrays[f"{name}_codes|{key}"] = q
                    arrays[f"{name}_scale|{key}"] = np.float32(scale)
            del rec
        if rank == 0:
            np.savez(os.path.join(out, "algos.npz"), **arrays)
        write("algos", algos)
        del res, arrays
        torch.cuda.empty_cache()
        # -- 16c: the full width, FedAvg then FedPA -----------------------
        t0 = time.perf_counter()
        cfg, argv, dtype = fsdp_case("full")
        fed, toks = fsdp_inputs(argv, cfg, seed)
        held = {}
        with fsdp_probe(held):
            res = fsdp_rounds(cfg, fed, toks, "cuda", dtype, seed, mesh)
        write("full", rounds_summary(res, held, t0))
        for r in res["rounds"]:
            del r["params"]
        # -- 16e: FedEP from 16c's state, 16 clients' sites a rank, on a
        # ("data", "model") mesh of 1 x 2: the same shards, every rank on
        # all of a client's rows (split, the halves' bf16 gradients round
        # before their sum and the round leaves phase 4's bound)
        whole = res["layout"].gather_state(res["state"])
        if rank == 0:
            torch.save({"params": whole.params, "opt_state": whole.opt_state,
                        "round": whole.round},
                       os.path.join(out, "full-state.pt"))
        del whole
        mesh = mesh_from_config(MeshConfig(shape=(1, 2),
                                           axes=("data", "model")), "cuda")
        layout = sharded_round.fsdp_layout(cfg, mesh)
        t0 = time.perf_counter()
        rec = fsdp_algo_round(
            cfg, dataclasses.replace(fed, **dict(FSDP_ALGOS)["fedep"]),
            toks[1], "cuda", dtype, res["state"], layout, mesh,
            num_clients=FSDP_STORE_CLIENTS, ids=FSDP_STORE_IDS,
            whole_states=False)
        summary = fsdp_summary(rank, mesh, rec, time.perf_counter() - t0)
        summary["n"] = res["layout"].n
        write("fedep-full", summary)
        if rank == 0:
            torch.save(rec["params"], os.path.join(out, "fedep-full.pt"))
        del rec
        torch.cuda.empty_cache()
        # -- 16f: FedLoRA lowrank+int8 from 16c's state on the same mesh;
        # 16g: each rank writes the new server state and reads it back
        t0 = time.perf_counter()
        rec = fsdp_algo_round(
            cfg, dataclasses.replace(fed, **dict(FSDP_ALGOS)[
                FSDP_LORA_FULL]), toks[1], "cuda", dtype, res["state"],
            layout, mesh, ckpt=(os.path.join(out, "ckpt-full"), "server"))
        summary = fsdp_summary(rank, mesh, rec, time.perf_counter() - t0)
        summary["n"] = layout.n
        write("fedlora-full", summary)
        if rank == 0:
            whole = rec["state"]
            torch.save({"params": whole.params,
                        "opt_state": whole.opt_state, "round": whole.round},
                       os.path.join(out, "fedlora-full-state.pt"))
            np.savez(os.path.join(out, "fedlora-full-codes.npz"),
                     **{f"codes|{k}": q
                        for k, (q, _) in rec["codes"].items()})
    finally:
        dist.destroy_process_group()


def fsdp_spawn(seed: int, meanwhile=None):
    """Phase 16b, 16c, 16e and 16f's two ranks (spawned children sharing
    the card); runs ``meanwhile()`` in this process while they work.
    Returns ``({case: the ranks' summaries}, {name: rank 0's arrays},
    meanwhile's result, seconds from the spawn to both exits)``; the
    arrays are the one-layer rounds' params (``one-layer``), each
    algorithm's (``algos``), 16c's whole state (``full-state``), 16e's
    params (``fedep-full``), 16f's state and codes, on the host, and
    16g's restores in this process (``restored``), read before the
    ranks' files are removed."""
    import multiprocessing as mp
    import shutil
    import tempfile

    import numpy as np
    import torch

    tmp = tempfile.mkdtemp(prefix="chip_smoke_fsdp_")
    try:
        ctx = mp.get_context("spawn")
        port = free_port()
        procs = [ctx.Process(target=fsdp_rank, args=(r, port, seed, tmp))
                 for r in (0, 1)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        extra = meanwhile() if meanwhile is not None else None
        for p in procs:
            p.join(MP_TIMEOUT_S)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
        wall = time.perf_counter() - t0
        if alive or any(p.exitcode for p in procs):
            fail(f"fsdp ranks exited {[p.exitcode for p in procs]}")
        sums = {}
        for case in ("one-layer", "algos", "full", "fedep-full",
                     "fedlora-full"):
            sums[case] = []
            for r in (0, 1):
                with open(os.path.join(tmp, f"rank{r}.{case}.json")) as f:
                    sums[case].append(json.load(f))
        files = {k: dict(np.load(os.path.join(tmp, f"{k}.npz")))
                 for k in ("one-layer", "algos", "fedlora-full-codes")}
        files.update({k: torch.load(os.path.join(tmp, f"{k}.pt"),
                                    map_location="cpu")
                      for k in ("full-state", "fedep-full",
                                "fedlora-full-state")})
        files["restored"] = fsdp_restore_one_process(tmp)
    finally:
        shutil.rmtree(tmp)
    return sums, files, extra, wall


def fsdp_restore_one_process(tmp: str) -> dict:
    """Phase 16g's restores in this process at W = 1 (no mesh), on the
    card: 16f's full-width server state from the two ranks' FSDP files
    (gathered into the whole tree) and 16b's FedEP store (its rows put
    together into whole trees); with the seconds each read took."""
    import torch

    from repro_torch.algorithms import get_algorithm
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.configs.base import FedConfig
    from repro_torch.core import fsdp
    from repro_torch.core.client_state import make_client_store
    from repro_torch.core.server import ServerState
    from repro_torch.models.model import init_params

    out = {}
    cfg, _, _ = fsdp_case("full")
    one = fsdp.FlatShard(init_params(None, cfg, device="meta"))
    like = {"server": ServerState(
        torch.empty(one.d, device="cuda"),
        {"step": 0, "m": torch.empty(one.d, device="cuda")}, 0, ())}
    t0 = time.perf_counter()
    tree, step, _ = ckpt_io.restore_checkpoint_fsdp(
        os.path.join(tmp, "ckpt-full"), like, None, one)
    out["server_s"] = time.perf_counter() - t0
    out["server"] = one.gather_state(tree["server"])
    cfg, _, _ = fsdp_case("one-layer")
    one = fsdp.FlatShard(init_params(None, cfg, device="meta"))
    store = make_client_store("device", FSDP_CLIENTS, device="cuda",
                              fsdp=one)
    store.ensure(get_algorithm(FedConfig(algorithm="fedep"))
                 .init_client_state(torch.empty(one.d, device="cuda")))
    t0 = time.perf_counter()
    tree, _, _ = ckpt_io.restore_checkpoint_fsdp(
        os.path.join(tmp, "ckpt-store"), {"clients": store.state_dict()},
        None, one)
    store.load_state_dict(tree["clients"])
    out["store_s"] = time.perf_counter() - t0
    out["rows"] = one.gather_rows(store.device_state()["buffers"])
    out["stamps"] = store.device_state()["stamps"].tolist()
    return out


def fsdp_launches(rounds: list) -> dict:
    """The DP launches of an FSDP run's FedPA round (its last)."""
    return rounds[-1]["launches"]


def fsdp_nccl_one_rank(seed: int):
    """Phase 16a: the one-layer fp32 cut's rounds with no mesh against the
    same rounds through a one-rank NCCL mesh: the burn-in round bitwise,
    the FedPA round within 1e-6 of the largest entry (the sharded step's
    coefficients come from the glue, not the reduce kernel's epilogue).
    Returns the DP launches of both FedPA rounds and the run with no
    mesh."""
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.core import tree_math as tm
    from repro_torch.launch.mesh import make_host_mesh

    cfg, argv, dtype = fsdp_case("one-layer")
    fed, toks = fsdp_inputs(argv, cfg, seed)
    ell = (fed.local_steps - fed.burn_in_steps) // fed.steps_per_sample
    expected = FSDP_CLIENTS * (ell - 1)
    name = f"{cfg.name} cut to {cfg.num_layers} layer"
    one = fsdp_rounds(cfg, fed, toks, "cuda", dtype, seed)
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=MP_CONNECT_S))
    try:
        mesh = make_host_mesh("cuda")
        nccl = fsdp_rounds(cfg, fed, toks, "cuda", dtype, seed, mesh)
        backend = mesh.backend
    finally:
        dist.destroy_process_group()
    first = equal_bitwise(one["rounds"][0]["params"],
                          nccl["rounds"][0]["params"])
    want, got = (tm.tleaves(r["rounds"][1]["params"]) for r in (one, nccl))
    scale = max(w.abs().max().item() for w in want)
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    calls = [r["traffic"]["calls"] for r in nccl["rounds"]]
    launches = {f"{name} fp32 sequential, no mesh": fsdp_launches(
        one["rounds"]), f"{name} fp32 sequential, one-rank nccl fsdp":
        fsdp_launches(nccl["rounds"])}
    print(f"fsdp nccl one rank ({name}, d={cfg.param_count():,}, fp32, "
          f"{FSDP_CLIENTS} clients, a burn-in and a FedPA round at "
          f"sequential, {mesh.shape} mesh, backend {backend}): NCCL calls "
          f"per round {calls}; burn-in round bitwise equal to no mesh "
          f"{first}; FedPA round max abs diff {err:.3g} of largest "
          f"{scale:.3g}; host ms per round no mesh "
          f"{[round(r['ms'], 1) for r in one['rounds']]}, one-rank mesh "
          f"{[round(r['ms'], 1) for r in nccl['rounds']]}; DP launches "
          f"{launches} (expected {expected} each)", flush=True)
    if not first or not err <= 1e-6 * scale or not all(calls):
        fail("fsdp nccl one rank: the mesh run differs from the run with "
             "no mesh (or made no NCCL call)")
    for n in launches.values():
        if any(v != expected for v in n.values()):
            fail(f"fsdp nccl one rank: DP launches {launches}")
    return launches, one


def fsdp_algos_one_process(cfg, fed, toks, device: str, dtype,
                           burn_state) -> dict:
    """``fsdp_algo_round`` of each of ``FSDP_ALGOS`` in one process (no
    mesh) from ``burn_state``: ``{name: its record}``."""
    import dataclasses

    return {name: fsdp_algo_round(cfg, dataclasses.replace(fed, **change),
                                  toks[1], device, dtype, burn_state)
            for name, change in FSDP_ALGOS}


def fsdp_two_rank_replay(sums, files, one, cpu, cpu_s: float) -> dict:
    """Phase 16b: the one-layer case on the two gloo ranks (one row of
    each client a rank) against the one-process card run (16a's) and the
    CPU run (phase 4's bound): the burn-in and FedPA rounds, then each of
    ``FSDP_ALGOS``' rounds from the burn-in state (params and SCAFFOLD's
    ``c``; the ranks' params, ``c`` and client states equal by digest;
    DP launches 6 of each kernel for the DP algorithms, 0 for the rest; a
    params all-gather per gradient, ``3K`` a client for MIME). Returns the
    ranks' DP launches and the one-process card run's."""
    import numpy as np
    import torch

    from repro_torch.core import tree_math as tm

    cfg, argv, _ = fsdp_case("one-layer")
    fed, _ = fsdp_inputs(argv, cfg, 0)
    expected = FSDP_CLIENTS * ((fed.local_steps - fed.burn_in_steps)
                               // fed.steps_per_sample - 1)
    name = f"{cfg.name} cut to {cfg.num_layers} layer"
    rounds, algos = sums["one-layer"], sums["algos"]
    first = files["one-layer"]
    n_leaves = len(tm.tleaves(one["rounds"][1]["params"]))
    ranks_equal = rounds[0]["digest"] == rounds[1]["digest"]
    print(f"fsdp two gloo ranks ({name}, fp32, {FSDP_CLIENTS} clients, one "
          f"row of each a rank, ('data',) mesh of 2 on one card): "
          f"{max(s['seconds'] for s in rounds):.1f} s a rank for the "
          f"burn-in and FedPA rounds, the CPU run meanwhile {cpu_s:.1f} s; "
          f"ranks' gathered params equal by digest {ranks_equal}",
          flush=True)
    launches = {}
    for s in rounds:
        print(f"  rank {s['rank']} on {s['device']}: n={s['n']:,} of d="
              f"{s['d']:,}; host ms per round "
              f"{[round(r['ms'], 1) for r in s['rounds']]}; losses "
              f"{[r['losses'] for r in s['rounds']]}; DP launches "
              f"{fsdp_launches(s['rounds'])}", flush=True)
        launches[f"{name} fp32 sequential, 2 gloo ranks fsdp: rank "
                 f"{s['rank']}"] = fsdp_launches(s["rounds"])
        if any(v != expected for v in fsdp_launches(s["rounds"]).values()):
            fail(f"fsdp two gloo ranks: rank {s['rank']} DP launches "
                 f"{fsdp_launches(s['rounds'])}")
    if not ranks_equal:
        fail("fsdp two gloo ranks: the ranks' gathered params differ")
    for i in (0, 1):
        got = [torch.from_numpy(first[f"r{i}_{j}"])
               for j in range(n_leaves)]
        params_close(got, one["rounds"][i]["params"],
                     f"two ranks vs one process on the card, round {i}")
        params_close(got, cpu["rounds"][i]["params"],
                     f"two ranks vs the CPU, round {i}")
    for alg, change in FSDP_ALGOS:
        per = [s[alg] for s in algos]
        want = expected if alg in FSDP_DP_ALGOS else 0
        K = change.get("local_steps", fed.local_steps)
        gathers = FSDP_CLIENTS * K * (3 if alg == "mime" else 1)
        equal = all(per[0][k] == per[1][k] for k in per[0]
                    if k.startswith("digest_"))
        got_gathers = [s["traffic"]["param_gathers"] for s in per]
        flips = ""
        if alg in FSDP_INT8_ALGOS:
            codes = {k.split("|", 1)[1]: (v, None)
                     for k, v in files["algos"].items()
                     if k.startswith(f"{alg}_codes|")}
            card = code_flips(codes, one["algos"][alg]["codes"],
                              f"{alg} codes, two ranks vs one process")
            host = code_flips(codes, cpu["algos"][alg]["codes"],
                              f"{alg} codes, two ranks vs the CPU")
            flips = (f"; int8 codes flipped against one process on the "
                     f"card {card[0]} of {card[1]}, against the CPU "
                     f"{host[0]} of {host[1]}; wire bytes a client "
                     f"{[s['wire_bytes'] for s in per]} (one process "
                     f"{one['algos'][alg]['wire_bytes']})")
            if any(s["wire_bytes"] != one["algos"][alg]["wire_bytes"]
                   for s in per):
                fail(f"fsdp two gloo ranks {alg}: wire bytes differ")
        print(f"fsdp two gloo ranks {alg} ({name}, one round from the "
              f"burn-in state): ranks equal by digest (params, c, client "
              f"states) {equal}; per rank host ms "
              f"{[round(s['ms'], 1) for s in per]}, DP launches "
              f"{[s['launches'] for s in per]} (expected {want} each), "
              f"params all-gathers {got_gathers} (expected {gathers}), "
              f"codec all-reduces "
              f"{[s['traffic']['codec_reduces'] for s in per]}, "
              f"losses {per[0]['losses']} ({K} local steps); one "
              f"process on the card {one['algos'][alg]['ms']:.1f} ms"
              f"{flips}", flush=True)
        if not equal:
            fail(f"fsdp two gloo ranks {alg}: the ranks differ")
        for s in per:
            launches[f"{name} fp32 sequential {alg}, 2 gloo ranks fsdp: "
                     f"rank {s['rank']}"] = s["launches"]
            if (any(v != want for v in s["launches"].values())
                    or s["traffic"]["param_gathers"] != gathers):
                fail(f"fsdp two gloo ranks {alg}: rank {s['rank']} DP "
                     f"launches {s['launches']}, gathers "
                     f"{s['traffic']['param_gathers']}")
        launches[f"{name} fp32 sequential {alg}, no mesh"] = \
            one["algos"][alg]["launches"]
        for k in ("params", "c"):
            if one["algos"][alg][k] is None:
                continue
            got = [torch.from_numpy(files["algos"][f"{alg}_{k}_{j}"])
                   for j in range(len(tm.tleaves(one["algos"][alg][k])))]
            params_close(got, one["algos"][alg][k],
                         f"{alg} {k}: two ranks vs one process on the card")
            params_close(got, cpu["algos"][alg][k],
                         f"{alg} {k}: two ranks vs the CPU")
    return launches


def fsdp_full_width(card: str, sums) -> dict:
    """Phase 16c: the full-width fedlm-100m (bf16 compute) with
    TRAIN_ARGV's FedPA settings and STEPS_CUT's local steps at
    ``sequential`` on the two gloo ranks, 2 clients (2 of each client's 4
    rows a rank), a burn-in and a FedPA round, every parameter-shaped
    state sharded in halves. Prints each rank's peak memory, host ms, DP
    launches, bytes gathered and reduced against the layout's formula and
    its state's bytes against one process's; the ranks' final params must
    have equal digests and the losses be finite. Returns the DP
    launches."""
    from repro_torch.launch import train

    cfg, argv, _ = fsdp_case("full")
    args = train.parse_args(argv)
    ell = (args.local_steps - args.burn_in_steps) // args.steps_per_sample
    lp, steps = ell - 1, FSDP_CLIENTS * args.local_steps
    d = sums[0]["d"]
    print(f"fsdp two gloo ranks train {cfg.name}: d={d:,}, bf16 compute, "
          f"{FSDP_CLIENTS} clients of {args.batch} x {args.seq_len} tokens "
          f"a step ({args.batch // 2} rows a rank), {args.local_steps} "
          f"local steps (l = {ell}), a burn-in and a FedPA round at "
          f"sequential on a ('data',) mesh of 2 sharing one card ({card}) "
          f"over gloo: {max(s['seconds'] for s in sums):.1f} s a rank",
          flush=True)
    launches = {}
    for s in sums:
        n = s["n"]
        # the formula: per local step the bf16 shard to the other rank,
        # and gloo's all-reduce of the padded fp32 gradient (2 (W-1) n)
        want_params, want_grads = steps * n * 2, steps * 2 * n * 4
        tr = [r["traffic"] for r in s["rounds"]]
        state = {"master": s["rounds"][-1]["master"] * 4,
                 "server momentum": s["rounds"][-1]["momentum"] * 4,
                 "accumulator": max(s["held"]["accumulator"]) * 4,
                 "v_hist": max(s["held"]["v_hist"]) * 4,
                 "samples": max(s["held"]["samples"]) * 4}
        whole = {"master": d * 4, "server momentum": d * 4,
                 "accumulator": d * 4, "v_hist": lp * d * 4,
                 "samples": ell * d * 4}
        print(f"  rank {s['rank']} on {s['device']}: n={n:,}; peak memory "
              f"allocated per round "
              f"{[round(r['peak'] / 2**30, 2) for r in s['rounds']]} GiB; "
              f"host ms per round "
              f"{[round(r['ms'], 1) for r in s['rounds']]}; losses "
              f"{[r['losses'] for r in s['rounds']]}; DP launches in the "
              f"FedPA round {fsdp_launches(s['rounds'])} (expected "
              f"{FSDP_CLIENTS * lp} each); per round params all-gathers "
              f"{[t['param_gathers'] for t in tr]} (expected {steps}), "
              f"bytes {[t['params'] for t in tr]} (formula {want_params}), "
              f"grads reduced {[t['grads'] for t in tr]} (formula "
              f"{want_grads}), staged through the host "
              f"{[t['staged'] for t in tr]}, host s inside the collectives "
              f"{[round(t['seconds'], 2) for t in tr]}; state bytes a rank "
              f"{state} against one process's {whole}; final params "
              f"digest {s['digest'][:3]}...", flush=True)
        launches[f"fedlm-100m bf16 sequential, 2 gloo ranks fsdp: rank "
                 f"{s['rank']}"] = fsdp_launches(s["rounds"])
        losses = [v for r in s["rounds"] for v in r["losses"].values()]
        if not all(map(math.isfinite, losses)):
            fail(f"fsdp full width: rank {s['rank']} losses {losses}")
        if any(v != FSDP_CLIENTS * lp
               for v in fsdp_launches(s["rounds"]).values()):
            fail(f"fsdp full width: rank {s['rank']} DP launches "
                 f"{fsdp_launches(s['rounds'])}")
        if any(t["param_gathers"] != steps or t["params"] != want_params
               or t["grads"] != want_grads for t in tr):
            fail(f"fsdp full width: rank {s['rank']} traffic {tr}")
        if any(2 * state[k] != whole[k] for k in state):
            fail(f"fsdp full width: rank {s['rank']} holds {state}, not "
                 f"half of {whole}")
    if sums[0]["digest"] != sums[1]["digest"]:
        fail("fsdp full width: the ranks' final params differ")
    return launches


def fsdp_full_fedep(card: str, sums, files, seed: int) -> dict:
    """Phase 16e: one FedEP round of the full-width fedlm-100m (bf16) on
    the two gloo ranks from 16c's state, the device store of
    ``FSDP_STORE_CLIENTS`` clients element-sharded over them, on a
    ``("data", "model")`` mesh of 1 x 2 (16c's shards, every rank on all
    of a client's rows: with the rows split, the halves' bf16 gradients
    round before their fp32 sum and the params leave phase 4's bound of
    one process). Prints each
    rank's host ms, peak memory, store bytes against ``C x 2 x n x 4``,
    gathers and bytes by kind, DP launches (6 each); then the same round
    in one process on the card from 16c's gathered state (run here, after
    the ranks exited), whose params the ranks' must meet to phase 4's
    bound. Returns the DP launches."""
    import dataclasses

    from repro_torch.core.server import ServerState
    from repro_torch.launch import train

    cfg, argv, dtype = fsdp_case("full")
    fed, toks = fsdp_inputs(argv, cfg, seed)
    args = train.parse_args(argv)
    ell = (args.local_steps - args.burn_in_steps) // args.steps_per_sample
    steps = FSDP_CLIENTS * args.local_steps
    expected = FSDP_CLIENTS * (ell - 1)
    print(f"fsdp two gloo ranks fedep {cfg.name}: bf16, clients "
          f"{list(FSDP_STORE_IDS)} of a device store of "
          f"{FSDP_STORE_CLIENTS} element-sharded over the 2 ranks, one "
          f"round from 16c's state on a ('data', 'model') mesh of 1 x 2 "
          f"(all {args.batch} rows of a client on each rank) on one card "
          f"({card}): "
          f"{max(s['seconds'] for s in sums):.1f} s a rank", flush=True)
    launches = {}
    for s in sums:
        n = s["n"]
        want_store = FSDP_STORE_CLIENTS * 2 * n * 4
        t = s["traffic"]
        print(f"  rank {s['rank']} on {s['device']}: n={n:,}; host ms "
              f"{s['ms']:.1f}; peak memory allocated "
              f"{s['peak'] / 2**30:.2f} GiB; store bytes {s['store_bytes']:,}"
              f" (formula {want_store:,}); params all-gathers "
              f"{t['param_gathers']} (expected {steps}), bytes {t['params']}"
              f" (formula {steps * n * 2}), grads reduced {t['grads']} "
              f"(formula {steps * 2 * n * 4}), small sums {t['small']} in "
              f"{t['small_reduces']} calls, staged {t['staged']}, host s "
              f"inside the collectives {t['seconds']:.2f}; DP launches "
              f"{s['launches']} (expected {expected} each); losses "
              f"{s['losses']}", flush=True)
        launches[f"fedlm-100m bf16 sequential fedep, 2 gloo ranks fsdp: "
                 f"rank {s['rank']}"] = s["launches"]
        if (s["store_bytes"] != want_store
                or any(v != expected for v in s["launches"].values())
                or t["param_gathers"] != steps
                or t["params"] != steps * n * 2
                or not all(map(math.isfinite, s["losses"].values()))):
            fail(f"fsdp full fedep: rank {s['rank']} {s}")
    if sums[0]["digest_params"] != sums[1]["digest_params"]:
        fail("fsdp full fedep: the ranks' params differ")
    saved = files["full-state"]
    state = ServerState(_to_cuda(saved["params"]),
                        _to_cuda(saved["opt_state"]), saved["round"], ())
    rec = fsdp_algo_round(
        cfg, dataclasses.replace(fed, **dict(FSDP_ALGOS)["fedep"]), toks[1],
        "cuda", dtype, state, num_clients=FSDP_STORE_CLIENTS,
        ids=FSDP_STORE_IDS,
        whole_states=False)
    launches["fedlm-100m bf16 sequential fedep, no mesh"] = rec["launches"]
    print(f"  one process on the card: host ms {rec['ms']:.1f}; peak "
          f"{rec['peak'] / 2**30:.2f} GiB; store bytes "
          f"{rec['store_bytes']:,}; DP launches {rec['launches']}",
          flush=True)
    params_close(files["fedep-full"], rec["params"],
                 "fedep full width: two ranks vs one process on the card")
    return launches


def codec_elements(cfg, rank: int = 4) -> tuple:
    """``(F, L)`` of ``cfg``'s params: the elements of every ``lowrank``
    factor (``R x r`` for each leaf with 2+ dims and a last dim over
    ``r``) and the number of leaves: a client's codec all-reduces under
    FSDP sum ``2 F`` fp32 partials (delta and precision) and max ``2 L``
    (one per leaf, both)."""
    from repro_torch.core import tree_math as tm
    from repro_torch.models.model import init_params

    leaves = [tuple(x.shape) for x in tm.tleaves(
        init_params(None, cfg, device="meta"))]
    return (sum(math.prod(s[:-1]) * rank for s in leaves
                if len(s) >= 2 and s[-1] > rank), len(leaves))


def fsdp_full_fedlora(card: str, sums, files, seed: int) -> dict:
    """Phase 16f: one FedLoRA ``lowrank+int8`` round (rank 4, error
    feedback, a device store of 2 clients made for the layout) of the
    full-width fedlm-100m (bf16) from 16c's state on the two gloo ranks,
    on 16e's ``("data", "model")`` mesh of 1 x 2. Prints each rank's host
    ms, peak memory, wire bytes a client (against ``round_bytes``'
    903,144), codec all-reduces and bytes against the formula, params
    all-gathers, DP launches (6 each); then the same round in one process
    on the card from 16c's gathered state, whose params the ranks' meet
    to phase 4's bound, and the int8 codes flipped between the two.
    Returns the DP launches."""
    import dataclasses

    from repro_torch.core.server import ServerState
    from repro_torch.launch import train

    cfg, argv, dtype = fsdp_case("full")
    fed, toks = fsdp_inputs(argv, cfg, seed)
    args = train.parse_args(argv)
    ell = (args.local_steps - args.burn_in_steps) // args.steps_per_sample
    steps = FSDP_CLIENTS * args.local_steps
    expected = FSDP_CLIENTS * (ell - 1)
    F, L = codec_elements(cfg)
    W = 2
    want_codec = FSDP_CLIENTS * 2 * (F + L) * 4 * (W - 1)
    print(f"fsdp two gloo ranks fedlora {cfg.name}: bf16, lowrank+int8 "
          f"rank 4 with error feedback, {FSDP_CLIENTS} clients, one round "
          f"from 16c's state on a ('data', 'model') mesh of 1 x 2 on one "
          f"card ({card}): {max(s['seconds'] for s in sums):.1f} s a rank "
          f"(its checkpoint included)", flush=True)
    launches = {}
    for s in sums:
        n, t = s["n"], s["traffic"]
        print(f"  rank {s['rank']} on {s['device']}: n={n:,}; host ms "
              f"{s['ms']:.1f}; peak memory allocated "
              f"{s['peak'] / 2**30:.2f} GiB; wire bytes a client "
              f"{s['wire_bytes']:,} (round_bytes "
              f"{FEDLM_UP['lowrank+int8']:,}); codec all-reduces "
              f"{t['codec_reduces']} (expected {2 * FSDP_CLIENTS}), bytes "
              f"{t['codec']:,} (formula {want_codec:,}: F={F:,} factor "
              f"elements, L={L} leaves); params all-gathers "
              f"{t['param_gathers']} (expected {steps}), staged "
              f"{t['staged']:,}, host s inside the collectives "
              f"{t['seconds']:.2f}; DP launches {s['launches']} (expected "
              f"{expected} each); store bytes {s['store_bytes']:,} "
              f"(formula {FSDP_CLIENTS * n * 4:,}); losses {s['losses']}",
              flush=True)
        launches[f"fedlm-100m bf16 sequential fedlora lowrank+int8, 2 gloo "
                 f"ranks fsdp: rank {s['rank']}"] = s["launches"]
        if (s["wire_bytes"] != FEDLM_UP["lowrank+int8"]
                or t["codec_reduces"] != 2 * FSDP_CLIENTS
                or t["codec"] != want_codec
                or t["param_gathers"] != steps
                or s["store_bytes"] != FSDP_CLIENTS * n * 4
                or any(v != expected for v in s["launches"].values())
                or not all(map(math.isfinite, s["losses"].values()))):
            fail(f"fsdp full fedlora: rank {s['rank']} {s}")
    if sums[0]["digest_params"] != sums[1]["digest_params"]:
        fail("fsdp full fedlora: the ranks' params differ")
    saved = files["full-state"]
    state = ServerState(_to_cuda(saved["params"]),
                        _to_cuda(saved["opt_state"]), saved["round"], ())
    rec = fsdp_algo_round(
        cfg, dataclasses.replace(fed, **dict(FSDP_ALGOS)[FSDP_LORA_FULL]),
        toks[1], "cuda", dtype, state, whole_states=False)
    launches["fedlm-100m bf16 sequential fedlora lowrank+int8, no mesh"] = \
        rec["launches"]
    codes = {k.split("|", 1)[1]: (v, None)
             for k, v in files["fedlora-full-codes"].items()}
    flips, total = code_flips(codes, rec["codes"],
                              "fedlora full width codes, two ranks vs one "
                              "process")
    print(f"  one process on the card: host ms {rec['ms']:.1f}; peak "
          f"{rec['peak'] / 2**30:.2f} GiB; wire bytes a client "
          f"{rec['wire_bytes']:,}; DP launches {rec['launches']}; int8 "
          f"codes flipped against the ranks {flips} of {total}", flush=True)
    params_close(files["fedlora-full-state"]["params"], rec["params"],
                 "fedlora full width: two ranks vs one process on the card")
    return launches


def fsdp_checkpoints(sums_algos, sums_full, files) -> None:
    """Phase 16g: the FSDP checkpoints the ranks wrote (16f's full-width
    server state, 16b's FedEP store): each rank read its own file back
    bitwise; one process restored both at W = 1 on the card
    (``fsdp_restore_one_process``), the state bitwise equal to what the
    ranks gathered (``gather_state``), the store's rows to
    ``gather_rows``."""
    from repro_torch.core import tree_math as tm

    restored = files["restored"]
    saved = files["fedlora-full-state"]
    state = restored["server"]
    server_equal = (equal_bitwise(state.params, saved["params"])
                    and equal_bitwise(state.opt_state["m"],
                                      saved["opt_state"]["m"])
                    and state.round == saved["round"]
                    and state.opt_state["step"] == saved["opt_state"]["step"])
    algos = files["algos"]
    rows = [algos[f"fedep_states_{j}"]
            for j in range(len(tm.tleaves(restored["rows"])))]
    rows_equal = equal_bitwise(restored["rows"], rows)
    own = [s["ckpt_bitwise"] for s in sums_full] + \
        [s["fedep"]["ckpt_bitwise"] for s in sums_algos]
    print(f"fsdp checkpoints: the two ranks wrote 16f's full-width server "
          f"state (write s {[round(s['ckpt_write_s'], 2) for s in sums_full]}"
          f", read back s {[round(s['ckpt_read_s'], 2) for s in sums_full]})"
          f" and 16b's FedEP store; each rank's own read bitwise {own}; "
          f"one process at W = 1 on the card: the state equal to the "
          f"ranks' gather_state bitwise {server_equal} "
          f"({restored['server_s']:.2f} s), the store's rows to their "
          f"gather_rows bitwise {rows_equal} ({restored['store_s']:.2f} s, "
          f"stamps {restored['stamps']})", flush=True)
    if not (all(own) and server_equal and rows_equal):
        fail("fsdp checkpoints: a restore differs from what was written")


def _to_cuda(tree):
    """A saved tree's tensors on the card (other leaves as they are)."""
    import torch

    from repro_torch.core import tree_math as tm

    return tm.tmap(lambda x: x.to("cuda") if isinstance(x, torch.Tensor)
                   else x, tree)


def sequential_fsdp(card: str, seed: int) -> dict:
    """Phase 16 (16a-16c, 16e-16g); returns the DP launches of its
    runs."""
    import torch

    by_run, one = fsdp_nccl_one_rank(seed)
    cfg, argv, dtype = fsdp_case("one-layer")
    fed, toks = fsdp_inputs(argv, cfg, seed)
    one["algos"] = fsdp_algos_one_process(cfg, fed, toks, "cuda", dtype,
                                          one["burn_state"])
    torch.cuda.empty_cache()

    def cpu_run():
        t0 = time.perf_counter()
        res = fsdp_rounds(cfg, fed, toks, "cpu", dtype, seed)
        res["algos"] = fsdp_algos_one_process(cfg, fed, toks, "cpu", dtype,
                                              res["burn_state"])
        return res, time.perf_counter() - t0

    sums, files, (cpu, cpu_s), wall = fsdp_spawn(seed, cpu_run)
    print(f"fsdp ranks: {wall:.1f} s from the spawn to both exits",
          flush=True)
    by_run.update(fsdp_two_rank_replay(sums, files, one, cpu, cpu_s))
    del one, cpu
    by_run.update(fsdp_full_width(card, sums["full"]))
    by_run.update(fsdp_full_fedep(card, sums["fedep-full"], files, seed))
    torch.cuda.empty_cache()
    by_run.update(fsdp_full_fedlora(card, sums["fedlora-full"], files,
                                    seed))
    fsdp_checkpoints(sums["algos"], sums["fedlora-full"], files)
    return by_run


def main() -> int:
    """Run the sixteen phases; returns the exit code."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are missing under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))

    from repro_torch.configs.emnist_cnn import config
    from repro_torch.core import tree_math as tm
    from repro_torch.kernels import build, fedpa_dp, swa_decode
    from repro_torch.models.cnn import init_cnn_params

    # -- phase 1: card, versions, flags, build ------------------------------
    t_start = time.perf_counter()

    def done(phase: int) -> None:
        print(f"phase {phase} done at {time.perf_counter() - t_start:.1f} s",
              flush=True)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card_line = smi.stdout.strip().splitlines()[0]
    card = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {card_line}")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} devices {torch.cuda.device_count()}")
    print(f"tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    libs = build.build_all(["fedpa_dp", "swa_decode"])
    print(f"built {', '.join(p.name for p in libs.values())} in "
          f"{time.perf_counter() - t0:.2f} s (in parallel)")
    for lib in libs.values():
        print(lib.with_suffix(".log").read_text().strip(), flush=True)
    done(1)

    # -- phase 2: kernels against their twins -------------------------------
    rows = check_kernels(card)
    done(2)

    # -- phase 3: the FedPA path on the card --------------------------------
    params = init_cnn_params(torch.Generator().manual_seed(args.seed),
                             config())
    print(f"EMNIST CNN: d={tm.tree_size(params)}")
    fedpa_dp.reset_launches()
    swa_decode.reset_launches()
    cuda_runs = {}
    for streaming in (False, True):
        t0 = time.perf_counter()
        with deterministic():
            state, history = run_main_path("cuda", params, args.seed,
                                           streaming)
        cuda_runs[streaming] = state
        print(f"cuda run streaming_dp={streaming}: "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms for {ROUNDS} rounds "
              f"(first run includes warm-up); losses "
              f"{[round(h['loss_last'], 4) for h in history]}", flush=True)
    launches = dict(fedpa_dp.launches)
    if swa_decode.launches["swa_decode"] != 0:
        fail("swa_decode launched on the FedPA path")
    ell = (FED_KW["local_steps"] - FED_KW["burn_in_steps"]) \
        // FED_KW["steps_per_sample"]
    expected = (ROUNDS - FED_KW["burn_in_rounds"]) * (ell - 1) * 2
    print(f"launches on the FedPA path: {launches} (expected {expected} "
          f"each)")
    if any(n != expected for n in launches.values()):
        fail(f"kernel launches {launches} != {expected} each")

    sim = make_sim("cuda", args.seed, False)
    state = sim.init(params)
    round_ms = []
    for r in range(ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = sim.round(state, r)
        torch.cuda.synchronize()
        round_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"per-round ms (batch DP, warm; round 0 is the FedAvg burn-in): "
          f"{[round(x, 2) for x in round_ms]}")
    done(3)

    # -- phase 4: the same rounds on the CPU --------------------------------
    cpu_runs = {}
    for streaming, cuda_state in cuda_runs.items():
        cpu_state, _ = run_main_path("cpu", params, args.seed, streaming)
        cpu_runs[streaming] = cpu_state.params
        err = max((cuda_state.params[k].cpu() - v).abs().max().item()
                  for k, v in cpu_state.params.items())
        print(f"cuda vs cpu final params (streaming_dp={streaming}): "
              f"max abs diff {err:.3g}")
        for k, v in cpu_state.params.items():
            # cuDNN vs CPU convolutions and sums in another order, through
            # 42 local steps and 3 server steps, all fp32 (TF32 off)
            torch.testing.assert_close(cuda_state.params[k].cpu(), v,
                                       rtol=1e-3, atol=1e-4,
                                       msg=lambda m, k=k: f"{k}: {m}")
    conv_kernels(params, args.seed, cpu_runs[False])
    done(4)
    torch.cuda.empty_cache()

    # -- phase 5: decode attention against its twin ------------------------
    rows["swa_decode"] = check_swa_decode(card)
    done(5)

    # -- phase 6: fp32 wiring at full width, reduced depth ------------------
    wiring_check(args.seed)
    done(6)
    torch.cuda.empty_cache()

    # -- phase 7: the serving path, full gemma3-27b -------------------------
    launches["swa_decode"] = serve_path(args.seed)
    done(7)
    torch.cuda.empty_cache()

    # -- phase 8: the rest of the synchronous round, and the quickstart ------
    by_run = {"fedpa parallel (phase 3)": {k: launches[k] for k in
                                           ("dp_reduce", "dp_map")}}
    by_run.update(rest_of_round(params, cuda_runs[False].params, args.seed))
    by_run["quickstart"] = quickstart_check()
    done(8)
    torch.cuda.empty_cache()

    # -- phase 9: LM training, full-width fedlm-100m ------------------------
    by_run["fedlm-100m train"], _, _, warm = train_path(card, args.seed)
    profile_train(sum(warm[1:]) / len(warm[1:]), args.seed)
    torch.cuda.empty_cache()
    by_run["fedlm-100m 1 layer fp32 (vs CPU)"] = train_replay(args.seed)
    done(9)
    torch.cuda.empty_cache()

    # -- phase 10: per-client state -----------------------------------------
    runs10, fedep_records = per_client_state(card, params, args.seed)
    by_run.update(runs10)
    done(10)
    torch.cuda.empty_cache()

    # -- phase 11: async rounds ---------------------------------------------
    by_run.update(async_rounds(card, params, args.seed))
    done(11)
    torch.cuda.empty_cache()

    # -- phase 12: FedLoRA and the codecs -----------------------------------
    by_run.update(fedlora_rounds(card, args.seed))
    done(12)
    torch.cuda.empty_cache()

    # -- phase 13: serving the rest of the LM stack --------------------------
    swa_by_run = {"gemma3-27b serve (phase 7)": launches["swa_decode"]}
    swa_by_run.update(serve_rest(card, args.seed))
    done(13)
    torch.cuda.empty_cache()

    # -- phase 14: training the rest of the LM stack ------------------------
    swa_decode.reset_launches()
    by_run.update(train_rest(card, args.seed))
    if swa_decode.launches["swa_decode"] != 0:
        fail("swa_decode launched while training (phase 14)")
    done(14)
    torch.cuda.empty_cache()

    # -- phase 15: multi-process training ------------------------------------
    by_run.update(multi_process(card, params, args.seed, fedep_records))
    done(15)
    torch.cuda.empty_cache()

    # -- phase 16: the sequential placement's FSDP over ranks ----------------
    by_run.update(sequential_fsdp(card, args.seed))
    done(16)

    kernels = [dict(name=name, route="cuda", source=SOURCES[name],
                    replaces=REPLACES[name], launches=launches[name],
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by="bytes", library_ms=r["library_ms"],
                    **{key: r[key] for key in ("device_ms",
                                               "library_device_ms",
                                               "host_ms", "by_stack")
                       if key in r},
                    launches_by_path=(swa_by_run if name == "swa_decode"
                                      else {run: n[name] for run, n in
                                            by_run.items()}))
               for name, r in rows.items()]
    print(json.dumps({"kernels": kernels}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
