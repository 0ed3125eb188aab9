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
   FedPA path's shapes (C=16 clients, d=428,350, lp in {1, 4}), on a ragged
   d=1300, and with bf16 inputs; times kernel, twin and one library call,
   and computes each kernel's bound from the bytes it must move.
3. Drives the FedPA path: ``FedSim(device="cuda").run`` for 3 FedPA rounds
   of the full-width EMNIST CNN (16 of 64 clients, l=5, one burn-in round),
   with batch and with streaming DP; each DP kernel must have been launched
   (rounds - burn_in_rounds) * (l - 1) * 2 runs = 16 times.
4. Runs the same rounds on the CPU (through the kernels' plain twins) from
   the same weights and data; final params must agree.
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
   62-layer gemma3-27b in bf16, batch 4, prompt 1280, 64 generated tokens;
   ``swa_decode`` must have been launched 63 x 62 = 3906 times. The same
   decode is replayed through the plain route (0 launches) from a copy of
   the prefill state, teacher-forced on the kernel route's tokens; the max
   logit difference must stay within one bf16 rounding (2^-8) of the
   largest logit per layer, plus one for the bf16 logits themselves:
   (62 + 1) x 2^-8 x max |logit|.

Prints one JSON line with every kernel's numbers, the card's line, and last
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result, when
there is no CUDA device or the port's sources are missing, and when any
phase fails.
"""
from __future__ import annotations

import argparse
import itertools
import json
import math
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

# the main path's configuration (ISSUE: one FedPA round of the EMNIST CNN)
FED_KW = dict(algorithm="fedpa", clients_per_round=16, local_steps=14,
              burn_in_steps=4, steps_per_sample=2, shrinkage_rho=0.01,
              burn_in_rounds=1, client_opt="sgdm", client_lr=0.01,
              server_opt="sgdm", server_lr=0.3)
NUM_CLIENTS, BATCH, ROUNDS = 64, 16, 3
SOURCES = {"dp_reduce": "src/repro_torch/kernels/csrc/fedpa_dp.cu",
           "dp_map": "src/repro_torch/kernels/csrc/fedpa_dp.cu",
           "swa_decode": "src/repro_torch/kernels/csrc/swa_decode.cu"}
REPLACES = {"dp_reduce": "src/repro/kernels/fedpa_dp.py:69",
            "dp_map": "src/repro/kernels/fedpa_dp.py:97",
            "swa_decode": "src/repro/kernels/swa_decode.py:70"}

# the serving path (gemma3-27b at full width): batch, prompt, generated
SERVE_B, SERVE_PROMPT, SERVE_GEN = 4, 1280, 64
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


def check_kernels(card: str):
    """Phase 2: every kernel against its twin; returns the numbers of the
    main path's shape (fp32, C=16, lp=4) per kernel."""
    import torch

    from repro_torch.kernels import fedpa_dp, ref

    rate = hbm_rate(card)
    d_main = 428_350
    cases = [(16, 4, d_main, torch.float32), (16, 1, d_main, torch.float32),
             (3, 4, 1300, torch.float32), (16, 4, d_main, torch.bfloat16)]
    main = {}
    for C, lp, d, dtype in cases:
        g = torch.Generator(device="cuda").manual_seed(C * 1000 + lp)
        u, delta = (torch.randn(C, d, device="cuda", generator=g).to(dtype)
                    for _ in range(2))
        V = torch.randn(C, lp, d, device="cuda", generator=g).to(dtype)
        w = torch.randn(C, lp, device="cuda", generator=g)
        s = torch.randn(C, device="cuda", generator=g)
        tag = f"C={C} lp={lp} d={d} {str(dtype).split('.')[-1]}"

        got = fedpa_dp.dp_reduce(u, delta, V)
        want = ref.dp_reduce_ref(u, delta, V)
        torch.cuda.synchronize()
        red_err = max((a - b).abs().max().item() for a, b in zip(got, want))
        scale = max(b.abs().max().item() for b in want)
        # fp32 sums of d terms in another order: 1e-5 of the largest sum
        if not red_err <= 1e-5 * max(scale, 1.0):
            fail(f"dp_reduce {tag}: max err {red_err} (scale {scale})")

        vout, dout = fedpa_dp.dp_map(w, s, u, delta, V)
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

        red_bytes = nbytes(u, delta, V) + C * (lp + 2) * 4
        map_bytes = nbytes(w, s, u, delta, V) + nbytes(u, delta)
        rows = {
            "dp_reduce": dict(
                max_abs_err=red_err,
                ms=time_ms(lambda: fedpa_dp.dp_reduce(u, delta, V)),
                plain_ms=time_ms(lambda: ref.dp_reduce_ref(u, delta, V)),
                library_ms=time_ms(lambda: torch.bmm(V, u[..., None])),
                bound_ms=max(red_bytes / rate,
                             2 * C * (lp + 2) * d / FP32_PEAK) * 1e3),
            "dp_map": dict(
                max_abs_err=map_err,
                ms=time_ms(lambda: fedpa_dp.dp_map(w, s, u, delta, V)),
                plain_ms=time_ms(lambda: ref.dp_map_ref(w, s, u, delta, V)),
                library_ms=time_ms(lambda: torch.baddbmm(
                    u[:, None, :], w.to(dtype)[:, None, :], V, alpha=-1)),
                bound_ms=max(map_bytes / rate,
                             2 * C * (lp + 1) * d / FP32_PEAK) * 1e3),
        }
        for name, r in rows.items():
            print(f"kernel {name} [{tag}]: max_abs_err={r['max_abs_err']:.3g} "
                  f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
                  f"library_ms={r['library_ms']:.4f} "
                  f"bound_ms={r['bound_ms']:.4f} (bytes)", flush=True)
        if (C, lp, d, dtype) == cases[0]:
            main = rows
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


def make_sim(device: str, seed: int, streaming: bool):
    """The main path's ``FedSim`` on the full-width EMNIST CNN."""
    from repro_torch.configs.base import FedConfig
    from repro_torch.configs.emnist_cnn import config
    from repro_torch.core.round import FedSim
    from repro_torch.models.cnn import cnn_grad_fn

    cfg = config()
    return FedSim(FedConfig(**FED_KW, streaming_dp=streaming),
                  cnn_grad_fn(cfg), make_batch_fn(cfg, seed), NUM_CLIENTS,
                  seed=seed, device=device)


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
]
SERVING = ("local", "global", "qwen3")


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


def main() -> int:
    """Run the seven phases; returns the exit code."""
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
        state, history = run_main_path("cuda", params, args.seed, streaming)
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
    for streaming, cuda_state in cuda_runs.items():
        cpu_state, _ = run_main_path("cpu", params, args.seed, streaming)
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

    kernels = [dict(name=name, route="cuda", source=SOURCES[name],
                    replaces=REPLACES[name], launches=launches[name],
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by="bytes", library_ms=r["library_ms"],
                    **{key: r[key] for key in ("device_ms",
                                               "library_device_ms",
                                               "host_ms") if key in r})
               for name, r in rows.items()]
    print(json.dumps({"kernels": kernels}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
