#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]

1. Prints the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions and the TF32 flags (both set off: the CPU comparison of
   phase 4 needs full fp32 convolutions), then builds the CUDA kernels
   from ``src/repro_torch/kernels/csrc`` with ``nvcc``.
2. Holds each kernel against its plain PyTorch twin on the card at the
   main path's shapes (C=16 clients, d=428,350, lp in {1, 4}), on a ragged
   d=1300, and with bf16 inputs; times kernel, twin and one library call,
   and computes each kernel's bound from the bytes it must move.
3. Drives the main path: ``FedSim(device="cuda").run`` for 3 FedPA rounds
   of the full-width EMNIST CNN (16 of 64 clients, l=5, one burn-in round),
   with batch and with streaming DP; each kernel must have been launched
   (rounds - burn_in_rounds) * (l - 1) * 2 runs = 16 times.
4. Runs the same rounds on the CPU (through the kernels' plain twins) from
   the same weights and data; final params must agree.

Prints one JSON line with every kernel's numbers, the card's line, and last
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result, when
there is no CUDA device or the port's sources are missing, and when any
phase fails.
"""
from __future__ import annotations

import argparse
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
SOURCE = "src/repro_torch/kernels/csrc/fedpa_dp.cu"
REPLACES = {"dp_reduce": "src/repro/kernels/fedpa_dp.py:69",
            "dp_map": "src/repro/kernels/fedpa_dp.py:97"}


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


def main() -> int:
    """Run the four phases; returns the exit code."""
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
    from repro_torch.kernels import build, fedpa_dp
    from repro_torch.models.cnn import init_cnn_params

    # -- phase 1: card, versions, flags, build ------------------------------
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
    lib = build.build("fedpa_dp")
    print(f"built {lib.name} in {time.perf_counter() - t0:.2f} s")
    print(lib.with_suffix(".log").read_text().strip(), flush=True)

    # -- phase 2: kernels against their twins -------------------------------
    rows = check_kernels(card)

    # -- phase 3: the main path on the card ---------------------------------
    params = init_cnn_params(torch.Generator().manual_seed(args.seed),
                             config())
    print(f"EMNIST CNN: d={tm.tree_size(params)}")
    fedpa_dp.reset_launches()
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
    ell = (FED_KW["local_steps"] - FED_KW["burn_in_steps"]) \
        // FED_KW["steps_per_sample"]
    expected = (ROUNDS - FED_KW["burn_in_rounds"]) * (ell - 1) * 2
    print(f"launches on the main path: {launches} (expected {expected} each)")
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

    kernels = [dict(name=name, route="cuda", source=SOURCE,
                    replaces=REPLACES[name], launches=launches[name],
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by="bytes", library_ms=r["library_ms"])
               for name, r in rows.items()]
    print(json.dumps({"kernels": kernels}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
