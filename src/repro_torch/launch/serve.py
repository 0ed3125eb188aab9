"""Batched serving (port of ``repro/launch/serve.py``): prefill a
batch of synthetic requests, then decode tokens with the cached state, for
every architecture of the JAX package.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-27b --full \\
      --batch 4 --prompt-len 1280 --gen 64 [--device cpu] [--plain-attention]

Runs on ``cuda`` unless ``--device cpu`` is given, and raises without a GPU.
The weights are random (``--seed``), drawn directly in the compute dtype,
bf16: a 27B-parameter tree in fp32 would need 108 GB. A frontend arch
(internvl2's vision patches, musicgen's audio conditioning) takes
``frontend_tokens`` stub embeddings in bf16 first and ``prompt_len -
frontend_tokens`` text tokens after them. Decode attention goes through
the ``swa_decode`` CUDA kernel on the card (its plain twin on the CPU);
``--plain-attention`` takes the einsum path instead, for comparisons.
Prints what the JAX entry point prints, plus prefill ms, decode ms per
step and tokens/s.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.round import resolve_device
from repro_torch.data.lm_synthetic import SyntheticLMData
from repro_torch.models.model import clone_state, init_params
from repro_torch.models.steps import prefill_step, serve_step

COMPUTE_DTYPE = torch.bfloat16


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_prompts(cfg, batch: int, prompt_len: int, seed: int) -> np.ndarray:
    """(batch, prompt_len) int32 prompts, one synthetic client each."""
    data = SyntheticLMData(vocab_size=cfg.vocab_size, num_clients=batch,
                           seed=seed)
    return np.stack([data.client_batches(i, 1, 1, prompt_len - 1)[0, 0]
                     for i in range(batch)])


def make_frontend(cfg, batch: int, seed: int) -> np.ndarray | None:
    """(batch, frontend_tokens, d_model) float32 stub frontend embeddings,
    one synthetic client each, or None when ``cfg`` has no frontend."""
    if not cfg.frontend:
        return None
    data = SyntheticLMData(vocab_size=cfg.vocab_size, num_clients=batch,
                           seed=seed)
    return np.stack([data.frontend_embeddings(i, 1, cfg.frontend_tokens,
                                              cfg.d_model)[0]
                     for i in range(batch)])


def decode(params, tok, state, cfg, steps: int, *, use_kernel: bool,
           forced=None, sample: bool = False, temperature: float = 1.0,
           generator=None, compute_dtype=COMPUTE_DTYPE):
    """``steps`` serve steps from the first token ``tok`` (B,).

    With ``forced`` (B, >= steps) the i-th step's input is ``forced[:, i]``
    (teacher forcing) instead of the token chosen before. Returns a dict:
    ``tokens`` (B, steps + 1) (``tok`` first), ``logits`` (one fp32 (B, V)
    per step), ``state``, and host ms for the first step and all steps.
    """
    device = tok.device
    out, logits_all = [tok], []
    _sync(device)
    t0 = time.perf_counter()
    t_first = t0
    for i in range(steps):
        inp = out[-1] if forced is None else forced[:, i]
        tok, logits, state = serve_step(
            params, inp, state, cfg, compute_dtype=compute_dtype,
            sample=sample, generator=generator, temperature=temperature,
            use_kernel=use_kernel)
        out.append(tok)
        logits_all.append(logits)
        if i == 0:
            _sync(device)
            t_first = time.perf_counter()
    _sync(device)
    t1 = time.perf_counter()
    return {"tokens": torch.stack(out, dim=1), "logits": logits_all,
            "state": state, "first_ms": (t_first - t0) * 1e3,
            "total_ms": (t1 - t0) * 1e3}


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gemma3-27b", choices=configs.ALL_ARCHS)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=96)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--sample", action="store_true")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--plain-attention", action="store_true",
                    help="decode attention through the plain einsum path "
                         "instead of the swa_decode kernel")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def main(argv=None, *, cfg=None, keep_prefill_state: bool = False) -> dict:
    """CLI: prefill a synthetic batch, then decode ``--gen`` tokens.

    ``cfg`` replaces the config that ``--arch`` / ``--smoke`` name (a
    full-width model cut in depth). Returns the run: ``cfg``, ``params``,
    the ``prompts`` and ``frontend`` inputs, the first token ``tok``, the
    ``decode`` dict, the timings, and with ``keep_prefill_state`` a copy of
    the state right after prefill.
    """
    args = _parse(argv)
    device = resolve_device(args.device)
    if cfg is None:
        cfg = configs.get_smoke(args.arch) if args.smoke \
            else configs.get_config(args.arch)
    params = init_params(torch.Generator(device=device).manual_seed(args.seed),
                         cfg, COMPUTE_DTYPE, device=device)
    s_text = args.prompt_len - (cfg.frontend_tokens if cfg.frontend else 0)
    prompts = torch.from_numpy(
        make_prompts(cfg, args.batch, s_text, args.seed)).to(device)
    frontend = make_frontend(cfg, args.batch, args.seed)
    if frontend is not None:
        frontend = torch.from_numpy(frontend).to(device, COMPUTE_DTYPE)

    max_len = args.prompt_len + args.gen
    q_chunk = min(32, s_text)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _sync(device)
    t0 = time.perf_counter()
    logits, state = prefill_step(params, prompts, cfg, max_len,
                                 frontend=frontend,
                                 compute_dtype=COMPUTE_DTYPE, q_chunk=q_chunk)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    _sync(device)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    print(f"prefill {args.batch}x{args.prompt_len}: {prefill_ms / 1e3:.2f}s "
          f"({prefill_ms:.1f} ms)")
    state0 = clone_state(state) if keep_prefill_state else None

    generator = torch.Generator(device=device).manual_seed(args.seed + 1)
    steps = args.gen - 1
    dec = decode(params, tok, state, cfg, steps,
                 use_kernel=not args.plain_attention, sample=args.sample,
                 temperature=args.temperature, generator=generator)
    dt = dec["total_ms"] / 1e3
    warm_ms = ((dec["total_ms"] - dec["first_ms"]) / (steps - 1)
               if steps > 1 else dec["total_ms"])
    tokens_per_s = steps * args.batch / max(dt, 1e-9)
    print(f"decoded {steps} steps in {dt:.2f}s ({tokens_per_s:.1f} tok/s)")
    print(f"decode ms per step: first {dec['first_ms']:.2f}, warm "
          f"{warm_ms:.3f}; tokens/s {tokens_per_s:.1f}")
    gen = dec["tokens"].cpu().numpy()
    for b in range(min(args.batch, 2)):
        print(f"request {b}: {gen[b].tolist()}")
    peak = None
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device)
        print(f"peak memory allocated: {peak / 2**30:.2f} GiB")
    if dec["logits"] and not torch.isfinite(dec["logits"][-1]).all():
        raise RuntimeError("non-finite logits")
    print("ok")
    return {"cfg": cfg, "params": params, "prompts": prompts,
            "frontend": frontend, "tok": tok,
            "prefill_logits": logits, "prefill_state": state0,
            "decode": dec, "prefill_ms": prefill_ms, "decode_ms": warm_ms,
            "tokens_per_s": tokens_per_s, "peak_bytes": peak}


if __name__ == "__main__":
    main()
