"""Serving steps (port of ``repro/models/steps.py``: ``serve_step``,
``prefill_step``). The loss and training steps are not ported."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_lib


def serve_step(params, token, state, cfg: ModelConfig, *,
               compute_dtype=torch.bfloat16, sample: bool = False,
               generator: Optional[torch.Generator] = None,
               temperature: float = 1.0, use_kernel: bool = False):
    """One decode step for a batch of requests. token: (B,) int.
    Returns (next_token (B,) int32, fp32 logits (B, V), new_state).

    Greedy unless ``sample``; then one categorical draw per request from
    ``generator`` (its numbers differ from ``jax.random``'s)."""
    logits, state = model_lib.decode_step(params, token, state, cfg,
                                          compute_dtype=compute_dtype,
                                          use_kernel=use_kernel)
    # padded vocab rows must never be sampled
    logits = logits.float()
    logits[:, cfg.vocab_size:] = -1e30
    if sample:
        probs = torch.softmax(logits / temperature, dim=-1)
        nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
    else:
        nxt = torch.argmax(logits, dim=-1)
    return nxt.to(torch.int32), logits, state


def prefill_step(params, tokens, cfg: ModelConfig, max_len: int, *,
                 compute_dtype=torch.bfloat16, q_chunk: int = 1024,
                 cache_dtype=torch.bfloat16):
    """Prompt ingestion: returns (last-token logits, decode state)."""
    return model_lib.prefill(params, tokens, cfg, max_len,
                             compute_dtype=compute_dtype, q_chunk=q_chunk,
                             cache_dtype=cache_dtype)
