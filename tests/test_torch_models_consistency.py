"""The port's decoder held to itself, as ``tests/test_models_smoke.py`` and
``tests/test_models_consistency.py`` hold the JAX package's: every smoke
arch takes a loss and a plain-autograd train step and stays finite; the
new families' (MoE, RG-LRU, mLSTM/sLSTM) training forward equals the
chain of decode steps, prefill then decode equals the forward, a future
token never changes a past logit, and the chunkwise mLSTM's output and
grads do not depend on its chunk size.

Weights are the port's own init from a seed; fp32 compute and caches;
tolerances those of the JAX files (2e-3 for forward against decode, 1e-5
for causality, 1e-4 for the chunk sizes).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.models import model, steps, xlstm
from repro_torch.optim import sgd

F32 = torch.float32
S, B = 48, 2
TOL = dict(rtol=2e-3, atol=2e-3)


def _params(cfg, seed=0):
    return model.init_params(torch.Generator().manual_seed(seed), cfg,
                             device="cpu")


def _tokens(cfg, shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=shape).astype(np.int64))


def _batch(cfg, seq=64, seed=1):
    """A (B, S_text + 1) token batch whose text and frontend fill ``seq``."""
    s_text = seq - (cfg.frontend_tokens if cfg.frontend else 0)
    batch = {"tokens": _tokens(cfg, (B, s_text + 1), seed)}
    if cfg.frontend:
        batch["frontend"] = torch.randn(
            (B, cfg.frontend_tokens, cfg.d_model),
            generator=torch.Generator().manual_seed(seed + 1))
    return batch


@pytest.mark.parametrize("arch", configs.ALL_ARCHS)
def test_forward_and_train_step(arch):
    """The reduced config's loss, then one sgd step with plain autograd
    (``remat="full"``: ``torch.utils.checkpoint``): finite loss, finite
    params."""
    cfg = configs.get_smoke(arch)
    assert cfg.num_layers == 2 and cfg.d_model <= 512
    if cfg.moe.enabled:
        assert cfg.moe.num_experts <= 4
    params, batch = _params(cfg), _batch(cfg)
    with torch.no_grad():
        loss, metrics = steps.lm_loss(params, batch, cfg, q_chunk=32)
    assert torch.isfinite(loss) and set(metrics) == {"xent", "moe_aux"}
    opt = sgd(0.1)
    p2, _, loss2, _ = steps.centralized_train_step(
        params, opt.init(params), batch, cfg, opt, q_chunk=32)
    assert torch.isfinite(loss2)
    assert all(torch.isfinite(t.float()).all() for t in
               torch.utils._pytree.tree_leaves(p2))


def _cfg(arch):
    cfg = configs.get_smoke(arch)
    if cfg.moe.enabled:
        # generous capacity so that no token drops: the forward's chunks
        # and the decode steps' would drop different ones
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    return cfg


#: The families new to training, as in the JAX file.
ARCHS = ["xlstm-125m", "recurrentgemma-9b", "qwen3-moe-30b-a3b",
         "llama4-scout-17b-a16e"]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_equals_decode_chain(arch):
    cfg = _cfg(arch)
    params = _params(cfg)
    tokens = _tokens(cfg, (B, S), 1)
    with torch.no_grad():
        fwd, _ = model.forward(params, tokens, cfg, compute_dtype=F32,
                               q_chunk=16, remat="none")
        state = model.init_decode_state(cfg, B, S + 8, cache_dtype=F32,
                                        device="cpu")
        outs = []
        for t in range(S):
            lg, state = model.decode_step(params, tokens[:, t], state, cfg,
                                          compute_dtype=F32)
            outs.append(lg)
    torch.testing.assert_close(torch.stack(outs, 1), fwd, **TOL)


@pytest.mark.parametrize("arch", ["xlstm-125m", "recurrentgemma-9b"])
def test_prefill_then_decode_matches_forward(arch):
    cfg = _cfg(arch)
    params = _params(cfg)
    tokens = _tokens(cfg, (B, S + 1), 2)
    with torch.no_grad():
        fwd, _ = model.forward(params, tokens, cfg, compute_dtype=F32,
                               q_chunk=16, remat="none")
        lp, state = model.prefill(params, tokens[:, :S], cfg, S + 8,
                                  compute_dtype=F32, q_chunk=16,
                                  cache_dtype=F32)
        torch.testing.assert_close(lp, fwd[:, S - 1], **TOL)
        ld, _ = model.decode_step(params, tokens[:, S], state, cfg,
                                  compute_dtype=F32)
    torch.testing.assert_close(ld, fwd[:, S], **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_causality(arch):
    """Changing the last token changes no earlier logit."""
    cfg = _cfg(arch)
    params = _params(cfg)
    tokens = _tokens(cfg, (1, S), 4)
    tokens2 = tokens.clone()
    tokens2[0, -1] = (tokens[0, -1] + 1) % cfg.vocab_size
    with torch.no_grad():
        l1, _ = model.forward(params, tokens, cfg, compute_dtype=F32,
                              q_chunk=16, remat="none")
        l2, _ = model.forward(params, tokens2, cfg, compute_dtype=F32,
                              q_chunk=16, remat="none")
    torch.testing.assert_close(l1[:, :-1], l2[:, :-1], rtol=0, atol=1e-5)
    assert (l1[:, -1] - l2[:, -1]).abs().max() > 1e-4


def test_mlstm_chunk_size_invariance():
    """The chunkwise mLSTM is exact: chunks of 8 and of 64 give the same
    outputs and, through ``torch.func.grad``, the same grads."""
    cfg = configs.get_smoke("xlstm-125m")
    spec = next(s for s in cfg.pattern if s.mixer == "mlstm")
    layer = _params(cfg)["pattern"][
        f"pos_{cfg.pattern.index(spec)}"]["mixer"]
    p = {k: v[0] for k, v in layer.items()}
    g = torch.Generator().manual_seed(1)
    x = torch.randn((B, 64, cfg.d_model), generator=g)
    w = torch.randn((B, 64, cfg.d_model), generator=g)

    def out(chunk):
        def loss(p, x):
            y, _ = xlstm.mlstm_forward(p, x, cfg, chunk=chunk)
            return (y * w).sum(), y
        return torch.func.grad(loss, argnums=(0, 1), has_aux=True)(p, x)

    (gp8, gx8), y8 = out(8)
    (gp64, gx64), y64 = out(64)
    torch.testing.assert_close(y8, y64, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(gx8, gx64, rtol=1e-4, atol=1e-4)
    for k in gp8:
        torch.testing.assert_close(gp8[k], gp64[k], rtol=1e-4, atol=1e-4)
