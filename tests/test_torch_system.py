"""End-to-end behaviour of the port, as ``tests/test_system.py`` checks the
JAX package's: federated LM training through the port's production round
(``core.sharded_round.make_fed_round`` on the smoke fedlm-100m, on the
CPU) learns, FedAvg learns on the same harness, and serving works after
training. The same settings and assertions as the JAX file; the weights
are the port's own init from the seed. Slow (deselected by default; run
with ``-m slow``).
"""
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.configs.base import FedConfig
from repro_torch.core.server import init_server_state
from repro_torch.core.sharded_round import make_fed_round
from repro_torch.data.lm_synthetic import SyntheticLMData
from repro_torch.models.model import init_params
from repro_torch.models.steps import lm_loss, prefill_step, serve_step
from repro_torch.optim import get_optimizer


def _run_training(algorithm: str, rounds: int = 12, seed: int = 0):
    cfg = configs.get_smoke("fedlm-100m")
    fed = FedConfig(algorithm=algorithm, clients_per_round=4, local_steps=6,
                    burn_in_steps=2, steps_per_sample=2, shrinkage_rho=0.01,
                    server_opt="sgdm", server_lr=0.5,
                    client_opt="sgd", client_lr=0.1)
    data = SyntheticLMData(vocab_size=cfg.vocab_size, num_clients=16,
                           seed=seed)
    B, S = 4, 64
    params = init_params(torch.Generator().manual_seed(seed), cfg,
                         device="cpu")
    server_opt = get_optimizer(fed.server_opt, fed.server_lr,
                               fed.server_momentum)
    state = init_server_state(params, server_opt)
    round_fn = make_fed_round(cfg, fed, placement="parallel", q_chunk=32)
    eval_batch = {"tokens": torch.from_numpy(
        data.client_batches(99, 1, B, S)[0])}

    @torch.no_grad()
    def eval_fn(p):
        return float(lm_loss(p, eval_batch, cfg, q_chunk=32)[0])

    losses = [eval_fn(state.params)]
    for r in range(rounds):
        ids = np.random.default_rng(r + seed).choice(16, 4, replace=False)
        batches = {"tokens": data.round_batches(ids, fed.local_steps, B, S,
                                                round_idx=r)}
        state, _ = round_fn(state, batches)
        losses.append(eval_fn(state.params))
    return cfg, state, losses


@pytest.mark.slow
def test_federated_training_learns():
    cfg, state, losses = _run_training("fedpa")
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0] - 0.5, losses


@pytest.mark.slow
def test_fedavg_also_learns_same_harness():
    cfg, state, losses = _run_training("fedavg")
    assert all(np.isfinite(losses)), losses
    # as in the JAX file: SGD-M at server_lr=0.5 may bounce at the cutoff
    # round, so the best loss reached is held
    assert min(losses) < losses[0] - 0.5, losses


@pytest.mark.slow
def test_serve_after_training():
    cfg, state, _ = _run_training("fedpa", rounds=3)
    B, S = 2, 48
    data = SyntheticLMData(vocab_size=cfg.vocab_size, num_clients=4, seed=1)
    prompts = torch.from_numpy(data.client_batches(0, 1, B, S)[0][:, :-1])
    with torch.no_grad():
        logits, dstate = prefill_step(state.params, prompts, cfg,
                                      max_len=S + 16, q_chunk=16)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        for _ in range(8):
            tok, logits, dstate = serve_step(state.params, tok, dstate, cfg)
    assert torch.isfinite(logits).all()
    assert int(tok.max()) < cfg.vocab_size
