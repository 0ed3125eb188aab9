"""Quickstart: federated posterior averaging on least squares (port of
``examples/quickstart.py``).

Builds a heterogeneous federated least-squares problem, runs FedAvg and
FedPA through the same federated round (only the client update differs),
and prints each one's distance to the global optimum, known in closed
form (Eq. 3). FedPA runs at ``chunked`` placement, 2 clients per chunk:
the same round math as ``parallel`` with half the cohort in memory.

    python -m repro_torch.examples.quickstart [--device cpu] [--rounds N]

Runs on ``cuda`` unless given ``--device``; raises without a GPU.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import FedConfig
from repro_torch.core.posterior import global_posterior_mode
from repro_torch.core.round import FedSim, resolve_device
from repro_torch.data.synthetic_lsq import lsq_batches, make_federated_lsq

D, N_CLIENTS, N_PER_CLIENT = 8, 8, 100
ROUNDS = 60

_COMMON = dict(clients_per_round=4, local_steps=300, client_opt="sgd",
               client_lr=0.002)
CONFIGS = {
    "fedavg": FedConfig(algorithm="fedavg", server_opt="sgdm",
                        server_lr=1.0, **_COMMON),
    "fedpa": FedConfig(algorithm="fedpa", burn_in_steps=100,
                       steps_per_sample=20, shrinkage_rho=1.0,
                       server_opt="sgd", server_lr=0.03,
                       round_placement="chunked", round_chunk_size=2,
                       **_COMMON),
}


def make_problem():
    """``(clients, batch_fn, grad_fn)``: the exact-posterior client views,
    numpy minibatches per (client, round), and one client's loss gradient
    (the sum-scale objective)."""
    clients, data = make_federated_lsq(N_CLIENTS, N_PER_CLIENT, D,
                                       heterogeneity=20.0, seed=0)

    def batch_fn(cid, round_idx, steps):
        X, y = data[cid]
        return lsq_batches(X, y, batch_size=25, num_steps=steps,
                           seed=round_idx * 977 + cid)

    def loss(p, batch):
        r = batch["x"] @ p - batch["y"]
        return 0.5 * (r * r).mean() * N_PER_CLIENT

    grad_and_value = torch.func.grad_and_value(loss)

    def grad_fn(p, batch):
        g, value = grad_and_value(p, batch)
        return value, g

    return clients, batch_fn, grad_fn


def run(device=None, rounds: int = ROUNDS) -> Dict[str, dict]:
    """Run both algorithms for ``rounds`` rounds on ``device``; returns
    ``{name: {"params", "distance", "history"}}`` (params as numpy)."""
    device = resolve_device(device)
    clients, batch_fn, grad_fn = make_problem()
    mu_star = global_posterior_mode(clients).numpy()   # exact optimum
    out = {}
    for name, fed in CONFIGS.items():
        sim = FedSim(fed=fed, grad_fn=grad_fn, batch_fn=batch_fn,
                     num_clients=N_CLIENTS, device=device)
        state, hist = sim.run(torch.zeros(D), num_rounds=rounds)
        params = state.params.cpu().numpy()
        out[name] = {"params": params, "history": hist,
                     "distance": float(np.linalg.norm(params - mu_star))}
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, dict]:
    """Parse ``--device`` / ``--rounds``, run, print one line per
    algorithm; returns ``run``'s result."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    args = ap.parse_args(argv)
    res = run(args.device, args.rounds)
    for name, r in res.items():
        last = r["history"][-1]
        # loss_first vs loss_last: how much the final round's local runs
        # still move
        print(f"{name:7s}: final round loss {last['loss_first']:.3f} -> "
              f"{last['loss_last']:.3f} (first -> last local step), "
              f"distance to global optimum {r['distance']:.4f}")
    return res


if __name__ == "__main__":
    main()
