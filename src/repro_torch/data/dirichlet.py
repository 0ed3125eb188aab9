"""Dirichlet non-IID federated classification (port of
``repro/data/dirichlet.py``, the Table-3 stand-in; numpy draws, equal to
the JAX package's).

Per-client label distributions are drawn from a Dirichlet(alpha) prior
(alpha small: highly heterogeneous clients), the construction Reddi et
al. (2020) used to build federated CIFAR-100. Features are noisy class
prototypes, so a linear or MLP model has a well-defined global optimum
while the client optima differ: the regime where FedAvg stagnates.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class FederatedClassification(NamedTuple):
    """One federated classification problem: per-client shards + test set."""

    client_x: list          # list of (n_i, d) float32 arrays
    client_y: list          # list of (n_i,) int32 arrays
    weights: np.ndarray     # q_i proportional to n_i
    test_x: torch.Tensor
    test_y: torch.Tensor
    num_classes: int
    d: int


def make_dirichlet_classification(
    num_clients: int,
    num_classes: int,
    d: int,
    *,
    n_per_client: int = 100,
    alpha: float = 0.1,
    proto_scale: float = 3.0,
    noise: float = 1.0,
    n_test: int = 1000,
    seed: int = 0,
) -> FederatedClassification:
    """Build the synthetic non-IID problem: per-client label distributions
    ~ Dirichlet(alpha), features = noisy class prototypes, the test set
    drawn from the global (uniform) label distribution."""
    rng = np.random.default_rng(seed)
    protos = proto_scale * rng.standard_normal((num_classes, d))

    def sample(n, label_p):
        ys = rng.choice(num_classes, size=n, p=label_p)
        xs = protos[ys] + noise * rng.standard_normal((n, d))
        return xs.astype(np.float32), ys.astype(np.int32)

    client_x, client_y = [], []
    for _ in range(num_clients):
        p = rng.dirichlet(alpha * np.ones(num_classes))
        xs, ys = sample(n_per_client, p)
        client_x.append(xs)
        client_y.append(ys)
    tx, ty = sample(n_test, np.ones(num_classes) / num_classes)
    weights = np.full(num_clients, 1.0 / num_clients)
    return FederatedClassification(
        client_x, client_y, weights, torch.from_numpy(tx),
        torch.from_numpy(ty), num_classes, d)


def classification_batches(xs, ys, batch_size: int, num_steps: int,
                           seed: int = 0):
    """One client-round's ``{"x", "y"}`` batches with a leading step axis,
    sampled with replacement from the client's shard. Numpy leaves: the
    round moves them to the device, and they cross the process
    prefetcher's arena."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, xs.shape[0], size=(num_steps, batch_size))
    return {"x": xs[idx], "y": ys[idx]}
