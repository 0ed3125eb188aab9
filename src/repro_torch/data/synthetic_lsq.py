"""Synthetic federated least-squares problems (port of
``repro/data/synthetic_lsq.py``).

The exactly-solvable problems the paper uses for its algorithmic analysis
(Fig. 1, Fig. 3, Fig. 4, Table 1) and the engine goldens train on. Pure
numpy on the host, the same draws as the reference: the data come back as
CPU tensors of ``dtype`` with exact-posterior views, the minibatches as
numpy arrays (the round moves them to its device).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.posterior import QuadraticClient, client_from_data


def make_regression(
    n_samples: int,
    n_features: int,
    *,
    n_informative: int | None = None,
    noise: float = 1.0,
    seed: int = 0,
    coef_shift: np.ndarray | None = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Guyon (2003)-style linear regression generator (scikit-learn's
    ``make_regression`` reimplemented). Returns (X, y, w); ``coef_shift``
    perturbs the ground-truth coefficients (per-client heterogeneity)."""
    rng = np.random.default_rng(seed)
    n_informative = n_informative or n_features
    X = rng.standard_normal((n_samples, n_features))
    w = np.zeros(n_features)
    w[:n_informative] = 100.0 * rng.uniform(size=n_informative)
    if coef_shift is not None:
        w = w + coef_shift
    y = X @ w + noise * rng.standard_normal(n_samples)
    return X, y, w


def make_federated_lsq(
    num_clients: int,
    n_per_client: int,
    d: int,
    *,
    heterogeneity: float = 25.0,
    noise: float = 1.0,
    seed: int = 0,
    dtype=torch.float32,
):
    """A federated least-squares problem with heterogeneous clients.

    Every client shares a base coefficient vector; each gets an independent
    Gaussian shift of scale ``heterogeneity``. Returns (clients, data):
    exact-posterior ``QuadraticClient`` views and the raw (X, y) pairs for
    SGD/IASG, as CPU tensors of ``dtype``.
    """
    rng = np.random.default_rng(seed)
    base_shift = rng.standard_normal(d)
    clients: List[QuadraticClient] = []
    data = []
    sizes = np.full(num_clients, n_per_client)
    for i in range(num_clients):
        shift = base_shift + heterogeneity * rng.standard_normal(d)
        X, y, _ = make_regression(
            n_per_client, d, noise=noise, seed=seed * 7919 + i, coef_shift=shift
        )
        Xt = torch.as_tensor(X, dtype=dtype)
        yt = torch.as_tensor(y, dtype=dtype)
        q = sizes[i] / sizes.sum()
        clients.append(client_from_data(Xt, yt, weight=q))
        data.append((Xt, yt))
    return clients, data


def make_quadratic_clients(
    num_clients: int,
    d: int,
    *,
    cond: float = 10.0,
    spread: float = 3.0,
    seed: int = 0,
    dtype=torch.float32,
) -> Sequence[QuadraticClient]:
    """Random quadratic objectives in natural form (Fig. 1's toy setting):
    random PSD precisions with condition number ~``cond`` and optima spread
    ``spread`` apart."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num_clients):
        Q, _ = np.linalg.qr(rng.standard_normal((d, d)))
        eigs = np.exp(rng.uniform(0, np.log(cond), size=d))
        prec = (Q * eigs) @ Q.T
        mu = spread * rng.standard_normal(d)
        out.append(
            QuadraticClient(
                sigma_inv=torch.as_tensor(prec, dtype=dtype),
                mu=torch.as_tensor(mu, dtype=dtype),
                weight=torch.as_tensor(1.0 / num_clients, dtype=dtype),
            )
        )
    return out


def lsq_batches(X, y, batch_size: int, num_steps: int, seed: int = 0):
    """Sample ``num_steps`` minibatches with replacement -> stacked numpy
    arrays with a leading step axis (one client's batches for a round)."""
    rng = np.random.default_rng(seed)
    n = X.shape[0]
    idx = rng.integers(0, n, size=(num_steps, batch_size))
    return {"x": np.asarray(X)[idx], "y": np.asarray(y)[idx]}
