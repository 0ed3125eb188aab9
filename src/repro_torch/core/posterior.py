"""Exact Gaussian posteriors for federated least squares (Section 3), port
of ``repro/core/posterior.py``.

For quadratic client objectives f_i(theta) = 1/2 ||X_i theta - y_i||^2 the
local posterior is Gaussian with Sigma_i^{-1} = X_i^T X_i and
mu_i = (X_i^T X_i)^{-1} X_i^T y_i, and the global posterior mode has the
closed form of Eq. 3: the oracles FedPA's approximations are held to.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch


class QuadraticClient(NamedTuple):
    """One client's quadratic objective in natural-parameter form."""

    sigma_inv: torch.Tensor   # (d, d) = X^T X  (precision)
    mu: torch.Tensor          # (d,)   local optimum / posterior mean
    weight: torch.Tensor      # scalar q_i

    def loss(self, theta):
        """0.5 (theta - mu)^T Sigma^{-1} (theta - mu)."""
        r = theta - self.mu
        return 0.5 * r @ self.sigma_inv @ r

    def grad(self, theta):
        """Sigma^{-1} (theta - mu) — the exact local gradient."""
        return self.sigma_inv @ (theta - self.mu)

    def exact_delta(self, theta):
        """The unbiased FedPA client update Delta_i = Sigma_i^{-1}(theta - mu_i)."""
        return self.grad(theta)


def client_from_data(X: torch.Tensor, y: torch.Tensor, weight=1.0,
                     ridge: float = 1e-6) -> QuadraticClient:
    """Local Gaussian posterior of a least-squares client (Eq. 2)."""
    d = X.shape[1]
    sigma_inv = X.T @ X + ridge * torch.eye(d, dtype=X.dtype, device=X.device)
    mu = torch.linalg.solve(sigma_inv, X.T @ y)
    return QuadraticClient(sigma_inv=sigma_inv, mu=mu,
                           weight=torch.as_tensor(weight, dtype=X.dtype,
                                                  device=X.device))


def _natural_sums(clients: Sequence[QuadraticClient]):
    A = sum(c.weight * c.sigma_inv for c in clients)
    b = sum(c.weight * (c.sigma_inv @ c.mu) for c in clients)
    return A, b


def global_posterior_mode(clients: Sequence[QuadraticClient]) -> torch.Tensor:
    """Eq. 3: mu = (sum q_i Sigma_i^{-1})^{-1} (sum q_i Sigma_i^{-1} mu_i)."""
    A, b = _natural_sums(clients)
    return torch.linalg.solve(A, b)


def global_quadratic(clients: Sequence[QuadraticClient]):
    """Proposition 2's surrogate Q(theta) = 1/2 theta^T A theta - b^T theta;
    returns (Q, grad_Q)."""
    A, b = _natural_sums(clients)

    def Q(theta):
        return 0.5 * theta @ A @ theta - b @ theta

    def grad_Q(theta):
        return A @ theta - b

    return Q, grad_Q


def global_objective(clients: Sequence[QuadraticClient]):
    """The federated objective F(theta) = sum q_i f_i(theta) (Eq. 1)."""
    def F(theta):
        return sum(c.weight * c.loss(theta) for c in clients)
    return F


def fedavg_fixed_point(clients: Sequence[QuadraticClient],
                       local_steps: int, client_lr: float) -> torch.Tensor:
    """Analytic fixed point of FedAvg with K local GD steps on quadratics.

    After K local gradient steps from theta on client i, the delta is
    (I - (I - lr Sigma_i^{-1})^K)(theta - mu_i); setting the q-weighted sum
    to zero gives the (generally suboptimal) stagnation point of Fig. 1.
    """
    mu0 = clients[0].mu
    d = mu0.shape[0]
    eye = torch.eye(d, dtype=mu0.dtype, device=mu0.device)
    A = torch.zeros(d, d, dtype=mu0.dtype, device=mu0.device)
    b = torch.zeros(d, dtype=mu0.dtype, device=mu0.device)
    for c in clients:
        m = eye - torch.linalg.matrix_power(eye - client_lr * c.sigma_inv,
                                            local_steps)
        A = A + c.weight * m
        b = b + c.weight * (m @ c.mu)
    return torch.linalg.solve(A, b)
