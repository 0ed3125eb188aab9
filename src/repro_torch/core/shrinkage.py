"""Shrinkage covariance estimation (Theorem 3 / Appendix C.1), port of
``repro/core/shrinkage.py``.

The Ledoit-Wolf-style estimator

    Sigma_hat_l = rho_l * I + (1 - rho_l) * S_l,   rho_l = 1 / (1 + (l-1) rho)

is the shrinkage schedule for which Sigma_tilde_t = I + rho (t-1) S_t
admits exact rank-1 updates with gamma_t = (t-1) rho / t, which is what
makes the Sherman-Morrison DP of ``dp_delta`` possible. This module holds
the dense, closed-form pieces: the O(d^3) oracle the DP is tested against
and the near-optimal shrinkage weight ``oas_rho``.
"""
from __future__ import annotations

import torch


def rho_l(ell, rho):
    """Shrinkage weight on the identity after ``ell`` samples."""
    return 1.0 / (1.0 + (ell - 1.0) * rho)


def gamma_t(t, rho):
    """Rank-1 update coefficient: Sigma_tilde_t - Sigma_tilde_{t-1} = gamma_t u u^T."""
    return (t - 1.0) * rho / t


def sample_mean_cov(samples: torch.Tensor):
    """Sample mean and (unbiased, /(l-1)) sample covariance of (l, d) samples."""
    ell = samples.shape[0]
    mean = samples.mean(dim=0)
    centered = samples - mean
    denom = max(ell - 1, 1)
    cov = centered.T @ centered / denom
    return mean, cov


def _eye_like(cov: torch.Tensor) -> torch.Tensor:
    return torch.eye(cov.shape[0], dtype=cov.dtype, device=cov.device)


def shrinkage_cov(samples: torch.Tensor, rho: float) -> torch.Tensor:
    """Dense Sigma_hat_l = rho_l I + (1 - rho_l) S_l.  O(l d^2) — tests only."""
    ell = samples.shape[0]
    _, cov = sample_mean_cov(samples)
    r = rho_l(ell, rho)
    return r * _eye_like(cov) + (1.0 - r) * cov


def shrinkage_cov_unnormalized(samples: torch.Tensor,
                               rho: float) -> torch.Tensor:
    """Dense Sigma_tilde_t = I + rho (t-1) S_t (the rank-1-recursive form)."""
    ell = samples.shape[0]
    _, cov = sample_mean_cov(samples)
    return _eye_like(cov) + rho * (ell - 1.0) * cov


def dense_delta(x0: torch.Tensor, samples: torch.Tensor,
                rho: float) -> torch.Tensor:
    """O(d^3) oracle: Delta_hat_l = Sigma_hat_l^{-1} (x0 - xbar_l), the
    quantity the DP computes in O(l^2 d)."""
    mean = samples.mean(dim=0)
    sigma = shrinkage_cov(samples, rho)
    return torch.linalg.solve(sigma, x0 - mean)


def oas_rho(samples: torch.Tensor) -> torch.Tensor:
    """Oracle-Approximating Shrinkage weight rho_l* in [0, 1] (Chen et al.
    2010): the *normalized* weight on the identity (what ``rho_l`` computes
    from the paper's rho)."""
    ell, d = samples.shape
    mean = samples.mean(dim=0)
    c = samples - mean
    s = c.T @ c / max(ell - 1, 1)
    tr_s = torch.trace(s)
    tr_s2 = (s * s).sum()
    num = (1.0 - 2.0 / d) * tr_s2 + tr_s ** 2
    den = (ell + 1.0 - 2.0 / d) * (tr_s2 - tr_s ** 2 / d)
    return torch.clamp(num / torch.clamp(den, min=1e-30), 0.0, 1.0)
