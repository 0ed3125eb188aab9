"""Sampler-quality diagnostics (Appendix A.2; port of
``repro/core/diagnostics.py``)."""
from __future__ import annotations

import torch


def effective_sample_size(log_weights: torch.Tensor) -> torch.Tensor:
    """ESS = (sum w)^2 / sum w^2 with w given in log-space.

    The paper weighs samples in proportion to their posterior probability,
    log w_j = -loss(theta_j); computed with logsumexp stabilization.
    """
    lse1 = torch.logsumexp(log_weights, dim=0)
    lse2 = torch.logsumexp(2.0 * log_weights, dim=0)
    return torch.exp(2.0 * lse1 - lse2)


def ess_from_losses(losses: torch.Tensor) -> torch.Tensor:
    """ESS of samples whose losses (negative log posteriors) are given."""
    return effective_sample_size(-losses)


def sample_autocorr(samples: torch.Tensor, lag: int = 1) -> torch.Tensor:
    """Mean lag-k autocorrelation across dimensions of (l, d) samples."""
    x = samples - samples.mean(dim=0)
    num = (x[:-lag] * x[lag:]).sum(dim=0)
    den = (x * x).sum(dim=0) + 1e-30
    return (num / den).mean()


def bias_variance(estimates: torch.Tensor, exact: torch.Tensor):
    """Empirical bias L2-norm and covariance Frobenius norm (Fig. 3).

    ``estimates``: (n_trials, d) independent estimates of the same exact
    (d,) quantity (a client delta). Returns ``(||bias||_2, ||Cov||_F)``.
    """
    mean = estimates.mean(dim=0)
    bias = torch.linalg.vector_norm(mean - exact)
    centered = estimates - mean
    cov = centered.T @ centered / max(estimates.shape[0] - 1, 1)
    return bias, torch.linalg.matrix_norm(cov)
