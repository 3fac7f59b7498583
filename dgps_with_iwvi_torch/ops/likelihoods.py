"""Gaussian likelihood (port of dgps_with_iwvi_tpu/ops/likelihoods.py:35-74).

Serving needs the predictive moments and density, training the analytic
variational expectations; the dispatch functions mirror
``likelihoods.py:808-826`` for ``gaussian`` only. The other families wait
for ROADMAP queue 8.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from .transforms import positive, positive_inverse

LikelihoodParams = Dict[str, torch.Tensor]

_LOG2PI = float(math.log(2.0 * math.pi))


def _check_kind(kind: str) -> None:
    if kind != "gaussian":
        raise NotImplementedError(
            f"likelihood {kind!r} is not ported yet (ROADMAP queue 8); the "
            "port has 'gaussian' only")


def gaussian_params(noise_variance: float = 0.05, *, dtype=torch.float32,
                    device="cuda") -> LikelihoodParams:
    return {"raw_noise_variance": positive_inverse(
        torch.as_tensor(noise_variance, dtype=dtype, device=device))}


def init_params(kind: str, noise_variance: float = 0.05, *,
                dtype=torch.float32, device="cuda") -> LikelihoodParams:
    _check_kind(kind)
    return gaussian_params(noise_variance, dtype=dtype, device=device)


def noise_variance(params: LikelihoodParams) -> torch.Tensor:
    return positive(params["raw_noise_variance"])


def variational_expectations(params: LikelihoodParams, mean: torch.Tensor,
                             var: torch.Tensor,
                             y: torch.Tensor) -> torch.Tensor:
    """E_{N(f|mean,var)}[log N(y | f, s2)], summed over the last axis."""
    s2 = noise_variance(params)
    per_dim = -0.5 * (_LOG2PI + torch.log(s2)
                      + (torch.square(y - mean) + var) / s2)
    return torch.sum(per_dim, dim=-1)


def log_prob(params: LikelihoodParams, f: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
    """log N(y | f, s2), summed over the last axis."""
    s2 = noise_variance(params)
    per_dim = -0.5 * (_LOG2PI + torch.log(s2) + torch.square(y - f) / s2)
    return torch.sum(per_dim, dim=-1)


def predict_mean_and_var(params: LikelihoodParams, fmean: torch.Tensor,
                         fvar: torch.Tensor):
    return fmean, fvar + noise_variance(params)


def predict_density(params: LikelihoodParams, fmean: torch.Tensor,
                    fvar: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """log N(y | fmean, fvar + s2), summed over the last axis."""
    v = fvar + noise_variance(params)
    per_dim = -0.5 * (_LOG2PI + torch.log(v) + torch.square(y - fmean) / v)
    return torch.sum(per_dim, dim=-1)


def dispatch_variational_expectations(params, mean, var, y, *,
                                      kind: str = "gaussian") -> torch.Tensor:
    _check_kind(kind)
    return variational_expectations(params, mean, var, y)


def dispatch_predict_mean_and_var(params, fmean, fvar, *,
                                  kind: str = "gaussian", y=None):
    _check_kind(kind)
    return predict_mean_and_var(params, fmean, fvar)


def dispatch_predict_density(params, fmean, fvar, y, *,
                             kind: str = "gaussian") -> torch.Tensor:
    _check_kind(kind)
    return predict_density(params, fmean, fvar, y)
