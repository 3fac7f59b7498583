"""KL divergences and Gaussian log-densities of the whitened objectives
(port of dgps_with_iwvi_tpu/ops/kl.py:14-78, 99-110, 132-154).

The non-whitened ``gauss_kl`` and ``gauss_kl_cov`` wait for ROADMAP
queue 7.
"""

from __future__ import annotations

import math

import torch

_LOG2PI = float(math.log(2.0 * math.pi))


def _logdet_sq_diag(L: torch.Tensor) -> torch.Tensor:
    """sum log diag(L)^2 over all axes."""
    diag = torch.diagonal(L, dim1=-2, dim2=-1)
    return torch.sum(torch.log(torch.square(diag)))


def gauss_kl_white(q_mu: torch.Tensor, q_sqrt: torch.Tensor) -> torch.Tensor:
    """KL(N(q_mu, L L^T) || N(0, I)) summed over output dims; q_mu [M, D],
    q_sqrt [D, M, M] (only its lower triangle is read)."""
    M, D = q_mu.shape
    L = torch.tril(q_sqrt)
    mahal = torch.sum(torch.square(q_mu))
    trace = torch.sum(torch.square(L))
    return 0.5 * (mahal + trace - M * D - _logdet_sq_diag(L))


class CarriedLogdet(torch.autograd.Function):
    """log det S_d [D] with the value carried from the natgrad state and
    the gradient g * S^-1 routed to S through the carried inverse, so the
    loss never factorizes S. logdet_val and Sinv get no gradient."""

    @staticmethod
    def forward(ctx, S, logdet_val, Sinv):
        ctx.save_for_backward(Sinv)
        return logdet_val.clone()

    @staticmethod
    def backward(ctx, g):
        (Sinv,) = ctx.saved_tensors
        return g[:, None, None] * Sinv, None, None


def carried_logdet(S, logdet_val, Sinv) -> torch.Tensor:
    return CarriedLogdet.apply(S, logdet_val, Sinv)


def gauss_kl_white_cov(q_mu: torch.Tensor, q_S: torch.Tensor,
                       logdet_val: torch.Tensor,
                       Sinv: torch.Tensor) -> torch.Tensor:
    """Whitened KL in covariance form, q(v) = N(q_mu, S), S [D, M, M]:
    0.5 sum_d [m_d^T m_d + tr(S_d) - M - log det S_d]."""
    M, D = q_mu.shape
    mahal = torch.sum(torch.square(q_mu))
    trace = torch.sum(torch.diagonal(q_S, dim1=-2, dim2=-1))
    logdet = torch.sum(carried_logdet(q_S, logdet_val, Sinv))
    return 0.5 * (mahal + trace - M * D - logdet)


def gauss_kl_white_diag(q_mu: torch.Tensor,
                        q_sqrt_diag: torch.Tensor) -> torch.Tensor:
    """Whitened KL of the q_diag family, scales [M, D]."""
    s2 = torch.square(q_sqrt_diag)
    return 0.5 * torch.sum(torch.square(q_mu) + s2 - 1.0 - torch.log(s2))


def gauss_kl_white_diagvar(q_mu: torch.Tensor,
                           v: torch.Tensor) -> torch.Tensor:
    """gauss_kl_white_diag in variance form, v = s^2 [M, D]."""
    return 0.5 * torch.sum(torch.square(q_mu) + v - 1.0 - torch.log(v))


def gauss_kl_diag_white(mu: torch.Tensor,
                        log_var: torch.Tensor) -> torch.Tensor:
    """Per-row KL(N(mu, diag exp(log_var)) || N(0, I)) over the last axis."""
    return 0.5 * torch.sum(torch.square(mu) + torch.exp(log_var) - 1.0
                           - log_var, dim=-1)


def diag_gaussian_logpdf(x: torch.Tensor, mu: torch.Tensor,
                         log_var: torch.Tensor) -> torch.Tensor:
    """log N(x | mu, diag exp(log_var)) over the last axis."""
    return -0.5 * torch.sum(_LOG2PI + log_var
                            + torch.square(x - mu) / torch.exp(log_var),
                            dim=-1)


def std_gaussian_logpdf(x: torch.Tensor) -> torch.Tensor:
    """log N(x | 0, I) over the last axis."""
    return -0.5 * torch.sum(_LOG2PI + torch.square(x), dim=-1)
