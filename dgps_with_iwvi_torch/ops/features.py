"""Inducing features beyond plain inducing points: multiscale
(port of dgps_with_iwvi_tpu/ops/features.py).

A multiscale feature is the inter-domain inducing variable
u_m = ∫ f(x) N(x | Z_m, diag(w_m^2)) dx, a Gaussian window of
per-dimension width around each inducing point. With an RBF kernel the
covariances stay closed-form; the trainable scales s enter through the
combined lengthscale a_m = l + softplus(s_m), so the window variance is
w_m^2 = a_m^2 - l^2 >= 0:

    Kuf[m, n] = v prod_d(l_d / a_md) exp(-0.5 sum_d (x_nd - z_md)^2 / a_md^2)
    Kuu[i, j] = v prod_d(l_d / c_ijd) exp(-0.5 sum_d (z_id - z_jd)^2 / c_ijd^2)
                with c_ij^2 = a_i^2 + a_j^2 - l^2

Kff is unchanged, so everything downstream of (Kuu, Kuf) is the points
model's. Kuf's exponent expands into two products, x^2 (1/a^2)^T and
x (z/a^2)^T, at the gram's classes (``kernels.gram_classes``), clipped at
0 before the exp. The per-m lengthscale rules out the RBF gram's custom
backward, so autograd runs through the two classed products. All plain
PyTorch: the reference computes these outside any Pallas kernel.
"""

from __future__ import annotations

import torch

from . import kernels, precision
from .transforms import positive, positive_inverse

FEATURE_KINDS = ("points", "multiscale")


def multiscale_scales_init(num_inducing: int, input_dim: int,
                           init_scale: float = 0.1, *, dtype=torch.float32,
                           device="cuda") -> torch.Tensor:
    """Unconstrained raw scales [M, D] (softplus-positive), each window
    starting at init_scale."""
    return positive_inverse(torch.full((num_inducing, input_dim), init_scale,
                                       dtype=dtype, device=device))


def _combined_lengthscales(kernel_params, raw_scales):
    """(l, a = l + softplus(s) [M, D])."""
    ls = kernels.kernel_lengthscales(kernel_params)
    return ls, ls + positive(raw_scales)


def _prod_last(t: torch.Tensor) -> torch.Tensor:
    """The product over the last dimension as a chain of multiplies:
    ``torch.prod``'s backward on the card counts the zeros of its input on
    the host, which a captured CUDA graph (``utils.graphs``) refuses."""
    out = t[..., 0]
    for d in range(1, t.shape[-1]):
        out = out * t[..., d]
    return out


def multiscale_Kuu(kernel_params, Z: torch.Tensor,
                   raw_scales: torch.Tensor) -> torch.Tensor:
    """[M, M] covariance of the window integrals."""
    ls, a = _combined_lengthscales(kernel_params, raw_scales)
    var = kernels.kernel_variance(kernel_params)
    a2 = torch.square(a)
    c2 = a2[:, None, :] + a2[None, :, :] - torch.square(ls)   # [M, M, D]
    diff2 = torch.square(Z[:, None, :] - Z[None, :, :])
    d = torch.sum(diff2 / c2, dim=-1)
    prefac = _prod_last(ls / torch.sqrt(c2))
    return var * prefac * torch.exp(-0.5 * d)


def multiscale_Kuf(kernel_params, Z: torch.Tensor, raw_scales: torch.Tensor,
                   X: torch.Tensor) -> torch.Tensor:
    """[..., M, N] window-versus-point cross-covariance."""
    ls, a = _combined_lengthscales(kernel_params, raw_scales)
    var = kernels.kernel_variance(kernel_params)
    inv_a2 = 1.0 / torch.square(a)                            # [M, D]
    fwd, bwd = kernels.gram_classes()
    xx = precision.matmul(torch.square(X), inv_a2.T, fwd, bwd)   # [..., N, M]
    xz = precision.matmul(X, (Z * inv_a2).T, fwd, bwd)
    zz = torch.sum(torch.square(Z) * inv_a2, dim=-1)          # [M]
    d2 = torch.clamp(xx - 2.0 * xz + zz, min=0.0)
    Kfu = var * _prod_last(ls / a) * torch.exp(-0.5 * d2)
    return Kfu.transpose(-1, -2)
