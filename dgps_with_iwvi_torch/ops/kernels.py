"""RBF kernel with ARD lengthscales (port of dgps_with_iwvi_tpu/ops/kernels.py).

Only the kind the flagship model uses: ``rbf_params`` (l.37),
``scaled_squared_distance`` (l.74), ``K`` / ``Kdiag`` (l.679, l.707) and
the cross gram's backward that keeps its output as the residual
(``_rbf_gram_kres``, l.216-263), taken by the reference's size rule
(``_use_kuf_residual``, l.185: float32 and at least 4 MB, so the M x M
Kuu grams stay on plain autograd). Every other kernel kind raises until
ROADMAP queue 8 ports the kernel family.

The squared distance uses the ||x||^2 - 2 x.y + ||y||^2 expansion with the
cross term at the ``highest`` class (the expansion cancels
catastrophically in bf16) and is clipped at 0.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import precision
from .transforms import positive, positive_inverse

KernelParams = Dict[str, torch.Tensor]

GRAM_KRES_MIN_BYTES = 4 * 1024 * 1024


def _check_kind(kind: str) -> None:
    if kind != "rbf":
        raise NotImplementedError(
            f"kernel kind {kind!r} is not ported yet (ROADMAP queue 8); "
            "the port has 'rbf' only")


def rbf_params(input_dim: int, variance: float = 1.0, lengthscales=1.0,
               *, dtype=torch.float32, device="cuda") -> KernelParams:
    """Unconstrained RBF parameters: unit variance, ARD lengthscales."""
    ls = torch.broadcast_to(
        torch.as_tensor(lengthscales, dtype=dtype, device=device),
        (input_dim,)).clone()
    return {
        "raw_variance": positive_inverse(
            torch.as_tensor(variance, dtype=dtype, device=device)),
        "raw_lengthscales": positive_inverse(ls),
    }


def kernel_params(kind: str, input_dim: int, variance: float = 1.0,
                  lengthscales=1.0, *, dtype=torch.float32,
                  device="cuda") -> KernelParams:
    _check_kind(kind)
    return rbf_params(input_dim, variance, lengthscales, dtype=dtype,
                      device=device)


def kernel_variance(params: KernelParams) -> torch.Tensor:
    return positive(params["raw_variance"])


def kernel_lengthscales(params: KernelParams) -> torch.Tensor:
    return positive(params["raw_lengthscales"])


def scaled_squared_distance(X: torch.Tensor, X2: torch.Tensor,
                            lengthscales: torch.Tensor) -> torch.Tensor:
    """||(x - x')/l||^2 for X [..., N, D], X2 [..., M, D] -> [..., N, M]."""
    Xs = X / lengthscales
    X2s = X2 / lengthscales
    xx = torch.sum(torch.square(Xs), dim=-1)
    yy = torch.sum(torch.square(X2s), dim=-1)
    cross = precision.matmul(Xs, X2s.transpose(-1, -2), "highest")
    d2 = xx[..., :, None] - 2.0 * cross + yy[..., None, :]
    return torch.clamp(d2, min=0.0)


def _use_kuf_residual(X: torch.Tensor, X2: torch.Tensor) -> bool:
    """The reference's size rule: float32 and an output of >= 4 MB."""
    n_out = X.shape[-2] * X2.shape[-2]
    for s in torch.broadcast_shapes(X.shape[:-2], X2.shape[:-2]):
        n_out *= s
    return X.dtype == torch.float32 and n_out * 4 >= GRAM_KRES_MIN_BYTES


class RbfGramKres(torch.autograd.Function):
    """var * exp(-0.5 |xs - x2s|^2) whose backward residual is the output.

    Forward is the plain path's math. Backward: dd2 = -0.5 g K, zero where
    the d2 >= 0 clamp bound (recovered as K >= var), and the cotangent
    dots at ``highest``."""

    @staticmethod
    def forward(ctx, Xs, X2s, var):
        xx = torch.sum(torch.square(Xs), dim=-1)
        yy = torch.sum(torch.square(X2s), dim=-1)
        cross = precision.matmul(Xs, X2s.transpose(-1, -2), "highest")
        d2 = xx[..., :, None] - 2.0 * cross + yy[..., None, :]
        out = var * torch.exp(-0.5 * torch.clamp(d2, min=0.0))
        ctx.save_for_backward(Xs, X2s, var, out)
        return out

    @staticmethod
    def backward(ctx, g):
        Xs, X2s, var, K = ctx.saved_tensors
        dvar = torch.sum(g * K) / var
        dd2 = torch.where(K < var, -0.5 * g * K, torch.zeros_like(K))
        dcross = -2.0 * dd2
        dXs = precision.matmul(dcross, X2s, "highest")
        dX2s = precision.matmul(dcross.transpose(-1, -2), Xs, "highest")
        dXs = dXs + 2.0 * Xs * torch.sum(dd2, dim=-1)[..., None]
        dX2s = dX2s + 2.0 * X2s * torch.sum(dd2, dim=-2)[..., None]
        return (precision.reduce_to_shape(dXs, Xs.shape),
                precision.reduce_to_shape(dX2s, X2s.shape),
                torch.reshape(dvar, var.shape))


def K(params: KernelParams, X: torch.Tensor, X2: torch.Tensor | None = None,
      *, kind: str = "rbf", kuf_residual: bool = True) -> torch.Tensor:
    """Gram k(X, X2): [..., N, D] x [..., M, D] -> [..., N, M].

    kuf_residual=False keeps even a large gram on plain autograd (the
    full-batch escalation)."""
    _check_kind(kind)
    if X2 is None:
        X2 = X
    ls = kernel_lengthscales(params)
    var = kernel_variance(params)
    if kuf_residual and _use_kuf_residual(X, X2):
        return RbfGramKres.apply(X / ls, X2 / ls, var)
    return var * torch.exp(-0.5 * scaled_squared_distance(X, X2, ls))


def Kdiag(params: KernelParams, X: torch.Tensor, *,
          kind: str = "rbf") -> torch.Tensor:
    """diag k(X, X): [..., N, D] -> [..., N]."""
    _check_kind(kind)
    return torch.broadcast_to(kernel_variance(params), X.shape[:-1])
