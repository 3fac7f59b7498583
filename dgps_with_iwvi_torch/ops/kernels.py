"""RBF kernel with ARD lengthscales (port of dgps_with_iwvi_tpu/ops/kernels.py).

Forward only, and only the kind the flagship model uses: ``rbf_params``
(l.37), ``scaled_squared_distance`` (l.74) and ``K`` / ``Kdiag``
(l.679, l.707). The gram's custom-vjp residual (``_rbf_gram_kres``,
l.216-263) comes with the training slice; its forward is the same math as
here. Every other kernel kind raises until ROADMAP queue 8 ports the
kernel family.

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


def K(params: KernelParams, X: torch.Tensor, X2: torch.Tensor | None = None,
      *, kind: str = "rbf") -> torch.Tensor:
    """Gram k(X, X2): [..., N, D] x [..., M, D] -> [..., N, M]."""
    _check_kind(kind)
    if X2 is None:
        X2 = X
    ls = kernel_lengthscales(params)
    var = kernel_variance(params)
    return var * torch.exp(-0.5 * scaled_squared_distance(X, X2, ls))


def Kdiag(params: KernelParams, X: torch.Tensor, *,
          kind: str = "rbf") -> torch.Tensor:
    """diag k(X, X): [..., N, D] -> [..., N]."""
    _check_kind(kind)
    return torch.broadcast_to(kernel_variance(params), X.shape[:-1])
