"""Whitened sparse-variational GP conditionals, forward
(port of dgps_with_iwvi_tpu/ops/conditionals.py).

Whitened semantics: q(v) = N(q_mu, q_sqrt q_sqrt^T), u = Lm v,
Lm = chol(Kuu). Per test point:

    A    = Lm^-1 Kuf                            [..., M, N]
    mean = A^T q_mu                             [..., N, D]
    var  = max(Kff_diag - sum_m A^2, 0)
           + sum_m (q_sqrt_d^T A)^2             [..., N, D] (marginal)

Precision classes follow the reference call site by call site
(``ops/precision.py``): the solve path A = Linv Kuf and the mean at
``solve_precision`` (default ``high``), with the transposed dots of its
backward at ``solve_bwd_precision`` (default: the same class), the
q-variance at ``var_precision`` (default ``default``), the grams at
``highest``.

The epilogue (mean, the prior sum of squares and the q-variance) is one
launch of the K2 kernel, with K3 as its backward (``ops/hopper/qvar.py``
``EpiFusedTrain``), whenever the structural conditions of the reference's
``_maybe_epi_fused`` hold: a 3-D W, q_mu [M, D], float32, the ``default``
q-variance class. The reference picks another variant for inference and
for training and gates both by TPU-measured floors (``EPI_TRAIN``,
``QVAR_PALLAS_TRAIN``, n >= 1024, d*n >= 16384); the port takes the one
Function for both, whose forward is the same K2 launch, and carries no
floor. At ``highest`` (the full-batch escalation) the conditions fail and
the plain path runs, as the reference's overrides make it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import kernels, precision
from .hopper import qvar as qvar_kernel
from .linalg import DEFAULT_JITTER, cholesky_with_jitter, solve_triangular


class ConditionalOut(NamedTuple):
    mean: torch.Tensor  # [..., N, D]
    var: torch.Tensor   # [..., N, D] (marginal)


def safe_sqrt(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """sqrt(max(v, eps)): the gradient-safe standard deviation (sqrt's
    infinite derivative at 0 would give inf * 0 = NaN backward)."""
    return torch.sqrt(torch.clamp(v, min=eps))


def _kernel_epilogue_ok(A, W, q_mu, var_precision) -> bool:
    """Structural conditions for K2/K3 (reference ``_maybe_epi_fused``)."""
    return (W is not None and W.ndim == 3
            and var_precision == "default"
            and A.dtype == torch.float32 and W.dtype == torch.float32
            and W.shape[-1] == A.shape[-2]
            and (q_mu is None or (q_mu.ndim == 2
                                  and q_mu.shape == (A.shape[-2], W.shape[0])
                                  and q_mu.dtype == A.dtype)))


def _maybe_epi_fused(A, q_sqrt, q_S, var_precision, q_mu):
    """(qv [..., D, N], sumsq [..., N], mean [..., D, N]) from one K2
    launch (backward: K3), or None when the separate-op composition
    applies."""
    if q_S is not None and q_S.ndim == 3:
        W, cov = q_S, True
    elif q_S is None and q_sqrt is not None and q_sqrt.ndim == 3:
        W, cov = torch.tril(q_sqrt), False
    else:
        return None
    if not _kernel_epilogue_ok(A, W, q_mu, var_precision):
        return None
    # the tril stays outside the Function: its backward masks the dense dW
    # back onto the triangle
    return qvar_kernel.EpiFusedTrain.apply(A, W, q_mu, cov)


def _q_variance(A: torch.Tensor, q_sqrt, q_S,
                var_precision: str | None) -> torch.Tensor:
    """diag of the q-covariance quadratic form: A [..., M, N] -> [..., N, D].

    - q_S [D, M, M]: covariance form, sum_M A * (S A)
    - q_S [M, D]: diagonal covariance form (variances)
    - q_sqrt [D, M, M]: root form, sum_M (q_sqrt^T A)^2
    - q_sqrt [M, D]: q_diag scales, (A^2)^T s^2
    """
    if q_S is not None:
        if q_S.ndim == 2:
            return precision.matmul(torch.square(A).transpose(-1, -2), q_S,
                                    var_precision)
        W, cov = q_S, True
    else:
        if q_sqrt.ndim == 2:
            return precision.matmul(torch.square(A).transpose(-1, -2),
                                    torch.square(q_sqrt), var_precision)
        W, cov = torch.tril(q_sqrt), False
    if _kernel_epilogue_ok(A, W, None, var_precision):
        qv = qvar_kernel.QvarFusedTrain.apply(A, W, cov)
    else:
        qv = qvar_kernel.qvar_plain(A, W, cov, var_precision)
    return qv.transpose(-1, -2)


def base_conditional_whitened(
    Kuf: torch.Tensor,        # [..., M, N]
    Lm: torch.Tensor,         # [M, M] lower Cholesky of Kuu (+jitter)
    Kff_diag: torch.Tensor,   # [..., N]
    q_mu: torch.Tensor,       # [M, D]
    q_sqrt: torch.Tensor,     # [D, M, M] lower-triangular (or [M, D] q_diag)
    var_precision: str | None = None,
    Linv: torch.Tensor | None = None,
    q_S: torch.Tensor | None = None,
    solve_precision: str | None = None,
    *,
    solve_bwd_precision: str | None = None,
) -> ConditionalOut:
    """Whitened marginal conditional; broadcasts over leading axes of Kuf."""
    m = Lm.shape[-1]
    n_cols = 1
    for s in (*Kuf.shape[:-2], Kuf.shape[-1]):
        n_cols *= s
    if Linv is None and Lm.ndim == 2 and n_cols >= 4 * m:
        Linv = solve_triangular(
            Lm, torch.eye(m, dtype=Lm.dtype, device=Lm.device), lower=True)
    if Linv is not None:
        A = precision.matmul(Linv, Kuf, solve_precision,      # [..., M, N]
                             solve_bwd_precision)
    else:
        A = solve_triangular(Lm, Kuf, lower=True)
    epi = _maybe_epi_fused(A, q_sqrt, q_S, var_precision, q_mu)
    if epi is not None:
        qv, ss, mn = epi
        fvar_prior = torch.clamp(Kff_diag - ss, min=0.0)
        return ConditionalOut(mn.transpose(-1, -2),
                              fvar_prior[..., None] + qv.transpose(-1, -2))
    mean = precision.matmul(A.transpose(-1, -2), q_mu, solve_precision,
                            solve_bwd_precision)
    # Kff - Qff >= 0 mathematically; rounding can push it below
    fvar_prior = torch.clamp(
        Kff_diag - torch.sum(torch.square(A), dim=-2), min=0.0)
    fvar_q = _q_variance(A, q_sqrt, q_S, var_precision)
    return ConditionalOut(mean, fvar_prior[..., None] + fvar_q)


def conditional(
    X: torch.Tensor,          # [..., N, D_in]
    Z: torch.Tensor,          # [M, D_in]
    kernel_params,
    q_mu: torch.Tensor,       # [M, D_out]
    q_sqrt: torch.Tensor,     # [D_out, M, M]
    *,
    kernel_kind: str = "rbf",
    jitter: float = DEFAULT_JITTER,
    Lm: torch.Tensor | None = None,
    Linv: torch.Tensor | None = None,
    jitter_tries: int = 4,
    white: bool = True,
    var_precision: str | None = None,
    q_S: torch.Tensor | None = None,
    solve_precision: str | None = None,
    solve_bwd_precision: str | None = None,
    kuf_residual: bool = True,
) -> ConditionalOut:
    """End-to-end whitened conditional: grams -> chol -> solve -> moments.

    Inducing points only; the non-whitened parameterization and the
    multiscale features wait for ROADMAP queue 8. kuf_residual: whether
    the cross gram may keep its output as its backward residual
    (``ops/kernels.py``)."""
    if not white:
        raise NotImplementedError(
            "the non-whitened conditional is not ported yet (ROADMAP "
            "queue 8)")
    if Lm is None:
        Kuu = kernels.K(kernel_params, Z, Z, kind=kernel_kind)
        Lm = cholesky_with_jitter(Kuu, jitter, max_tries=jitter_tries)
    Kuf = kernels.K(kernel_params, Z, X, kind=kernel_kind,     # [..., M, N]
                    kuf_residual=kuf_residual)
    Kff_diag = kernels.Kdiag(kernel_params, X, kind=kernel_kind)
    return base_conditional_whitened(
        Kuf, Lm, Kff_diag, q_mu, q_sqrt, var_precision=var_precision,
        Linv=Linv, q_S=q_S, solve_precision=solve_precision,
        solve_bwd_precision=solve_bwd_precision)
