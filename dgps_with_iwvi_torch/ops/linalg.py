"""Jitter-stabilized dense linear algebra (port of dgps_with_iwvi_tpu/ops/linalg.py).

Cholesky of K + jitter*I with 10x jitter escalation: the factor at the
base jitter is used where it is usable (finite, positive diagonal), else
the first usable level of the ladder jitter * 10^t, t < max_tries (falling
through to the last level when none is usable). The reference factors
once and re-factors the whole batch on failure (``linalg.py:96-180``); the
port factors all levels at once, in one launch of the K1 kernel on the
card (``ops/hopper/chol.py``), and selects per matrix. The values are the
same, fast path and rescue alike, and no host sync is needed to decide.

``chol_and_inverse`` is a ``torch.autograd.Function`` whose backward is
the reference's matmul-only pullback at ``highest`` (``linalg.py:234-257``),
evaluated at the selected ladder level: the forward already produced
Linv, so no triangular solve runs backward.
"""

from __future__ import annotations

import torch

from . import precision
from .hopper import chol as chol_kernel

DEFAULT_JITTER = 1e-6


def add_jitter(K: torch.Tensor, jitter: float) -> torch.Tensor:
    """K + jitter * I on the trailing [..., M, M] axes."""
    m = K.shape[-1]
    return K + jitter * torch.eye(m, dtype=K.dtype, device=K.device)


def _chol_ok(L: torch.Tensor) -> torch.Tensor:
    """True where a Cholesky factor is usable: finite, positive diagonal."""
    diag = torch.diagonal(L, dim1=-2, dim2=-1)
    return torch.all(torch.isfinite(diag) & (diag > 0), dim=-1)


def _jitter_ladder(jitter: float, max_tries: int, dtype,
                   device) -> torch.Tensor:
    """[T] jitters jitter * 10^t in K's dtype, as the reference's rescue
    computes them (``jitter * 10.0 ** level``)."""
    levels = torch.arange(max_tries, dtype=dtype, device=device)
    return jitter * (10.0 ** levels)


def _first_ok_level(L_all: torch.Tensor) -> torch.Tensor:
    """[*batch] index of the first usable ladder level (the last level when
    none is usable), from factors [T, *batch, M, M]."""
    ok = _chol_ok(L_all)                                   # [T, *batch]
    t = ok.shape[0]
    first = torch.argmax(ok.to(torch.int8), dim=0)         # first True
    return torch.where(torch.any(ok, dim=0), first,
                       torch.full_like(first, t - 1))


def _pick(X_all: torch.Tensor, level: torch.Tensor) -> torch.Tensor:
    """X_all [T, *batch, M, M] at a per-element level [*batch]."""
    idx = level[None, ..., None, None].expand((1,) + X_all.shape[1:])
    return torch.gather(X_all, 0, idx)[0]


def _select_jitter(K: torch.Tensor, jitter: float,
                   max_tries: int) -> torch.Tensor:
    """The jitter the ladder selects per matrix, shape = K's batch shape."""
    jitters = _jitter_ladder(jitter, max_tries, K.dtype, K.device)
    L_all, _ = chol_kernel.chol_inv(K, jitters)
    return jitters[_first_ok_level(L_all)]


def _mm(a, b):
    return precision.matmul(a, b, "highest")


class CholAndInverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, K, jitter, max_tries):
        jitters = _jitter_ladder(jitter, max_tries, K.dtype, K.device)
        L_all, Linv_all = chol_kernel.chol_inv(K, jitters)
        level = _first_ok_level(L_all)
        L, Linv = _pick(L_all, level), _pick(Linv_all, level)
        ctx.save_for_backward(L, Linv)
        return L, Linv

    @staticmethod
    def backward(ctx, L_bar, Linv_bar):
        L, Linv = ctx.saved_tensors
        LinvT = Linv.transpose(-1, -2)
        # pullback of Linv = L^-1: <Linv_bar, -Linv dL Linv>
        L_bar = torch.tril(L_bar) - torch.tril(
            _mm(LinvT, _mm(Linv_bar, LinvT)))
        # the Cholesky pullback at L, with the solves replaced by Linv
        M = _mm(L.transpose(-1, -2), L_bar)
        eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
        phi = torch.tril(M) - 0.5 * M * eye
        K_bar = _mm(LinvT, _mm(phi, Linv))
        return 0.5 * (K_bar + K_bar.transpose(-1, -2)), None, None


def chol_and_inverse(K: torch.Tensor, jitter: float = DEFAULT_JITTER,
                     max_tries: int = 4):
    """(L, L^-1) of K + jitter*I with the escalation ladder; K [..., M, M].
    Differentiable in K (matmul-only backward)."""
    return CholAndInverse.apply(K, jitter, max_tries)


def cholesky_with_jitter(K: torch.Tensor, jitter: float = DEFAULT_JITTER,
                         max_tries: int = 4) -> torch.Tensor:
    """Cholesky of K + jitter*I with the escalation ladder. max_tries=1 is
    one fixed-jitter factorization whose failure leaves a non-finite or
    non-positive diagonal."""
    return chol_and_inverse(K, jitter, max_tries)[0]


def solve_triangular(L: torch.Tensor, B: torch.Tensor, *, lower: bool = True,
                     trans: bool = False) -> torch.Tensor:
    """op(L) X = B, broadcasting over batch axes (reference convention)."""
    if trans:
        L = L.transpose(-1, -2)
        lower = not lower
    if L.ndim == 2 and B.ndim > 2:
        # fold the batch axes into the columns: one wide solve
        batch, (m, n) = B.shape[:-2], B.shape[-2:]
        Bw = torch.movedim(B, -2, 0).reshape(m, -1)
        Xw = torch.linalg.solve_triangular(L, Bw, upper=not lower)
        return torch.movedim(Xw.reshape((m,) + batch + (n,)), 0, -2)
    return torch.linalg.solve_triangular(L, B, upper=not lower)


def cho_solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve (L L^T) X = B given the lower Cholesky factor L."""
    y = solve_triangular(L, B, lower=True)
    return solve_triangular(L, y, lower=True, trans=True)


def log_det_from_chol(L: torch.Tensor) -> torch.Tensor:
    """log det(L L^T) = 2 sum(log diag L), batched."""
    return 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)),
                           dim=-1)
