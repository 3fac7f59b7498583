"""Fused conditional epilogue and q-variance quadratic form (kernel K2).

Replaces ``dgps_with_iwvi_tpu/ops/pallas/qvar.py`` ``_epi_kernel``
(l.429, entry ``epi_fused`` l.521) and ``_qvar_kernel`` (l.96, entry
``qvar_fused`` l.125). Both entry points launch ``csrc/epilogue.cu``;
``qvar_fused`` switches the mean and the sum of squares off. For
A ``[..., M, N]``, W ``[D, M, M]`` and q_mu ``[M, D]``:

- ``qv [..., D, N]``: sum_m (W_d^T A)^2 (root, ``cov=False``) or
  sum_m A * (W_d A) (``cov=True``), bf16 operands into f32 accumulation;
- ``ss [..., N]``: sum_m A^2, exact f32;
- ``mean [..., D, N]``: q_mu^T A at the ``high`` (bf16x3) class.

``epi_plain`` / ``qvar_plain`` are the same functions in plain PyTorch,
through ``ops/precision.py``; the wrappers take them for CPU tensors only.
"""

from __future__ import annotations

import ctypes

import torch

from .. import precision
from . import build

NAME = "epilogue"


def qvar_plain(A: torch.Tensor, W: torch.Tensor, cov: bool,
               precision_class: str = "default") -> torch.Tensor:
    """qv [..., D, N] of the quadratic form, plain PyTorch."""
    Ax = A[..., None, :, :]                                 # [..., 1, M, N]
    Wk = W if cov else W.transpose(-1, -2)
    T = precision.matmul(Wk, Ax, precision_class)           # [..., D, M, N]
    if cov:
        return torch.sum(Ax * T, dim=-2)
    return torch.sum(T * T, dim=-2)


def epi_plain(A: torch.Tensor, W: torch.Tensor, q_mu: torch.Tensor,
              cov: bool):
    """(qv [..., D, N], ss [..., N], mean [..., D, N]), plain PyTorch."""
    qv = qvar_plain(A, W, cov)
    ss = torch.sum(A * A, dim=-2)
    mean = precision.matmul(q_mu.transpose(0, 1), A, "high")
    return qv, ss, mean


_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "epilogue_launch": ([_P] * 7 + [_I] * 6 + [_P], _I),
    "epilogue_wop_elems": ([_I, _I], ctypes.c_longlong),
    "epilogue_error_string": ([_I], ctypes.c_char_p),
}


def _launch(A, W, q_mu, cov: bool, with_ss: bool):
    if A.device.type != "cuda":
        raise ValueError(f"the epilogue kernel runs on cuda, got {A.device}")
    lib = build.library(NAME, SIGNATURES)
    lead, (m, n) = A.shape[:-2], A.shape[-2:]
    d = W.shape[0]
    named = [("A", A), ("W", W)] + ([("q_mu", q_mu)] if q_mu is not None
                                    else [])
    for name, t in named:
        if t.dtype != torch.float32 or t.device != A.device:
            raise TypeError(f"epilogue kernel: {name} must be float32 on "
                            f"{A.device}, got {t.dtype} on {t.device}")
    if W.shape != (d, m, m):
        raise ValueError(f"epilogue kernel takes W [D, M, M] for A [..., M, "
                         f"N]; got A {tuple(A.shape)}, W {tuple(W.shape)}")
    if q_mu is not None and q_mu.shape != (m, d):
        raise ValueError(f"q_mu must be [{m}, {d}], got {tuple(q_mu.shape)}")
    L = 1
    for s in lead:
        L *= s
    Ac = A.contiguous().reshape(L, m, n)
    Wc = W.contiguous()
    qc = q_mu.contiguous() if q_mu is not None else None
    f32 = dict(dtype=torch.float32, device=A.device)
    qv = torch.empty((L, d, n), **f32)
    ss = torch.empty((L, n), **f32) if with_ss else None
    mean = torch.empty((L, d, n), **f32) if q_mu is not None else None
    wop = torch.empty((lib.epilogue_wop_elems(m, d),), dtype=torch.bfloat16,
                      device=A.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    stream = torch.cuda.current_stream(A.device).cuda_stream
    err = lib.epilogue_launch(ptr(Ac), ptr(Wc), ptr(qc), ptr(qv), ptr(ss),
                              ptr(mean), ptr(wop), L, m, n, d, int(cov),
                              A.device.index or 0, stream)
    build.check(lib, NAME, err)
    build.count_launch(NAME)
    qv = qv.reshape(lead + (d, n))
    ss = ss.reshape(lead + (n,)) if with_ss else None
    mean = mean.reshape(lead + (d, n)) if mean is not None else None
    return qv, ss, mean


def epi_fused(A: torch.Tensor, W: torch.Tensor, q_mu: torch.Tensor,
              cov: bool = False):
    """(qv, ss, mean): the kernel on CUDA, plain on the CPU."""
    if build.use_plain(A):
        return epi_plain(A, W, q_mu, cov)
    return _launch(A, W, q_mu, cov, with_ss=True)


def qvar_fused(A: torch.Tensor, W: torch.Tensor,
               cov: bool = False) -> torch.Tensor:
    """qv [..., D, N]: the kernel on CUDA (mean and sum of squares off),
    plain on the CPU."""
    if build.use_plain(A):
        return qvar_plain(A, W, cov)
    return _launch(A, W, None, cov, with_ss=False)[0]
