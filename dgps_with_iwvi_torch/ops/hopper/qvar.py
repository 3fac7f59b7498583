"""Fused conditional epilogue, forward (kernel K2) and backward (K3).

Forward, ``csrc/epilogue.cu``: replaces ``dgps_with_iwvi_tpu/ops/pallas/
qvar.py`` ``_epi_kernel`` (l.429, entry ``epi_fused``), ``_ps_kernel``
(l.437, ``ps_fused``, the mean off) and ``_qvar_kernel`` (l.96,
``qvar_fused``, the mean and the sum of squares off). For A ``[..., M,
N]``, W ``[D, M, M]`` and q_mu ``[M, D]``:

- ``qv [..., D, N]``: sum_m (W_d^T A)^2 (root, ``cov=False``) or
  sum_m A * (W_d A) (``cov=True``), bf16 operands into f32 accumulation;
- ``ss [..., N]``: sum_m A^2, exact f32;
- ``mean [..., D, N]``: q_mu^T A at the ``high`` (bf16x3) class.

Backward, ``csrc/epilogue_bwd.cu``: replaces ``_epi_bwd_kernel`` (l.567,
``epi_bwd_fused``), ``_ps_bwd_kernel`` (l.685, ``ps_bwd_fused``) and
``_qvar_bwd_kernel`` (l.224, ``qvar_bwd_fused``), with the Pallas kernels'
rounding: A and W_d to bf16 into f32 products; root T = W_d^T a,
dt = bf16(2 g_d T), dA += W_d dt, dW_d += a dt^T; covariance
ga = bf16(a g_d), dA += g_d (W_d a) + W_d^T ga, dW_d += ga a^T (no
symmetry of S assumed); dA += 2 a g_ss in f32; the mean terms
dA += q_mu g_mn and dq_mu += a g_mn^T at bf16x3.

``EpiFusedTrain``, ``PsFusedTrain`` and ``QvarFusedTrain`` are the
autograd Functions (forward K2, backward K3) the conditional takes.
``*_plain`` are the same functions in plain PyTorch through
``ops/precision.py``; the wrappers take them for CPU tensors, or inside
``build.plain_versions()``.
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


def ps_plain(A: torch.Tensor, W: torch.Tensor, cov: bool):
    """(qv [..., D, N], ss [..., N]), plain PyTorch."""
    return qvar_plain(A, W, cov), torch.sum(A * A, dim=-2)


def epi_plain(A: torch.Tensor, W: torch.Tensor, q_mu: torch.Tensor,
              cov: bool):
    """(qv [..., D, N], ss [..., N], mean [..., D, N]), plain PyTorch."""
    qv, ss = ps_plain(A, W, cov)
    mean = precision.matmul(q_mu.transpose(0, 1), A, "high")
    return qv, ss, mean


def _sum_over_columns(X: torch.Tensor, Y: torch.Tensor,
                      cls: str) -> torch.Tensor:
    """sum over the lead axes and n of X[..., a, p, n] Y[..., b, q, n]
    -> [max(a, b), P, Q], at class `cls`."""
    def fold(T):  # [..., c, R, N] -> [c, R, lead * N]
        c, r, n = T.shape[-3:]
        return T.reshape(-1, c, r, n).permute(1, 2, 0, 3).reshape(c, r, -1)
    return precision.matmul(fold(X), fold(Y).transpose(-1, -2), cls)


def qvar_bwd_plain(A: torch.Tensor, W: torch.Tensor, g: torch.Tensor,
                   cov: bool):
    """(dA [..., M, N], dW [D, M, M]) of sum(qv * g), plain PyTorch with
    K3's rounding."""
    Ax = A[..., None, :, :]                                 # [..., 1, M, N]
    gx = g[..., :, None, :]                                 # [..., D, 1, N]
    if cov:
        sa = precision.matmul(W, Ax, "default")
        ga = precision.round_bf16(Ax * gx)
        dA = torch.sum(gx * sa + precision.matmul(W.transpose(-1, -2), ga,
                                                  "default"), dim=-3)
        return dA, _sum_over_columns(ga, Ax, "default")
    T = precision.matmul(W.transpose(-1, -2), Ax, "default")
    dt = precision.round_bf16(2.0 * gx * T)
    dA = torch.sum(precision.matmul(W, dt, "default"), dim=-3)
    return dA, _sum_over_columns(Ax, dt, "default")


def ps_bwd_plain(A, W, g_qv, g_ss, cov: bool):
    """(dA, dW) of the mean-less epilogue, plain PyTorch."""
    dA_q, dW = qvar_bwd_plain(A, W, g_qv, cov)
    return 2.0 * A * g_ss[..., None, :] + dA_q, dW


def epi_bwd_plain(A, W, q_mu, g_qv, g_ss, g_mn, cov: bool):
    """(dA, dW, dq_mu) of the whole epilogue, plain PyTorch."""
    dA_q, dW = qvar_bwd_plain(A, W, g_qv, cov)
    dA = (2.0 * A * g_ss[..., None, :]
          + precision.matmul(q_mu, g_mn, "high")) + dA_q
    dq_mu = _sum_over_columns(A[..., None, :, :],
                              g_mn[..., None, :, :], "high")[0]
    return dA, dW, dq_mu


_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "epilogue_launch": ([_P] * 7 + [_I] * 6 + [_P], _I),
    "epilogue_wop_elems": ([_I, _I], ctypes.c_longlong),
    "epilogue_error_string": ([_I], ctypes.c_char_p),
}
BWD_NAME = "epilogue_bwd"
BWD_SIGNATURES = {
    "epilogue_bwd_launch": ([_P] * 10 + [_I] * 6 + [_P], _I),
    "epilogue_bwd_scratch_bytes": ([_I] * 5, ctypes.c_longlong),
    "epilogue_bwd_error_string": ([_I], ctypes.c_char_p),
}


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(kernel, A, W, q_mu, named):
    """Device, dtype and shape checks shared by K2 and K3; returns the
    flattened lead size L."""
    if A.device.type != "cuda":
        raise ValueError(f"the {kernel} kernel runs on cuda, got {A.device}")
    lead, m = A.shape[:-2], A.shape[-2]
    d = W.shape[0]
    for name, t in [("A", A), ("W", W), ("q_mu", q_mu)] + named:
        if t is not None and (t.dtype != torch.float32
                              or t.device != A.device):
            raise TypeError(f"{kernel} kernel: {name} must be float32 on "
                            f"{A.device}, got {t.dtype} on {t.device}")
    if W.shape != (d, m, m):
        raise ValueError(f"{kernel} kernel takes W [D, M, M] for A [..., M, "
                         f"N]; got A {tuple(A.shape)}, W {tuple(W.shape)}")
    if q_mu is not None and q_mu.shape != (m, d):
        raise ValueError(f"q_mu must be [{m}, {d}], got {tuple(q_mu.shape)}")
    L = 1
    for s in lead:
        L *= s
    return L


_wop_cache: dict = {}
_wop_outgrown: list = []


def _wop_scratch(lib, device, stream: int, m: int, d: int) -> torch.Tensor:
    """K2's bf16 scratch (W's blocks and q_mu's split, written by the call
    itself), kept per (device, stream) and grown as needed: calls on one
    stream run in order, so one buffer serves them all. An outgrown buffer
    is kept, not freed: a CUDA graph captured with it (``utils.graphs``,
    which warms up on its capture stream, so the buffer is made before
    the capture) still writes to it at every replay."""
    elems = lib.epilogue_wop_elems(m, d)
    key = (device.index, stream)
    buf = _wop_cache.get(key)
    if buf is None or buf.numel() < elems:
        if buf is not None:
            _wop_outgrown.append(buf)
        buf = torch.empty((elems,), dtype=torch.bfloat16, device=device)
        _wop_cache[key] = buf
    return buf


def _launch(A, W, q_mu, cov: bool, with_ss: bool):
    L = _check(NAME, A, W, q_mu, [])
    lib = build.library(NAME, SIGNATURES)
    lead, (m, n) = A.shape[:-2], A.shape[-2:]
    d = W.shape[0]
    Ac = A.contiguous().reshape(L, m, n)
    Wc = W.contiguous()
    qc = q_mu.contiguous() if q_mu is not None else None
    f32 = dict(dtype=torch.float32, device=A.device)
    qv = torch.empty((L, d, n), **f32)
    ss = torch.empty((L, n), **f32) if with_ss else None
    mean = torch.empty((L, d, n), **f32) if q_mu is not None else None
    stream = torch.cuda.current_stream(A.device).cuda_stream
    wop = _wop_scratch(lib, A.device, stream, m, d)
    err = lib.epilogue_launch(_ptr(Ac), _ptr(Wc), _ptr(qc), _ptr(qv),
                              _ptr(ss), _ptr(mean), _ptr(wop), L, m, n, d,
                              int(cov), A.device.index or 0, stream)
    build.check(lib, NAME, err)
    build.count_launch(NAME, "epi" if q_mu is not None
                       else "ps" if with_ss else "qvar")
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


def ps_fused(A: torch.Tensor, W: torch.Tensor, cov: bool = False):
    """(qv, ss): the kernel on CUDA (mean off), plain on the CPU."""
    if build.use_plain(A):
        return ps_plain(A, W, cov)
    return _launch(A, W, None, cov, with_ss=True)[:2]


def qvar_fused(A: torch.Tensor, W: torch.Tensor,
               cov: bool = False) -> torch.Tensor:
    """qv [..., D, N]: the kernel on CUDA (mean and sum of squares off),
    plain on the CPU."""
    if build.use_plain(A):
        return qvar_plain(A, W, cov)
    return _launch(A, W, None, cov, with_ss=False)[0]


def _launch_bwd(A, W, q_mu, g_qv, g_ss, g_mn, cov: bool):
    L = _check(BWD_NAME, A, W, q_mu,
               [("g_qv", g_qv), ("g_ss", g_ss), ("g_mn", g_mn)])
    if (q_mu is None) != (g_mn is None) or (g_mn is not None
                                            and g_ss is None):
        raise ValueError("epilogue_bwd takes g_mn with q_mu, and g_ss "
                         "with the mean")
    lib = build.library(BWD_NAME, BWD_SIGNATURES)
    lead, (m, n) = A.shape[:-2], A.shape[-2:]
    d = W.shape[0]
    for name, t, shape in (("g_qv", g_qv, lead + (d, n)),
                           ("g_ss", g_ss, lead + (n,)),
                           ("g_mn", g_mn, lead + (d, n))):
        if t is not None and t.shape != shape:
            raise ValueError(f"{name} must be {tuple(shape)}, got "
                             f"{tuple(t.shape)}")

    def flat(t, shape):
        return None if t is None else t.contiguous().reshape(shape)

    Ac = flat(A, (L, m, n))
    gq, gs, gm = (flat(g_qv, (L, d, n)), flat(g_ss, (L, n)),
                  flat(g_mn, (L, d, n)))
    Wc = W.contiguous()
    qc = q_mu.contiguous() if q_mu is not None else None
    f32 = dict(dtype=torch.float32, device=A.device)
    dA = torch.empty((L, m, n), **f32)
    dW = torch.empty((d, m, m), **f32)
    dq = torch.empty((m, d), **f32) if q_mu is not None else None
    scratch = torch.empty((lib.epilogue_bwd_scratch_bytes(
        L, m, n, d, int(q_mu is not None)),), dtype=torch.uint8,
        device=A.device)
    stream = torch.cuda.current_stream(A.device).cuda_stream
    err = lib.epilogue_bwd_launch(
        _ptr(Ac), _ptr(Wc), _ptr(qc), _ptr(gq), _ptr(gs), _ptr(gm), _ptr(dA),
        _ptr(dW), _ptr(dq), _ptr(scratch), L, m, n, d, int(cov),
        A.device.index or 0, stream)
    build.check(lib, BWD_NAME, err)
    build.count_launch(BWD_NAME, "epi" if q_mu is not None
                       else "ps" if g_ss is not None else "qvar")
    return dA.reshape(A.shape), dW, dq


def epi_bwd_fused(A, W, q_mu, g_qv, g_ss, g_mn, cov: bool = False):
    """(dA, dW, dq_mu): K3 on CUDA, plain on the CPU."""
    if build.use_plain(A):
        return epi_bwd_plain(A, W, q_mu, g_qv, g_ss, g_mn, cov)
    return _launch_bwd(A, W, q_mu, g_qv, g_ss, g_mn, cov)


def ps_bwd_fused(A, W, g_qv, g_ss, cov: bool = False):
    """(dA, dW) of the mean-less epilogue: K3 on CUDA, plain on the CPU."""
    if build.use_plain(A):
        return ps_bwd_plain(A, W, g_qv, g_ss, cov)
    return _launch_bwd(A, W, None, g_qv, g_ss, None, cov)[:2]


def qvar_bwd_fused(A, W, g, cov: bool = False):
    """(dA, dW) of the quadratic form: K3 on CUDA, plain on the CPU."""
    if build.use_plain(A):
        return qvar_bwd_plain(A, W, g, cov)
    return _launch_bwd(A, W, None, g, None, None, cov)[:2]


class EpiFusedTrain(torch.autograd.Function):
    """(qv, ss, mean) of the whole epilogue: forward K2, backward K3."""

    @staticmethod
    def forward(ctx, A, W, q_mu, cov):
        ctx.save_for_backward(A, W, q_mu)
        ctx.cov = cov
        return epi_fused(A, W, q_mu, cov)

    @staticmethod
    def backward(ctx, g_qv, g_ss, g_mn):
        A, W, q_mu = ctx.saved_tensors
        return (*epi_bwd_fused(A, W, q_mu, g_qv, g_ss, g_mn, ctx.cov), None)


class PsFusedTrain(torch.autograd.Function):
    """(qv, ss) of the mean-less epilogue: forward K2, backward K3."""

    @staticmethod
    def forward(ctx, A, W, cov):
        ctx.save_for_backward(A, W)
        ctx.cov = cov
        return ps_fused(A, W, cov)

    @staticmethod
    def backward(ctx, g_qv, g_ss):
        A, W = ctx.saved_tensors
        return (*ps_bwd_fused(A, W, g_qv, g_ss, ctx.cov), None)


class QvarFusedTrain(torch.autograd.Function):
    """qv of the quadratic form: forward K2, backward K3."""

    @staticmethod
    def forward(ctx, A, W, cov):
        ctx.save_for_backward(A, W)
        ctx.cov = cov
        return qvar_fused(A, W, cov)

    @staticmethod
    def backward(ctx, g):
        A, W = ctx.saved_tensors
        return (*qvar_bwd_fused(A, W, g, ctx.cov), None)
