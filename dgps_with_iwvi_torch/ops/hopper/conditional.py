"""The whole whitened conditional at true f32, with an optional in-kernel
sample (kernel K5, ``csrc/conditional.cu``).

Replaces ``dgps_with_iwvi_tpu/ops/pallas/conditional.py`` ``_fused_kernel``
(l.51, variant ``fused``) and ``_sample_kernel`` (l.93, variant
``sample``). Per row n of the lengthscale-scaled inputs xs [N, d_in],
against the scaled inducing points zs [M, d_in]:

    d2   = max(|x|^2 - 2 x.z + |z|^2, 0)
    Kxz  = var exp(-d2 / 2)                      [N, M]
    A    = Kxz Linv^T                            [N, M]
    mean = A q_mu                                [N, D]
    var  = var - sum_m A^2 + sum_m (A Lq_d)^2    [N, D]   (no clamp)

every product in true f32 (the reference runs each dot at HIGHEST, and
TF32 is none of the port's classes). ``sample`` adds
mean + sqrt(max(var, 0)) eps with eps from Box-Muller on a counter-based
Philox4x32-10 stream: key = the 64-bit seed, counter = (row, column, 0, 0),
so the stream does not depend on the tile size. The reference's stream is
the TPU's on-core generator and cannot be reproduced; the port's is, by
``philox_normal`` here.

Kxz and A are written as the backward's residuals only when autograd
needs them. The backward is the reference's ``_bwd`` (l.268-298) and
``_sample_bwd`` (l.229-240) in plain f32 PyTorch (XLA in the reference,
outside any Pallas kernel): ``FusedConditional`` and
``FusedConditionalSample``.

``*_plain`` are the same forwards in plain PyTorch; the wrappers take them
for CPU tensors, or inside ``build.plain_versions()``. Every entry casts its
inputs to f32, as the reference does (``_fused_forward`` l.130-132), and
the Functions return in the caller's dtype.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import precision
from . import build, cost

NAME = "conditional"

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _f32(*ts):
    return [t.to(torch.float32) for t in ts]


def _mm(a, b):
    return precision.matmul(a, b, "highest")


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit words of a * m for uint32 values `a` held in int64
    and a 32-bit constant m, without leaving the int64 range."""
    p1 = (a & 0xFFFF) * m                     # < 2^48
    p2 = (a >> 16) * m                        # < 2^48
    low = p1 + ((p2 & 0xFFFF) << 16)          # < 2^49
    return (p2 >> 16) + (low >> 32), low & _MASK32


def philox4x32(c0, c1, c2, c3, k0, k1, rounds: int = 10):
    """Philox4x32-R (Salmon et al., SC'11) on uint32 words held in int64
    tensors (or ints): the counter (c0, c1, c2, c3) under the key (k0, k1)."""
    for r in range(rounds):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _MASK32
            k1 = (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_normal(seed: torch.Tensor, n: int, d: int,
                  device=None, stream: int = 0) -> torch.Tensor:
    """[n, d] f32 standard normals of K5's stream: Philox4x32-10 with key =
    the int64 seed's (low, high) words and counter = (row, column,
    stream, 0); the top 24 bits of the first two words make u1 (+1e-12)
    and u2, and eps = sqrt(-2 log u1) cos(2 pi u2), the reference's
    Box-Muller. K5 draws stream 0; another stream is another, independent
    sequence under the same seed."""
    device = seed.device if device is None else device
    seed = seed.to(device=device, dtype=torch.int64).reshape(())
    rows = torch.arange(n, dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(d, dtype=torch.int64, device=device)[None, :]
    rows, cols = torch.broadcast_tensors(rows, cols)
    zero = torch.zeros_like(rows)
    b1, b2, _, _ = philox4x32(rows, cols, zero + stream, zero,
                              seed & _MASK32, (seed >> 32) & _MASK32)
    u1 = (b1 >> 8).to(torch.float32) * (1.0 / 16777216.0) + 1e-12
    u2 = (b2 >> 8).to(torch.float32) * (1.0 / 16777216.0)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)


def fused_conditional_plain(xs, zs, var, linv, q_mu, lq):
    """(mean [N, D], var [N, D], Kxz [N, M], A [N, M]) in f32, plain
    PyTorch at the ``highest`` class."""
    xs, zs, var, linv, q_mu, lq = _f32(xs, zs, var, linv, q_mu, lq)
    xx = torch.sum(xs * xs, dim=1, keepdim=True)
    zz = torch.sum(zs * zs, dim=1)[None, :]
    d2 = torch.clamp(xx - 2.0 * _mm(xs, zs.T) + zz, min=0.0)
    kxz = var * torch.exp(-0.5 * d2)
    a = _mm(kxz, linv.T)
    mean = _mm(a, q_mu)
    varp = var - torch.sum(a * a, dim=1, keepdim=True)
    t = _mm(a[None], torch.tril(lq))                        # [D, N, M]
    return mean, varp + torch.sum(t * t, dim=-1).T, kxz, a


def fused_conditional_sample_plain(xs, zs, var, linv, q_mu, lq, seed):
    """(sample, mean, var, Kxz, A) in f32: ``fused_conditional_plain`` plus
    mean + sqrt(max(var, 0)) eps with eps = ``philox_normal(seed)``."""
    mean, v, kxz, a = fused_conditional_plain(xs, zs, var, linv, q_mu, lq)
    eps = philox_normal(seed, mean.shape[0], mean.shape[1], mean.device)
    return mean + torch.sqrt(torch.clamp(v, min=0.0)) * eps, mean, v, kxz, a


_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "conditional_launch": ([_P] * 13 + [_I] * 5 + [_P], _I),
    "conditional_scratch_bytes": ([_I] * 3, ctypes.c_longlong),
    "conditional_error_string": ([_I], ctypes.c_char_p),
}


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_inputs(kernel, xs, zs, var, linv, q_mu, lq):
    """Device, dtype and shape checks shared by K4 and K5."""
    if xs.device.type != "cuda":
        raise ValueError(f"the {kernel} kernel runs on cuda, got {xs.device}")
    if xs.ndim != 2 or zs.ndim != 2 or zs.shape[1] != xs.shape[1]:
        raise ValueError(f"{kernel}: xs [N, d_in] and zs [M, d_in], got "
                         f"{tuple(xs.shape)}, {tuple(zs.shape)}")
    m, d = zs.shape[0], q_mu.shape[-1]
    if (var.numel() != 1 or linv.shape != (m, m) or q_mu.shape != (m, d)
            or lq.shape != (d, m, m)):
        raise ValueError(f"{kernel}: var [], Linv [{m}, {m}], q_mu [{m}, D], "
                         f"Lq [D, {m}, {m}]; got {tuple(var.shape)}, "
                         f"{tuple(linv.shape)}, {tuple(q_mu.shape)}, "
                         f"{tuple(lq.shape)}")
    for name, t in (("zs", zs), ("var", var), ("linv", linv), ("q_mu", q_mu),
                    ("lq", lq)):
        if t.device != xs.device:
            raise ValueError(f"{kernel}: {name} is on {t.device}, xs on "
                             f"{xs.device}")


def _launch(xs, zs, var, linv, q_mu, lq, seed, residuals: bool):
    _check_inputs(NAME, xs, zs, var, linv, q_mu, lq)
    lib = build.library(NAME, SIGNATURES)
    (n, d_in), m, d = xs.shape, zs.shape[0], q_mu.shape[1]
    f32 = dict(dtype=torch.float32, device=xs.device)
    mean, v = torch.empty((n, d), **f32), torch.empty((n, d), **f32)
    samp = torch.empty((n, d), **f32) if seed is not None else None
    kxz = torch.empty((n, m), **f32) if residuals else None
    a = torch.empty((n, m), **f32) if residuals else None
    if seed is not None:
        seed = seed.to(device=xs.device, dtype=torch.int64).reshape(1)
    scratch = torch.empty((lib.conditional_scratch_bytes(d_in, m, d),),
                          dtype=torch.uint8, device=xs.device)
    ins = [t.contiguous() for t in (xs, zs, var.reshape(1), linv, q_mu, lq)]
    stream = torch.cuda.current_stream(xs.device).cuda_stream
    err = lib.conditional_launch(
        *(_ptr(t) for t in ins), _ptr(seed), _ptr(mean), _ptr(v), _ptr(samp),
        _ptr(kxz), _ptr(a), _ptr(scratch), n, d_in, m, d,
        xs.device.index or 0, stream)
    build.check(lib, NAME, err)
    sample = seed is not None
    build.count_launch(NAME, "sample" if sample else "fused",
                       cost.conditional(n, d_in, m, d, sample, residuals))
    return mean, v, samp, kxz, a


def fused_forward(xs, zs, var, linv, q_mu, lq, seed=None, *,
                  residuals: bool = True):
    """(mean, var, sample, Kxz, A) in f32 of either variant (sample None
    without a seed; Kxz and A None without residuals): K5 on CUDA, plain on
    the CPU."""
    xs, zs, var, linv, q_mu, lq = _f32(xs, zs, var, linv, q_mu, lq)
    if build.use_plain(xs):
        if seed is None:
            mean, v, kxz, a = fused_conditional_plain(xs, zs, var, linv,
                                                      q_mu, lq)
            samp = None
        else:
            samp, mean, v, kxz, a = fused_conditional_sample_plain(
                xs, zs, var, linv, q_mu, lq, seed)
        if not residuals:
            kxz = a = None
        return mean, v, samp, kxz, a
    return _launch(xs, zs, var, linv, q_mu, lq, seed, residuals)


def fused_backward(xs, zs, var, linv, q_mu, lq, kxz, a, g_mean, g_var):
    """Cotangents (xs, zs, var, Linv, q_mu, Lq) of (mean, var): the
    reference's ``_bwd`` in f32 at ``highest``; d_Lq is projected onto the
    lower triangle."""
    xs, zs, var, linv, q_mu, lq, g_mean, g_var = _f32(
        xs, zs, var, linv, q_mu, lq, g_mean, g_var)
    lq_t = torch.tril(lq)
    gv_sum = torch.sum(g_var, dim=1, keepdim=True)          # [N, 1]
    d_qmu = _mm(a.T, g_mean)                                # [M, D]
    bd = _mm(a[None], lq_t)                                 # [D, N, M]
    wbd = 2.0 * bd * g_var.T[:, :, None]
    d_lq = torch.tril(_mm(a.T[None], wbd))                  # [D, M, M]
    dA = (_mm(g_mean, q_mu.T) - 2.0 * a * gv_sum
          + torch.sum(_mm(wbd, lq_t.transpose(-1, -2)), dim=0))
    d_linv = _mm(dA.T, kxz)
    d_kxz = _mm(dA, linv)
    d_var = torch.sum(d_kxz * kxz) / var + torch.sum(gv_sum)
    d_d2 = -0.5 * kxz * d_kxz
    row = torch.sum(d_d2, dim=1, keepdim=True)
    col = torch.sum(d_d2, dim=0, keepdim=True)
    d_xs = 2.0 * xs * row - 2.0 * _mm(d_d2, zs)
    d_zs = 2.0 * zs * col.T - 2.0 * _mm(d_d2.T, xs)
    return d_xs, d_zs, d_var.reshape(var.shape), d_linv, d_qmu, d_lq


def sample_backward(xs, zs, var, linv, q_mu, lq, kxz, a, mean, v, samp,
                    g_samp, g_mean, g_var):
    """Cotangents of (sample, mean, var): the reference's ``_sample_bwd``.
    eps is recovered from the saved primals, not replayed; the seed gets
    no gradient."""
    sd = torch.sqrt(torch.clamp(v, min=0.0))
    safe = torch.clamp(sd, min=1e-30)
    eps = torch.where(sd > 0, (samp - mean) / safe, torch.zeros_like(sd))
    g_mean = g_mean + g_samp
    g_var = g_var + torch.where(sd > 0, g_samp * eps / (2.0 * safe),
                                torch.zeros_like(sd))
    return fused_backward(xs, zs, var, linv, q_mu, lq, kxz, a, g_mean, g_var)


def _cast_grads(grads, inputs):
    return tuple(g.to(t.dtype) for g, t in zip(grads, inputs))


class FusedConditional(torch.autograd.Function):
    """(mean, var) of the whole conditional: forward K5 ``fused``,
    backward the reference's ``_bwd`` in plain f32."""

    @staticmethod
    def forward(ctx, xs, zs, var, linv, q_mu, lq):
        residuals = any(ctx.needs_input_grad)
        mean, v, _, kxz, a = fused_forward(xs, zs, var, linv, q_mu, lq,
                                           residuals=residuals)
        if residuals:
            ctx.save_for_backward(xs, zs, var, linv, q_mu, lq, kxz, a)
        return mean.to(xs.dtype), v.to(xs.dtype)

    @staticmethod
    def backward(ctx, g_mean, g_var):
        saved = ctx.saved_tensors
        return _cast_grads(fused_backward(*saved, g_mean, g_var), saved[:6])


class FusedConditionalSample(torch.autograd.Function):
    """(sample, mean, var): forward K5 ``sample``, backward the reference's
    ``_sample_bwd`` in plain f32."""

    @staticmethod
    def forward(ctx, xs, zs, var, linv, q_mu, lq, seed):
        residuals = any(ctx.needs_input_grad)
        mean, v, samp, kxz, a = fused_forward(xs, zs, var, linv, q_mu, lq,
                                              seed, residuals=residuals)
        if residuals:
            ctx.save_for_backward(xs, zs, var, linv, q_mu, lq, kxz, a, mean,
                                  v, samp)
        dtype = xs.dtype
        return samp.to(dtype), mean.to(dtype), v.to(dtype)

    @staticmethod
    def backward(ctx, g_samp, g_mean, g_var):
        saved = ctx.saved_tensors
        grads = sample_backward(*saved, g_samp.float(), g_mean.float(),
                                g_var.float())
        return (*_cast_grads(grads, saved[:6]), None)


def fused_conditional(xs, zs, var, linv, q_mu, lq):
    """(mean [N, D], var [N, D]) in xs's dtype, differentiable in all six
    inputs."""
    return FusedConditional.apply(xs, zs, var, linv, q_mu, lq)


def fused_conditional_sample(xs, zs, var, linv, q_mu, lq, seed):
    """(sample, mean, var), each [N, D] in xs's dtype; `seed` an int64
    tensor (no gradient)."""
    return FusedConditionalSample.apply(xs, zs, var, linv, q_mu, lq, seed)
