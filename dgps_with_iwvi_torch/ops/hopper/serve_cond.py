"""The whole whitened conditional for inference at the bf16x3 / bf16
classes, with an optional sample (kernel K4, ``csrc/serve_cond.cu``).

Replaces ``dgps_with_iwvi_tpu/ops/pallas/serve_cond.py`` ``_infer_kernel``
(l.73, reached through ``fused_conditional_infer``, l.104). Per row n of
the lengthscale-scaled inputs xs [N, d_in], against zs [M, d_in]:

    d2   = max(|x|^2 - 2 dot3(x, z^T) + |z|^2, 0)
    Kxz  = var exp(-d2 / 2)
    A    = dot3(Kxz, Linv^T)
    mean = dot3(A, q_mu)
    qv_d = sum_k (bf16(A) bf16(Lq_d))^2          (f32 accumulation)
    var  = max(var - sum_m A^2, 0) + qv
    samp = mean + sqrt(max(var, 1e-12)) eps      (eps from the caller)

dot3 is the hi/lo bf16 split without the lo*lo term (``precision``'s
``high`` class). Only mean, var and the sample leave the kernel: Kxz and A
never reach device memory.

Inference only, as in the reference (l.116): ``fused_conditional_infer``
raises when autograd would need a gradient through it. The plain version,
``fused_conditional_infer_plain``, rounds at the same places
(``precision.split_bf16`` / ``bf16_dot``); the wrapper takes it for CPU
tensors, or inside ``build.plain_versions()``.
"""

from __future__ import annotations

import ctypes

import torch

from .. import precision
from . import build, cost
from .conditional import _check_inputs, _f32, _ptr

NAME = "serve_cond"


def fused_conditional_infer_plain(xs, zs, var, linv, q_mu, lq, eps=None):
    """(sample, mean, var) with eps [N, D], else (mean, var); f32, plain
    PyTorch with K4's rounding."""
    xs, zs, var, linv, q_mu, lq = _f32(xs, zs, var, linv, q_mu, lq)
    xx = torch.sum(xs * xs, dim=1, keepdim=True)
    zz = torch.sum(zs * zs, dim=1)[None, :]
    d2 = torch.clamp(xx - 2.0 * precision.matmul(xs, zs.T, "high") + zz,
                     min=0.0)
    kxz = var * torch.exp(-0.5 * d2)
    a = precision.matmul(kxz, linv.T, "high")
    mean = precision.matmul(a, q_mu, "high")
    varp = var - torch.sum(a * a, dim=1, keepdim=True)
    t = precision.matmul(a[None], torch.tril(lq), "default")   # [D, N, M]
    v = torch.clamp(varp, min=0.0) + torch.sum(t * t, dim=-1).T
    if eps is None:
        return mean, v
    samp = mean + torch.sqrt(torch.clamp(v, min=1e-12)) * eps.float()
    return samp, mean, v


_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "serve_cond_launch": ([_P] * 11 + [_I] * 5 + [_P], _I),
    "serve_cond_scratch_bytes": ([_I] * 3, ctypes.c_longlong),
    "serve_cond_error_string": ([_I], ctypes.c_char_p),
}


def _launch(xs, zs, var, linv, q_mu, lq, eps):
    _check_inputs(NAME, xs, zs, var, linv, q_mu, lq)
    (n, d_in), m, d = xs.shape, zs.shape[0], q_mu.shape[1]
    if eps is not None and (eps.shape != (n, d) or eps.device != xs.device):
        raise ValueError(f"{NAME}: eps must be [{n}, {d}] on {xs.device}, "
                         f"got {tuple(eps.shape)} on {eps.device}")
    lib = build.library(NAME, SIGNATURES)
    f32 = dict(dtype=torch.float32, device=xs.device)
    mean, v = torch.empty((n, d), **f32), torch.empty((n, d), **f32)
    samp = torch.empty((n, d), **f32) if eps is not None else None
    scratch = torch.empty((lib.serve_cond_scratch_bytes(d_in, m, d),),
                          dtype=torch.uint8, device=xs.device)
    ins = [t.contiguous() for t in (xs, zs, var.reshape(1), linv, q_mu, lq)]
    eps = eps.contiguous() if eps is not None else None
    stream = torch.cuda.current_stream(xs.device).cuda_stream
    err = lib.serve_cond_launch(
        *(_ptr(t) for t in ins), _ptr(eps), _ptr(mean), _ptr(v), _ptr(samp),
        _ptr(scratch), n, d_in, m, d, xs.device.index or 0, stream)
    build.check(lib, NAME, err)
    sample = eps is not None
    build.count_launch(NAME, "sample" if sample else "infer",
                       cost.serve_cond(n, d_in, m, d, sample))
    return (mean, v) if eps is None else (samp, mean, v)


def needs_grad(*tensors) -> bool:
    """Whether autograd would need a gradient through a function of these
    tensors (None entries ignored)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def fused_conditional_infer(xs, zs, var, linv, q_mu, lq, eps=None):
    """(sample, mean, var) with eps [N, D], else (mean, var), in f32: K4 on
    CUDA, plain on the CPU. Not differentiable: raises where autograd
    would need a gradient through it."""
    if needs_grad(xs, zs, var, linv, q_mu, lq, eps):
        raise RuntimeError(
            "the fused inference conditional (serve_pallas) is not "
            "differentiable; run it under torch.no_grad() or on tensors "
            "that need no gradient")
    xs, zs, var, linv, q_mu, lq = _f32(xs, zs, var, linv, q_mu, lq)
    eps = eps.float() if eps is not None else None
    if build.use_plain(xs):
        return fused_conditional_infer_plain(xs, zs, var, linv, q_mu, lq, eps)
    return _launch(xs, zs, var, linv, q_mu, lq, eps)
