"""Batched Cholesky + triangular inverse over a jitter ladder (kernel K1).

Replaces ``dgps_with_iwvi_tpu/ops/pallas/chol.py`` ``_chol_inv_kernel``
(l.101). ``chol_inv(K, jitters)`` factors ``K[g] + jitters[t] * I`` for
every matrix g and every ladder level t in one launch of
``csrc/chol_inv.cu`` and returns ``(L, Linv)`` of shape ``[T, *batch, M,
M]``. A non-positive pivot leaves a non-finite or non-positive diagonal in
that level's factor, which ``linalg._chol_ok`` rejects.

``chol_inv_plain`` is the same function in plain PyTorch
(``torch.linalg.cholesky_ex`` + ``solve_triangular``, failed factors set
to NaN); the wrapper takes it for CPU tensors only.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, cost

NAME = "chol_inv"


def chol_inv_plain(K: torch.Tensor, jitters: torch.Tensor):
    """(L, Linv) [T, *batch, M, M] of K + jitters[t] * I, plain PyTorch."""
    m = K.shape[-1]
    eye = torch.eye(m, dtype=K.dtype, device=K.device)
    jit = jitters.to(K.dtype).reshape((-1,) + (1,) * K.ndim)
    Kj = K[None] + jit * eye
    L, info = torch.linalg.cholesky_ex(Kj)
    L = torch.where((info == 0)[..., None, None], L,
                    torch.full_like(L, float("nan")))
    Linv = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
    return L, Linv


_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "chol_inv_launch": ([_P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
    "chol_inv_error_string": ([_I], ctypes.c_char_p),
}


def _lib() -> ctypes.CDLL:
    return build.library(NAME, SIGNATURES)


def chol_inv(K: torch.Tensor, jitters: torch.Tensor):
    """(L, Linv) [T, *batch, M, M]: the kernel on CUDA, plain on the CPU."""
    if build.use_plain(K):
        return chol_inv_plain(K, jitters)
    if K.device.type != "cuda":
        raise ValueError(f"chol_inv runs on cuda or cpu, got {K.device}")
    if K.dtype != torch.float32:
        raise TypeError(f"the chol_inv kernel is float32-only, got {K.dtype}")
    lib = _lib()
    batch, m = K.shape[:-2], K.shape[-1]
    if K.shape[-2] != m:
        raise ValueError(f"chol_inv takes [..., M, M], got {tuple(K.shape)}")
    g = 1
    for s in batch:
        g *= s
    Kc = K.contiguous().reshape(g, m, m)
    jit = jitters.to(device=K.device, dtype=K.dtype).contiguous()
    t = jit.numel()
    L = torch.empty((t, g, m, m), dtype=K.dtype, device=K.device)
    Linv = torch.empty_like(L)
    stream = torch.cuda.current_stream(K.device).cuda_stream
    err = lib.chol_inv_launch(Kc.data_ptr(), jit.data_ptr(), L.data_ptr(),
                              Linv.data_ptr(), g, t, m, K.device.index or 0,
                              stream)
    build.check(lib, NAME, err)
    build.count_launch(NAME, work=cost.chol_inv(g, m, t))
    shape = (t,) + tuple(batch) + (m, m)
    return L.reshape(shape), Linv.reshape(shape)
