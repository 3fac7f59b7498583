"""Explicit matmul precision classes.

The reference names the MXU precision at every call site
(``dgps_with_iwvi_tpu/ops/conditionals.py`` ``_var_prec``; the in-kernel
``_dot3`` of ``ops/pallas/qvar.py``). The port keeps the same three
classes, each written out so that no class depends on a global setting:

- ``"default"``: bf16 operands, f32 accumulation, f32 result (the
  q-variance dots);
- ``"high"``: the bf16x3 split — hi/lo bf16 halves of both operands,
  hi·hi + hi·lo + lo·hi accumulated in f32, lo·lo dropped (the solve path
  A = Linv·Kuf and the mean);
- ``"highest"`` (or None): f32 with TF32 off (the grams).

float64 inputs pass through every class exactly, as JAX on the CPU runs
them; the f64 parity tests rely on that.

``torch.matmul`` on bf16 tensors returns bf16, which is not the class: on
CUDA the bf16 products go through ``torch.bmm(..., out_dtype=float32)``;
on the CPU (which has no such overload) through an f32 matmul of the
bf16-rounded values, whose products are exact in f32.
"""

from __future__ import annotations

import contextlib

import torch

CLASSES = ("default", "high", "highest")


def check_tf32_off() -> None:
    """Raise if TF32 is on for f32 matmuls: it is none of the classes."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is True; the port's f32 "
            "products must run in full f32 (ROADMAP 'Numerics')")


def split_bf16(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) bf16 halves of an f32 tensor: x ~= hi + lo."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.to(x.dtype)).to(torch.bfloat16)
    return hi, lo


def bf16_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """matmul of two bf16 tensors with f32 accumulation and an f32 result,
    broadcasting over leading axes like torch.matmul."""
    if x.dtype != torch.bfloat16 or y.dtype != torch.bfloat16:
        raise TypeError(f"bf16_dot takes bf16 operands, got {x.dtype}, "
                        f"{y.dtype}")
    if not x.is_cuda:
        return torch.matmul(x.float(), y.float())
    with _f32_reductions():
        if x.ndim == 2 and y.ndim == 2:
            return torch.mm(x, y, out_dtype=torch.float32)
        batch = torch.broadcast_shapes(x.shape[:-2], y.shape[:-2])
        xb = x.expand(batch + x.shape[-2:]).reshape((-1,) + x.shape[-2:])
        yb = y.expand(batch + y.shape[-2:]).reshape((-1,) + y.shape[-2:])
        out = torch.bmm(xb, yb, out_dtype=torch.float32)
        return out.reshape(batch + out.shape[-2:])


@contextlib.contextmanager
def _f32_reductions():
    """cuBLAS may reduce split-K partial sums of a bf16 GEMM in bf16
    unless told not to (PyTorch's default allows it); the class promises
    f32 accumulation, so it is disallowed for the call."""
    flags = torch.backends.cuda.matmul
    saved = flags.allow_bf16_reduced_precision_reduction
    flags.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        flags.allow_bf16_reduced_precision_reduction = saved


def matmul(x: torch.Tensor, y: torch.Tensor,
           precision: str | None = None) -> torch.Tensor:
    """x @ y at a named precision class (see module docstring)."""
    if precision is None or precision == "highest" \
            or x.dtype == torch.float64:
        if x.is_cuda and x.dtype == torch.float32:
            check_tf32_off()
        return torch.matmul(x, y)
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"precision {precision!r} takes f32 or f64 "
                        f"operands, got {x.dtype}, {y.dtype}")
    if precision == "default":
        return bf16_dot(x.to(torch.bfloat16), y.to(torch.bfloat16))
    if precision == "high":
        xh, xl = split_bf16(x)
        yh, yl = split_bf16(y)
        return bf16_dot(xh, yh) + bf16_dot(xh, yl) + bf16_dot(xl, yh)
    raise ValueError(f"unknown precision class {precision!r}; one of "
                     f"{CLASSES}")
