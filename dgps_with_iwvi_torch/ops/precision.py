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

Gradients: autograd through the bf16 casts would give cotangent dots of
the wrong class, so a classed matmul that needs a gradient goes through
``ClassedMatmul``, whose two transposed dots run at a stated class (the
reference's ``matmul_split_precision``, ``conditionals.py:73-116``).

``Numerics`` is the precision set one objective runs at, passed down
explicitly from the trainer (the reference swaps module switches around
the loss instead, ``training/train.py:106-135``).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

CLASSES = ("default", "high", "highest")


@dataclasses.dataclass(frozen=True)
class Numerics:
    """Precision set of one objective evaluation.

    var: class of the q-variance dots; solve: class of A = Linv Kuf and
    the mean; solve_bwd: class of the solve path's transposed dots (None:
    the solve class, the reference's "same"); kuf_residual: whether the
    cross gram may keep its output as the backward residual
    (``ops/kernels.py`` size rule; off on the full-batch escalation)."""

    var: str | None = "default"
    solve: str | None = "high"
    solve_bwd: str | None = None
    kuf_residual: bool = True


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


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 and back (float64 passes through exactly, as
    every class does)."""
    if x.dtype == torch.float64:
        return x
    return x.to(torch.bfloat16).to(x.dtype)


def reduce_to_shape(g: torch.Tensor, shape) -> torch.Tensor:
    """Sum g over the axes along which an operand of `shape` broadcast."""
    extra = g.ndim - len(shape)
    if extra > 0:
        g = torch.sum(g, dim=tuple(range(extra)))
    axes = tuple(i for i, (gs, s) in enumerate(zip(g.shape, shape))
                 if s == 1 and gs != 1)
    if axes:
        g = torch.sum(g, dim=axes, keepdim=True)
    return g


class ClassedMatmul(torch.autograd.Function):
    """x @ y at class `fwd`; the cotangent dots g y^T and x^T g at `bwd`."""

    @staticmethod
    def forward(ctx, x, y, fwd, bwd):
        ctx.save_for_backward(x, y)
        ctx.bwd = bwd
        return _matmul(x, y, fwd)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        dx = dy = None
        if ctx.needs_input_grad[0]:
            dx = reduce_to_shape(_matmul(g, y.transpose(-1, -2), ctx.bwd),
                                 x.shape)
        if ctx.needs_input_grad[1]:
            dy = reduce_to_shape(_matmul(x.transpose(-1, -2), g, ctx.bwd),
                                 y.shape).to(y.dtype)
        return dx, dy, None, None


def matmul(x: torch.Tensor, y: torch.Tensor, precision: str | None = None,
           bwd_precision: str | None = None) -> torch.Tensor:
    """x @ y at a named precision class (see module docstring); where a
    gradient is needed, its dots run at `bwd_precision` (default: the
    forward's class)."""
    if torch.is_grad_enabled() and (x.requires_grad or y.requires_grad):
        return ClassedMatmul.apply(
            x, y, precision, precision if bwd_precision is None
            else bwd_precision)
    return _matmul(x, y, precision)


def _matmul(x: torch.Tensor, y: torch.Tensor,
            precision: str | None) -> torch.Tensor:
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
