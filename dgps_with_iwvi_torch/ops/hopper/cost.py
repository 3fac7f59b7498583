"""The work of each hand-written kernel, from its shapes, and its bound.

One call of a kernel's wrapper computes one function; ``Work`` is what
that function must do on the card whatever implements it: the bytes it
moves (each input read once, each output written once, float32) and the
operations it does, by the unit that runs them (bf16 tensor-core
products, f32 outside the tensor cores). A kernel that reads an operand
twice or pads a tile does more; that is its own cost, not the function's.

``bound(*work)`` is the least time of that work on the card, the larger
of the bytes over the memory rate and the operations of each type over
that type's peak, from the one table of peaks (``utils.flops``). Every
wrapper hands its call's ``Work`` to ``build.count_launch``, so that
``build.launch_costs()`` gives the hand kernels' work of any window, a
replayed CUDA graph's included, and the sum of its launches' bounds;
``chip_smoke.py`` and ``experiments.roofline`` read the same formulas.

``SYMBOLS`` maps each kernel to the C++ namespace of its ``__global__``
functions in ``csrc/``, by which a profiler's device rows are joined to
the launches.
"""

from __future__ import annotations

from typing import NamedTuple

# kernel -> (label, namespace of its device functions in csrc/<kernel>.cu)
SYMBOLS = {
    "chol_inv": ("K1", "k1_chol_inv"),
    "epilogue": ("K2", "k2_epilogue"),
    "epilogue_bwd": ("K3", "k3_epilogue_bwd"),
    "serve_cond": ("K4", "k4_serve_cond"),
    "conditional": ("K5", "k5_conditional"),
}


class Work(NamedTuple):
    bytes_moved: float
    bf16_ops: float = 0.0
    f32_ops: float = 0.0


def peaks() -> tuple:
    """(bf16 FLOP/s, f32 FLOP/s, bytes/s) of the card whose data-sheet
    peaks bound the kernels, ``utils.flops.CARD`` (imported here, not at
    the top, since it imports the models, which import these kernels)."""
    from ...utils import flops

    bf16, f32 = flops.PEAK_FLOPS[flops.CARD]
    return bf16, f32, flops.PEAK_BYTES[flops.CARD]


def bound(bytes_moved: float, bf16_ops: float = 0.0, f32_ops: float = 0.0):
    """(bound_ms, bound_by): the largest of the bytes over the memory rate
    and the operations of each type over that type's peak rate (the
    tensor cores and the CUDA cores run at once, so the two op times do
    not add)."""
    peak_bf16, peak_f32, peak_bytes = peaks()
    t_bytes = bytes_moved / peak_bytes
    t_ops = max(bf16_ops / peak_bf16, f32_ops / peak_f32)
    if t_ops > t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def chol_inv(g: int, m: int, levels: int) -> Work:
    """K1: g factors of [m, m] grams and their inverses (K in, L and Linv
    out, the ladder's `levels` jitters in); Cholesky m^3/3 + triangular
    inverse m^3/3 f32 FLOP each, at the selected level."""
    return Work(bytes_moved=4 * (3 * g * m * m + levels),
                f32_ops=g * (2.0 / 3.0) * m ** 3)


def epilogue(L: int, m: int, n: int, d: int, form: str) -> Work:
    """K2 over A [L, m, n], W [d, m, m] (and q_mu [m, d] in 'epi'): the
    q-variance [L, d, n] (and the mean [L, d, n] in 'epi', the square sum
    [L, n] in 'epi' and 'ps') out; 2 L d m^2 n bf16 FLOP of the quadratic
    form, the bf16x3 mean product (3 passes), the f32 square sums."""
    mean, ssq = form == "epi", form != "qvar"
    out_floats = L * d * n * (2 if mean else 1) + (L * n if ssq else 0)
    in_floats = L * m * n + d * m * m + (m * d if mean else 0)
    return Work(bytes_moved=4 * (in_floats + out_floats),
                bf16_ops=2 * L * d * m * m * n + (6 * L * d * m * n if mean
                                                  else 0),
                f32_ops=2 * L * d * m * n + (2 * L * m * n if ssq else 0))


def epilogue_bwd(L: int, m: int, n: int, d: int, form: str) -> Work:
    """K3: A, the cotangents, W and q_mu in, dA, dW, dq_mu out; 6 L d m^2 n
    bf16 FLOP of the three products, plus the two bf16x3 mean products (3
    passes each), and the f32 prior term."""
    mean, ssq = form == "epi", form != "qvar"
    in_floats = (L * m * n + L * d * n + (L * n if ssq else 0) + d * m * m
                 + ((L * d * n + m * d) if mean else 0))
    out_floats = L * m * n + d * m * m + (m * d if mean else 0)
    return Work(bytes_moved=4 * (in_floats + out_floats),
                bf16_ops=6 * L * d * m * m * n
                + (12 * L * m * n * d if mean else 0),
                f32_ops=(3 * L * m * n if ssq else 0))


def serve_cond(n: int, d_in: int, m: int, d: int, sample: bool) -> Work:
    """K4: its inputs in and mean, var (and the sample) out; 2 n m (3 d_in
    + 3 m + 3 d) bf16 FLOP for the dot3 passes (three per dot, on the dense
    Linv) and n m (m + 1) d for the single-pass q-variance against
    tril(Lq)."""
    in_f = n * d_in + m * d_in + 1 + m * m + m * d + d * m * m
    out_f = n * d * 2
    if sample:
        in_f, out_f = in_f + n * d, out_f + n * d
    return Work(bytes_moved=4 * (in_f + out_f),
                bf16_ops=(2 * n * m * (3 * d_in + 3 * m + 3 * d)
                          + n * m * (m + 1) * d))


def conditional(n: int, d_in: int, m: int, d: int, sample: bool,
                residuals: bool) -> Work:
    """K5: 2 n m (d_in + m + d) + n m (m + 1) d f32 FLOP (the q-variance
    against tril(Lq)) against its inputs, mean and var (the sample, Kxz and
    A where written)."""
    in_f = n * d_in + m * d_in + 1 + m * m + m * d + d * m * m
    out_f = n * d * (3 if sample else 2) + (2 * n * m if residuals else 0)
    return Work(bytes_moved=4 * (in_f + out_f),
                f32_ops=2 * n * m * (d_in + m + d) + n * m * (m + 1) * d)
