"""The yardstick's arithmetic: the work of a cell from its shapes alone.

Frozen copies of the formulas the port carries for itself
(``utils/flops.py`` ``step_cost`` and ``ops/hopper/cost.py``), restricted
to the models the benchmark runs (RBF kernel, inducing points, whitened
q(u), an amortized latent layer, natural gradients on the final layer,
the joint schedule, float32; a minibatch smaller than the data, or the
full-batch step). The roofline shares and MFU divide this work by
measured time, so the same work stands whatever implements it, and a
later change to the program's own tallies moves none of these numbers.

Convention of the FLOP counts (the port's and its reference's): every
matrix product counts 2abc for [a, b] x [b, c], forward and each
cotangent product that exists; Cholesky factors, triangular solves and
elementwise work are not counted.
"""

from __future__ import annotations

# NVIDIA's data sheet for the H100 SXM5 (dense, no sparsity), at its
# 700 W limit: bf16 tensor-core FLOP/s, f32 CUDA-core FLOP/s, HBM bytes/s
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989e12, "f32": 67e12,
                              "bytes": 3.35e12},
}


def peaks(card: str) -> dict | None:
    return PEAKS.get(card)


def gp_layers(specs: list) -> list:
    """(d_in, d_out, final) of each GP layer of a ``layer_specs`` stack."""
    return [(s[1], s[2], s[3]) for s in specs if s[0] == "G"]


def step_rows(dataset: dict, minibatch_size: int) -> tuple:
    """(rows, full) of a training step: the rows it computes, its
    minibatch or every training row where the minibatch is at least that
    many, and whether it is then the full-batch step."""
    n_train = int(dataset["train_share"] * dataset["N"])
    return min(minibatch_size, n_train), minibatch_size >= n_train


def train_step_flops(specs: list, encoder_hidden, d_y: int, M: int, K: int,
                     B: int, full: bool = False) -> int:
    """FLOPs of one joint IW training step (value and gradient of every
    parameter, and the natural-gradient update of the final layer's
    covariance-form q(u)), at K samples of B rows. `full`: the full-batch
    step, which keeps no bf16 residual of the q-variance, so that its
    square sum over M is elementwise work and not a product (the port's
    count adds the backward's recomputation of the q-variance there: not
    work the step needs, so not counted here)."""
    C = K * B
    gps = gp_layers(specs)
    f = 0
    for d_in, _, _ in gps:
        f += 3 * 2 * M * M * d_in           # Kuu cross term and 2 cotangents
    f += 5 * 2 * len(gps) * M ** 3          # batched (L, L^-1) pullback
    for s in specs:
        if s[0] == "L":
            d_x, d_w = s[1], s[2]
            sizes = [d_x + d_y, *encoder_hidden]
            for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
                f += (2 + (i > 0)) * 2 * B * a * b
            f += 2 * 3 * 2 * B * sizes[-1] * d_w   # the two heads
    for d_in, D, final in gps:
        f += 3 * 2 * M * d_in * C           # Kuf
        f += 3 * 2 * M * M * C              # A = L^-1 Kuf
        f += 3 * 2 * M * C * D              # mean = A^T q_mu
        f += 3 * 2 * D * M * M * C          # q-variance
        if not full:
            f += 3 * 2 * D * M * C          # its square sum (bf16 residual)
        if not final and d_in != D:
            f += 2 * 2 * C * d_in * D       # the skip projection
    D = gps[-1][1]
    f += 3 * 2 * D * M * M + 2 * 2 * D * M ** 3   # natural-gradient update
    return f


def score_flops_per_row(specs: list, M: int, S: int, batch: int) -> float:
    """FLOPs of the mixture predictive per scored row: S samples through
    every GP layer (Kuf, A, mean, q-variance, skip), and each layer's Kuu
    once per batch of `batch` rows."""
    f = 0.0
    for d_in, D, final in gp_layers(specs):
        f += S * (2 * M * d_in + 2 * M * M + 2 * M * D + 2 * D * M * M)
        if not final and d_in != D:
            f += S * 2 * d_in * D
        f += 2 * M * M * d_in / batch
    return f


def bound_s(card: str, bytes_moved: float, bf16_ops: float = 0.0,
            f32_ops: float = 0.0) -> float:
    """The least seconds of a call's work on the card: the larger of its
    bytes over the memory rate and its operations over their unit's rate
    (tensor cores and CUDA cores run at once)."""
    p = PEAKS[card]
    return max(bytes_moved / p["bytes"], bf16_ops / p["bf16"],
               f32_ops / p["f32"])


def k3_work(L: int, m: int, n: int, d: int) -> tuple:
    """(bytes, bf16 ops, f32 ops) of the epilogue's backward (K3) over A
    [L, m, n], W [d, m, m] and q_mu [m, d]: A, the three cotangents, W and
    q_mu in; dA, dW, dq_mu out; the three q-variance products, the two
    bf16x3 mean products and the f32 prior term."""
    in_f = L * m * n + L * d * n + L * n + d * m * m + L * d * n + m * d
    out_f = L * m * n + d * m * m + m * d
    return (4 * (in_f + out_f), 6 * L * d * m * m * n + 12 * L * m * n * d,
            3 * L * m * n)


def k4_work(n: int, d_in: int, m: int, d: int, sample: bool) -> tuple:
    """(bytes, bf16 ops, f32 ops) of the inference conditional (K4) over n
    rows: inputs, the scaled Z, variance, L^-1, q_mu and q_sqrt in; mean
    and var (and the sample, from its noise) out; three bf16 passes of
    each dot on the dense L^-1, one of the q-variance."""
    in_f = n * d_in + m * d_in + 1 + m * m + m * d + d * m * m
    out_f = n * d * 2
    if sample:
        in_f, out_f = in_f + n * d, out_f + n * d
    return (4 * (in_f + out_f),
            2 * n * m * (3 * d_in + 3 * m + 3 * d) + n * m * (m + 1) * d,
            0.0)


def k3_bound_s_per_step(card: str, specs: list, M: int, K: int,
                        B: int) -> float:
    """K3's bound for one training step: one call per GP layer, each over
    A [K, M, B], bounds summed (the calls run one after another)."""
    return sum(bound_s(card, *k3_work(K, M, B, D))
               for _, D, _ in gp_layers(specs))


def k4_bound_s_per_batch(card: str, specs: list, M: int, S: int,
                         batch: int) -> float:
    """K4's bound for one scored batch: one call per GP layer over S x
    batch rows, 'sample' on inner layers, 'infer' on the final one."""
    return sum(bound_s(card, *k4_work(S * batch, d_in, M, D, not final))
               for d_in, D, final in gp_layers(specs))
