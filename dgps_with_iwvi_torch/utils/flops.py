"""Model FLOPs per training step by precision class, and MFU
(port of dgps_with_iwvi_tpu/utils/flops.py).

The reference reads its dot FLOPs out of the lowered StableHLO of the
jitted chunk (``dot_flops_by_precision``, l.45-68) and the total out of
XLA's cost analysis (l.82-100). The port has neither: its kernels are
ctypes launches that no tracer sees. So the count here is analytic, from
the model configuration, the ``TrainConfig`` and the batch alone. It is
the same work whatever implements it: the K2/K3 route, ``use_pallas``
(K5) and the plain versions on the CPU all give one count, and nothing is
launched.

Convention: the reference's. Every product the reference's lowered
``chunk_fn`` holds as a ``stablehlo.dot_general`` is counted once at its
precision attribute, forward and backward; a Cholesky or a triangular
solve is no ``dot_general`` there and is not counted; the scan body counts
once, so the figure is per step. The classes are the port's
(``ops/precision.py``): ``"default"`` / ``"high"`` / ``"highest"`` are the
reference's ``DEFAULT`` / ``HIGH`` / ``HIGHEST`` call site by call site.

Per GP layer, with M inducing points, d the input width of a kernel leaf,
D the output width and C = (K or S) x B the columns of the layer
(a product of shapes [a, b] x [b, c] counts 2abc; a cotangent product
counts as its forward does, and exists only where its operand needs a
gradient):

- Kuu: a cross term per leaf with a product form (stationary but cosine,
  linear, polynomial, arccosine) 2 M^2 d, plus two cotangents, at the
  gram classes (``kernels.gram_classes``); a coregion leaf's W W^T is
  2 C_t^2 r at ``default`` per gram, plus two cotangents. The batched
  (L, L^-1) pullback of each group of layers with one M is five
  [G, M, M] products at ``highest``: 10 G M^3.
- Kuf: 2 M d C per leaf (multiscale features: two such products, x^2
  against 1/a^2 and x against z/a^2), with the cotangents of Z and of the
  layer's input.
- A = L^-1 Kuf: 2 M^2 C at the solve class, cotangents at the solve
  backward class (whitened layers; a non-whitened layer solves instead,
  and its solves' tangents with respect to L are products: 2 M^2 C per
  solve of Kuf, 2 M^2 D for the KL's solve of q_mu and 2 D M^3 for each of
  the KL's solves of the [D, M, M] covariance or root).
- mean = A^T q_mu: 2 M C D at the solve class, cotangents too.
- q-variance: [D, M, M] x [M, C] = 2 D M^2 C at the var class, with two
  cotangents; where the residual is kept in bf16 (float32, M <= 256, not
  the full-batch escalation) the square-sum over M is a dot too, 2 D M C
  at ``default``, with its cotangents; where the reference rematerializes
  instead (its residual over 64 MiB, M <= 256) the backward recomputes the
  forward product. The q_diag family: 2 M C D at the var class.
- mean function: a skip projection (d_in != d_out) or a linear mean
  2 C d_in d_out at ``default``.
- amortized encoder: 2 B a b per [a, b] weight at ``default``.
- natgrad, per full-covariance block: three [D, M, M] x [M, 1] and two
  [D, M, M] x [M, M] products at ``highest``.

``flops`` is the sum of the three classes. It reads about 2% under the
reference's cost-analysis figure at the flagship shape (11.405 against
11.647 GFLOP per step at B=512) because XLA's figure also counts the
elementwise work; that part is not estimated here.

``adjusted_flops`` weighs each class by what it costs on the card, in
bf16-FLOP units: ``default + 3 high + highest * P_bf16 / P_f32``. The
``high`` class is three bf16 tensor-core products (``PASSES``); the
``highest`` class is true f32 on the CUDA cores with TF32 off, whose peak
is P_f32 (so the reference's TPU weight of 6 does not apply here).
"""

from __future__ import annotations

import os

import torch

from ..models.layers import GPLayerConfig, LVLayerConfig, \
    resolved_mean_function
from ..ops import kernels
from ..ops.precision import CLASSES

# dense peaks by torch.cuda.get_device_name: (bf16 tensor core, f32 CUDA
# core), FLOP/s; NVIDIA's H100 SXM5 data sheet values (PERF.md section 3)
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": (989e12, 67e12),
}
# the card whose peaks weigh the adjusted count
CARD = "NVIDIA H100 80GB HBM3"

# bf16 tensor-core products per nominal FLOP of each class
PASSES = {"default": 1, "high": 3}

# the reference's q-variance residual policy (ops/conditionals.py:161-162,
# 122-124): bf16 residual at M <= 256 in float32, else a rematerialized
# forward over 64 MiB at M <= 256
_QVAR_BF16_MAX_M = 256
_REMAT_MIN_BYTES = 64 * 1024 * 1024
_REMAT_MAX_M = 256

_CROSS_KINDS = ("rbf", "matern12", "matern32", "matern52", "rq",
                "linear", "polynomial", "arccosine", "arccosine0",
                "arccosine2")
_NO_DOT_KINDS = ("cosine", "periodic", "white", "constant")


def device_peak(device=None) -> tuple:
    """(device name, dense bf16 peak FLOP/s or None): None for the CPU and
    for a card not in ``PEAK_FLOPS``; ``DGP_PEAK_FLOPS`` overrides the
    peak, as in the reference (``utils/flops.py:71-78``)."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        name = "cpu"
    else:
        name = torch.cuda.get_device_name(device)
    if os.environ.get("DGP_PEAK_FLOPS"):
        return name, float(os.environ["DGP_PEAK_FLOPS"])
    peaks = PEAK_FLOPS.get(name)
    return name, (peaks[0] if peaks else None)


def adjusted(by_class: dict) -> float:
    """default + 3 high + highest * P_bf16 / P_f32, the peaks of CARD."""
    bf16, f32 = PEAK_FLOPS[CARD]
    return (by_class["default"] * PASSES["default"]
            + by_class["high"] * PASSES["high"]
            + by_class["highest"] * bf16 / f32)


class _Tally:
    def __init__(self):
        self.by = dict.fromkeys(CLASSES, 0)

    def dot(self, flops: int, fwd: str, bwd: str | None = None,
            grads: int = 0) -> None:
        """One product of `flops` at class `fwd`, and `grads` cotangent
        products of the same size at class `bwd`."""
        self.by[fwd] += flops
        if grads:
            self.by[bwd or fwd] += grads * flops


def _cls(p: str | None) -> str:
    return "highest" if p is None else p


def _leaves(kind: str, d_in: int) -> tuple:
    """(cross terms as (width, stationary), coregion (C, r) shapes) of a
    kernel kind. A stationary cross term scales both operands by the
    lengthscales; a weighted inner product (linear, polynomial,
    arccosine) scales one."""
    cross, coreg = [], []
    for term in kernels.parse_kind(kind):
        for token in term:
            name, dims = kernels.split_token(token)
            cr = kernels.coregion_shape(name)
            if cr is not None:
                coreg.append(cr)
            elif name in _CROSS_KINDS:
                cross.append((d_in if dims is None else len(dims),
                              name in kernels.STATIONARY_KINDS))
            elif name not in _NO_DOT_KINDS:
                raise ValueError(f"no FLOP count for kernel leaf {name!r}")
    return cross, coreg


class _Policy:
    """The classes and residual choices of one objective evaluation:
    `numerics` as the trainer resolves them, `escalated` on the
    full-batch path (where the reference also keeps no bf16 residual)."""

    def __init__(self, numerics, escalated: bool, dtype):
        self.var = _cls(numerics.var)
        self.solve = _cls(numerics.solve)
        self.solve_bwd = _cls(numerics.solve_bwd or self.solve)
        self.bf16_residual = dtype == torch.float32 and not escalated
        self.gram, self.gram_bwd = kernels.gram_classes()
        self.itemsize = torch.tensor([], dtype=dtype).element_size()


def _kuu(t: _Tally, cfg: GPLayerConfig, pol: _Policy,
         hyp_grad: bool) -> None:
    """The prior gram K(Z, Z) of one layer (none for multiscale
    features, whose Kuu is elementwise)."""
    if cfg.feature == "multiscale":
        return
    M = cfg.num_inducing
    cross, coreg = _leaves(cfg.kernel_kind, cfg.d_in)
    for d, _ in cross:
        t.dot(2 * M * M * d, pol.gram, pol.gram_bwd, 2 * hyp_grad)
    for c, r in coreg:
        t.dot(2 * c * r * c, "default", "default", 2 * hyp_grad)


def _gp_layer(t: _Tally, cfg: GPLayerConfig, pol: _Policy, C: int,
              q_form: str, hyp_grad: bool, q_grad: bool,
              f_grad: bool) -> None:
    """Kuf, the conditional, the mean function and the KL of one layer
    with C columns; q_form: 'root', 'cov' or 'diag'."""
    M, d_in, D = cfg.num_inducing, cfg.d_in, cfg.d_out
    if cfg.feature == "multiscale":
        if cfg.kernel_kind != "rbf":
            raise ValueError("multiscale features are defined for the RBF "
                             "kernel only")
        # x^2 (1/a^2)^T and x (z/a^2)^T
        t.dot(2 * 2 * M * d_in * C, pol.gram, pol.gram_bwd,
              hyp_grad + f_grad)
    else:
        cross, coreg = _leaves(cfg.kernel_kind, d_in)
        for d, stationary in cross:
            grads = (2 if hyp_grad else int(f_grad)) if stationary \
                else hyp_grad + f_grad
            t.dot(2 * M * d * C, pol.gram, pol.gram_bwd, grads)
        for c, r in coreg:
            t.dot(2 * c * r * c, "default", "default", 2 * hyp_grad)
    a_grad = hyp_grad or f_grad
    if cfg.white:
        t.dot(2 * M * M * C, pol.solve, pol.solve_bwd,
              a_grad + hyp_grad)
    elif hyp_grad:
        # the two solves L^-1 Kuf and L^-T A1: their cotangents w.r.t. L
        t.by["highest"] += 2 * (2 * M * M * C)
    # the mean's cotangents stay at the solve class (conditionals.py:664)
    t.dot(2 * M * C * D, pol.solve, pol.solve, a_grad + q_grad)
    any_grad = a_grad or q_grad
    if q_form == "diag":
        t.dot(2 * M * C * D, pol.var, pol.var, a_grad + q_grad)
    elif pol.bf16_residual and M <= _QVAR_BF16_MAX_M:
        t.dot(2 * D * M * M * C, pol.var, pol.var, a_grad + q_grad)
        # the square-sum over M as a dot of the bf16 residual
        t.dot(2 * D * M * C, "default", "default",
              2 * any_grad if q_form == "root" else a_grad + any_grad)
    else:
        t.dot(2 * D * M * M * C, pol.var, pol.var, a_grad + q_grad)
        if (any_grad and M <= _REMAT_MAX_M
                and D * C * M * pol.itemsize > _REMAT_MIN_BYTES):
            t.dot(2 * D * M * M * C, pol.var)   # the rematerialized forward
    mf = resolved_mean_function(cfg)
    if (mf == "skip" and d_in != D) or mf == "linear":
        t.dot(2 * C * d_in * D, "default", "default",
              f_grad + (mf == "linear" and hyp_grad))
    if not cfg.white and hyp_grad:
        # the KL's solves L^-1 q_mu and L^-1 of the [D, M, M] root (two,
        # L^-T L^-1, of the covariance): their cotangents w.r.t. L
        t.by["highest"] += 2 * M * M * D
        if q_form != "diag":
            t.by["highest"] += (1 if q_form == "root" else 2) \
                * 2 * D * M ** 3


def _encoder(t: _Tally, cfg: LVLayerConfig, B: int, grad: bool) -> None:
    """The amortized encoder on [x, y] rows: a tanh trunk and the two
    linear heads; the input needs no cotangent."""
    d_x = cfg.d_x if cfg.d_x > 0 else cfg.d_in
    sizes = [d_x + cfg.d_y, *cfg.encoder_hidden]
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        t.dot(2 * B * a * b, "default", "default", grad * (1 + (i > 0)))
    for _ in range(2):
        t.dot(2 * B * sizes[-1] * cfg.d_w, "default", "default", 2 * grad)


def _objective(t: _Tally, config, pol: _Policy, B: int, lead: int,
               wrt: str, nat_ids: tuple) -> None:
    """One evaluation of the ELBO on B rows with `lead` samples, and its
    gradient w.r.t. `wrt`: 'all', 'rest' (all but the natgrad blocks) or
    'nat' (the natgrad blocks only)."""
    rest = wrt in ("all", "rest")
    C = lead * B
    groups: dict = {}
    for cfg in config.layers:
        if isinstance(cfg, GPLayerConfig):
            _kuu(t, cfg, pol, rest)
            groups[cfg.num_inducing] = groups.get(cfg.num_inducing, 0) + 1
    if rest:
        # the batched (L, L^-1) pullback per group: five [G, M, M] products
        for M, G in groups.items():
            t.by["highest"] += 5 * 2 * G * M ** 3
    f_grad = False
    for i, cfg in enumerate(config.layers):
        if isinstance(cfg, LVLayerConfig):
            if cfg.amortized:
                _encoder(t, cfg, B, rest)
            f_grad = f_grad or rest
            continue
        nat = i in nat_ids
        q_grad = wrt == "all" or (wrt == "nat" and nat) \
            or (wrt == "rest" and not nat)
        if cfg.q_diag:
            q_form = "diag"
        else:
            q_form = "cov" if nat else "root"
        _gp_layer(t, cfg, pol, C, q_form, rest, q_grad, f_grad)
        f_grad = f_grad or rest or q_grad


def _natgrad_update(t: _Tally, config, nat_ids: tuple) -> None:
    for i in nat_ids:
        cfg = config.layers[i]
        if cfg.q_diag:
            continue
        M, D = cfg.num_inducing, cfg.d_out
        t.by["highest"] += 3 * 2 * D * M * M + 2 * 2 * D * M ** 3


def _lead(config) -> int:
    return config.num_iw_samples if config.objective == "iw" \
        else config.num_samples


def flops_by_class(config, tc, n_rows: int, *, dtype=torch.float32,
                   mesh_shape: tuple | None = None) -> dict:
    """Nominal FLOPs of the products of one training step, forward and
    backward, by precision class: {"default", "high", "highest"}.

    config: the model's ``DGPConfig``; tc: its ``TrainConfig``; n_rows: the
    rows of the training set (the step is full-batch, at the escalated
    classes of ``training.train.resolve_full_batch``, when
    ``tc.minibatch_size >= n_rows``). dtype: the parameters' dtype (the
    reference's bf16 q-variance residual, and so its square-sum dot, is
    float32 only). mesh_shape: (n_dp, n_k) of a sharded step; the figure is
    then one rank's, as the reference's shard_map body counts it (B /
    n_dp rows, K / n_k samples; the natgrad update once). Raises
    ValueError for a configuration it cannot count.
    """
    from ..training.natgrad import natgrad_layer_ids
    from ..training.train import resolve_full_batch

    if tc.schedule not in ("joint", "alternating"):
        raise ValueError(f"no FLOP count for schedule {tc.schedule!r}")
    nat_ids = natgrad_layer_ids(config, tc.natgrad)
    t = _Tally()
    if mesh_shape is not None:
        n_dp, n_k = mesh_shape
        B = max(tc.minibatch_size // n_dp, 1)
        full = tc.minibatch_size >= config.num_data
        lead = _lead(config) // n_k
    else:
        B = min(tc.minibatch_size, n_rows)
        full = tc.minibatch_size >= n_rows
        lead = _lead(config)
    if not nat_ids:
        passes = ["rest"]
    elif tc.schedule == "alternating":
        passes = ["nat", "rest"]
    else:
        passes = ["all"]
    _, numerics = resolve_full_batch(config, tc, full)
    pol = _Policy(numerics, full and tc.full_batch_precision != "off",
                  dtype)
    for wrt in passes:
        _objective(t, config, pol, B, lead, wrt, nat_ids)
    _natgrad_update(t, config, nat_ids)
    return dict(t.by)


def objective_flops_by_class(config, n_rows: int, *,
                             dtype=torch.float32) -> dict:
    """FLOPs by class of the objective's value and its gradient w.r.t.
    every parameter (``jax.value_and_grad(elbo)`` in the reference) on
    n_rows rows, at the configuration's own classes."""
    from ..models.dgp import numerics_of

    t = _Tally()
    _objective(t, config, _Policy(numerics_of(config), False, dtype),
               n_rows, _lead(config), "all", ())
    return dict(t.by)


def step_cost(config, tc, n_rows: int, *, dtype=torch.float32,
              mesh_shape: tuple | None = None) -> dict:
    """{"flops", "adjusted_flops", "flops_by_class"} of one training step:
    flops is the sum of the classes, adjusted_flops weighs them by CARD's
    peaks (``adjusted``)."""
    by = flops_by_class(config, tc, n_rows, dtype=dtype,
                        mesh_shape=mesh_shape)
    return {"flops": sum(by.values()), "adjusted_flops": adjusted(by),
            "flops_by_class": by}
