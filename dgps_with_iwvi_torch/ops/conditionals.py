"""Sparse-variational GP conditionals, forward
(port of dgps_with_iwvi_tpu/ops/conditionals.py).

Whitened semantics: q(v) = N(q_mu, q_sqrt q_sqrt^T), u = Lm v,
Lm = chol(Kuu). Per test point:

    A    = Lm^-1 Kuf                            [..., M, N]
    mean = A^T q_mu                             [..., N, D]
    var  = max(Kff_diag - sum_m A^2, 0)
           + sum_m (q_sqrt_d^T A)^2             [..., N, D] (marginal)

Precision classes follow the reference call site by call site
(``ops/precision.py``): the solve path A = Linv Kuf and the mean at
``solve_precision`` (default ``high``), with the transposed dots of its
backward at ``solve_bwd_precision`` (default: the same class), the
q-variance at ``var_precision`` (default ``default``), the grams at
``highest``.

The epilogue (mean, the prior sum of squares and the q-variance) is one
launch of the K2 kernel, with K3 as its backward (``ops/hopper/qvar.py``
``EpiFusedTrain``), whenever the structural conditions of the reference's
``_maybe_epi_fused`` hold: a 3-D W, q_mu [M, D], float32, the ``default``
q-variance class. The reference picks another variant for inference and
for training and gates both by TPU-measured floors (``EPI_TRAIN``,
``QVAR_PALLAS_TRAIN``, n >= 1024, d*n >= 16384); the port takes the one
Function for both, whose forward is the same K2 launch, and carries no
floor. At ``highest`` (the full-batch escalation) the conditions fail and
the plain path runs, as the reference's overrides make it.

Non-whitened layers (``base_conditional(white=False)``, reference
l.683-716) hold q over u itself: A1 = Lm^-1 Kuf gives the prior term,
A = Lm^-T A1 = Kuu^-1 Kuf the mean and the q-variance, which goes through
``_q_variance`` and so through K2/K3's q-variance-only variant
(``QvarFusedTrain``) on the card. ``base_conditional_whitened_fullcov``
is the full-covariance form of prediction, all at ``highest``. Multiscale
features (``conditional(feature_raw_scales=)``) swap Kuu and Kuf for the
window integrals of ``ops/features.py``.

The whole-conditional routes (reference l.808-998) take the gram, A, the
moments and optionally the sample in one kernel, on lengthscale-scaled
inputs (so the lengthscale and variance gradients flow through ordinary
autograd around it):

- ``conditional(use_pallas=True)``: K5 ``fused`` at true f32, with its
  residual backward (``ops/hopper/conditional.py``);
- ``sample_conditional_fused``: K5 ``sample``, the noise drawn in the
  kernel from a seed off the caller's generator; with injected ``eps``,
  K5 ``fused`` and the sample outside, as the reference's off-TPU route;
- ``infer_conditional_fused``: K4 at the bf16x3 / bf16 classes,
  inference only (``ops/hopper/serve_cond.py``), behind the model's
  ``serve_pallas`` (the reference's ``SERVE_PALLAS``), whose "auto"
  takes it for inference on the card.

They keep the reference's structural conditions and drop its TPU tile and
size floors (``Z.shape[0] % 128``, ``_SERVE_FUSED_MIN_COLS``): K4 and K5
take any M and N.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import features, kernels, precision
from .hopper import conditional as cond_kernel
from .hopper import qvar as qvar_kernel
from .hopper import serve_cond as serve_kernel
from .linalg import DEFAULT_JITTER, cholesky_with_jitter, solve_triangular


class ConditionalOut(NamedTuple):
    mean: torch.Tensor  # [..., N, D]
    var: torch.Tensor   # [..., N, D] (marginal) or [..., D, N, N] (full)


def safe_sqrt(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """sqrt(max(v, eps)): the gradient-safe standard deviation (sqrt's
    infinite derivative at 0 would give inf * 0 = NaN backward)."""
    return torch.sqrt(torch.clamp(v, min=eps))


def _kernel_epilogue_ok(A, W, q_mu, var_precision) -> bool:
    """Structural conditions for K2/K3 (reference ``_maybe_epi_fused``)."""
    return (W is not None and W.ndim == 3
            and var_precision == "default"
            and A.dtype == torch.float32 and W.dtype == torch.float32
            and W.shape[-1] == A.shape[-2]
            and (q_mu is None or (q_mu.ndim == 2
                                  and q_mu.shape == (A.shape[-2], W.shape[0])
                                  and q_mu.dtype == A.dtype)))


def _maybe_epi_fused(A, q_sqrt, q_S, var_precision, q_mu):
    """(qv [..., D, N], sumsq [..., N], mean [..., D, N]) from one K2
    launch (backward: K3), or None when the separate-op composition
    applies."""
    if q_S is not None and q_S.ndim == 3:
        W, cov = q_S, True
    elif q_S is None and q_sqrt is not None and q_sqrt.ndim == 3:
        W, cov = torch.tril(q_sqrt), False
    else:
        return None
    if not _kernel_epilogue_ok(A, W, q_mu, var_precision):
        return None
    # the tril stays outside the Function: its backward masks the dense dW
    # back onto the triangle
    return qvar_kernel.EpiFusedTrain.apply(A, W, q_mu, cov)


def _q_variance(A: torch.Tensor, q_sqrt, q_S,
                var_precision: str | None) -> torch.Tensor:
    """diag of the q-covariance quadratic form: A [..., M, N] -> [..., N, D].

    - q_S [D, M, M]: covariance form, sum_M A * (S A)
    - q_S [M, D]: diagonal covariance form (variances)
    - q_sqrt [D, M, M]: root form, sum_M (q_sqrt^T A)^2
    - q_sqrt [M, D]: q_diag scales, (A^2)^T s^2
    """
    if q_S is not None:
        if q_S.ndim == 2:
            return precision.matmul(torch.square(A).transpose(-1, -2), q_S,
                                    var_precision)
        W, cov = q_S, True
    else:
        if q_sqrt.ndim == 2:
            return precision.matmul(torch.square(A).transpose(-1, -2),
                                    torch.square(q_sqrt), var_precision)
        W, cov = torch.tril(q_sqrt), False
    if _kernel_epilogue_ok(A, W, None, var_precision):
        qv = qvar_kernel.QvarFusedTrain.apply(A, W, cov)
    else:
        qv = qvar_kernel.qvar_plain(A, W, cov, var_precision)
    return qv.transpose(-1, -2)


def base_conditional_whitened(
    Kuf: torch.Tensor,        # [..., M, N]
    Lm: torch.Tensor,         # [M, M] lower Cholesky of Kuu (+jitter)
    Kff_diag: torch.Tensor,   # [..., N]
    q_mu: torch.Tensor,       # [M, D]
    q_sqrt: torch.Tensor,     # [D, M, M] lower-triangular (or [M, D] q_diag)
    var_precision: str | None = None,
    Linv: torch.Tensor | None = None,
    q_S: torch.Tensor | None = None,
    solve_precision: str | None = None,
    *,
    solve_bwd_precision: str | None = None,
) -> ConditionalOut:
    """Whitened marginal conditional; broadcasts over leading axes of Kuf."""
    m = Lm.shape[-1]
    n_cols = 1
    for s in (*Kuf.shape[:-2], Kuf.shape[-1]):
        n_cols *= s
    if Linv is None and Lm.ndim == 2 and n_cols >= 4 * m:
        Linv = solve_triangular(
            Lm, torch.eye(m, dtype=Lm.dtype, device=Lm.device), lower=True)
    if Linv is not None:
        A = precision.matmul(Linv, Kuf, solve_precision,      # [..., M, N]
                             solve_bwd_precision)
    else:
        A = solve_triangular(Lm, Kuf, lower=True)
    epi = _maybe_epi_fused(A, q_sqrt, q_S, var_precision, q_mu)
    if epi is not None:
        qv, ss, mn = epi
        fvar_prior = torch.clamp(Kff_diag - ss, min=0.0)
        return ConditionalOut(mn.transpose(-1, -2),
                              fvar_prior[..., None] + qv.transpose(-1, -2))
    mean = precision.matmul(A.transpose(-1, -2), q_mu, solve_precision,
                            solve_bwd_precision)
    # Kff - Qff >= 0 mathematically; rounding can push it below
    fvar_prior = torch.clamp(
        Kff_diag - torch.sum(torch.square(A), dim=-2), min=0.0)
    fvar_q = _q_variance(A, q_sqrt, q_S, var_precision)
    return ConditionalOut(mean, fvar_prior[..., None] + fvar_q)


def base_conditional(
    Kuf: torch.Tensor,        # [..., M, N]
    Lm: torch.Tensor,         # [M, M] lower Cholesky of Kuu (+jitter)
    Kff_diag: torch.Tensor,   # [..., N]
    q_mu: torch.Tensor,       # [M, D]
    q_sqrt: torch.Tensor,     # [D, M, M] lower-triangular (or [M, D])
    *,
    white: bool = True,
    var_precision: str | None = None,
    Linv: torch.Tensor | None = None,
    q_S: torch.Tensor | None = None,
    solve_precision: str | None = None,
    solve_bwd_precision: str | None = None,
) -> ConditionalOut:
    """Marginal conditional in either parameterization: white=True is
    ``base_conditional_whitened`` (through the prefactor's Linv where
    given, its backward at solve_bwd_precision). white=False, q directly
    over u = f(Z):

        A1   = Lm^-1 Kuf,  A = Lm^-T A1 = Kuu^-1 Kuf
        mean = A^T q_mu                      (at solve_precision)
        var  = max(Kff_diag - sum_m A1^2, 0) + q-variance over A

    There A comes from two triangular solves, so Linv and
    solve_bwd_precision (which govern the product Linv Kuf) have nothing
    to act on, as in the reference (l.683-716)."""
    if white:
        return base_conditional_whitened(
            Kuf, Lm, Kff_diag, q_mu, q_sqrt, var_precision=var_precision,
            Linv=Linv, q_S=q_S, solve_precision=solve_precision,
            solve_bwd_precision=solve_bwd_precision)
    A1 = solve_triangular(Lm, Kuf, lower=True)
    fvar_prior = torch.clamp(
        Kff_diag - torch.sum(torch.square(A1), dim=-2), min=0.0)
    A = solve_triangular(Lm, A1, lower=True, trans=True)
    mean = precision.matmul(A.transpose(-1, -2), q_mu, solve_precision)
    fvar_q = _q_variance(A, q_sqrt, q_S, var_precision)
    return ConditionalOut(mean, fvar_prior[..., None] + fvar_q)


def base_conditional_whitened_fullcov(
    Kuf: torch.Tensor,        # [M, N]
    Lm: torch.Tensor,         # [M, M]
    Kff: torch.Tensor,        # [N, N]
    q_mu: torch.Tensor,       # [M, D]
    q_sqrt: torch.Tensor,     # [D, M, M] lower-triangular, or [M, D] scales
    *,
    white: bool = True,
) -> ConditionalOut:
    """Full-covariance conditional (prediction at a small N), every product
    at ``highest``: mean [..., N, D], cov [..., D, N, N]. A = Lm^-1 Kuf
    (white) or Kuu^-1 Kuf; the prior term Kff - Kuf^T Kuu^-1 Kuf is the
    same in both. A 2-D q_sqrt holds the q_diag family's scales s [M, D]
    (S_d = diag(s[:, d]^2)). Leading axes of Kuf and Kff broadcast."""
    def mm(x, y):
        return precision.matmul(x, y, "highest")

    A1 = solve_triangular(Lm, Kuf, lower=True)
    prior_cov = Kff - mm(A1.transpose(-1, -2), A1)
    A = A1 if white else solve_triangular(Lm, A1, lower=True, trans=True)
    mean = mm(A.transpose(-1, -2), q_mu)
    A = A.unsqueeze(-3)                                       # [..., 1, M, N]
    if q_sqrt.ndim == 2:
        B = q_sqrt.T[:, :, None] * A                          # [..., D, M, N]
    else:
        B = mm(q_sqrt.transpose(-1, -2), A)
    return ConditionalOut(mean, prior_cov.unsqueeze(-3)
                          + mm(B.transpose(-1, -2), B))


def conditional(
    X: torch.Tensor,          # [..., N, D_in]
    Z: torch.Tensor,          # [M, D_in]
    kernel_params,
    q_mu: torch.Tensor,       # [M, D_out]
    q_sqrt: torch.Tensor,     # [D_out, M, M]
    *,
    kernel_kind: str = "rbf",
    jitter: float = DEFAULT_JITTER,
    Lm: torch.Tensor | None = None,
    Linv: torch.Tensor | None = None,
    jitter_tries: int = 4,
    white: bool = True,
    var_precision: str | None = None,
    q_S: torch.Tensor | None = None,
    solve_precision: str | None = None,
    solve_bwd_precision: str | None = None,
    kuf_residual: bool = True,
    use_pallas: bool | str = False,
    feature_raw_scales: torch.Tensor | None = None,
) -> ConditionalOut:
    """End-to-end conditional: grams -> chol -> solve -> moments, whitened
    or not (``white``).

    kuf_residual: whether the cross gram may keep its output as its
    backward residual (``ops/kernels.py``). use_pallas=True takes the whole
    conditional through K5 ``fused`` (every dot at f32, whatever the
    precision arguments say) where the reference's conditions hold: rbf,
    white, no q_S, a 3-D q_sqrt; "auto" resolves to False, as in the
    reference. feature_raw_scales: raw [M, D] multiscale window scales
    (``ops/features.py``, rbf only): Kuu and Kuf become the window
    integrals, Kff is unchanged, and the default route runs."""
    if feature_raw_scales is not None:
        if kernel_kind != "rbf":
            raise ValueError("multiscale features are defined for the RBF "
                             f"kernel only, got {kernel_kind!r}")
        if Lm is None:
            Kuu = features.multiscale_Kuu(kernel_params, Z,
                                          feature_raw_scales)
            Lm = cholesky_with_jitter(Kuu, jitter, max_tries=jitter_tries)
        Kuf = features.multiscale_Kuf(kernel_params, Z, feature_raw_scales,
                                      X)
        Kff_diag = kernels.Kdiag(kernel_params, X, kind=kernel_kind)
        return base_conditional(
            Kuf, Lm, Kff_diag, q_mu, q_sqrt, white=white,
            var_precision=var_precision, Linv=Linv, q_S=q_S,
            solve_precision=solve_precision,
            solve_bwd_precision=solve_bwd_precision)
    if Lm is None:
        Kuu = kernels.K(kernel_params, Z, Z, kind=kernel_kind)
        Lm = cholesky_with_jitter(Kuu, jitter, max_tries=jitter_tries)
    if use_pallas == "auto":
        use_pallas = False
    if (use_pallas and kernel_kind == "rbf" and white and q_S is None
            and q_sqrt is not None and q_sqrt.ndim == 3):
        xs, zs, var, shape = _scaled(X, Z, kernel_params, q_mu)
        mean, v = cond_kernel.fused_conditional(
            xs, zs, var, _linv(Z, kernel_params, jitter, jitter_tries, Lm,
                               Linv), q_mu, q_sqrt)
        return ConditionalOut(mean.reshape(shape).to(X.dtype),
                              v.reshape(shape).to(X.dtype))
    Kuf = kernels.K(kernel_params, Z, X, kind=kernel_kind,     # [..., M, N]
                    kuf_residual=kuf_residual)
    Kff_diag = kernels.Kdiag(kernel_params, X, kind=kernel_kind)
    return base_conditional(
        Kuf, Lm, Kff_diag, q_mu, q_sqrt, white=white,
        var_precision=var_precision, Linv=Linv, q_S=q_S,
        solve_precision=solve_precision,
        solve_bwd_precision=solve_bwd_precision)


def _scaled(X, Z, kernel_params, q_mu):
    """(xs [rows, d_in], zs [M, d_in], var, output shape [..., N, D]): the
    lengthscale-scaled inputs of K4 and K5 (reference l.814-821)."""
    ls = kernels.kernel_lengthscales(kernel_params)
    xs = (X / ls).reshape(-1, X.shape[-1])
    return (xs, Z / ls, kernels.kernel_variance(kernel_params),
            X.shape[:-1] + (q_mu.shape[1],))


def _linv(Z, kernel_params, jitter, jitter_tries, Lm, Linv):
    """Linv, else Lm^-1 by a triangular solve, Lm factored from Kuu where
    not given (reference l.822-823, l.905-910)."""
    if Linv is not None:
        return Linv
    if Lm is None:
        Kuu = kernels.K(kernel_params, Z, Z, kind="rbf")
        Lm = cholesky_with_jitter(Kuu, jitter, max_tries=jitter_tries)
    m = Lm.shape[-1]
    return solve_triangular(
        Lm, torch.eye(m, dtype=Lm.dtype, device=Lm.device), lower=True)


def _serve_fused_applicable(X, q_sqrt, q_S, kernel_kind: str, white: bool,
                            var_precision, solve_precision,
                            serve_pallas: bool | str,
                            grad_needed: bool) -> bool:
    """Whether K4 takes this conditional (reference l.860-883): asked for,
    rbf, white, root form, float32, and the precision classes K4
    implements. "auto" asks for it where the reference's "auto" does, in
    inference off the CPU: on CUDA tensors through which no gradient is
    needed. The reference's TPU floors (M a multiple of 128, at least
    1024 columns) are not carried over."""
    want = (X.is_cuda and not grad_needed if serve_pallas == "auto"
            else bool(serve_pallas))
    return (want and kernel_kind == "rbf" and white
            and q_S is None and q_sqrt is not None and q_sqrt.ndim == 3
            and X.dtype == torch.float32 and var_precision == "default"
            and solve_precision == "high")


def infer_conditional_fused(X, Z, kernel_params, q_mu, q_sqrt, *,
                            eps: torch.Tensor | None = None,
                            jitter: float = DEFAULT_JITTER,
                            jitter_tries: int = 4,
                            Lm: torch.Tensor | None = None,
                            Linv: torch.Tensor | None = None):
    """(sample or None, ConditionalOut) through K4 (reference l.886-933):
    the sample mean + sqrt(max(var, 1e-12)) eps where the caller gives
    eps [..., N, D] (ordinary noise, as the default route draws it).
    Inference only; callers check ``_serve_fused_applicable``."""
    Linv = _linv(Z, kernel_params, jitter, jitter_tries, Lm, Linv)
    xs, zs, var, shape = _scaled(X, Z, kernel_params, q_mu)
    out = serve_kernel.fused_conditional_infer(
        xs, zs, var, Linv, q_mu, q_sqrt,
        None if eps is None else eps.reshape(-1, shape[-1]))
    out = [t.reshape(shape).to(X.dtype) for t in out]
    if eps is None:
        return None, ConditionalOut(*out)
    return out[0], ConditionalOut(out[1], out[2])


def sample_conditional(X, Z, kernel_params, q_mu, q_sqrt, *,
                       eps: torch.Tensor | None = None,
                       generator: torch.Generator | None = None, **kw):
    """(sample, ConditionalOut): F = mean + safe_sqrt(var) eps, the noise
    from ``eps`` or ``generator`` (reference l.981-998)."""
    out = conditional(X, Z, kernel_params, q_mu, q_sqrt, **kw)
    if eps is None:
        eps = torch.randn(out.mean.shape, generator=generator,
                          dtype=out.mean.dtype, device=out.mean.device)
    return out.mean + safe_sqrt(out.var) * eps.to(out.mean.dtype), out


def sample_conditional_fused(X, Z, kernel_params, q_mu, q_sqrt, *,
                             kernel_kind: str = "rbf",
                             jitter: float = DEFAULT_JITTER,
                             jitter_tries: int = 4,
                             Lm: torch.Tensor | None = None,
                             Linv: torch.Tensor | None = None,
                             eps: torch.Tensor | None = None,
                             generator: torch.Generator | None = None):
    """(sample, ConditionalOut) of an inner layer in one K5 ``sample``
    launch: the noise is drawn in the kernel from an int64 seed that
    ``generator`` gives (reference l.936-978; there the seed is
    ``jax.random.bits(key)``). With injected ``eps`` (tests), K5 ``fused``
    and the sample outside, as the reference's route off the TPU; another
    kernel kind takes the default route. Linv is the prefactor's inverse
    where given (the reference solves for it again, l.971)."""
    if eps is not None or kernel_kind != "rbf":
        return sample_conditional(
            X, Z, kernel_params, q_mu, q_sqrt, eps=eps, generator=generator,
            kernel_kind=kernel_kind, jitter=jitter, jitter_tries=jitter_tries,
            Lm=Lm, Linv=Linv, use_pallas=True)
    if generator is None:
        raise ValueError("a sample site needs eps or a torch.Generator")
    Linv = _linv(Z, kernel_params, jitter, jitter_tries, Lm, Linv)
    xs, zs, var, shape = _scaled(X, Z, kernel_params, q_mu)
    seed = torch.randint(0, 2 ** 62, (), generator=generator,
                         dtype=torch.int64, device=generator.device)
    samp, mean, v = cond_kernel.fused_conditional_sample(
        xs, zs, var, Linv, q_mu, q_sqrt, seed.to(X.device))
    return (samp.reshape(shape).to(X.dtype),
            ConditionalOut(mean.reshape(shape).to(X.dtype),
                           v.reshape(shape).to(X.dtype)))
