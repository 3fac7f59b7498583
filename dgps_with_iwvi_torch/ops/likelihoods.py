"""Likelihood families (port of dgps_with_iwvi_tpu/ops/likelihoods.py:35-826).

Each family gives the three functions the objectives and the mixture
predictive need: ``variational_expectations`` E_{N(f|m,v)}[log p(y|f)],
``predict_mean_and_var`` and ``predict_density`` log ∫ p(y|f) N(f|m,v) df,
each summed over the trailing output axis and broadcast over leading
sample axes. The families, with the reference's links and defaults:
gaussian, switched_gaussian (per-task noise, the task index in Y's last
column), bernoulli (probit), student_t, poisson, exponential, gamma, beta,
ordinal (probit bins), multiclass (robust-max) and softmax (a fixed
quasi-Monte-Carlo rule). Non-conjugate integrals run probabilists'
Gauss-Hermite rules; the nodes come from numpy's ``hermegauss``.

Parameters the reference holds under ``stop_gradient`` (student_t's df,
ordinal's bin edges) are detached here, so Adam leaves them as the
reference's zero-gradient Adam does. ``dispatch_sample_observations``
draws observations at given function values (``predict_y_samples``):
from a ``torch.Generator``, or, where the reference draws a normal or a
uniform (gaussian, bernoulli, ordinal, multiclass), from the caller's
draws (``noise``).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
from torch._subclasses.fake_tensor import is_fake

from .conditionals import safe_sqrt
from .transforms import positive, positive_inverse

LikelihoodParams = Dict[str, torch.Tensor]

_LOG2PI = float(math.log(2.0 * math.pi))
DEFAULT_NUM_GAUSS_HERMITE = 20
ROBUSTMAX_EPS = 1e-3
SOFTMAX_QMC_POINTS = 256
# finite stand-in for ordinal's +-inf edges: Phi(+-1e4) and its pdf round
# to 1/0 exactly in f32 and f64, so no inf - inf reaches autograd
_ORDINAL_SENTINEL = 1e4


# ---- Gaussian -------------------------------------------------------------

def gaussian_params(noise_variance: float = 0.05, *, dtype=torch.float32,
                    device="cuda") -> LikelihoodParams:
    return {"raw_noise_variance": positive_inverse(
        torch.as_tensor(noise_variance, dtype=dtype, device=device))}


def noise_variance(params: LikelihoodParams) -> torch.Tensor:
    return positive(params["raw_noise_variance"])


def variational_expectations(params: LikelihoodParams, mean: torch.Tensor,
                             var: torch.Tensor,
                             y: torch.Tensor) -> torch.Tensor:
    """E_{N(f|mean,var)}[log N(y | f, s2)], summed over the last axis."""
    s2 = noise_variance(params)
    per_dim = -0.5 * (_LOG2PI + torch.log(s2)
                      + (torch.square(y - mean) + var) / s2)
    return torch.sum(per_dim, dim=-1)


def log_prob(params: LikelihoodParams, f: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
    """log N(y | f, s2), summed over the last axis."""
    s2 = noise_variance(params)
    per_dim = -0.5 * (_LOG2PI + torch.log(s2) + torch.square(y - f) / s2)
    return torch.sum(per_dim, dim=-1)


def predict_mean_and_var(params: LikelihoodParams, fmean: torch.Tensor,
                         fvar: torch.Tensor):
    return fmean, fvar + noise_variance(params)


def predict_density(params: LikelihoodParams, fmean: torch.Tensor,
                    fvar: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """log N(y | fmean, fvar + s2), summed over the last axis."""
    v = fvar + noise_variance(params)
    per_dim = -0.5 * (_LOG2PI + torch.log(v) + torch.square(y - fmean) / v)
    return torch.sum(per_dim, dim=-1)


# ---- quadrature -----------------------------------------------------------

_CONSTANTS: dict = {}


def _constant(key: tuple, make, like: torch.Tensor) -> torch.Tensor:
    """A constant table from `make()` (float64 numpy) in the dtype and on
    the device of `like`, kept per (key, dtype, device): a copy from host
    memory on every call would wait for the card's queue each time. A
    table made while a program is traced (a fake tensor) is not kept."""
    full = key + (like.dtype, like.device)
    t = _CONSTANTS.get(full)
    if t is None:
        t = torch.as_tensor(make(), dtype=like.dtype, device=like.device)
        if not is_fake(t):
            _CONSTANTS[full] = t
    return t


def _rule(n_points: int, like: torch.Tensor, log_weights: bool = False):
    """(nodes, weights / sqrt(2 pi), or their logs) of the probabilists'
    Gauss-Hermite rule."""
    def weights():
        ws = np.polynomial.hermite_e.hermegauss(n_points)[1]
        ws = ws / np.sqrt(2.0 * np.pi)
        return np.log(ws) if log_weights else ws

    return (_constant(("gh_nodes", n_points),
                      lambda: np.polynomial.hermite_e.hermegauss(n_points)[0],
                      like),
            _constant(("gh_weights", n_points, log_weights), weights, like))


def gauss_hermite_expectation(log_fn, mean: torch.Tensor, var: torch.Tensor,
                              n_points: int = DEFAULT_NUM_GAUSS_HERMITE):
    """E_{N(f | mean, var)}[log_fn(f)], elementwise over mean / var. The
    sd is ``safe_sqrt``: a final-layer variance can be exactly 0, where
    sqrt's infinite derivative would make the gradient NaN."""
    xs, ws = _rule(n_points, mean)
    f = mean[..., None] + safe_sqrt(var)[..., None] * xs
    return torch.sum(log_fn(f) * ws, dim=-1)


def gauss_hermite_log_expectation(logp_fn, mean: torch.Tensor,
                                  var: torch.Tensor,
                                  n_points: int = DEFAULT_NUM_GAUSS_HERMITE):
    """log E_{N(f|mean,var)}[exp(logp_fn(f))] under a logsumexp, so that
    p(y|f) at the tail nodes cannot underflow."""
    xs, logws = _rule(n_points, mean, log_weights=True)
    f = mean[..., None] + safe_sqrt(var)[..., None] * xs
    return torch.logsumexp(logp_fn(f) + logws, dim=-1)


def _expn(mean, var, a: float):
    """E[exp(a f)] under N(f | mean, var) = exp(a m + a^2 v / 2)."""
    return torch.exp(a * mean + (a * a / 2.0) * var)


def _unused_params(dtype, device) -> LikelihoodParams:
    """A family without free parameters keeps a non-empty tree."""
    return {"_unused": torch.zeros((), dtype=dtype, device=device)}


# ---- Bernoulli (probit) ---------------------------------------------------

def bernoulli_params(*, dtype=torch.float32, device="cuda"):
    return _unused_params(dtype, device)


def _sign(y):
    return torch.where(y > 0.5, 1.0, -1.0).to(y.dtype)


def bernoulli_variational_expectations(params, mean, var, y,
                                       n_points=DEFAULT_NUM_GAUSS_HERMITE):
    """E[log Phi(+-f)] by quadrature; y in {0, 1} (or {-1, 1})."""
    sign = _sign(y)[..., None]
    per_dim = gauss_hermite_expectation(
        lambda f: torch.special.log_ndtr(sign * f), mean, var, n_points)
    return torch.sum(per_dim, dim=-1)


def bernoulli_predict_mean_and_var(params, fmean, fvar):
    """p = E[Phi(f)] = Phi(m / sqrt(1 + v))."""
    p = torch.special.ndtr(fmean / torch.sqrt(1.0 + fvar))
    return p, p - torch.square(p)


def bernoulli_predict_density(params, fmean, fvar, y):
    """log Phi(+-m / sqrt(1 + v)), summed over the last axis."""
    per_dim = torch.special.log_ndtr(
        _sign(y) * fmean / torch.sqrt(1.0 + fvar))
    return torch.sum(per_dim, dim=-1)


# ---- Student-t (identity link; df fixed) ---------------------------------

def student_t_params(scale: float = 1.0, df: float = 3.0, *,
                     dtype=torch.float32, device="cuda"):
    kw = dict(dtype=dtype, device=device)
    return {"raw_scale": positive_inverse(torch.as_tensor(scale, **kw)),
            "df": torch.as_tensor(df, **kw)}


def _student_t_logp(scale, df, f, y):
    z = torch.square(y - f) / (df * torch.square(scale))
    return (torch.lgamma((df + 1.0) / 2.0) - torch.lgamma(df / 2.0)
            - 0.5 * torch.log(df * math.pi * torch.square(scale))
            - ((df + 1.0) / 2.0) * torch.log1p(z))


def student_t_variational_expectations(params, mean, var, y,
                                       n_points=DEFAULT_NUM_GAUSS_HERMITE):
    scale, df = positive(params["raw_scale"]), params["df"].detach()
    per_dim = gauss_hermite_expectation(
        lambda f: _student_t_logp(scale, df, f, y[..., None]), mean, var,
        n_points)
    return torch.sum(per_dim, dim=-1)


def student_t_predict_mean_and_var(params, fmean, fvar):
    """Var(y|f) = scale^2 df / (df - 2) for df > 2, +inf otherwise."""
    scale, df = positive(params["raw_scale"]), params["df"].detach()
    cond_var = torch.where(
        df > 2.0, torch.square(scale) * df / torch.clamp(df - 2.0, min=1e-12),
        torch.full_like(df, math.inf))
    return fmean, fvar + cond_var


def student_t_predict_density(params, fmean, fvar, y,
                              n_points=DEFAULT_NUM_GAUSS_HERMITE):
    scale, df = positive(params["raw_scale"]), params["df"].detach()
    per_dim = gauss_hermite_log_expectation(
        lambda f: _student_t_logp(scale, df, f, y[..., None]), fmean, fvar,
        n_points)
    return torch.sum(per_dim, dim=-1)


# ---- Poisson (exp link) ---------------------------------------------------

def poisson_params(*, dtype=torch.float32, device="cuda"):
    return _unused_params(dtype, device)


def poisson_variational_expectations(params, mean, var, y):
    """y m - exp(m + v/2) - lgamma(y + 1): analytic."""
    per_dim = y * mean - _expn(mean, var, 1.0) - torch.lgamma(y + 1.0)
    return torch.sum(per_dim, dim=-1)


def poisson_predict_mean_and_var(params, fmean, fvar):
    """E[y] = E[lam], Var[y] = E[lam] + Var[lam], lam = exp(f)."""
    m = _expn(fmean, fvar, 1.0)
    return m, m + torch.square(m) * torch.expm1(fvar)


def poisson_predict_density(params, fmean, fvar, y,
                            n_points=DEFAULT_NUM_GAUSS_HERMITE):
    yq = y[..., None]
    per_dim = gauss_hermite_log_expectation(
        lambda f: yq * f - torch.exp(f) - torch.lgamma(yq + 1.0), fmean,
        fvar, n_points)
    return torch.sum(per_dim, dim=-1)


# ---- Exponential (exp link = conditional mean) ---------------------------

def exponential_params(*, dtype=torch.float32, device="cuda"):
    return _unused_params(dtype, device)


def exponential_variational_expectations(params, mean, var, y):
    """E[-f - y exp(-f)] = -m - y exp(-m + v/2)."""
    return torch.sum(-mean - y * _expn(mean, var, -1.0), dim=-1)


def exponential_predict_mean_and_var(params, fmean, fvar):
    m = _expn(fmean, fvar, 1.0)
    return m, 2.0 * _expn(fmean, fvar, 2.0) - torch.square(m)


def exponential_predict_density(params, fmean, fvar, y,
                                n_points=DEFAULT_NUM_GAUSS_HERMITE):
    yq = y[..., None]
    per_dim = gauss_hermite_log_expectation(
        lambda f: -f - yq * torch.exp(-f), fmean, fvar, n_points)
    return torch.sum(per_dim, dim=-1)


# ---- Gamma (trainable shape; exp link = scale) ---------------------------

def gamma_params(shape: float = 1.0, *, dtype=torch.float32, device="cuda"):
    return {"raw_shape": positive_inverse(
        torch.as_tensor(shape, dtype=dtype, device=device))}


def gamma_variational_expectations(params, mean, var, y):
    k = positive(params["raw_shape"])
    per_dim = ((k - 1.0) * torch.log(y) - y * _expn(mean, var, -1.0)
               - k * mean - torch.lgamma(k))
    return torch.sum(per_dim, dim=-1)


def gamma_predict_mean_and_var(params, fmean, fvar):
    k = positive(params["raw_shape"])
    e_th = _expn(fmean, fvar, 1.0)
    e_th2 = _expn(fmean, fvar, 2.0)
    return k * e_th, k * e_th2 + torch.square(k) * (e_th2
                                                    - torch.square(e_th))


def gamma_predict_density(params, fmean, fvar, y,
                          n_points=DEFAULT_NUM_GAUSS_HERMITE):
    k = positive(params["raw_shape"])
    yq = y[..., None]
    per_dim = gauss_hermite_log_expectation(
        lambda f: ((k - 1.0) * torch.log(yq) - yq * torch.exp(-f) - k * f
                   - torch.lgamma(k)), fmean, fvar, n_points)
    return torch.sum(per_dim, dim=-1)


# ---- Beta (logit link; trainable scale) ----------------------------------

def beta_params(scale: float = 1.0, *, dtype=torch.float32, device="cuda"):
    return {"raw_scale": positive_inverse(
        torch.as_tensor(scale, dtype=dtype, device=device))}


def _beta_logp(scale, f, y):
    mu = torch.sigmoid(f)
    alpha, beta = mu * scale, (1.0 - mu) * scale
    return ((alpha - 1.0) * torch.log(y) + (beta - 1.0) * torch.log1p(-y)
            + torch.lgamma(scale) - torch.lgamma(alpha) - torch.lgamma(beta))


def beta_variational_expectations(params, mean, var, y,
                                  n_points=DEFAULT_NUM_GAUSS_HERMITE):
    scale = positive(params["raw_scale"])
    per_dim = gauss_hermite_expectation(
        lambda f: _beta_logp(scale, f, y[..., None]), mean, var, n_points)
    return torch.sum(per_dim, dim=-1)


def beta_predict_mean_and_var(params, fmean, fvar,
                              n_points=DEFAULT_NUM_GAUSS_HERMITE):
    """E[y] = E[mu], Var[y] = E[mu (1 - mu)] / (scale + 1) + Var[mu]."""
    scale = positive(params["raw_scale"])
    e_mu = gauss_hermite_expectation(torch.sigmoid, fmean, fvar, n_points)
    e_mu2 = gauss_hermite_expectation(
        lambda f: torch.square(torch.sigmoid(f)), fmean, fvar, n_points)
    v = ((e_mu - e_mu2) / (scale + 1.0)
         + torch.clamp(e_mu2 - torch.square(e_mu), min=0.0))
    return e_mu, v


def beta_predict_density(params, fmean, fvar, y,
                         n_points=DEFAULT_NUM_GAUSS_HERMITE):
    scale = positive(params["raw_scale"])
    per_dim = gauss_hermite_log_expectation(
        lambda f: _beta_logp(scale, f, y[..., None]), fmean, fvar, n_points)
    return torch.sum(per_dim, dim=-1)


# ---- Ordinal (probit bins, fixed edges) ----------------------------------

def ordinal_params(num_classes: int = 3, bin_edges=None, *,
                   dtype=torch.float32, device="cuda"):
    """bin_edges [C-1], increasing; by default unit-spaced about 0."""
    if bin_edges is None:
        bin_edges = [i - (num_classes - 2) / 2.0
                     for i in range(num_classes - 1)]
    return {"bin_edges": torch.as_tensor(bin_edges, dtype=dtype,
                                         device=device)}


def _log_gauss_interval(lo, hi):
    """log(Phi(hi) - Phi(lo)) for lo < hi, reflected into the left tail
    where the interval sits in the right one (a difference of two CDFs
    underflows ~8 sigma out)."""
    flip = (lo + hi) > 0.0
    l2 = torch.where(flip, -hi, lo)
    h2 = torch.where(flip, -lo, hi)
    la = torch.special.log_ndtr(h2)
    lb = torch.special.log_ndtr(l2)
    return la + torch.log1p(-torch.exp(torch.clamp(lb - la, max=-1e-12)))


def _ordinal_bounds(edges, y):
    """Per-label (lo, hi) edges with finite sentinel boundaries."""
    sent = torch.full((1,), _ORDINAL_SENTINEL, dtype=edges.dtype,
                      device=edges.device)
    lo_edges = torch.cat([-sent, edges])
    hi_edges = torch.cat([edges, sent])
    yi = torch.clamp(y.long(), 0, edges.shape[0])
    return lo_edges[yi], hi_edges[yi]


def ordinal_variational_expectations(params, mean, var, y,
                                     n_points=DEFAULT_NUM_GAUSS_HERMITE):
    lo, hi = _ordinal_bounds(params["bin_edges"].detach(), y[..., None])
    per_dim = gauss_hermite_expectation(
        lambda f: _log_gauss_interval(lo - f, hi - f), mean, var, n_points)
    return torch.sum(per_dim, dim=-1)


def ordinal_predict_probs(params, fmean, fvar) -> torch.Tensor:
    """Class probabilities [..., C]: p(y <= c) = Phi((b_c - m)/sqrt(1+v))."""
    edges = params["bin_edges"].detach()
    m = fmean[..., 0]
    s = torch.sqrt(1.0 + fvar[..., 0])
    cdf = torch.special.ndtr((edges - m[..., None]) / s[..., None])
    cdf = torch.cat([torch.zeros_like(m)[..., None], cdf,
                     torch.ones_like(m)[..., None]], dim=-1)
    return torch.clamp(torch.diff(cdf, dim=-1), 0.0, 1.0)


def ordinal_predict_mean_and_var(params, fmean, fvar):
    """Moments of the predictive label distribution, [..., 1] each."""
    p = ordinal_predict_probs(params, fmean, fvar)
    ks = torch.arange(p.shape[-1], dtype=p.dtype, device=p.device)
    m = torch.sum(p * ks, dim=-1, keepdim=True)
    v = torch.sum(p * torch.square(ks), dim=-1, keepdim=True) \
        - torch.square(m)
    return m, torch.clamp(v, min=0.0)


def ordinal_predict_density(params, fmean, fvar, y):
    """log[Phi((b_y - m)/s) - Phi((b_{y-1} - m)/s)], s = sqrt(1 + v)."""
    lo, hi = _ordinal_bounds(params["bin_edges"].detach(), y)
    s = torch.sqrt(1.0 + fvar)
    per_dim = _log_gauss_interval((lo - fmean) / s, (hi - fmean) / s)
    return torch.sum(per_dim, dim=-1)


# ---- Multiclass (robust-max) ---------------------------------------------

def multiclass_params(*, dtype=torch.float32, device="cuda"):
    return _unused_params(dtype, device)


def _class_onehot(y, num_classes: int, dtype):
    """[..., 1] float class column -> [..., C] one-hot, the label clipped
    into [0, C) (an all-zero row would corrupt ``_robustmax_p_win``). A
    comparison, not ``one_hot``, which reads the labels' range to the host
    off the card."""
    idx = torch.clamp(y[..., 0].long(), 0, num_classes - 1)
    classes = torch.arange(num_classes, device=y.device)
    return (idx[..., None] == classes).to(dtype)


def _robustmax_p_win(mean, var, onehot, n_points):
    """P(f_c >= f_j for all j) for the class marked by onehot [..., C]:
    one Gauss-Hermite rule over the winning component, the j == c factor
    masked to 1."""
    xs, ws = _rule(n_points, mean)
    sd = safe_sqrt(var)
    m_c = torch.sum(mean * onehot, dim=-1, keepdim=True)
    sd_c = torch.sum(sd * onehot, dim=-1, keepdim=True)
    fc = m_c[..., None] + sd_c[..., None] * xs                # [..., 1, Q]
    z = (fc - mean[..., None]) / sd[..., None]                # [..., C, Q]
    logcdf = torch.special.log_ndtr(z)
    logcdf = torch.where(onehot[..., None] > 0.5,
                         torch.zeros_like(logcdf), logcdf)
    prod = torch.exp(torch.sum(logcdf, dim=-2))               # [..., Q]
    return torch.clamp(torch.sum(prod * ws, dim=-1), 0.0, 1.0)


def _robustmax_p(p_win, C: int):
    return (1.0 - ROBUSTMAX_EPS) * p_win + (ROBUSTMAX_EPS / (C - 1)) * (
        1.0 - p_win)


def multiclass_variational_expectations(params, mean, var, y,
                                        n_points=DEFAULT_NUM_GAUSS_HERMITE):
    """P_win log(1 - eps) + (1 - P_win) log(eps / (C - 1))."""
    C = mean.shape[-1]
    p = _robustmax_p_win(mean, var, _class_onehot(y, C, mean.dtype),
                         n_points)
    return (p * math.log(1.0 - ROBUSTMAX_EPS)
            + (1.0 - p) * math.log(ROBUSTMAX_EPS / (C - 1)))


def multiclass_predict_probs(params, fmean, fvar,
                             n_points=DEFAULT_NUM_GAUSS_HERMITE):
    """Predictive class probabilities [..., C]."""
    C = fmean.shape[-1]
    eye = torch.eye(C, dtype=fmean.dtype, device=fmean.device)
    p_win = torch.stack([_robustmax_p_win(fmean, fvar, eye[c], n_points)
                         for c in range(C)], dim=-1)
    return _robustmax_p(p_win, C)


def multiclass_predict_mean_and_var(params, fmean, fvar,
                                    n_points=DEFAULT_NUM_GAUSS_HERMITE):
    p = multiclass_predict_probs(params, fmean, fvar, n_points)
    return p, p - torch.square(p)


def multiclass_predict_density(params, fmean, fvar, y,
                               n_points=DEFAULT_NUM_GAUSS_HERMITE):
    C = fmean.shape[-1]
    p_win = _robustmax_p_win(fmean, fvar, _class_onehot(y, C, fmean.dtype),
                             n_points)
    return torch.log(_robustmax_p(p_win, C))


# ---- Softmax (a fixed quasi-Monte-Carlo rule) ----------------------------

def softmax_params(num_classes: int | None = None, *, dtype=torch.float32,
                   device="cuda"):
    del num_classes  # C is the final layer's width
    return _unused_params(dtype, device)


def _halton_uniform(n_points: int, dim: int) -> np.ndarray:
    """[P, C] Halton points in (0, 1), float64, clipped as the
    reference's before its inverse normal CDF."""
    primes, cand = [], 2
    while len(primes) < dim:
        if all(cand % p for p in primes):
            primes.append(cand)
        cand += 1
    idx = np.arange(1, n_points + 1)
    cols = []
    for b in primes:
        i, f, r = idx.copy(), 1.0, np.zeros(n_points)
        while i.max() > 0:
            f = f / b
            r = r + f * (i % b)
            i = i // b
        cols.append(r)
    return np.clip(np.stack(cols, axis=-1), 1e-7, 1.0 - 1e-7)


def _halton_qmc_normal(n_points: int, dim: int, like: torch.Tensor):
    """[P, C] standard-normal QMC points in the dtype and on the device of
    `like` (the inverse CDF taken in float64)."""
    return _constant(("halton", n_points, dim), lambda: torch.special.ndtri(
        torch.from_numpy(_halton_uniform(n_points, dim))).numpy(), like)


def _softmax_draws(mean, var, n_points):
    P = n_points or SOFTMAX_QMC_POINTS
    z = _halton_qmc_normal(P, mean.shape[-1], mean)
    return mean[..., None, :] + safe_sqrt(var)[..., None, :] * z


def _softmax_label_logps(mean, var, y, n_points):
    """[..., P] log softmax_y(f_p) at the QMC draws."""
    logp = torch.log_softmax(_softmax_draws(mean, var, n_points), dim=-1)
    onehot = _class_onehot(y, mean.shape[-1], mean.dtype)
    return torch.sum(logp * onehot[..., None, :], dim=-1)


def softmax_variational_expectations(params, mean, var, y, n_points=None):
    return torch.mean(_softmax_label_logps(mean, var, y, n_points), dim=-1)


def softmax_predict_probs(params, fmean, fvar, n_points=None):
    """p_c = E[softmax_c(f)]: [..., C]."""
    return torch.mean(torch.softmax(_softmax_draws(fmean, fvar, n_points),
                                    dim=-1), dim=-2)


def softmax_predict_mean_and_var(params, fmean, fvar, n_points=None):
    p = softmax_predict_probs(params, fmean, fvar, n_points)
    return p, p - torch.square(p)


def softmax_predict_density(params, fmean, fvar, y, n_points=None):
    """log E[softmax_y(f)], a logsumexp over the QMC draws."""
    lps = _softmax_label_logps(fmean, fvar, y, n_points)
    return torch.logsumexp(lps, dim=-1) - math.log(float(lps.shape[-1]))


# ---- Switched Gaussian (per-task noise) ----------------------------------

def switched_gaussian_params(num_tasks: int, noise_variance: float = 0.05, *,
                             dtype=torch.float32, device="cuda"):
    """One trainable noise variance per task, all equal at the start."""
    if num_tasks < 1:
        raise ValueError(f"num_tasks must be >= 1, got {num_tasks}")
    return {"raw_noise_variance": positive_inverse(torch.full(
        (num_tasks,), noise_variance, dtype=dtype, device=device))}


def _switched_split(params, y):
    """(targets [..., N, D-1], per-point s2 [..., N, 1]) from y whose last
    column is the task index."""
    s2_all = positive(params["raw_noise_variance"])
    ix = torch.clamp(torch.round(y[..., -1]).long(), 0, s2_all.shape[0] - 1)
    return y[..., :-1], s2_all[ix][..., None]


def switched_variational_expectations(params, mean, var, y):
    yt, s2 = _switched_split(params, y)
    per_dim = -0.5 * (_LOG2PI + torch.log(s2)
                      + (torch.square(yt - mean) + var) / s2)
    return torch.sum(per_dim, dim=-1)


def switched_predict_mean_and_var(params, fmean, fvar, y=None):
    """The observation moments need each point's task: y, task-tagged."""
    if y is None:
        raise ValueError(
            "switched_gaussian predict_mean_and_var needs the task-tagged y "
            "(task index in the last column) to pick each point's noise; "
            "use predict_y_and_log_density or evaluate, which pass it")
    _, s2 = _switched_split(params, y)
    return fmean, fvar + s2


def switched_predict_density(params, fmean, fvar, y):
    yt, s2 = _switched_split(params, y)
    v = fvar + s2
    per_dim = -0.5 * (_LOG2PI + torch.log(v) + torch.square(yt - fmean) / v)
    return torch.sum(per_dim, dim=-1)


# ---- dispatch -------------------------------------------------------------

_FAMILIES = {
    "gaussian": (variational_expectations, predict_mean_and_var,
                 predict_density),
    "switched_gaussian": (switched_variational_expectations,
                          switched_predict_mean_and_var,
                          switched_predict_density),
    "bernoulli": (bernoulli_variational_expectations,
                  bernoulli_predict_mean_and_var, bernoulli_predict_density),
    "student_t": (student_t_variational_expectations,
                  student_t_predict_mean_and_var, student_t_predict_density),
    "poisson": (poisson_variational_expectations,
                poisson_predict_mean_and_var, poisson_predict_density),
    "exponential": (exponential_variational_expectations,
                    exponential_predict_mean_and_var,
                    exponential_predict_density),
    "gamma": (gamma_variational_expectations, gamma_predict_mean_and_var,
              gamma_predict_density),
    "beta": (beta_variational_expectations, beta_predict_mean_and_var,
             beta_predict_density),
    "multiclass": (multiclass_variational_expectations,
                   multiclass_predict_mean_and_var,
                   multiclass_predict_density),
    "ordinal": (ordinal_variational_expectations,
                ordinal_predict_mean_and_var, ordinal_predict_density),
    "softmax": (softmax_variational_expectations,
                softmax_predict_mean_and_var, softmax_predict_density),
}

LIKELIHOOD_KINDS = tuple(_FAMILIES)


def _family(kind: str) -> tuple:
    try:
        return _FAMILIES[kind]
    except KeyError:
        raise ValueError(f"unknown likelihood {kind!r}; one of "
                         f"{LIKELIHOOD_KINDS}") from None


def init_params(kind: str = "gaussian", noise_variance: float = 0.05, *,
                dtype=torch.float32, device="cuda",
                **family_kwargs) -> LikelihoodParams:
    """family_kwargs: switched_gaussian(num_tasks), student_t(scale, df),
    gamma(shape), beta(scale), ordinal(num_classes, bin_edges).
    noise_variance applies to the Gaussian families only."""
    _family(kind)
    kw = dict(dtype=dtype, device=device)
    if kind == "gaussian":
        return gaussian_params(noise_variance, **kw)
    if kind == "switched_gaussian":
        return switched_gaussian_params(noise_variance=noise_variance, **kw,
                                        **family_kwargs)
    if kind in ("bernoulli", "poisson", "exponential", "multiclass"):
        return _unused_params(dtype, device)
    makers = {"student_t": student_t_params, "gamma": gamma_params,
              "beta": beta_params, "softmax": softmax_params,
              "ordinal": ordinal_params}
    return makers[kind](**kw, **family_kwargs)


def dispatch_variational_expectations(params, mean, var, y, *,
                                      kind: str = "gaussian") -> torch.Tensor:
    return _family(kind)[0](params, mean, var, y)


def dispatch_predict_mean_and_var(params, fmean, fvar, *,
                                  kind: str = "gaussian", y=None):
    """y (task-tagged labels) is read by 'switched_gaussian' only."""
    if kind == "switched_gaussian":
        return _family(kind)[1](params, fmean, fvar, y)
    return _family(kind)[1](params, fmean, fvar)


def dispatch_predict_density(params, fmean, fvar, y, *,
                             kind: str = "gaussian") -> torch.Tensor:
    return _family(kind)[2](params, fmean, fvar, y)


def _noise(noise, shape, like, generator, draw):
    """The caller's draws of `shape`, else `draw` from the generator."""
    if noise is not None:
        if tuple(noise.shape) != tuple(shape):
            raise ValueError(f"noise must have shape {tuple(shape)}, got "
                             f"{tuple(noise.shape)}")
        return noise.to(device=like.device)
    if generator is None:
        raise ValueError("observation draws need noise or a "
                         "torch.Generator")
    return draw(shape, generator=generator, dtype=like.dtype,
                device=like.device)


def _gamma_draws(alpha, generator):
    """Gamma(alpha, 1) draws, one per element of alpha."""
    return torch._standard_gamma(alpha.contiguous(), generator=generator)


def dispatch_sample_observations(params, fs: torch.Tensor,
                                 generator: torch.Generator | None = None, *,
                                 kind: str = "gaussian",
                                 noise=None) -> torch.Tensor:
    """One observation draw per function draw f (same shape; [..., 1]
    labels from [..., C] for multiclass and softmax), the sampling side of
    the observation model (reference l.827-878).

    noise: the caller's draws in place of the generator's, for the
    families whose reference draws are normal or uniform: gaussian and
    ordinal a standard normal of fs's shape, bernoulli a uniform of fs's
    shape (y = u < Phi(f)), multiclass a pair (u uniform [...], offset
    integers in [1, C) [...]): the label is the argmax, replaced by
    (argmax + offset) mod C where u < eps."""
    if kind == "gaussian":
        z = _noise(noise, fs.shape, fs, generator, torch.randn)
        return fs + torch.sqrt(noise_variance(params)) * z
    if kind == "switched_gaussian":
        raise ValueError(
            "switched_gaussian observation sampling needs per-point task "
            "indices; draw f with predict_f_samples and add "
            "N(0, s2[task]) noise for your task assignment")
    if kind == "bernoulli":
        u = _noise(noise, fs.shape, fs, generator, torch.rand)
        return (u < torch.special.ndtr(fs)).to(fs.dtype)
    if kind == "ordinal":
        z = fs + _noise(noise, fs.shape, fs, generator, torch.randn)
        edges = params["bin_edges"].detach()
        return torch.sum(z[..., None] > edges, dim=-1).to(fs.dtype)
    if kind == "multiclass":
        C = fs.shape[-1]
        win = torch.argmax(fs, dim=-1)
        if noise is None:
            u = _noise(None, win.shape, fs, generator, torch.rand)
            offset = torch.randint(1, C, win.shape, generator=generator,
                                   device=fs.device)
        else:
            u, offset = (t.to(fs.device) for t in noise)
        other = (win + offset.to(win.dtype)) % C
        return torch.where(u < ROBUSTMAX_EPS, other,
                           win).to(fs.dtype)[..., None]
    if noise is not None:
        raise ValueError(f"{kind!r} draws take a torch.Generator, not "
                         "injected noise")
    if generator is None:
        raise ValueError("observation draws need a torch.Generator")
    if kind == "student_t":
        scale = positive(params["raw_scale"])
        df = params["df"].detach()
        z = torch.randn(fs.shape, generator=generator, dtype=fs.dtype,
                        device=fs.device)
        g = _gamma_draws(torch.broadcast_to(df / 2.0, fs.shape), generator)
        return fs + scale * z * torch.sqrt(df / (2.0 * g))
    if kind == "poisson":
        return torch.poisson(torch.exp(fs), generator=generator)
    if kind == "exponential":
        return torch.exp(fs) * torch.empty_like(fs).exponential_(
            generator=generator)
    if kind == "gamma":
        k = positive(params["raw_shape"])
        return torch.exp(fs) * _gamma_draws(torch.broadcast_to(k, fs.shape),
                                            generator)
    if kind == "beta":
        scale = positive(params["raw_scale"])
        mu = torch.sigmoid(fs)
        a = _gamma_draws(mu * scale, generator)
        b = _gamma_draws((1.0 - mu) * scale, generator)
        return a / (a + b)
    if kind == "softmax":  # Gumbel-max over the last axis
        u = torch.rand(fs.shape, generator=generator, dtype=fs.dtype,
                       device=fs.device)
        return torch.argmax(fs - torch.log(-torch.log(u)),
                            dim=-1).to(fs.dtype)[..., None]
    raise ValueError(f"unknown likelihood {kind!r}; one of "
                     f"{LIKELIHOOD_KINDS}")
