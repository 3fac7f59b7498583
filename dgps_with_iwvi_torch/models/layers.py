"""DGP layer stack: whitened SVGP layers and latent-variable layers
(port of dgps_with_iwvi_tpu/models/layers.py).

A layer is a static dataclass config plus a plain dict of tensors. Leading
sample axes (S prediction samples) broadcast through every layer as batch
axes. Every random draw takes either the caller's noise (``eps``) or an
explicit ``torch.Generator``; tests inject the reference's own draws.

Training merges natural-gradient blocks in covariance form: a GP layer's
params then carry ``q_cov`` [D, M, M] (with the carried ``q_cov_logdet``
and ``q_cov_Sinv``) or ``q_cov_diag`` [M, D] in place of ``q_sqrt``
(``training/natgrad.py``).
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import conditionals, kernels, kl, mean_functions
from ..ops.linalg import DEFAULT_JITTER
from ..ops.precision import Numerics
from . import encoders


class LatentVarMode:
    """Where latent-variable layers get w from.

    POSTERIOR: q(w | x, y), amortized or per data point — training.
    PRIOR:     w ~ N(0, I) — prediction.
    GIVEN:     externally fixed w — latent traversals / plotting.
    """

    POSTERIOR = "posterior"
    PRIOR = "prior"
    GIVEN = "given"


@dataclasses.dataclass(frozen=True)
class GPLayerConfig:
    d_in: int
    d_out: int
    num_inducing: int
    kernel_kind: str = "rbf"
    # 'skip' (identity / fixed linear), 'zero', 'linear', 'constant' or
    # 'auto': zero on the final layer, skip between inner layers
    mean_function: str = "auto"
    final: bool = False   # final layers return (mean, var), no sample
    white: bool = True    # whitened q(v), u = Lm v
    q_diag: bool = False  # diagonal q covariance


@dataclasses.dataclass(frozen=True)
class LVLayerConfig:
    d_w: int
    d_in: int   # width of the propagated features entering this layer
    d_y: int    # observation dim fed to the amortized encoder
    d_x: int = -1  # encoder's x width; <= 0 means d_in
    encoder_hidden: tuple = (20, 20)
    encoder_init_logvar: float = -4.6
    amortized: bool = True
    num_data: int = 0


def _normal(shape, like: torch.Tensor, eps: torch.Tensor | None,
            generator: torch.Generator | None) -> torch.Tensor:
    """The caller's noise, or a standard normal draw from `generator`."""
    if eps is not None:
        if tuple(eps.shape) != tuple(shape):
            raise ValueError(f"eps must have shape {tuple(shape)}, got "
                             f"{tuple(eps.shape)}")
        return eps.to(dtype=like.dtype, device=like.device)
    if generator is None:
        raise ValueError("a sample site needs eps or a torch.Generator")
    return torch.randn(shape, generator=generator, dtype=like.dtype,
                       device=like.device)


def resolved_mean_function(cfg: GPLayerConfig) -> str:
    if cfg.mean_function == "auto":
        return "zero" if cfg.final else "skip"
    return cfg.mean_function


def gp_layer_init(generator: torch.Generator, cfg: GPLayerConfig,
                  Z: torch.Tensor | None = None, lengthscales=1.0,
                  kernel_variance: float = 1.0, q_sqrt_scale: float = 1.0, *,
                  dtype=torch.float32, device="cuda"):
    """Parameters of one whitened SVGP layer: q_mu = 0, q_sqrt = scale * I,
    unit variance, ARD lengthscales; Z standard normal unless given."""
    kw = dict(dtype=dtype, device=device)
    m = cfg.num_inducing
    if Z is None:
        Z = torch.randn((m, cfg.d_in), generator=generator, **kw)
    if cfg.q_diag:
        q_sqrt = torch.full((m, cfg.d_out), q_sqrt_scale, **kw)
    else:
        q_sqrt = (q_sqrt_scale * torch.eye(m, **kw)).expand(
            cfg.d_out, m, m).clone()
    params = {
        "kernel": kernels.kernel_params(cfg.kernel_kind, cfg.d_in,
                                        variance=kernel_variance,
                                        lengthscales=lengthscales, **kw),
        "Z": torch.as_tensor(Z, **kw),
        "q_mu": torch.zeros((m, cfg.d_out), **kw),
        "q_sqrt": q_sqrt,
    }
    mf = resolved_mean_function(cfg)
    if mf == "skip":
        W = mean_functions.skip_projection(cfg.d_in, cfg.d_out, **kw)
        if W is not None:
            params["mean_W"] = W
    elif mf == "linear":
        params["mean_W"] = torch.eye(cfg.d_in, cfg.d_out, **kw)
        params["mean_b"] = torch.zeros((cfg.d_out,), **kw)
    elif mf == "constant":
        params["mean_b"] = torch.zeros((cfg.d_out,), **kw)
    elif mf != "zero":
        raise ValueError(f"unknown mean function {mf!r}")
    return params


def lv_layer_init(generator: torch.Generator, cfg: LVLayerConfig, *,
                  dtype=torch.float32, device="cuda"):
    kw = dict(dtype=dtype, device=device)
    if not cfg.amortized:
        if cfg.num_data <= 0:
            raise ValueError("a non-amortized LV layer needs num_data")
        return {
            "q_mu_w": torch.zeros((cfg.num_data, cfg.d_w), **kw),
            "q_logvar_w": torch.full((cfg.num_data, cfg.d_w),
                                     cfg.encoder_init_logvar, **kw),
        }
    d_x = cfg.d_x if cfg.d_x > 0 else cfg.d_in
    return {"encoder": encoders.encoder_init(
        generator, d_x + cfg.d_y, cfg.d_w, cfg.encoder_hidden,
        cfg.encoder_init_logvar, **kw)}


def layer_Kuu(params, cfg: GPLayerConfig) -> torch.Tensor:
    """[M, M] prior covariance of this layer's inducing variables."""
    return kernels.K(params["kernel"], params["Z"], params["Z"],
                     kind=cfg.kernel_kind)


def gp_layer_propagate(
    params,
    cfg: GPLayerConfig,
    F: torch.Tensor,                 # [..., B, d_in]
    *,
    eps: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    jitter: float = DEFAULT_JITTER,
    jitter_tries: int = 4,
    numerics: Numerics = Numerics(),
    Lm: torch.Tensor | None = None,
    Linv: torch.Tensor | None = None,
):
    """One whitened-SVGP layer step.

    Non-final: (reparameterized sample [..., B, d_out], (mean, var)), the
    sample noise from ``eps`` or ``generator``. Final: (None, (mean, var)).
    """
    q_cov = params.get("q_cov", params.get("q_cov_diag"))
    if q_cov is not None:
        q_sqrt = None
    else:
        q_sqrt = (params["q_sqrt"] if cfg.q_diag
                  else torch.tril(params["q_sqrt"]))
    out = conditionals.conditional(
        F, params["Z"], params["kernel"], params["q_mu"], q_sqrt,
        kernel_kind=cfg.kernel_kind, jitter=jitter, jitter_tries=jitter_tries,
        white=cfg.white, var_precision=numerics.var,
        solve_precision=numerics.solve,
        solve_bwd_precision=numerics.solve_bwd,
        kuf_residual=numerics.kuf_residual, Lm=Lm, Linv=Linv, q_S=q_cov)
    mf_kind = resolved_mean_function(cfg)
    if mf_kind == "skip":
        W = params.get("mean_W")  # fixed: no gradient, as in the reference
        mean = out.mean + mean_functions.apply_mean_function(
            F, None if W is None else W.detach())
    elif mf_kind == "linear":
        mean = (out.mean + mean_functions.linear_mean(F, params["mean_W"])
                + params["mean_b"])
    elif mf_kind == "constant":
        mean = out.mean + params["mean_b"]
    else:
        mean = out.mean
    if cfg.final:
        return None, (mean, out.var)
    noise = _normal(mean.shape, mean, eps, generator)
    return mean + conditionals.safe_sqrt(out.var) * noise, (mean, out.var)


def gp_layer_kl(params, cfg: GPLayerConfig) -> torch.Tensor:
    """Global KL(q(u) || p(u)) of one whitened GP layer (reference
    ``layers.py:286-315``; the non-whitened KL waits for ROADMAP queue 7)."""
    if not cfg.white:
        raise NotImplementedError(
            "the non-whitened KL is not ported yet (ROADMAP queue 7)")
    if cfg.q_diag:
        if "q_cov_diag" in params:
            return kl.gauss_kl_white_diagvar(params["q_mu"],
                                             params["q_cov_diag"])
        return kl.gauss_kl_white_diag(params["q_mu"], params["q_sqrt"])
    if "q_cov" in params:
        return kl.gauss_kl_white_cov(params["q_mu"], params["q_cov"],
                                     params["q_cov_logdet"],
                                     params["q_cov_Sinv"])
    return kl.gauss_kl_white(params["q_mu"], torch.tril(params["q_sqrt"]))


def lv_layer_propagate(
    params,
    cfg: LVLayerConfig,
    F: torch.Tensor,                 # [..., B, d_in]
    *,
    mode: str = LatentVarMode.PRIOR,
    X0: torch.Tensor | None = None,
    Y: torch.Tensor | None = None,
    w_given: torch.Tensor | None = None,
    data_idx: torch.Tensor | None = None,
    eps: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
):
    """Concatenate a latent w onto the features: (F_aug, log_w, local_kl).

    POSTERIOR: w = mu + exp(log_var / 2) eps from the encoder on
    concat[X0, Y] (amortized) or the rows ``data_idx`` of the per-point
    parameters; log_w [..., B] = log p(w) - log q(w|x,y) and local_kl [B]
    the analytic KL. PRIOR and GIVEN: both zero."""
    lead, B = F.shape[:-2], F.shape[-2]
    kw = dict(dtype=F.dtype, device=F.device)
    log_w, local_kl = torch.zeros(lead + (B,), **kw), torch.zeros((B,), **kw)
    if mode == LatentVarMode.PRIOR:
        w = _normal(lead + (B, cfg.d_w), F, eps, generator)
    elif mode == LatentVarMode.GIVEN:
        if w_given is None:
            raise ValueError("GIVEN mode needs w_given")
        w = torch.broadcast_to(w_given.to(**kw), lead + (B, cfg.d_w))
    elif mode == LatentVarMode.POSTERIOR:
        if cfg.amortized:
            if X0 is None or Y is None:
                raise ValueError("POSTERIOR mode needs (X0, Y)")
            mu, log_var = encoders.encode(params["encoder"],
                                          torch.cat([X0, Y], dim=-1))
        else:
            if data_idx is None:
                raise ValueError("a non-amortized POSTERIOR needs data_idx")
            mu = params["q_mu_w"][data_idx]
            log_var = params["q_logvar_w"][data_idx]
        w = mu + torch.exp(0.5 * log_var) * _normal(lead + (B, cfg.d_w), F,
                                                    eps, generator)
        log_w = (kl.std_gaussian_logpdf(w)
                 - kl.diag_gaussian_logpdf(w, mu, log_var))
        local_kl = kl.gauss_kl_diag_white(mu, log_var)
    else:
        raise ValueError(f"unknown LatentVarMode {mode!r}")
    F_aug = torch.cat([torch.broadcast_to(F, lead + F.shape[-2:]), w], dim=-1)
    return F_aug, log_w, local_kl
