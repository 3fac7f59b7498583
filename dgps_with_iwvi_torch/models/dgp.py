"""DGP model, objectives and prediction (port of dgps_with_iwvi_tpu/models/dgp.py).

``DGPConfig``, ``init_dgp``, ``prefactor_gp_layers``, ``propagate``, the
objectives ``gp_kls`` and ``elbo`` ('vi' and 'iw', with the
hyperparameter log-prior, l.245-296) and the prediction functions:
``predict_y_and_log_density`` (the live scoring call), the marginal and
full-covariance predictives and the function and observation draws.

Noise: the reference keys layer i with ``fold_in(key, i)``. Here every
sample site takes either the caller's noise (``eps[i]`` for layer i: w of
a latent-variable layer, the sample noise of an inner GP layer; the
sampling predictives' own draws by name) or a draw from ``generator``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from ..ops import conditionals, features, kernels, likelihoods, linalg
from ..ops import priors as priors_mod
from ..ops.precision import Numerics
from .layers import (GPLayerConfig, LatentVarMode, LVLayerConfig,
                     gp_layer_init, gp_layer_kl, gp_layer_propagate,
                     layer_Kuu, layer_mean_function, lv_layer_init,
                     lv_layer_propagate)


@dataclasses.dataclass(frozen=True)
class DGPConfig:
    """Static model configuration (the reference's fields this slice uses).

    var_precision: class of the q-variance matmuls ('default' = bf16
    operands, f32 accumulation). solve_precision: class of the solve path
    A = Linv Kuf and the mean ('high' = bf16x3). See ops/precision.py.

    use_pallas: True takes whitened RBF layers through the whole-
    conditional kernel K5 (inner layers with the sample drawn in the
    kernel, the final layer through its f32 forward and residual
    backward); "auto" resolves to False, as in the reference
    (``models/dgp.py:63``, ``layers.py:213-214``).
    serve_pallas: True takes prediction through the inference-only K4 (at
    the 'default' / 'high' classes); the counterpart of the reference's
    module switch ``ops/conditionals.py:856`` ``SERVE_PALLAS``, as an
    explicit field. Not differentiable: an objective that needs gradients
    raises with it True. "auto" takes K4 where the reference's "auto"
    does, in inference off the CPU: on CUDA tensors through which no
    gradient is needed. The reference ships "off" from TPU measurements;
    on the H100 K4 is the fastest serving route (PERF.md), so "auto" is
    the default here, and False keeps the default route.
    """

    layers: tuple  # tuple[GPLayerConfig | LVLayerConfig, ...]
    num_data: int
    objective: str = "vi"       # 'vi' | 'iw'
    num_samples: int = 1        # S, the prediction default
    num_iw_samples: int = 1     # K
    jitter: float = linalg.DEFAULT_JITTER
    use_pallas: bool | str = "auto"
    likelihood: str = "gaussian"
    jitter_tries: int = 4
    var_precision: str = "default"
    solve_precision: str = "high"
    # hyperparameter priors, (path_suffix, kind, a, b) specs
    # (ops/priors.py), added to the objective; () = off
    priors: tuple = ()
    serve_pallas: bool | str = "auto"

    def __post_init__(self):
        if self.objective not in ("vi", "iw"):
            raise ValueError(f"objective must be 'vi' or 'iw', got "
                             f"{self.objective!r}")
        gp_cfgs = [c for c in self.layers if isinstance(c, GPLayerConfig)]
        if not gp_cfgs or gp_cfgs[-1] is not self.layers[-1]:
            raise ValueError("the last layer must be a GP layer")
        if any(c.final for c in gp_cfgs[:-1]) or not gp_cfgs[-1].final:
            raise ValueError("exactly the last GP layer must have final=True")


def init_dgp(generator: torch.Generator, config: DGPConfig,
             Z_inits: Sequence[torch.Tensor | None] | None = None,
             inner_q_sqrt_scale: float = 1e-5, noise_variance: float = 0.05,
             *, dtype=torch.float32, device="cuda",
             likelihood_kwargs: dict | None = None):
    """Full parameter tree {"layers": [...], "likelihood": {...}}.

    Inner GP layers start near-deterministic (q_sqrt = 1e-5 I), the final
    layer at q_sqrt = I. likelihood_kwargs: the family's own initial
    values (``likelihoods.init_params``)."""
    kw = dict(dtype=dtype, device=device)
    n_gp = sum(isinstance(c, GPLayerConfig) for c in config.layers)
    Z_iter = list(Z_inits) if Z_inits is not None else [None] * n_gp
    layer_params, gp_idx = [], 0
    for cfg in config.layers:
        if isinstance(cfg, GPLayerConfig):
            scale = 1.0 if cfg.final else inner_q_sqrt_scale
            layer_params.append(gp_layer_init(
                generator, cfg, Z=Z_iter[gp_idx], q_sqrt_scale=scale, **kw))
            gp_idx += 1
        else:
            layer_params.append(lv_layer_init(generator, cfg, **kw))
    return {"layers": layer_params,
            "likelihood": likelihoods.init_params(
                config.likelihood, noise_variance, **kw,
                **(likelihood_kwargs or {}))}


def prefactor_gp_layers(params, config: DGPConfig) -> dict:
    """One batched Kuu factorization for all GP layers of each M:
    {layer_id: (Lm, Linv)}; on the card, one K1 launch per M."""
    groups: dict = {}
    for i, cfg in enumerate(config.layers):
        if isinstance(cfg, GPLayerConfig):
            groups.setdefault(cfg.num_inducing, []).append(i)
    out = {}
    for ids in groups.values():
        Kuus = torch.stack([layer_Kuu(params["layers"][i], config.layers[i])
                            for i in ids])
        Lms, Linvs = linalg.chol_and_inverse(Kuus, config.jitter,
                                             config.jitter_tries)
        for j, i in enumerate(ids):
            out[i] = (Lms[j], Linvs[j])
    return out


def numerics_of(config: DGPConfig) -> Numerics:
    """The precision set a config names (solve backward at the solve
    class, the gram residual by size)."""
    return Numerics(var=config.var_precision, solve=config.solve_precision)


def propagate(params, config: DGPConfig, X: torch.Tensor, lead: tuple, *,
              lv_mode: str = LatentVarMode.PRIOR, ws_given=None,
              Y: torch.Tensor | None = None,
              data_idx: torch.Tensor | None = None,
              eps: Sequence | None = None,
              generator: torch.Generator | None = None,
              factors: dict | None = None,
              numerics: Numerics | None = None,
              stop_before_final: bool = False):
    """Thread samples through the layer stack.

    Returns (fmean, fvar, log_w, local_kl): fmean/fvar [*lead, B, d_y] the
    final layer's moments, log_w [*lead, B], local_kl [B].
    eps: per-layer noise (None entries draw from ``generator``). Y and
    data_idx feed the POSTERIOR latent mode. factors: a
    prefactor_gp_layers result to share; computed here when None.
    stop_before_final=True: returns (F, log_w, local_kl, factors) with F
    the final layer's input samples, without running it."""
    B = X.shape[0]
    numerics = numerics_of(config) if numerics is None else numerics
    F = torch.broadcast_to(X, tuple(lead) + X.shape)
    log_w = torch.zeros(tuple(lead) + (B,), dtype=X.dtype, device=X.device)
    local_kl = torch.zeros((B,), dtype=X.dtype, device=X.device)
    if factors is None:
        factors = prefactor_gp_layers(params, config)
    final_out, lv_idx = None, 0
    for i, cfg in enumerate(config.layers):
        eps_i = None if eps is None else eps[i]
        if isinstance(cfg, LVLayerConfig):
            w_given = None if ws_given is None else ws_given[lv_idx]
            F, lw_i, kl_i = lv_layer_propagate(
                params["layers"][i], cfg, F, mode=lv_mode, X0=X, Y=Y,
                w_given=w_given, data_idx=data_idx, eps=eps_i,
                generator=generator)
            log_w = log_w + lw_i
            local_kl = local_kl + kl_i
            lv_idx += 1
        else:
            if stop_before_final and cfg.final:
                return F, log_w, local_kl, factors
            Lm, Linv = factors[i]
            F, moments = gp_layer_propagate(
                params["layers"][i], cfg, F, eps=eps_i, generator=generator,
                jitter=config.jitter, jitter_tries=config.jitter_tries,
                numerics=numerics, Lm=Lm, Linv=Linv,
                use_pallas=config.use_pallas,
                serve_pallas=config.serve_pallas)
            if cfg.final:
                final_out = moments
    fmean, fvar = final_out
    return fmean, fvar, log_w, local_kl


def layer_noise(config: DGPConfig, lead: tuple, B: int,
                generator: torch.Generator, *,
                dtype=torch.float32) -> list:
    """The per-layer standard normals one ``propagate`` over B rows draws
    from `generator` (on its device), in the same order and shapes, as
    its ``eps``:
    [*lead, B, d_w] for a latent layer, [*lead, B, d_out] for an inner GP
    layer, None for the final layer. Slicing rows of each keeps those rows'
    noise, which lets a rank score part of a batch as the whole batch
    would. An inner layer that draws its noise inside K5 'sample'
    (``use_pallas``) draws a seed there instead, and given this noise takes
    K5 'fused' with the sample outside."""
    return [None if getattr(c, "final", False) else torch.randn(
        tuple(lead) + (B, c.d_w if isinstance(c, LVLayerConfig) else c.d_out),
        generator=generator, dtype=dtype, device=generator.device)
        for c in config.layers]


def gp_kls(params, config: DGPConfig,
           factors: dict | None = None) -> torch.Tensor:
    """Sum of the global KL(q(u) || p(u)) over GP layers. factors: the
    step's prefactor_gp_layers result, whose Lm the non-whitened KLs share
    (else each factors its Kuu)."""
    return sum(gp_layer_kl(params["layers"][i], cfg, config.jitter,
                           config.jitter_tries,
                           None if factors is None else factors[i][0])
               for i, cfg in enumerate(config.layers)
               if isinstance(cfg, GPLayerConfig))


def elbo(params, config: DGPConfig, X: torch.Tensor, Y: torch.Tensor,
         generator: torch.Generator | None = None, *,
         eps: Sequence | None = None, data_idx: torch.Tensor | None = None,
         numerics: Numerics | None = None) -> torch.Tensor:
    """The training objective (maximize), 'vi' or 'iw' per config.

    vi: (N/B) sum_B [mean_S ve - local_kl] - sum KL;
    iw: (N/B) sum_B [logsumexp_K(ve + log_w) - log K] - sum KL.
    eps: per-layer noise as in ``propagate``; data_idx: the minibatch's
    dataset rows (non-amortized latent layers); numerics: the precision
    set (default: the config's). One batched Kuu factorization serves the
    conditionals and the non-whitened KLs; the hyperparameter log-prior
    (config.priors) is added once."""
    scale = config.num_data / X.shape[0]
    lead = (config.num_samples if config.objective == "vi"
            else config.num_iw_samples,)
    factors = prefactor_gp_layers(params, config)
    fmean, fvar, log_w, local_kl = propagate(
        params, config, X, lead, lv_mode=LatentVarMode.POSTERIOR, Y=Y,
        data_idx=data_idx, eps=eps, generator=generator, factors=factors,
        numerics=numerics)
    ve = likelihoods.dispatch_variational_expectations(
        params["likelihood"], fmean, fvar, Y, kind=config.likelihood)
    if config.objective == "vi":
        datafit = torch.sum(torch.mean(ve, dim=0) - local_kl)
    else:
        datafit = torch.sum(torch.logsumexp(ve + log_w, dim=0)
                            - math.log(float(lead[0])))
    out = scale * datafit - gp_kls(params, config, factors)
    if config.priors:
        out = out + priors_mod.log_prior(params, config.priors)
    return out


def predict_f(params, config: DGPConfig, X: torch.Tensor,
              generator: torch.Generator | None = None,
              num_samples: int | None = None, *,
              lv_mode: str = LatentVarMode.PRIOR, ws_given=None,
              Y: torch.Tensor | None = None,
              data_idx: torch.Tensor | None = None,
              eps: Sequence | None = None, factors: dict | None = None):
    """S propagated samples of the final-layer moments: [S, B, d_y] x2.

    Latents come from the PRIOR; to reconstruct at training points pass
    lv_mode=LatentVarMode.POSTERIOR with Y (amortized layers) or data_idx
    (non-amortized). factors: a prefactor_gp_layers result to reuse (else
    computed)."""
    S = num_samples or config.num_samples
    fmean, fvar, _, _ = propagate(
        params, config, X, (S,), lv_mode=lv_mode, ws_given=ws_given, Y=Y,
        data_idx=data_idx, eps=eps, generator=generator, factors=factors)
    return fmean, fvar


def predict_f_full_cov(params, config: DGPConfig, X: torch.Tensor,
                       generator: torch.Generator | None = None,
                       num_samples: int | None = None, *,
                       lv_mode: str = LatentVarMode.PRIOR, ws_given=None,
                       Y: torch.Tensor | None = None,
                       data_idx: torch.Tensor | None = None,
                       eps: Sequence | None = None,
                       factors: dict | None = None):
    """The final layer's full-covariance predictive given S sampled paths
    through the earlier layers (marginal between layers, as the
    doubly-stochastic factorization has it): mean [S, B, d_y] and cov
    [S, d_y, B, B], all S at once (the reference maps over them).
    Arguments as ``predict_f``."""
    S = num_samples or config.num_samples
    F, _, _, factors = propagate(
        params, config, X, (S,), lv_mode=lv_mode, ws_given=ws_given, Y=Y,
        data_idx=data_idx, eps=eps, generator=generator, factors=factors,
        stop_before_final=True)
    i = len(config.layers) - 1
    cfg, lp = config.layers[i], params["layers"][i]
    q_sqrt = lp["q_sqrt"] if cfg.q_diag else torch.tril(lp["q_sqrt"])
    scales = lp.get("raw_Z_scales")
    if scales is not None:
        Kuf = features.multiscale_Kuf(lp["kernel"], lp["Z"], scales, F)
    else:
        Kuf = kernels.K(lp["kernel"], lp["Z"], F, kind=cfg.kernel_kind)
    Kff = kernels.K(lp["kernel"], F, F, kind=cfg.kernel_kind)
    out = conditionals.base_conditional_whitened_fullcov(
        Kuf, factors[i][0], Kff, lp["q_mu"], q_sqrt, white=cfg.white)
    mf = layer_mean_function(lp, cfg, F)
    return (out.mean if mf is None else out.mean + mf), out.var


def predict_f_samples(params, config: DGPConfig, X: torch.Tensor,
                      generator: torch.Generator | None = None,
                      num_samples: int | None = None, *,
                      lv_mode: str = LatentVarMode.PRIOR, ws_given=None,
                      Y: torch.Tensor | None = None,
                      data_idx: torch.Tensor | None = None,
                      eps: Sequence | None = None,
                      sample_eps: torch.Tensor | None = None,
                      factors: dict | None = None) -> torch.Tensor:
    """S function draws [S, B, d_y]: one reparameterized draw from each
    path's final-layer marginal (marginal across X; joint draws over a
    small X come from ``predict_f_full_cov``). sample_eps: the draw's
    noise [S, B, d_y], else from ``generator``; other arguments as
    ``predict_f``."""
    fmean, fvar = predict_f(params, config, X, generator, num_samples,
                            lv_mode=lv_mode, ws_given=ws_given, Y=Y,
                            data_idx=data_idx, eps=eps, factors=factors)
    if sample_eps is None:
        sample_eps = torch.randn(fmean.shape, generator=generator,
                                 dtype=fmean.dtype, device=fmean.device)
    return fmean + conditionals.safe_sqrt(fvar) * sample_eps.to(fmean)


def predict_y_samples(params, config: DGPConfig, X: torch.Tensor,
                      generator: torch.Generator | None = None,
                      num_samples: int | None = None, *,
                      lv_mode: str = LatentVarMode.PRIOR, ws_given=None,
                      Y: torch.Tensor | None = None,
                      data_idx: torch.Tensor | None = None,
                      eps: Sequence | None = None,
                      sample_eps: torch.Tensor | None = None,
                      obs_noise=None, factors: dict | None = None):
    """S observation draws [S, B, d_y] (multiclass and softmax: [S, B, 1]
    labels): ``predict_f_samples`` pushed through the observation model
    (``likelihoods.dispatch_sample_observations``, its injected draws
    ``obs_noise``)."""
    fs = predict_f_samples(params, config, X, generator, num_samples,
                           lv_mode=lv_mode, ws_given=ws_given, Y=Y,
                           data_idx=data_idx, eps=eps, sample_eps=sample_eps,
                           factors=factors)
    return likelihoods.dispatch_sample_observations(
        params["likelihood"], fs, generator, kind=config.likelihood,
        noise=obs_noise)


def _mixture_moments(params, config, fmean, fvar, Y=None):
    """Moments of the S-sample mixture; Y (task-tagged) is read by the
    switched Gaussian only."""
    m, v = likelihoods.dispatch_predict_mean_and_var(
        params["likelihood"], fmean, fvar, kind=config.likelihood, y=Y)
    mix_mean = torch.mean(m, dim=0)
    mix_var = torch.mean(v + torch.square(m), dim=0) - torch.square(mix_mean)
    return mix_mean, mix_var


def _mixture_log_density(params, config, fmean, fvar, Y):
    logp = likelihoods.dispatch_predict_density(
        params["likelihood"], fmean, fvar, Y, kind=config.likelihood)
    return torch.logsumexp(logp, dim=0) - math.log(float(fmean.shape[0]))


def predict_y(params, config: DGPConfig, X: torch.Tensor,
              generator: torch.Generator | None = None,
              num_samples: int | None = None, *, eps: Sequence | None = None,
              Y: torch.Tensor | None = None):
    """Mixture predictive moments of (1/S) sum_s N(m_s, v_s + s2). Y is
    needed by the switched Gaussian only, whose noise is indexed by the
    task column Y[:, -1]."""
    fmean, fvar = predict_f(params, config, X, generator, num_samples,
                            eps=eps)
    return _mixture_moments(params, config, fmean, fvar, Y)


def predict_log_density(params, config: DGPConfig, X: torch.Tensor,
                        Y: torch.Tensor,
                        generator: torch.Generator | None = None,
                        num_samples: int | None = None, *,
                        eps: Sequence | None = None) -> torch.Tensor:
    """Per-point mixture log-likelihood logsumexp_s log N(y|m_s, v_s+s2)
    - log S -> [B]."""
    fmean, fvar = predict_f(params, config, X, generator, num_samples,
                            eps=eps)
    return _mixture_log_density(params, config, fmean, fvar, Y)


def predict_y_and_log_density(params, config: DGPConfig, X: torch.Tensor,
                              Y: torch.Tensor,
                              generator: torch.Generator | None = None,
                              num_samples: int | None = None, *,
                              eps: Sequence | None = None,
                              factors: dict | None = None):
    """The serving call: mixture moments AND the per-point mixture
    log-density from the same S prior-latent samples.
    Returns ((mix_mean, mix_var), log_density)."""
    fmean, fvar = predict_f(params, config, X, generator, num_samples,
                            eps=eps, factors=factors)
    return (_mixture_moments(params, config, fmean, fvar, Y),
            _mixture_log_density(params, config, fmean, fvar, Y))
