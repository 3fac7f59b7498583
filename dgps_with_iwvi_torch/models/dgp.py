"""DGP model, objectives and prediction (port of dgps_with_iwvi_tpu/models/dgp.py).

``DGPConfig``, ``init_dgp``, ``prefactor_gp_layers``, ``propagate``, the
objectives ``gp_kls`` and ``elbo`` ('vi' and 'iw', l.245-296) and the
prediction functions, of which ``predict_y_and_log_density`` is the live
scoring call. Hyperparameter priors wait for ROADMAP queue 7.

Noise: the reference keys layer i with ``fold_in(key, i)``. Here every
sample site takes either the caller's noise (``eps[i]`` for layer i: w of
a latent-variable layer, the sample noise of an inner GP layer) or a
draw from ``generator``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from ..ops import likelihoods, linalg
from ..ops.precision import Numerics
from .layers import (GPLayerConfig, LatentVarMode, LVLayerConfig,
                     gp_layer_init, gp_layer_kl, gp_layer_propagate,
                     layer_Kuu, lv_layer_init, lv_layer_propagate)


@dataclasses.dataclass(frozen=True)
class DGPConfig:
    """Static model configuration (the reference's fields this slice uses).

    var_precision: class of the q-variance matmuls ('default' = bf16
    operands, f32 accumulation). solve_precision: class of the solve path
    A = Linv Kuf and the mean ('high' = bf16x3). See ops/precision.py.
    """

    layers: tuple  # tuple[GPLayerConfig | LVLayerConfig, ...]
    num_data: int
    objective: str = "vi"       # 'vi' | 'iw'
    num_samples: int = 1        # S, the prediction default
    num_iw_samples: int = 1     # K
    jitter: float = linalg.DEFAULT_JITTER
    likelihood: str = "gaussian"
    jitter_tries: int = 4
    var_precision: str = "default"
    solve_precision: str = "high"
    priors: tuple = ()          # hyperparameter priors: ROADMAP queue 7

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
             *, dtype=torch.float32, device="cuda"):
    """Full parameter tree {"layers": [...], "likelihood": {...}}.

    Inner GP layers start near-deterministic (q_sqrt = 1e-5 I), the final
    layer at q_sqrt = I."""
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
            "likelihood": likelihoods.init_params(config.likelihood,
                                                  noise_variance, **kw)}


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
              numerics: Numerics | None = None):
    """Thread samples through the layer stack.

    Returns (fmean, fvar, log_w, local_kl): fmean/fvar [*lead, B, d_y] the
    final layer's moments, log_w [*lead, B], local_kl [B].
    eps: per-layer noise (None entries draw from ``generator``). Y and
    data_idx feed the POSTERIOR latent mode. factors: a
    prefactor_gp_layers result to share; computed here when None."""
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
            Lm, Linv = factors[i]
            F, moments = gp_layer_propagate(
                params["layers"][i], cfg, F, eps=eps_i, generator=generator,
                jitter=config.jitter, jitter_tries=config.jitter_tries,
                numerics=numerics, Lm=Lm, Linv=Linv)
            if cfg.final:
                final_out = moments
    fmean, fvar = final_out
    return fmean, fvar, log_w, local_kl


def gp_kls(params, config: DGPConfig) -> torch.Tensor:
    """Sum of the global whitened KL(q(u) || p(u)) over GP layers."""
    return sum(gp_layer_kl(params["layers"][i], cfg)
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
    set (default: the config's)."""
    if config.priors:
        raise NotImplementedError(
            "hyperparameter priors are not ported yet (ROADMAP queue 7)")
    scale = config.num_data / X.shape[0]
    lead = (config.num_samples if config.objective == "vi"
            else config.num_iw_samples,)
    fmean, fvar, log_w, local_kl = propagate(
        params, config, X, lead, lv_mode=LatentVarMode.POSTERIOR, Y=Y,
        data_idx=data_idx, eps=eps, generator=generator, numerics=numerics)
    ve = likelihoods.dispatch_variational_expectations(
        params["likelihood"], fmean, fvar, Y, kind=config.likelihood)
    if config.objective == "vi":
        datafit = torch.sum(torch.mean(ve, dim=0) - local_kl)
    else:
        datafit = torch.sum(torch.logsumexp(ve + log_w, dim=0)
                            - math.log(float(lead[0])))
    return scale * datafit - gp_kls(params, config)


def predict_f(params, config: DGPConfig, X: torch.Tensor,
              generator: torch.Generator | None = None,
              num_samples: int | None = None, *,
              lv_mode: str = LatentVarMode.PRIOR, ws_given=None,
              eps: Sequence | None = None):
    """S propagated samples of the final-layer moments: [S, B, d_y] x2."""
    S = num_samples or config.num_samples
    fmean, fvar, _, _ = propagate(
        params, config, X, (S,), lv_mode=lv_mode, ws_given=ws_given,
        eps=eps, generator=generator)
    return fmean, fvar


def _mixture_moments(params, config, fmean, fvar):
    m, v = likelihoods.dispatch_predict_mean_and_var(
        params["likelihood"], fmean, fvar, kind=config.likelihood)
    mix_mean = torch.mean(m, dim=0)
    mix_var = torch.mean(v + torch.square(m), dim=0) - torch.square(mix_mean)
    return mix_mean, mix_var


def _mixture_log_density(params, config, fmean, fvar, Y):
    logp = likelihoods.dispatch_predict_density(
        params["likelihood"], fmean, fvar, Y, kind=config.likelihood)
    return torch.logsumexp(logp, dim=0) - math.log(float(fmean.shape[0]))


def predict_y(params, config: DGPConfig, X: torch.Tensor,
              generator: torch.Generator | None = None,
              num_samples: int | None = None, *, eps: Sequence | None = None):
    """Mixture predictive moments of (1/S) sum_s N(m_s, v_s + s2)."""
    fmean, fvar = predict_f(params, config, X, generator, num_samples,
                            eps=eps)
    return _mixture_moments(params, config, fmean, fvar)


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
                              eps: Sequence | None = None):
    """The serving call: mixture moments AND the per-point mixture
    log-density from the same S prior-latent samples.
    Returns ((mix_mean, mix_var), log_density)."""
    fmean, fvar = predict_f(params, config, X, generator, num_samples,
                            eps=eps)
    return (_mixture_moments(params, config, fmean, fvar),
            _mixture_log_density(params, config, fmean, fvar, Y))
