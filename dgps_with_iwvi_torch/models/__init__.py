"""DGP model stack: layers, encoders, the prediction path, builder
(port of dgps_with_iwvi_tpu/models)."""

from .builder import (PRIOR_TARGETS, BuildArgs, build_config, build_model,
                      kmeans_centers, load_build_args, parse_prior_flag,
                      save_build_args)
from .dgp import (DGPConfig, elbo, gp_kls, init_dgp, layer_noise,
                  numerics_of, predict_f,
                  predict_f_full_cov, predict_f_samples, predict_log_density,
                  predict_y, predict_y_and_log_density, predict_y_samples,
                  prefactor_gp_layers, propagate)
from .layers import GPLayerConfig, LatentVarMode, LVLayerConfig

__all__ = [
    "BuildArgs",
    "DGPConfig",
    "GPLayerConfig",
    "LVLayerConfig",
    "LatentVarMode",
    "PRIOR_TARGETS",
    "build_config",
    "build_model",
    "elbo",
    "gp_kls",
    "init_dgp",
    "kmeans_centers",
    "layer_noise",
    "load_build_args",
    "numerics_of",
    "parse_prior_flag",
    "predict_f",
    "predict_f_full_cov",
    "predict_f_samples",
    "predict_log_density",
    "predict_y",
    "predict_y_and_log_density",
    "predict_y_samples",
    "prefactor_gp_layers",
    "propagate",
    "save_build_args",
]
