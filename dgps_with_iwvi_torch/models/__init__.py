"""DGP model stack: layers, encoders, the prediction path, builder
(port of dgps_with_iwvi_tpu/models)."""

from .builder import BuildArgs, build_config, build_model, kmeans_centers
from .dgp import (DGPConfig, elbo, gp_kls, init_dgp, numerics_of, predict_f,
                  predict_log_density, predict_y, predict_y_and_log_density,
                  prefactor_gp_layers, propagate)
from .layers import GPLayerConfig, LatentVarMode, LVLayerConfig

__all__ = [
    "BuildArgs",
    "DGPConfig",
    "GPLayerConfig",
    "LVLayerConfig",
    "LatentVarMode",
    "build_config",
    "build_model",
    "elbo",
    "gp_kls",
    "init_dgp",
    "kmeans_centers",
    "numerics_of",
    "predict_f",
    "predict_log_density",
    "predict_y",
    "predict_y_and_log_density",
    "prefactor_gp_layers",
    "propagate",
]
