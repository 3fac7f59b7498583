"""Training of the port: natural gradients and the trainer
(port of dgps_with_iwvi_tpu/training; checkpoints and the monitor wait for
ROADMAP queue 6)."""

from .natgrad import (extract_natvars, insert_natvars, natgrad_layer_ids,
                      natgrad_update, natvars_to_canonical)
from .train import (TrainConfig, TrainState, fit, gamma_schedule,
                    loss_and_grads, make_trainer, resolve_full_batch,
                    resolve_solve_bwd)

__all__ = [
    "TrainConfig",
    "TrainState",
    "extract_natvars",
    "fit",
    "gamma_schedule",
    "insert_natvars",
    "loss_and_grads",
    "make_trainer",
    "natgrad_layer_ids",
    "natgrad_update",
    "natvars_to_canonical",
    "resolve_full_batch",
    "resolve_solve_bwd",
]
