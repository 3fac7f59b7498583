"""FLOP and MFU accounting of the training step (``flops``) and the CUDA
graphs that ``fit`` and ``Scorer`` replay on the card (``graphs``)."""

from .flops import (PASSES, PEAK_FLOPS, adjusted, device_peak,
                    flops_by_class, objective_flops_by_class, step_cost)

__all__ = ["PASSES", "PEAK_FLOPS", "adjusted", "device_peak",
           "flops_by_class", "objective_flops_by_class", "step_cost"]
