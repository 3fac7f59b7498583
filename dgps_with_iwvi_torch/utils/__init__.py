"""FLOP and MFU accounting of the training step (``flops``)."""

from .flops import (PASSES, PEAK_FLOPS, adjusted, device_peak,
                    flops_by_class, objective_flops_by_class, step_cost)

__all__ = ["PASSES", "PEAK_FLOPS", "adjusted", "device_peak",
           "flops_by_class", "objective_flops_by_class", "step_cost"]
