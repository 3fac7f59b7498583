"""Parameter-constraint bijectors (port of dgps_with_iwvi_tpu/ops/transforms.py).

Positive parameters (kernel variance and lengthscales, likelihood noise)
are stored unconstrained and mapped through the reference stack's shifted
softplus ``Log1pe(lower=1e-6)``:

    constrained = lower + log(1 + exp(raw))
"""

from __future__ import annotations

import torch

DEFAULT_POSITIVE_LOWER = 1e-6


def positive(raw: torch.Tensor,
             lower: float = DEFAULT_POSITIVE_LOWER) -> torch.Tensor:
    """Shifted softplus: raw (unconstrained) -> (lower, inf).

    softplus as logaddexp(raw, 0), the reference's formula:
    torch.nn.functional.softplus switches to the identity above its
    threshold, which differs in the last digits."""
    return lower + torch.logaddexp(raw, torch.zeros_like(raw))


def positive_inverse(value: torch.Tensor,
                     lower: float = DEFAULT_POSITIVE_LOWER) -> torch.Tensor:
    """Inverse of :func:`positive`: softplus^-1(y) = y + log(1 - exp(-y)).

    Values in ``[0, lower]`` clamp to a tiny positive excess instead of
    giving NaN; negative values are invalid initializations and map to NaN.
    """
    y = value - lower
    y = torch.clamp(y, min=1e-20)
    raw = y + torch.log(-torch.expm1(-y))
    return torch.where(value < 0, torch.full_like(raw, float("nan")), raw)
