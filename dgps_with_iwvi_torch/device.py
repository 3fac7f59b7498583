"""Device resolution for the port's entry points.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
There is no silent CPU path: asking for CUDA where there is none raises.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; the port runs on an NVIDIA GPU by "
            "default — pass device='cpu' to run the plain PyTorch versions")
    return device


def as_tensor(x, device: torch.device, dtype=torch.float32) -> torch.Tensor:
    """A numpy array or tensor as a tensor on `device` in `dtype`."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
