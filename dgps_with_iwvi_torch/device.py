"""Device resolution for the port's entry points.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
There is no silent CPU path: asking for CUDA where there is none raises.
"""

from __future__ import annotations

import subprocess

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


def backend(device: torch.device) -> str:
    """'cpu', or the card's name and power limit (as nvidia-smi gives it;
    the name alone where nvidia-smi does not answer): the ``backend``
    field of the experiments' records."""
    if device.type != "cuda":
        return "cpu"
    name = torch.cuda.get_device_name(device)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return name
    limit = out.stdout.strip()
    return f"{name}, {limit}" if out.returncode == 0 and limit else name
