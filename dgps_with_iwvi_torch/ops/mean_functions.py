"""Mean functions: Identity / (fixed) Linear skip connections
(port of dgps_with_iwvi_tpu/ops/mean_functions.py).

Between inner DGP layers the Salimbeni-2017 skip connection is the
identity when widths match, otherwise a fixed truncated/padded-identity
projection.
"""

from __future__ import annotations

import torch


def identity_mean(X: torch.Tensor) -> torch.Tensor:
    return X


def linear_mean(X: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """X [..., N, D_in] @ W [D_in, D_out], bias-free."""
    return torch.matmul(X, W)


def skip_projection(d_in: int, d_out: int, *, dtype=torch.float32,
                    device="cuda") -> torch.Tensor | None:
    """None when d_in == d_out (identity skip), else eye(d_in, d_out)."""
    if d_in == d_out:
        return None
    return torch.eye(d_in, d_out, dtype=dtype, device=device)


def apply_mean_function(X: torch.Tensor,
                        W: torch.Tensor | None) -> torch.Tensor:
    """The skip connection: identity when W is None, else X @ W."""
    if W is None:
        return identity_mean(X)
    return linear_mean(X, W)
