"""Amortized recognition network for latent-variable layers
(port of dgps_with_iwvi_tpu/models/encoders.py).

Maps s = concat[x, y] to the mean and log-variance of q(w | x, y): a tanh
trunk and zero-initialized linear heads, so the initial posterior is
N(0, exp(init_logvar) I) whatever the input. Prediction draws w from the
prior and never calls the encoder; it is ported so that ``init_dgp``
builds the whole LGG parameter tree and weights carry over whole.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch


def encoder_init(generator: torch.Generator, d_in: int, d_w: int,
                 hidden: Sequence[int] = (20, 20), init_logvar: float = -4.6,
                 *, dtype=torch.float32, device="cuda"):
    """Init tree: Glorot-normal tanh trunk + zero (mu, logvar) heads."""
    sizes = [d_in, *hidden]
    kw = dict(dtype=dtype, device=device)
    trunk = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        scale = math.sqrt(2.0 / (fan_in + fan_out))
        trunk.append({
            "W": scale * torch.randn((fan_in, fan_out), generator=generator,
                                     **kw),
            "b": torch.zeros((fan_out,), **kw),
        })
    last = sizes[-1]
    return {
        "trunk": trunk,
        "mu_head": {"W": torch.zeros((last, d_w), **kw),
                    "b": torch.zeros((d_w,), **kw)},
        "logvar_head": {"W": torch.zeros((last, d_w), **kw),
                        "b": torch.full((d_w,), init_logvar, **kw)},
    }


def encode(params, s: torch.Tensor):
    """s [..., d_in] -> (mu, log_var), each [..., d_w]."""
    h = s
    for layer in params["trunk"]:
        h = torch.tanh(torch.matmul(h, layer["W"]) + layer["b"])
    mu = torch.matmul(h, params["mu_head"]["W"]) + params["mu_head"]["b"]
    log_var = (torch.matmul(h, params["logvar_head"]["W"])
               + params["logvar_head"]["b"])
    return mu, log_var
