"""Batched live scoring on the card (port of dgps_with_iwvi_tpu/serving.py:41-104, 211-311).

``make_scorer_fn`` closes the one-propagate serving pair
(``models.predict_y_and_log_density``) over a model, optionally mapping
raw-unit inputs and outputs through the train split's normalization
statistics. ``Scorer.score`` scores a table in fixed-size batches on the
card and returns ``mean`` / ``var`` / ``log_density`` on the host.

The reference also freezes the scorer into a StableHLO artifact
(``export_scorer``, ``save_scorer``, ``load_scorer``); its counterpart
with ``torch.export`` is later work (ROADMAP queue 7).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from .device import resolve_device
from .models import predict_y_and_log_density
from .models.layers import LVLayerConfig
from .params import params_to_device


@dataclasses.dataclass(frozen=True)
class NormalizationStats:
    """Train-split standardization statistics: X and Y standardized by the
    train mean/std; log-densities reported in raw y units by subtracting
    sum(log y_std)."""

    x_mean: np.ndarray  # [1, d_in] (any broadcastable shape)
    x_std: np.ndarray
    y_mean: np.ndarray  # [1, d_out]
    y_std: np.ndarray


def make_scorer_fn(params, config, num_samples: int,
                   stats: NormalizationStats | None = None, *,
                   device="cuda"):
    """``score(xb, yb, seed, eps=None) -> (mean, var, log_density)``.

    With ``stats``, inputs are raw units and outputs are mapped back
    (mean * y_std + y_mean, var * y_std^2, ld - sum(log y_std)); the
    statistics are float32, as in the reference. The noise comes from a
    torch generator seeded with ``seed``, or from ``eps`` (per layer, see
    ``models.dgp.propagate``)."""
    device = resolve_device(device)
    params = params_to_device(params, device)
    if stats is not None:
        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        x_mean, x_std = f32(stats.x_mean), f32(stats.x_std)
        y_mean, y_std = f32(stats.y_mean), f32(stats.y_std)
        log_sigma = float(np.sum(np.log(np.asarray(stats.y_std, np.float64))))

    def score(xb: torch.Tensor, yb: torch.Tensor, seed: int,
              eps: Sequence | None = None):
        if stats is not None:
            xb = (xb - x_mean) / x_std
            yb = (yb - y_mean) / y_std
        gen = torch.Generator(device=device).manual_seed(int(seed))
        (m, v), ld = predict_y_and_log_density(
            params, config, xb, yb, gen, num_samples, eps=eps)
        if stats is not None:
            m = m * y_std + y_mean
            v = v * torch.square(y_std)
            ld = ld - log_sigma
        return m, v, ld

    return score


class Scorer:
    """Scores arbitrary-length tables in fixed-size batches on the card."""

    def __init__(self, params, config, num_samples: int,
                 stats: NormalizationStats | None = None, *, device="cuda"):
        self.device = resolve_device(device)
        self.config = config
        first = config.layers[0]
        self.d_in = first.d_x if (isinstance(first, LVLayerConfig)
                                  and first.d_x > 0) else first.d_in
        self.d_out = config.layers[-1].d_out  # DGPConfig: a GP layer
        self._fn = make_scorer_fn(params, config, num_samples, stats,
                                  device=self.device)

    def score(self, X, Y=None, *, seed: int = 0,
              max_batch: int = 8192) -> dict:
        """X [n, d_in] (and Y [n, d_out], or None: log_density omitted) ->
        {"mean", "var"[, "log_density"]} as float32 numpy arrays.

        Batch i uses seed + i; a short last batch is padded to max_batch,
        so every call runs at one shape. On the card the table is uploaded
        from pinned memory without blocking: a pageable copy would hold
        the host until the card finished the batch before, so the host
        could not queue the next batch's launches meanwhile. Results come
        back in one copy."""
        X = np.asarray(X, np.float32)
        n = X.shape[0]
        if X.ndim != 2 or X.shape[1] != self.d_in:
            raise ValueError(f"X must be [n, {self.d_in}], got {X.shape}")
        have_y = Y is not None
        Ys = (np.asarray(Y, np.float32) if have_y
              else np.zeros((n, self.d_out), np.float32))
        if Ys.shape != (n, self.d_out):
            raise ValueError(f"Y must be [{n}, {self.d_out}], got {Ys.shape}")
        bs = max_batch
        padded = -(-n // bs) * bs
        table = np.zeros((padded, self.d_in + self.d_out), np.float32)
        table[:n, :self.d_in], table[:n, self.d_in:] = X, Ys
        host = torch.from_numpy(table)
        if self.device.type == "cuda":
            host = host.pin_memory()
        outs = []
        for i, start in enumerate(range(0, padded, bs)):
            batch = host[start:start + bs].to(self.device, non_blocking=True)
            m, v, ld = self._fn(batch[:, :self.d_in], batch[:, self.d_in:],
                                seed + i)
            outs.append((m, v, ld))
        out = {"mean": torch.cat([o[0] for o in outs])[:n],
               "var": torch.cat([o[1] for o in outs])[:n]}
        if have_y:
            out["log_density"] = torch.cat([o[2] for o in outs])[:n]
        return {k: v.cpu().numpy() for k, v in out.items()}
