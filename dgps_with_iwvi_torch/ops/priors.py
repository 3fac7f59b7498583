"""Hyperparameter priors: the objective's ``log_prior`` term
(port of dgps_with_iwvi_tpu/ops/priors.py).

A spec ``(path_suffix, kind, a, b)`` matches every parameter whose
'/'-joined path in the parameter tree ends with ``path_suffix`` (e.g.
``"kernel/raw_variance"``, ``"raw_noise_variance"``,
``"layers/2/kernel/terms/0/raw_lengthscales"``); ``kind`` is one of

- ``"gaussian"``: N(raw | a, b^2) on the raw unconstrained value;
- ``"gamma"``: Gamma(x | shape a, rate b) on the positive value
  x = positive(raw), plus the softplus log-Jacobian log sigmoid(raw);
- ``"lognormal"``: LogNormal(x | mu a, sigma b), plus the log-Jacobian.

The sum is differentiable, so the priors reach Adam's gradients; they
never match q_mu or q_sqrt, so natural-gradient blocks are unaffected.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .transforms import positive

PRIOR_KINDS = ("gaussian", "gamma", "lognormal")


def _flatten_with_path(tree, path=()):
    """[(path, leaf)] in the reference's order (dict keys sorted, as
    ``jax.tree_util`` flattens them)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _flatten_with_path(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _flatten_with_path(v, path + (i,))]
    return [] if tree is None else [(path, tree)]


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def _log_density(raw: torch.Tensor, kind: str, a: float,
                 b: float) -> torch.Tensor:
    if kind == "gaussian":
        return torch.sum(-0.5 * math.log(2.0 * math.pi * b * b)
                         - torch.square(raw - a) / (2.0 * b * b))
    if kind not in ("gamma", "lognormal"):
        raise ValueError(f"unknown prior kind {kind!r}")
    x = positive(raw)
    log_jac = torch.sum(F.logsigmoid(raw))
    if kind == "gamma":  # shape a, rate b; the constant in Python, as a
        # tensor made from it would be a host copy in every step
        logp = (a * math.log(b) - math.lgamma(a)
                + (a - 1.0) * torch.log(x) - b * x)
        return torch.sum(logp) + log_jac
    lx = torch.log(x)  # lognormal: mu a, sigma b
    logp = (-lx - math.log(b) - 0.5 * math.log(2.0 * math.pi)
            - torch.square(lx - a) / (2.0 * b * b))
    return torch.sum(logp) + log_jac


def log_prior(params, priors: tuple) -> torch.Tensor | float:
    """Sum of the log-prior densities of the leaves the specs match; 0.0
    for no specs. Raises ValueError when no leaf matches any spec."""
    if not priors:
        return 0.0
    total, matched = 0.0, 0
    for path, leaf in _flatten_with_path(params):
        ps = _path_str(path)
        for suffix, kind, a, b in priors:
            if ps.endswith(suffix):
                total = total + _log_density(leaf, kind, float(a), float(b))
                matched += 1
    if matched == 0:
        raise ValueError(
            f"no parameter path matched any prior spec {priors!r}; check "
            "the path suffixes (e.g. 'kernel/raw_variance', "
            "'raw_noise_variance')")
    return total
