"""Natural-gradient step for the Gaussian variational blocks
(port of dgps_with_iwvi_tpu/training/natgrad.py:50-236).

For each whitened block q(v) = N(m, S), one step of size gamma in natural
parameters, from the loss gradients (dm, G) w.r.t. (m, S):

    H = (G + G^T) / 2
    P = S^-1 + 2 gamma H                 (the new precision)
    S' = P^-1,  m' = S' (S^-1 m - gamma (dm - 2 H m))

The state carries S^-1 and log det S beside (m, S): the new S^-1 is the
factorized P itself and log det S' = -log det P comes from its Cholesky
diagonal, so no step ever factorizes S. P's Cholesky and inverse are one
K1 launch (``ops.linalg.chol_and_inverse``, jitter 1e-12, 2 tries). A
block whose factor comes back unusable (P genuinely indefinite: gamma too
large) keeps its old (m, S, S^-1, log det S). Every product runs at
``highest``. The q_diag family takes the same step elementwise.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..models.layers import GPLayerConfig
from ..ops import precision
from ..ops.linalg import (chol_and_inverse, cho_solve, cholesky_with_jitter,
                          log_det_from_chol)

_CARRIED = ("q_sqrt", "q_cov", "q_cov_diag", "q_cov_logdet", "q_cov_Sinv")


def _mm(a, b):
    return precision.matmul(a, b, "highest")


def natgrad_layer_ids(config, which: str = "final") -> tuple:
    """Indices of the GP layers whose q(u) takes natural-gradient steps:
    'final', 'all' or 'none'."""
    gp_ids = [i for i, c in enumerate(config.layers)
              if isinstance(c, GPLayerConfig)]
    if which == "final":
        return (gp_ids[-1],)
    if which == "all":
        return tuple(gp_ids)
    if which == "none":
        return ()
    raise ValueError(f"unknown natgrad selection {which!r}")


@torch.no_grad()
def extract_natvars(params, layer_ids: Sequence[int]) -> list:
    """(m, S = L L^T, S^-1, log det S) per natgrad block from the canonical
    (q_mu, q_sqrt); (m, v = s^2) for the q_diag family."""
    natvars = []
    for i in layer_ids:
        q_mu = params["layers"][i]["q_mu"]
        q_sqrt = params["layers"][i]["q_sqrt"]
        if q_sqrt.ndim == 2:
            natvars.append({"q_mu": q_mu.clone(), "q_v": torch.square(q_sqrt)})
            continue
        L = torch.tril(q_sqrt)
        S = _mm(L, L.transpose(-1, -2))
        eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
        Sinv = cho_solve(L, eye.expand(S.shape))
        Sinv = 0.5 * (Sinv + Sinv.transpose(-1, -2))
        logdet = 2.0 * torch.sum(torch.log(torch.abs(
            torch.diagonal(L, dim1=-2, dim2=-1))), dim=-1)
        natvars.append({"q_mu": q_mu.clone(), "q_S": S, "q_Sinv": Sinv,
                        "q_logdet": logdet})
    return natvars


def insert_natvars(params, natvars, layer_ids: Sequence[int]):
    """Full params in covariance form, differentiable in the natvars: the
    layer gets q_cov = S (or q_cov_diag = v) with the carried (logdet,
    Sinv) detached, so dL/dS comes out of one backward pass with no
    Cholesky of S."""
    layers = list(params["layers"])
    for nv, i in zip(natvars, layer_ids):
        lp = {k: v for k, v in layers[i].items() if k not in _CARRIED}
        lp["q_mu"] = nv["q_mu"]
        if "q_v" in nv:
            lp["q_cov_diag"] = nv["q_v"]
        else:
            lp["q_cov"] = nv["q_S"]
            lp["q_cov_logdet"] = nv["q_logdet"].detach()
            lp["q_cov_Sinv"] = nv["q_Sinv"].detach()
        layers[i] = lp
    return dict(params, layers=layers)


@torch.no_grad()
def natgrad_update(natvars, nat_grads, gamma) -> list:
    """The closed-form step on each block; nat_grads are the gradients of
    the loss (= -ELBO) w.r.t. the block's (q_mu, q_S) or (q_mu, q_v)."""
    new = []
    for nv, g in zip(natvars, nat_grads):
        if "q_v" in nv:
            m, v = nv["q_mu"], nv["q_v"]
            dm, h = g["q_mu"], g["q_v"]
            vinv_new = 1.0 / v + 2.0 * gamma * h
            vinv_new = torch.where(vinv_new > 0, vinv_new, 1.0 / v)
            v_new = 1.0 / vinv_new
            m_new = v_new * (m / v - gamma * (dm - 2.0 * h * m))
            new.append({"q_mu": m_new, "q_v": v_new})
            continue
        m, S, Sinv = nv["q_mu"], nv["q_S"], nv["q_Sinv"]
        dm, G = g["q_mu"], g["q_S"]
        H = 0.5 * (G + G.transpose(-1, -2))
        mT = m.transpose(0, 1)[..., None]                      # [D, M, 1]
        dmT = dm.transpose(0, 1)[..., None]
        deta1 = dmT - 2.0 * _mm(H, mT)
        theta1_new = _mm(Sinv, mT) - gamma * deta1
        P = Sinv + 2.0 * gamma * H
        P = 0.5 * (P + P.transpose(-1, -2))
        Lp, Lp_inv = chol_and_inverse(P, 1e-12, 2)
        U = Lp_inv.transpose(-1, -2)                            # Lp^-T
        S_new = _mm(U, U.transpose(-1, -2))
        m_new = _mm(S_new, theta1_new)[..., 0].transpose(0, 1)  # [M, D]
        # carry the precision that was factorized (P plus any jitter)
        P_eff = _mm(Lp, Lp.transpose(-1, -2))
        logdet_new = -log_det_from_chol(Lp)
        diag = torch.diagonal(Lp, dim1=-2, dim2=-1)
        ok = torch.all(torch.isfinite(diag) & (diag > 0), dim=-1)  # [D]
        okb = ok[:, None, None]
        new.append({
            "q_mu": torch.where(ok[None, :], m_new, m),
            "q_S": torch.where(okb, S_new, S),
            "q_Sinv": torch.where(
                okb, 0.5 * (P_eff + P_eff.transpose(-1, -2)), Sinv),
            "q_logdet": torch.where(ok, logdet_new, nv["q_logdet"]),
        })
    return new


@torch.no_grad()
def natvars_to_canonical(natvars, params, layer_ids: Sequence[int]):
    """The blocks back as canonical (q_mu, q_sqrt = chol S), q_sqrt =
    sqrt(v) for the q_diag family."""
    layers = list(params["layers"])
    for nv, i in zip(natvars, layer_ids):
        lp = {k: v for k, v in layers[i].items() if k not in _CARRIED}
        lp["q_mu"] = nv["q_mu"]
        if "q_v" in nv:
            lp["q_sqrt"] = torch.sqrt(nv["q_v"])
        else:
            lp["q_sqrt"] = cholesky_with_jitter(nv["q_S"], 1e-10, 4)
        layers[i] = lp
    return dict(params, layers=layers)
