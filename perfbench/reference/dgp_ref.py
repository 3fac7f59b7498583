"""Plain PyTorch reference of the benchmark's deep GPs.

The models of Salimbeni et al. (ICML 2019): a latent-variable layer whose
q(w | x, y) comes from an amortized encoder, then whitened sparse GP
layers with an RBF kernel, a Gaussian likelihood, the importance-weighted
bound (IW, K samples), natural-gradient steps on the final layer's q(u)
and Adam on everything else; and the S-sample mixture predictive that
scores a table. Written from the paper and the model's equations, with no
kernel, cache, graph or batching trick, and nothing of the program under
test: it reads only the benchmark's own weights, data and noise.

``Arith`` says how it computes. ``"f64"`` is the reference: every tensor
in float64. The controls keep float32 tensors and round every product's
operands first, to TF32 (``"tf32"``, 10 mantissa bits) or to bfloat16
(``"bf16"``), accumulating in float32, as the card's tensor cores do;
the Cholesky factors and inverses stay unrounded in float32. Rounding is
emulated, so a control reads the same on the CPU and on the card.

The noise: both sides draw from a generator of the same seed. Where the
program draws, in this order, is part of what it serves: a training step
draws its B minibatch rows (uniform, with replacement), then each layer's
standard normals in layer order ([K, B, d_w] for the latent layer,
[K, B, d_out] for each inner GP layer); a full-batch step (B at least
the training rows) draws no rows, only the normals over every row; a
scored batch draws [S, B, d_w], then [S, B, d_out] per inner GP layer.
``draw_train``, ``draw_noise`` and ``draw_score`` make the same draws.
"""

from __future__ import annotations

import math

import torch

LOG2PI = math.log(2.0 * math.pi)
POSITIVE_LOWER = 1e-6          # shifted softplus of the positive parameters
JITTER = 1e-6                  # added to Kuu's diagonal
SQRT_FLOOR = 1e-12             # sqrt(max(var, floor)) of a sample's scale
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


class Arith:
    """Precision of one reference evaluation: 'f64', 'tf32' or 'bf16'."""

    def __init__(self, mode: str = "f64"):
        if mode not in ("f64", "tf32", "bf16"):
            raise ValueError(f"unknown arithmetic {mode!r}")
        self.mode = mode
        self.dtype = torch.float64 if mode == "f64" else torch.float32

    def round(self, x: torch.Tensor) -> torch.Tensor:
        """x with its mantissa cut to the mode's product operands (the
        rounding passes the gradient through unchanged)."""
        if self.mode == "f64":
            return x
        if self.mode == "bf16":
            r = x.to(torch.bfloat16).to(torch.float32)
        else:
            bits = x.contiguous().view(torch.int32)
            r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
        return x + (r - x).detach()

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.round(a), self.round(b))


def layer_specs(model: dict, d_x: int, d_y: int) -> list:
    """The layer stack of a configuration's ``model`` block: ('L', d_in,
    d_w) for a latent-variable layer, ('G', d_in, d_out, final) for a GP
    layer. Inner GP widths are min(d_x, inner_dim_cap); a latent layer
    widens its input by d_w."""
    tokens = model["configuration"]
    n_gp = tokens.count("G")
    inner = min(d_x, model["inner_dim_cap"])
    specs, width, seen = [], d_x, 0
    for t in tokens:
        if t == "L":
            specs.append(("L", width, model["d_w"]))
            width += model["d_w"]
        else:
            seen += 1
            final = seen == n_gp
            d_out = d_y if final else inner
            specs.append(("G", width, d_out, final))
            width = d_out
    return specs


def positive(raw: torch.Tensor) -> torch.Tensor:
    return POSITIVE_LOWER + torch.logaddexp(raw, torch.zeros_like(raw))


def rbf(variance, lengthscales, A, B, ar: Arith) -> torch.Tensor:
    """variance * exp(-|a - b|^2 / 2 l^2): A [..., n, d], B [..., m, d] ->
    [..., n, m]."""
    As, Bs = A / lengthscales, B / lengthscales
    d2 = (torch.sum(As * As, -1)[..., :, None]
          - 2.0 * ar.mm(As, Bs.transpose(-1, -2))
          + torch.sum(Bs * Bs, -1)[..., None, :])
    return variance * torch.exp(-0.5 * torch.clamp(d2, min=0.0))


def encoder(lv: dict, s: torch.Tensor, ar: Arith):
    """(mu, log_var) of q(w | x, y) from s = [x, y]: two tanh layers and
    two linear heads."""
    h = torch.tanh(ar.mm(s, lv["W1"]) + lv["b1"])
    h = torch.tanh(ar.mm(h, lv["W2"]) + lv["b2"])
    return ar.mm(h, lv["Wmu"]) + lv["bmu"], ar.mm(h, lv["Wlv"]) + lv["blv"]


def kuu_inverse_factor(gp: dict, ar: Arith) -> torch.Tensor:
    """L^-1 for L = chol(Kuu + jitter I)."""
    Z = gp["Z"]
    var, ls = positive(gp["raw_variance"]), positive(gp["raw_lengthscales"])
    Kuu = rbf(var, ls, Z, Z, ar)
    eye = torch.eye(Z.shape[0], dtype=Z.dtype, device=Z.device)
    L = torch.linalg.cholesky(Kuu + JITTER * eye)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def gp_moments(gp: dict, F: torch.Tensor, d_out: int, Linv, ar: Arith, *,
               cov: torch.Tensor | None = None):
    """The whitened conditional of one GP layer at inputs F [..., N, d_in]:
    (mean, var), each [..., N, d_out], with q(v) = N(q_mu, Lq Lq^T) (Lq the
    lower triangle of q_sqrt) or, where `cov` is given, N(q_mu, cov).

        A = L^-1 Kuf,  mean = A^T q_mu + skip(F),
        var = max(k(x, x) - sum_m A^2, 0) + diag(A^T S A)

    The skip mean is F @ eye(d_in, d_out) on an inner layer, zero on the
    final one (added by the caller)."""
    var = positive(gp["raw_variance"])
    ls = positive(gp["raw_lengthscales"])
    Kuf = rbf(var, ls, gp["Z"], F, ar)                      # [..., M, N]
    A = ar.mm(Linv, Kuf)
    mean = ar.mm(A.transpose(-1, -2), gp["q_mu"])           # [..., N, D]
    prior = torch.clamp(var - torch.sum(A * A, -2), min=0.0)
    Ab = A.unsqueeze(-3)                                    # [..., 1, M, N]
    if cov is None:
        LqT = torch.tril(gp["q_sqrt"]).transpose(-1, -2)    # [D, M, M]
        B = ar.mm(LqT, Ab)                                  # [..., D, M, N]
        qv = torch.sum(B * B, -2)
    else:
        qv = torch.sum(Ab * ar.mm(cov, Ab), -2)
    return mean, prior[..., None] + qv.transpose(-1, -2)


def _skip(F: torch.Tensor, d_out: int) -> torch.Tensor:
    """F @ eye(d_in, d_out): the first d_out columns, zero-padded."""
    d_in = F.shape[-1]
    if d_out <= d_in:
        return F[..., :d_out]
    pad = torch.zeros(F.shape[:-1] + (d_out - d_in,), dtype=F.dtype,
                      device=F.device)
    return torch.cat([F, pad], -1)


def propagate(weights: dict, specs: list, X, eps: list, ar: Arith, *,
              Y=None, final_cov=None, final_mu=None):
    """Samples through the stack: (fmean, fvar [lead, B, d_y], log_w
    [lead, B]). eps[i] is layer i's noise [lead, B, d] (None for the final
    layer). With Y the latent layer samples q(w | x, y) (training), else
    its prior N(0, I) (scoring). final_cov / final_mu: the final layer's
    q(u) in covariance form, where training keeps it so."""
    lead = eps[0].shape[:-2]
    F = X.expand(lead + X.shape)
    log_w = torch.zeros(lead + X.shape[:1], dtype=X.dtype, device=X.device)
    for i, spec in enumerate(specs):
        lp = weights["layers"][i]
        if spec[0] == "L":
            e = eps[i].to(X.dtype)
            if Y is None:
                w = e
            else:
                mu, log_var = encoder(lp, torch.cat([X, Y], -1), ar)
                w = mu + torch.exp(0.5 * log_var) * e
                log_w = log_w + torch.sum(
                    -0.5 * (LOG2PI + w * w)
                    + 0.5 * (LOG2PI + log_var
                             + (w - mu) ** 2 / torch.exp(log_var)), -1)
            F = torch.cat([F, w], -1)
            continue
        _, _, d_out, final = spec
        Linv = kuu_inverse_factor(lp, ar)
        if final:
            gp = lp if final_mu is None else dict(lp, q_mu=final_mu)
            return (*gp_moments(gp, F, d_out, Linv, ar, cov=final_cov),
                    log_w)
        mean, var = gp_moments(lp, F, d_out, Linv, ar)
        mean = mean + _skip(F, d_out)
        F = mean + torch.sqrt(torch.clamp(var, min=SQRT_FLOOR)) \
            * eps[i].to(X.dtype)
    raise ValueError("the last layer must be a GP layer")


def noise_variance(weights: dict) -> torch.Tensor:
    return positive(weights["likelihood"]["raw_noise_variance"])


def kl_root(q_mu, q_sqrt) -> torch.Tensor:
    """KL(N(q_mu, Lq Lq^T) || N(0, I)) summed over the output columns."""
    M, D = q_mu.shape
    Lq = torch.tril(q_sqrt)
    logdet = torch.sum(torch.log(torch.diagonal(Lq, dim1=-2, dim2=-1) ** 2))
    return 0.5 * (torch.sum(q_mu * q_mu) + torch.sum(Lq * Lq) - M * D
                  - logdet)


def kl_cov(q_mu, S) -> torch.Tensor:
    """KL(N(q_mu, S_d) || N(0, I)) summed over d, S [D, M, M]."""
    M, D = q_mu.shape
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(
        torch.linalg.cholesky(S), dim1=-2, dim2=-1)))
    return 0.5 * (torch.sum(q_mu * q_mu)
                  + torch.sum(torch.diagonal(S, dim1=-2, dim2=-1))
                  - M * D - logdet)


def neg_iw_elbo(weights, specs, X, Y, eps, num_data: int, ar: Arith, *,
                final_mu, final_cov) -> torch.Tensor:
    """-ELBO_IW = -[(N / B) sum_b (logsumexp_k (log p(y|f_k) + log_w_k)
    - log K) - sum_l KL_l], the expectation of the Gaussian likelihood
    under the final layer's marginal taken in closed form."""
    fmean, fvar, log_w = propagate(weights, specs, X, eps, ar, Y=Y,
                                   final_cov=final_cov, final_mu=final_mu)
    s2 = noise_variance(weights)
    ve = torch.sum(-0.5 * (LOG2PI + torch.log(s2)
                           + ((Y - fmean) ** 2 + fvar) / s2), -1)
    K = ve.shape[0]
    datafit = torch.sum(torch.logsumexp(ve + log_w, 0) - math.log(K))
    kl = 0.0
    for i, spec in enumerate(specs):
        if spec[0] == "G":
            lp = weights["layers"][i]
            kl = kl + (kl_cov(final_mu, final_cov) if spec[3]
                       else kl_root(lp["q_mu"], lp["q_sqrt"]))
    return -(num_data / X.shape[0] * datafit - kl)


def draw_train(gen: torch.Generator, num_data: int, batch: int, K: int,
               specs: list) -> tuple:
    """One training step's draws: (rows [B], noise per layer)."""
    idx = torch.randint(0, num_data, (batch,), generator=gen,
                        device=gen.device)
    return idx, draw_noise(gen, batch, K, specs)


def draw_noise(gen: torch.Generator, batch: int, K: int,
               specs: list) -> list:
    """One training step's noise per layer over `batch` rows, after its
    row draw (a full-batch step draws no rows: this alone)."""
    dev = gen.device
    eps = []
    for spec in specs:
        if spec[0] == "L":
            eps.append(torch.randn((K, batch, spec[2]), generator=gen,
                                   device=dev))
        elif spec[3]:
            eps.append(None)
        else:
            eps.append(torch.randn((K, batch, spec[2]), generator=gen,
                                   device=dev))
    return eps


def draw_score(gen: torch.Generator, S: int, batch: int, specs: list):
    """One scored batch's noise per layer."""
    return [None if (spec[0] == "G" and spec[3]) else torch.randn(
        (S, batch, spec[2]), generator=gen, device=gen.device)
        for spec in specs]


def _cast(weights: dict, dtype) -> dict:
    return {"layers": [{k: v.detach().to(dtype) for k, v in lp.items()}
                       for lp in weights["layers"]],
            "likelihood": {k: v.detach().to(dtype)
                           for k, v in weights["likelihood"].items()}}


def train(weights: dict, specs: list, X, Y, draws: list, num_data: int,
          lr: float, gamma: float, ar: Arith) -> dict:
    """len(draws) joint steps from `weights`: natural-gradient steps on the
    final layer's q(u) = N(m, S) of size gamma,

        H = (G + G^T) / 2,  P = S^-1 + 2 gamma H,
        S' = P^-1,  m' = S' (S^-1 m - gamma (dm - 2 H m)),

    with (dm, G) the gradient of -ELBO w.r.t. (m, S), and Adam (lr, betas
    0.9 / 0.999, eps 1e-8) on every other parameter. Returns {"losses"
    [steps], "grads": [{leaf: each step's gradient}] ("final.q_mu" dm and
    "final.q_S" H for the natural-gradient block), "params": {leaf: value
    after the steps}, "start": {leaf: value before them}} in float64 leaves
    named "<layer>.<key>" and "likelihood.raw_noise_variance"."""
    w = _cast(weights, ar.dtype)
    X, Y = X.to(ar.dtype), Y.to(ar.dtype)
    fi = len(specs) - 1
    final = w["layers"][fi]
    m = final["q_mu"].clone()
    Lq = torch.tril(final["q_sqrt"])
    S = torch.matmul(Lq, Lq.transpose(-1, -2))
    Sinv = torch.cholesky_inverse(Lq)
    leaves = {}
    for i, lp in enumerate(w["layers"]):
        for k, v in lp.items():
            if i == fi and k in ("q_mu", "q_sqrt"):
                continue
            leaves[f"{i}.{k}"] = v.requires_grad_(True)
    leaves["likelihood.raw_noise_variance"] = \
        w["likelihood"]["raw_noise_variance"].requires_grad_(True)
    start = {k: v.detach().clone().double() for k, v in leaves.items()}
    start["final.q_mu"], start["final.q_S"] = m.double(), S.double()
    moments = {k: (torch.zeros_like(v), torch.zeros_like(v))
               for k, v in leaves.items()}
    b1, b2 = ADAM_BETAS
    losses, grads_per_step = [], []
    for t, (idx, eps) in enumerate(draws, start=1):
        m_l = m.detach().requires_grad_(True)
        S_l = S.detach().requires_grad_(True)
        loss = neg_iw_elbo(w, specs, X[idx], Y[idx], eps, num_data, ar,
                           final_mu=m_l, final_cov=S_l)
        names = list(leaves)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names]
                                    + [m_l, S_l])
        g = dict(zip(names, grads[:-2]))
        dm, G = grads[-2:]
        H = 0.5 * (G + G.transpose(-1, -2))
        losses.append(float(loss.detach()))
        step_grads = {k: v.detach().double() for k, v in g.items()}
        step_grads["final.q_mu"], step_grads["final.q_S"] = \
            dm.double(), H.double()
        grads_per_step.append(step_grads)
        with torch.no_grad():
            mT = m.transpose(0, 1)[..., None]
            theta = torch.matmul(Sinv, mT) - gamma * (
                dm.transpose(0, 1)[..., None] - 2.0 * torch.matmul(H, mT))
            P = Sinv + 2.0 * gamma * H
            P = 0.5 * (P + P.transpose(-1, -2))
            S = torch.cholesky_inverse(torch.linalg.cholesky(P))
            m = torch.matmul(S, theta)[..., 0].transpose(0, 1)
            Sinv = P
            for k, p in leaves.items():
                ma, va = moments[k]
                ma.mul_(b1).add_(g[k], alpha=1.0 - b1)
                va.mul_(b2).addcmul_(g[k], g[k], value=1.0 - b2)
                denom = (va / (1.0 - b2 ** t)).sqrt() + ADAM_EPS
                p.sub_(lr * (ma / (1.0 - b1 ** t)) / denom)
    params = {k: v.detach().double() for k, v in leaves.items()}
    params["final.q_mu"], params["final.q_S"] = m.double(), S.double()
    return {"losses": losses, "grads": grads_per_step, "params": params,
            "start": start}


@torch.no_grad()
def score(weights: dict, specs: list, X, Y, eps: list, ar: Arith,
          block_rows: int = 512) -> tuple:
    """The mixture predictive of a batch X [B, d_x], Y [B, d_y] from S
    prior samples (eps[i] [S, B, d]): (mean, var) [B, d_y] of (1/S) sum_s
    N(m_s, v_s + s2) and the log-density [B], log (1/S) sum_s N(y | m_s,
    v_s + s2), in blocks of rows."""
    w = _cast(weights, ar.dtype)
    s2 = noise_variance(w)
    outs = []
    for r0 in range(0, X.shape[0], block_rows):
        r1 = min(r0 + block_rows, X.shape[0])
        xb = X[r0:r1].to(ar.dtype)
        yb = Y[r0:r1].to(ar.dtype)
        eb = [None if e is None else e[:, r0:r1] for e in eps]
        fmean, fvar, _ = propagate(w, specs, xb, eb, ar)
        v = fvar + s2
        mix_mean = fmean.mean(0)
        mix_var = (v + fmean ** 2).mean(0) - mix_mean ** 2
        logp = torch.sum(-0.5 * (LOG2PI + torch.log(v)
                                 + (yb - fmean) ** 2 / v), -1)
        ld = torch.logsumexp(logp, 0) - math.log(fmean.shape[0])
        outs.append((mix_mean.double(), mix_var.double(), ld.double()))
    return tuple(torch.cat(parts) for parts in zip(*outs))
