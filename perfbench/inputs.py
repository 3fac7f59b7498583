"""A cell's inputs from its seed: the data, the scoring tables and the
model's weights, made on the device in a few large draws.

There are no UCI files in the repository, so the data are a surrogate of
the published shape (N rows, D inputs, a 90/10 split): standard normal
inputs and a random-feature target with heteroscedastic noise,

    y = w . cos(Omega x + b) + (0.1 + 0.1 (tanh f + 1)) e,

standardized by the training rows. The weights are random too: the
inducing points are random training rows (padded with standard normals
where a layer also reads the latent w), lengthscales near sqrt(d_in) so
that the RBF grams are neither diagonal nor flat, and a random q(u).
The same seed gives the same inputs on any run.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

N_FEATURES = 64


@dataclasses.dataclass
class Seeds:
    """The independent seeds a run's --seed splits into."""

    data: int
    weights: int
    run: int
    sample: int

    @classmethod
    def of(cls, seed: int) -> "Seeds":
        s = np.random.SeedSequence(int(seed)).generate_state(4, np.uint64)
        return cls(*(int(v) & ((1 << 63) - 1) for v in s))


@dataclasses.dataclass
class Data:
    X: torch.Tensor          # [n_train, D] standardized inputs
    Y: torch.Tensor          # [n_train, 1] standardized targets
    target: tuple            # (Omega, b, w, y_mean, y_std) of the target


def _target(X, Omega, b, w):
    return torch.cos(X @ Omega + b) @ w


def make_data(dataset: dict, seed: int, device) -> Data:
    gen = torch.Generator(device=device).manual_seed(seed)
    n = int(dataset["train_share"] * dataset["N"])
    D = dataset["D"]
    kw = dict(generator=gen, device=device)
    X = torch.randn((n, D), **kw)
    Omega = torch.randn((D, N_FEATURES), **kw) / math.sqrt(D)
    b = 2 * math.pi * torch.rand((N_FEATURES,), **kw)
    w = torch.randn((N_FEATURES,), **kw) / math.sqrt(N_FEATURES)
    f = _target(X, Omega, b, w)
    y = f + (0.1 + 0.1 * (torch.tanh(f) + 1.0)) * torch.randn((n,), **kw)
    y_mean, y_std = y.mean(), y.std()
    Y = ((y - y_mean) / y_std)[:, None]
    return Data(X, Y, (Omega, b, w, y_mean, y_std))


def make_tables(data: Data, count: int, rows: int, seed: int) -> list:
    """`count` host tables of `rows` new rows from the data's law:
    [(X [rows, D], Y [rows, 1])] as float32 numpy arrays."""
    Omega, b, w, y_mean, y_std = data.target
    device = data.X.device
    gen = torch.Generator(device=device).manual_seed(seed)
    kw = dict(generator=gen, device=device)
    X = torch.randn((count, rows, data.X.shape[1]), **kw)
    f = _target(X, Omega, b, w)
    y = f + (0.1 + 0.1 * (torch.tanh(f) + 1.0)) * torch.randn(f.shape, **kw)
    Y = ((y - y_mean) / y_std)[..., None]
    Xh, Yh = X.cpu().numpy(), Y.cpu().numpy()
    return [(np.ascontiguousarray(Xh[i]), np.ascontiguousarray(Yh[i]))
            for i in range(count)]


def softplus_inverse(y: torch.Tensor, lower: float = 1e-6) -> torch.Tensor:
    y = y - lower
    return y + torch.log(-torch.expm1(-y))


def make_weights(specs: list, model: dict, X: torch.Tensor, d_y: int,
                 seed: int) -> dict:
    """{"layers": [...], "likelihood": {...}} of float32 tensors on X's
    device: per latent layer the encoder's W1, b1, W2, b2 and heads Wmu,
    bmu, Wlv, blv; per GP layer raw_variance, raw_lengthscales, Z [M,
    d_in], q_mu [M, D], q_sqrt [D, M, M] (lower triangular); the
    likelihood's raw_noise_variance."""
    device = X.device
    gen = torch.Generator(device=device).manual_seed(seed)
    kw = dict(generator=gen, device=device)
    M = model["num_inducing"]
    rows = X[torch.randperm(X.shape[0], **kw)[:M]]
    layers = []
    for spec in specs:
        if spec[0] == "L":
            d_s, d_w = spec[1] + d_y, spec[2]
            h1, h2 = model["encoder_hidden"]
            layers.append({
                "W1": torch.randn((d_s, h1), **kw) * math.sqrt(2 / (d_s + h1)),
                "b1": 0.1 * torch.randn((h1,), **kw),
                "W2": torch.randn((h1, h2), **kw) * math.sqrt(2 / (h1 + h2)),
                "b2": 0.1 * torch.randn((h2,), **kw),
                "Wmu": 0.1 * torch.randn((h2, d_w), **kw) / math.sqrt(h2),
                "bmu": 0.1 * torch.randn((d_w,), **kw),
                "Wlv": 0.1 * torch.randn((h2, d_w), **kw) / math.sqrt(h2),
                "blv": model["encoder_init_logvar"]
                + 0.1 * torch.randn((d_w,), **kw)})
            continue
        _, d_in, D, final = spec
        if d_in <= rows.shape[1]:
            Z = rows[:, :d_in]
        else:
            Z = torch.cat([rows, torch.randn((M, d_in - rows.shape[1]),
                                             **kw)], 1)
        scale = 0.5 if final else 0.1
        diag = torch.exp(0.1 * torch.randn((D, M), **kw))
        lower = torch.tril(torch.randn((D, M, M), **kw), -1) \
            * (0.2 / math.sqrt(M))
        layers.append({
            "raw_variance": softplus_inverse(
                torch.exp(0.1 * torch.randn((), **kw))),
            "raw_lengthscales": softplus_inverse(
                math.sqrt(d_in) * torch.exp(0.1 * torch.randn((d_in,),
                                                               **kw))),
            "Z": Z.contiguous(),
            "q_mu": (1.0 if final else 0.1) * torch.randn((M, D), **kw),
            "q_sqrt": scale * (torch.diag_embed(diag) + lower)})
    lik = {"raw_noise_variance": softplus_inverse(
        torch.tensor(model["noise_variance"], device=device))}
    return {"layers": layers, "likelihood": lik}
