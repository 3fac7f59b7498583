"""Model builder: configuration string -> (DGPConfig, params)
(port of dgps_with_iwvi_tpu/models/builder.py).

Tokens 'G' (GP layer) and 'L' (latent-variable layer), e.g. 'LGG'; inner
GP width min(d_x, inner_dim_cap); Z of the first GP layer from k-means on
the standardized inputs (Lloyd's iterations in torch, from an explicit
generator), deeper layers reuse those centres padded or truncated to
their width.
"""

from __future__ import annotations

import dataclasses

import torch

from ..device import as_tensor, resolve_device
from .dgp import DGPConfig, init_dgp
from .layers import GPLayerConfig, LVLayerConfig


@dataclasses.dataclass(frozen=True)
class BuildArgs:
    """The reference harness's build flags that this slice supports."""

    configuration: str = "G"
    mode: str = "VI"            # 'VI' | 'IW'
    num_inducing: int = 128     # M
    num_iw_samples: int = 5     # K
    num_samples: int = 1        # S
    d_w: int = 1                # latent dim per LV layer
    inner_dim_cap: int = 30     # inner GP width = min(d_x, cap)
    encoder_hidden: tuple = (20, 20)
    encoder_init_logvar: float = -4.6
    noise_variance_init: float = 0.05
    jitter: float = 1e-6
    kernel_kind: str = "rbf"
    amortized: bool = True
    likelihood: str = "gaussian"
    jitter_tries: int = 4
    mean_function: str = "auto"
    white: bool = True
    q_diag: bool = False
    var_precision: str = "default"
    solve_precision: str = "high"


def kmeans_centers(X: torch.Tensor, k: int, generator: torch.Generator,
                   iters: int = 20) -> torch.Tensor:
    """Lloyd's k-means on X [N, D] -> [k, D] centres.

    Starts from k distinct rows drawn by `generator`; an empty cluster
    keeps its centre. With N <= k, tiles X and adds 1e-3 noise."""
    N = X.shape[0]
    if N <= k:
        reps = -(-k // N)
        Xp = X.repeat(reps, 1)[:k]
        return Xp + 1e-3 * torch.randn(Xp.shape, generator=generator,
                                       dtype=X.dtype, device=X.device)
    idx = torch.randperm(N, generator=generator, device=X.device)[:k]
    centers = X[idx]
    xx = torch.sum(X * X, dim=1)[:, None]
    for _ in range(iters):
        d2 = xx - 2.0 * X @ centers.T + torch.sum(centers * centers, 1)[None]
        assign = torch.argmin(d2, dim=1)
        counts = torch.bincount(assign, minlength=k).to(X.dtype)
        sums = torch.zeros_like(centers).index_add_(0, assign, X)
        centers = torch.where(counts[:, None] > 0,
                              sums / torch.clamp(counts[:, None], min=1.0),
                              centers)
    return centers


def build_config(args: BuildArgs, d_x: int, d_y: int,
                 num_data: int) -> DGPConfig:
    """Parse the configuration string into a static DGPConfig."""
    tokens = args.configuration.upper()
    if not tokens or not set(tokens) <= {"G", "L"} or not tokens.endswith("G"):
        raise ValueError(f"bad configuration {tokens!r}: letters G and L, "
                         "ending with a GP layer")
    inner_dim = min(d_x, args.inner_dim_cap)
    layer_cfgs: list = []
    width = d_x
    n_gp = tokens.count("G")
    gp_seen = 0
    for t in tokens:
        if t == "L":
            layer_cfgs.append(LVLayerConfig(
                d_w=args.d_w, d_in=width, d_y=d_y, d_x=d_x,
                encoder_hidden=tuple(args.encoder_hidden),
                encoder_init_logvar=args.encoder_init_logvar,
                amortized=args.amortized,
                num_data=0 if args.amortized else num_data))
            width += args.d_w
        else:
            gp_seen += 1
            final = gp_seen == n_gp
            d_out = d_y if final else inner_dim
            layer_cfgs.append(GPLayerConfig(
                d_in=width, d_out=d_out, num_inducing=args.num_inducing,
                kernel_kind=args.kernel_kind, final=final, white=args.white,
                q_diag=args.q_diag, mean_function=args.mean_function))
            width = d_out
    return DGPConfig(
        layers=tuple(layer_cfgs),
        num_data=num_data,
        objective="iw" if args.mode.upper() in ("IW", "IWAE") else "vi",
        num_samples=args.num_samples,
        num_iw_samples=args.num_iw_samples,
        jitter=args.jitter,
        likelihood=args.likelihood,
        jitter_tries=args.jitter_tries,
        var_precision=args.var_precision,
        solve_precision=args.solve_precision,
    )


def build_model(seed: int, args: BuildArgs, X, Y, *, device="cuda",
                dtype=torch.float32):
    """(config, params) for a standardized dataset (X [N, d_x], Y [N, d_y],
    numpy arrays or tensors), on `device`, from a torch generator seeded
    with `seed`."""
    device = resolve_device(device)
    X = as_tensor(X, device, dtype)
    Y = as_tensor(Y, device, dtype)
    d_x, d_y = X.shape[1], Y.shape[1]
    config = build_config(args, d_x, d_y, num_data=X.shape[0])
    gen = torch.Generator(device=device).manual_seed(seed)
    Zx = kmeans_centers(X, args.num_inducing, gen)               # [M, d_x]
    Z_inits = []
    for cfg in config.layers:
        if isinstance(cfg, GPLayerConfig):
            if cfg.d_in >= d_x:
                pad = torch.zeros((args.num_inducing, cfg.d_in - d_x),
                                  dtype=dtype, device=device)
                Z_inits.append(torch.cat([Zx, pad], dim=1))
            else:
                Z_inits.append(Zx[:, :cfg.d_in])
    params = init_dgp(gen, config, Z_inits=Z_inits,
                      noise_variance=args.noise_variance_init, dtype=dtype,
                      device=device)
    return config, params
