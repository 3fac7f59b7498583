"""Model builder: configuration string -> (DGPConfig, params)
(port of dgps_with_iwvi_tpu/models/builder.py).

Tokens 'G' (GP layer) and 'L' (latent-variable layer), e.g. 'LGG'; inner
GP width min(d_x, inner_dim_cap); Z of the first GP layer from k-means on
the standardized inputs, deeper layers reuse those centres padded or
truncated to their width. The k-means is the reference's: the native
kmeans++ of ``native/libdgpdata.so`` where N > M and the library loads,
else Lloyd's iterations in torch.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re

import torch

from ..data import native_loader
from ..device import as_tensor, resolve_device
from .dgp import DGPConfig, init_dgp
from .layers import GPLayerConfig, LVLayerConfig


@dataclasses.dataclass(frozen=True)
class BuildArgs:
    """The reference harness's build flags that the port supports.

    kernel_kind: any kind of ``ops.kernels.parse_kind`` ('rbf',
    'matern52+linear', 'rbf[0:3]*coregion4x1[3]', ...). likelihood: any
    of ``ops.likelihoods.LIKELIHOOD_KINDS``. num_classes: multiclass and
    softmax give the final layer that many outputs; ordinal has C - 1 bin
    edges. num_tasks: switched_gaussian's task count, 0 to read it from
    the kernel's first coregion leaf. white: the whitened parameterization
    of q(u). priors: (path_suffix, kind, a, b) specs (``ops/priors.py``,
    ``parse_prior_flag``). feature: 'points' or 'multiscale' on every GP
    layer (``ops/features.py``, rbf only), the windows starting at
    feature_init_scale."""

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
    num_classes: int = 3
    num_tasks: int = 0
    jitter_tries: int = 4
    mean_function: str = "auto"
    white: bool = True
    q_diag: bool = False
    priors: tuple = ()
    feature: str = "points"
    feature_init_scale: float = 0.1
    var_precision: str = "default"
    solve_precision: str = "high"
    use_pallas: bool | str = "auto"   # DGPConfig.use_pallas
    serve_pallas: bool | str = "auto"  # DGPConfig.serve_pallas


# prior targets by name -> parameter-path suffixes (ops/priors.py)
PRIOR_TARGETS = {
    "kernel_variance": "kernel/raw_variance",
    "lengthscales": "kernel/raw_lengthscales",
    "noise_variance": "raw_noise_variance",
}


def parse_prior_flag(spec: str) -> tuple:
    """'kernel_variance=gamma(2,3)' -> ('kernel/raw_variance', 'gamma',
    2.0, 3.0); a target not in PRIOR_TARGETS is taken as a path suffix."""
    target, _, dist = spec.partition("=")
    kind, _, args = dist.partition("(")
    a, b = (float(v) for v in args.rstrip(")").split(","))
    target = target.strip()
    return (PRIOR_TARGETS.get(target, target), kind.strip(), a, b)


def save_build_args(ckpt_dir: str, args: BuildArgs, **train_meta) -> str:
    """Write the whole BuildArgs to ckpt_dir/build_args.json beside the
    checkpoints, so a later run rebuilds the exact model structure.

    Extra keyword arguments (e.g. natgrad='final', which fixes the
    TrainState layout a restore template must match) are stored under
    '_train'."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, "build_args.json")
    d = dataclasses.asdict(args)
    if train_meta:
        d["_train"] = train_meta
    with open(path, "w") as f:
        json.dump(d, f, indent=1)
    return path


def load_build_args(ckpt_dir: str, with_meta: bool = False):
    """Inverse of save_build_args; None when no build_args.json exists.
    with_meta=True returns (BuildArgs, train_meta_dict) instead."""
    path = os.path.join(ckpt_dir, "build_args.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        d = json.load(f)
    meta = d.pop("_train", {})
    # JSON gives lists; a file written before priors existed has none
    d["encoder_hidden"] = tuple(d["encoder_hidden"])
    d["priors"] = tuple(tuple(p) for p in d.get("priors", ()))
    build = BuildArgs(**d)
    return (build, meta) if with_meta else build


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


def _infer_num_tasks(kernel_kind: str) -> int:
    """T from the first coregion leaf of the kind string
    ('coregion<C>x<R>' -> C): the task count when num_tasks is 0."""
    m = re.search(r"coregion(\d+)x\d+", kernel_kind)
    if not m:
        raise ValueError(
            "switched_gaussian with num_tasks=0 needs a coregion leaf in "
            f"kernel_kind to infer the task count (got {kernel_kind!r}); "
            "set BuildArgs.num_tasks otherwise")
    return int(m.group(1))


def _final_width(args: BuildArgs, d_y: int) -> int:
    """Outputs of the final GP layer: one per class for multiclass and
    softmax (Y holds one label column), d_y - 1 for switched_gaussian (Y's
    last column is the task index), else d_y."""
    if args.likelihood in ("multiclass", "softmax", "ordinal") and d_y != 1:
        raise ValueError(f"{args.likelihood} expects integer labels in one "
                         f"Y column, got {d_y}")
    if args.likelihood in ("multiclass", "softmax"):
        return args.num_classes
    if args.likelihood == "switched_gaussian":
        if d_y < 2:
            raise ValueError("switched_gaussian expects Y = [targets..., "
                             "task_index], at least 2 columns")
        return d_y - 1
    return d_y


def _likelihood_kwargs(args: BuildArgs) -> dict | None:
    """The family's initial values that the build arguments fix."""
    if args.likelihood == "ordinal":
        return {"num_classes": args.num_classes}
    if args.likelihood == "switched_gaussian":
        return {"num_tasks": args.num_tasks
                or _infer_num_tasks(args.kernel_kind)}
    return None


def build_config(args: BuildArgs, d_x: int, d_y: int,
                 num_data: int) -> DGPConfig:
    """Parse the configuration string into a static DGPConfig."""
    tokens = args.configuration.upper()
    if not tokens or not set(tokens) <= {"G", "L"} or not tokens.endswith("G"):
        raise ValueError(f"bad configuration {tokens!r}: letters G and L, "
                         "ending with a GP layer")
    d_out_final = _final_width(args, d_y)
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
            d_out = d_out_final if final else inner_dim
            layer_cfgs.append(GPLayerConfig(
                d_in=width, d_out=d_out, num_inducing=args.num_inducing,
                kernel_kind=args.kernel_kind, final=final, white=args.white,
                q_diag=args.q_diag, mean_function=args.mean_function,
                feature=args.feature,
                feature_init_scale=args.feature_init_scale))
            width = d_out
    return DGPConfig(
        layers=tuple(layer_cfgs),
        num_data=num_data,
        objective="iw" if args.mode.upper() in ("IW", "IWAE") else "vi",
        num_samples=args.num_samples,
        num_iw_samples=args.num_iw_samples,
        jitter=args.jitter,
        use_pallas=args.use_pallas,
        likelihood=args.likelihood,
        jitter_tries=args.jitter_tries,
        priors=tuple(tuple(p) for p in args.priors),
        var_precision=args.var_precision,
        solve_precision=args.solve_precision,
        serve_pallas=args.serve_pallas,
    )


def build_model(seed: int, args: BuildArgs, X, Y, *, device="cuda",
                dtype=torch.float32):
    """(config, params) for a standardized dataset (X [N, d_x], Y [N, d_y],
    numpy arrays or tensors), on `device`, from a torch generator seeded
    with `seed`.

    The generator's first draw seeds the k-means, as the reference's first
    key of its split does (``builder.py:262-279``): the native kmeans++
    where N > M and the library loads, else Lloyd's from a generator of
    that seed; the parameters are drawn after it."""
    device = resolve_device(device)
    X = as_tensor(X, device, dtype)
    Y = as_tensor(Y, device, dtype)
    d_x, d_y = X.shape[1], Y.shape[1]
    config = build_config(args, d_x, d_y, num_data=X.shape[0])
    gen = torch.Generator(device=device).manual_seed(seed)
    km_seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=gen,
                                device=device))
    if X.shape[0] > args.num_inducing and native_loader.native_available():
        Zx = as_tensor(native_loader.kmeans(X.cpu().numpy(),
                                            args.num_inducing, seed=km_seed),
                       device, dtype)
    else:
        Zx = kmeans_centers(X, args.num_inducing, torch.Generator(
            device=device).manual_seed(km_seed))
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
                      device=device,
                      likelihood_kwargs=_likelihood_kwargs(args))
    return config, params
