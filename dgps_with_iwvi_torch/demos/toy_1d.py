"""1-D toy demo: a latent-variable DGP on bimodal, heteroscedastic data
(port of demos/toy_1d.py).

A small LG model (IW, K=20, M=32, natgrad on the final layer) is trained
full-batch on 200 points whose conditional density is bimodal, then

  1. 60 posterior predictive draws, one w ~ N(0, 1) per draw shared
     across x, so each draw is a smooth function, and
  2. a latent traversal under ``LatentVarMode.GIVEN``: w swept over a
     7-point grid shows how the latent input indexes the two modes.

Both are ``predict_f`` under GIVEN, each as ONE batched call: the w values
become the sample axis ([S, 200, 1]), where the reference ``vmap``s one
single-sample call per w. Under GIVEN nothing is drawn, so a sample of
the batch is that single call.

Run: python -m dgps_with_iwvi_torch.demos.toy_1d [--iterations N] [--K K]
[--out PATH] [--device cpu]. The plot needs matplotlib; without it the
arrays are computed and no file is written.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..device import resolve_device
from ..models import BuildArgs, LatentVarMode, build_model, predict_f
from ..ops.likelihoods import noise_variance
from ..training import TrainConfig, fit

N_DRAWS = 60
W_GRID = np.linspace(-2.0, 2.0, 7)


def make_data(n=200, seed=0):
    """Bimodal: y = sin(3x) +/- 0.7 with a random branch, noise 0.05 left
    of zero and 0.15 right of it (the reference's data, same seed)."""
    rng = np.random.RandomState(seed)
    X = rng.uniform(-2, 2, n)[:, None]
    branch = rng.rand(n) > 0.5
    y = np.sin(3 * X[:, 0]) + np.where(branch, 0.7, -0.7)
    y += (0.05 + 0.1 * (X[:, 0] > 0)) * rng.randn(n)
    return X.astype(np.float32), y[:, None].astype(np.float32)


def build(K: int = 20) -> BuildArgs:
    return BuildArgs(configuration="LG", mode="IW", num_inducing=32,
                     num_iw_samples=K, encoder_init_logvar=-2.0)


def train_config(iterations: int = 3000, chunk: int = 100) -> TrainConfig:
    return TrainConfig(lr=5e-3, natgrad="final", gamma=5e-2,
                       minibatch_size=200, iterations=iterations,
                       steps_per_call=min(chunk, iterations))


def grid(device, dtype=torch.float32) -> torch.Tensor:
    return torch.linspace(-2.5, 2.5, 200, dtype=dtype,
                          device=device)[:, None]


def given(params, config, xg: torch.Tensor, ws) -> np.ndarray:
    """predict_f's mean [len(ws), len(xg)] under GIVEN, w = ws[s] for
    every x of sample s, in one call."""
    ws = torch.as_tensor(np.asarray(ws), dtype=xg.dtype, device=xg.device)
    w = ws[:, None, None].expand(len(ws), xg.shape[0], 1)
    with torch.no_grad():
        fm, _ = predict_f(params, config, xg, None, len(ws),
                          lv_mode=LatentVarMode.GIVEN, ws_given=[w])
    return fm[..., 0].cpu().numpy()


def predict(params, config, ws, device) -> dict:
    """The prediction half: the draws at ws, the traversal over W_GRID
    and the learned noise variance."""
    xg = grid(device, params["layers"][-1]["Z"].dtype)
    return {"xg": xg[:, 0].cpu().numpy(),
            "draws": given(params, config, xg, ws),
            "wgrid": W_GRID,
            "traversal": given(params, config, xg, W_GRID),
            "noise_variance": float(noise_variance(params["likelihood"]))}


def compute(iterations: int = 3000, K: int = 20, device="cuda",
            callback=None, chunk: int = 100) -> dict:
    """Train, then predict: the data, the mean loss of each chunk of
    `chunk` steps, the trained parameters and the arrays of ``predict``.
    callback(step, mean_loss, state) per chunk."""
    device = resolve_device(device)
    X, Y = make_data()
    config, params = build_model(0, build(K), X, Y, device=device)
    tc = train_config(iterations, chunk)
    losses = []

    def cb(step, loss, state):
        losses.append(loss)
        if callback is not None:
            callback(step, loss, state)

    gen = torch.Generator(device=device).manual_seed(0)
    trained, _ = fit(gen, config, params, torch.from_numpy(X).to(device),
                     torch.from_numpy(Y).to(device), tc, callback=cb)
    ws = torch.randn(N_DRAWS, generator=torch.Generator().manual_seed(1),
                     dtype=torch.float64).numpy()
    out = predict(trained, config, ws, device)
    out.update(X=X, Y=Y, losses=np.asarray(losses), params=trained,
               config=config, ws=ws)
    return out


def plot(result: dict, out: str) -> str:
    """The reference's two panels: the draws and the traversal."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    X, Y, xg = result["X"], result["Y"], result["xg"]
    fig, axes = plt.subplots(1, 2, figsize=(12, 4.5), sharey=True)
    ax = axes[0]
    for d in result["draws"]:
        ax.plot(xg, d, color="C0", alpha=0.12, lw=1)
    ax.scatter(X[:, 0], Y[:, 0], s=8, color="k", zorder=3, label="data")
    ax.set_title("posterior draws (w ~ prior), noise std "
                 f"{np.sqrt(result['noise_variance']):.3f}")
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.legend()
    ax = axes[1]
    cmap = plt.get_cmap("coolwarm")
    wgrid = result["wgrid"]
    for i, (w, t) in enumerate(zip(wgrid, result["traversal"])):
        ax.plot(xg, t, color=cmap(i / (len(wgrid) - 1)), lw=2,
                label=f"w={w:+.1f}")
    ax.scatter(X[:, 0], Y[:, 0], s=8, color="k", zorder=3)
    ax.set_title("latent traversal (LatentVarMode.GIVEN)")
    ax.set_xlabel("x")
    ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    plt.close(fig)
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--iterations", type=int, default=3000)
    p.add_argument("--K", type=int, default=20)
    p.add_argument("--out", default="toy_1d_torch.png",
                   help="the plot (default: in the working directory)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    result = compute(args.iterations, args.K, args.device,
                     callback=lambda s, l, _: s % 1000 == 0 and print(
                         f"  step {s}: elbo {-l:.1f}"))
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print("matplotlib is not installed: no plot written")
        return result
    print(f"wrote {plot(result, args.out)}")
    return result


if __name__ == "__main__":
    main()
