"""Multi-task demo: an ICM GP with per-task noise, Coregion x Switched
(port of demos/multitask_icm.py).

Three tasks share one latent function through an intrinsic-
coregionalization kernel k(x,t; x',t') = k_rbf(x,x') B[t,t'],
B = W W^T + diag(kappa), while the switched_gaussian likelihood learns
one noise variance per task (Y's last column is the task index). A
single-layer sparse GP (VI, M=32, Adam only, full batch) is trained on
three noisy copies of related functions; the prediction half returns the
per-task predictive moments on a grid (``predict_f`` over 64 samples),
the learned task covariance B and the per-task noise variances.

Run: python -m dgps_with_iwvi_torch.demos.multitask_icm [--iterations N]
[--out PATH] [--device cpu]. The plot needs matplotlib; without it the
arrays are computed and no file is written.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..device import resolve_device
from ..models import BuildArgs, build_model, predict_f
from ..ops.kernels import coregion_B
from ..ops.likelihoods import noise_variance
from ..training import TrainConfig, fit

TRUE_STDS = (0.05, 0.25, 0.6)
# per-task affine links to one shared latent f(x) = sin(2x): the ICM's
# rank-1 B can represent exactly this family
TASK_SCALE = (1.0, 0.7, -0.9)
N_SAMPLES = 64


def make_data(n_per=120, seed=0):
    """The reference's data, same seed: X = [x, task], Y = [y, task]."""
    rng = np.random.RandomState(seed)
    xs, ys = [], []
    for t, (s, a) in enumerate(zip(TRUE_STDS, TASK_SCALE)):
        x = np.sort(rng.uniform(-3, 3, (n_per, 1)), axis=0)
        y = a * np.sin(2 * x) + s * rng.randn(n_per, 1)
        xs.append(np.concatenate([x, np.full((n_per, 1), float(t))], 1))
        ys.append(np.concatenate([y, np.full((n_per, 1), float(t))], 1))
    return (np.concatenate(xs).astype(np.float32),
            np.concatenate(ys).astype(np.float32))


def build() -> BuildArgs:
    return BuildArgs(configuration="G", mode="VI", num_inducing=32,
                     kernel_kind="rbf[0]*coregion3x1[1]",
                     likelihood="switched_gaussian")


def train_config(iterations: int = 4000, n: int = 360,
                 chunk: int = 500) -> TrainConfig:
    return TrainConfig(lr=0.01, natgrad="none", minibatch_size=n,
                       iterations=iterations,
                       steps_per_call=min(chunk, iterations))


def predict(params, config, device) -> dict:
    """Per task t on a 200-point grid: the moments of f over the S
    samples (mean, and the variance of the mixture), B and the noise
    variances."""
    dtype = params["layers"][-1]["Z"].dtype
    xg = np.linspace(-3.2, 3.2, 200)[:, None]
    gen = torch.Generator(device=device).manual_seed(1)
    means, variances = [], []
    with torch.no_grad():
        for t in range(len(TRUE_STDS)):
            Xt = torch.as_tensor(
                np.concatenate([xg, np.full_like(xg, float(t))], 1),
                dtype=dtype, device=device)
            fm_s, fv_s = predict_f(params, config, Xt, gen, N_SAMPLES)
            fm = torch.mean(fm_s, 0)
            fv = torch.mean(fv_s + torch.square(fm_s), 0) - torch.square(fm)
            means.append(fm[:, 0].cpu().numpy())
            variances.append(fv[:, 0].cpu().numpy())
        # the coregion leaf is the second factor of the single product term
        B = coregion_B(params["layers"][-1]["kernel"]["terms"][0][1])
        noise = noise_variance(params["likelihood"])
    return {"xg": xg[:, 0], "mean": np.stack(means),
            "var": np.stack(variances), "B": B.cpu().numpy(),
            "noise_variance": noise.cpu().numpy()}


def compute(iterations: int = 4000, device="cuda", callback=None,
            chunk: int = 500) -> dict:
    """Train, then predict: the data, the mean loss of each chunk of
    `chunk` steps, the trained parameters and the arrays of ``predict``.
    callback(step, mean_loss, state) per chunk."""
    device = resolve_device(device)
    X, Y = make_data()
    config, params = build_model(0, build(), X, Y, device=device)
    losses = []

    def cb(step, loss, state):
        losses.append(loss)
        if callback is not None:
            callback(step, loss, state)

    gen = torch.Generator(device=device).manual_seed(0)
    trained, _ = fit(gen, config, params, torch.from_numpy(X).to(device),
                     torch.from_numpy(Y).to(device),
                     train_config(iterations, X.shape[0], chunk),
                     callback=cb)
    out = predict(trained, config, device)
    out.update(X=X, Y=Y, losses=np.asarray(losses), params=trained,
               config=config)
    return out


def plot(result: dict, out: str) -> str:
    """The reference's five panels: the three tasks' fits (mean +/- 2
    sd in the task's own noise), the task correlation and the noise."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    X, Y, xg = result["X"], result["Y"], result["xg"]
    noise_t = result["noise_variance"]
    fig, axes = plt.subplots(1, 5, figsize=(22, 4),
                             gridspec_kw={"width_ratios": [3, 3, 3, 2, 2]})
    for t in range(len(TRUE_STDS)):
        fm, sd = result["mean"][t], np.sqrt(result["var"][t] + noise_t[t])
        ax = axes[t]
        mask = np.isclose(X[:, 1], t)
        ax.plot(X[mask, 0], Y[mask, 0], "k.", ms=3, alpha=0.5)
        ax.plot(xg, fm, "C0")
        ax.fill_between(xg, fm - 2 * sd, fm + 2 * sd, color="C0", alpha=0.2)
        ax.set_title(f"task {t}: learned sd={np.sqrt(noise_t[t]):.3f} "
                     f"(true {TRUE_STDS[t]})")
    corr = correlation(result["B"])
    im = axes[3].imshow(corr, vmin=-1, vmax=1, cmap="RdBu_r")
    axes[3].set_title("learned task correlation")
    for i in range(3):
        for j in range(3):
            axes[3].text(j, i, f"{corr[i, j]:+.2f}", ha="center",
                         va="center", fontsize=9)
    fig.colorbar(im, ax=axes[3], shrink=0.8)
    axes[4].bar(np.arange(3) - 0.17, TRUE_STDS, 0.34, label="true sd")
    axes[4].bar(np.arange(3) + 0.17, np.sqrt(noise_t), 0.34,
                label="learned sd")
    axes[4].set_xticks(range(3))
    axes[4].set_title("per-task noise (SwitchedLikelihood analog)")
    axes[4].legend()
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    plt.close(fig)
    return out


def correlation(B: np.ndarray) -> np.ndarray:
    d = np.sqrt(np.diag(B))
    return B / np.outer(d, d)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--iterations", type=int, default=4000)
    p.add_argument("--out", default="multitask_icm_torch.png",
                   help="the plot (default: in the working directory)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    result = compute(args.iterations, args.device)
    print(f"[demo] learned per-task sd: "
          f"{np.sqrt(result['noise_variance']).round(3)} (true {TRUE_STDS});"
          f" task correlation row 0: "
          f"{correlation(result['B'])[0].round(2)}")
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print("matplotlib is not installed: no plot written")
        return result
    print(f"wrote {plot(result, args.out)}")
    return result


if __name__ == "__main__":
    main()
