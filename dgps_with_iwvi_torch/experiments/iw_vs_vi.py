#!/usr/bin/env python
"""The IW-vs-VI experiment (port of benchmarks/iw_vs_vi.py).

The claim of the ICML 2019 paper (arXiv:1905.05435) is that the K-sample
importance-weighted bound gives better latent-variable DGPs than VI. The
experiment tests it by construction (reference l.11-26):

1. BIMODAL case: y | x is a two-branch, heteroscedastic density, which a
   Gaussian-likelihood model can capture only through the latent w. The
   IW bound must win there.
2. UNIMODAL control: the same generator with one branch, where y | x is
   Gaussian and the latent variable is not needed.
3. K-scan on the bimodal LG model: IW1, IW5 and IW20.

    python -m dgps_with_iwvi_torch.experiments.iw_vs_vi    # on the card
    python -m dgps_with_iwvi_torch.experiments.iw_vs_vi --quick --device cpu

Training goes through ``training.fit`` (on the card every step replays one
CUDA graph), the test NLL through ``evaluate`` at S=500 in standardized
units, and both bounds through ``elbo`` on the trained parameters.

``--seed S`` builds, trains and evaluates every run from seed S (the
reference's runs are seed 0; the data stay seed 0's), to read the spread
of a row over seeds. Writes ``<out>.json`` (the rows and the points
below) and ``<out>.md``
with the reference's two tables (``--out``, default ``IW_VS_VI`` in the
working directory); the ``backend`` field holds the card's name and power
limit. In place of the reference's verdict prose, which states its own
numbers, the ``.md`` states from the rows whether each of its points
holds (``points``): (1) IW20's test NLL is below VI's on bimodal LG and on
bimodal LGG, and the LG test NLL does not rise from IW1 to IW5 to IW20;
(2) bimodal LGG-VI lands within 0.01 nats of GG-VI.

One difference from the reference: a run of fewer than 500 iterations
takes them in one chunk of that size, where the reference's fixed chunk
of 500 steps rounds the run up to 500 steps.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import time

import numpy as np
import torch

from dgps_with_iwvi_torch.device import backend, resolve_device
from dgps_with_iwvi_torch.evaluation import evaluate
from dgps_with_iwvi_torch.models import (BuildArgs, LatentVarMode,
                                         build_model, elbo, propagate)
from dgps_with_iwvi_torch.ops import likelihoods
from dgps_with_iwvi_torch.training import TrainConfig, fit

CONFIGS = ("LG", "LGG", "GG")
K_SCAN = (1, 5)
KSCAN_TAGS = ("bimodal/LG-VI", "bimodal/LG-IW1", "bimodal/LG-IW5",
              "bimodal/LG-IW20")
COLLAPSE_NATS = 0.01   # point (2): LGG-VI within this of GG-VI


def make_data(n: int, seed: int, bimodal: bool = True):
    """Two-branch heteroscedastic 1-D density (reference l.55-64, the
    scaled-up toy_1d generator); bimodal=False keeps the upper branch, a
    Gaussian conditional (the control)."""
    rng = np.random.RandomState(seed)
    X = rng.uniform(-2, 2, n)[:, None]
    branch = rng.rand(n) > 0.5 if bimodal else np.zeros(n, bool)
    y = np.sin(3 * X[:, 0]) + np.where(branch, -0.7, 0.7)
    y += (0.05 + 0.1 * (X[:, 0] > 0)) * rng.randn(n)
    return X.astype(np.float64), y[:, None].astype(np.float64)


def standardized(n_train, n_test, seed, bimodal):
    """(X_train, Y_train, X_test, Y_test, y_std) in float32, standardized
    by the train split (reference l.67-74)."""
    Xtr, Ytr = make_data(n_train, seed, bimodal)
    Xte, Yte = make_data(n_test, seed + 1, bimodal)
    xm, xs = Xtr.mean(0), Xtr.std(0) + 1e-12
    ym, ys = Ytr.mean(0), Ytr.std(0) + 1e-12

    def f32(a):
        return np.asarray(a, np.float32)

    return (f32((Xtr - xm) / xs), f32((Ytr - ym) / ys),
            f32((Xte - xm) / xs), f32((Yte - ym) / ys), ys)


def iw_diagnostics(params, config, X, Y, generator=None, K=20, *, eps=None):
    """Mean over the rows of the effective sample size of the IW weights,
    ESS_n = (sum_k w)^2 / sum_k w^2 in [1, K] (reference l.77-95); ESS
    near 1 means the logsumexp gradient rests on a single sample. The
    noise comes from `generator`, or per layer from `eps` as
    ``propagate`` takes it."""
    cfg = (config if config.num_iw_samples == K
           else dataclasses.replace(config, num_iw_samples=K))
    with torch.no_grad():
        fmean, fvar, log_w, _ = propagate(
            params, cfg, X, (K,), lv_mode=LatentVarMode.POSTERIOR, Y=Y,
            eps=eps, generator=generator)
        ve = likelihoods.dispatch_variational_expectations(
            params["likelihood"], fmean, fvar, Y, kind="gaussian")  # [K, B]
        lw = ve + log_w
        lw = lw - torch.logsumexp(lw, dim=0, keepdim=True)
        ess = 1.0 / torch.sum(torch.square(torch.exp(lw)), dim=0)  # [B]
        return float(torch.mean(ess))


def run_one(tag, configuration, mode, K, data, *, iterations, M, seed=0,
            num_samples=1, device="cuda") -> dict:
    """Build, train and measure one model (reference l.98-135): the test
    NLL at S=500, the VI bound and the IW bound at K=20 per point on the
    first min(2048, N) training rows, the ESS of K=20 weights on the first
    512 of them, the training seconds and steps/s."""
    device = resolve_device(device)
    Xtr, Ytr, Xte, Yte, _ = data
    X = torch.as_tensor(Xtr, device=device)
    Y = torch.as_tensor(Ytr, device=device)
    build = BuildArgs(configuration=configuration, mode=mode,
                      num_inducing=M, num_iw_samples=K,
                      num_samples=num_samples)
    cfg, params = build_model(seed, build, X, Y, device=device)
    chunk = min(500, iterations)
    tc = TrainConfig(lr=5e-3, gamma=1e-2, natgrad="final",
                     minibatch_size=min(512, X.shape[0]),
                     iterations=iterations, steps_per_call=chunk)
    t0 = time.perf_counter()
    trained, _ = fit(torch.Generator(device=device).manual_seed(seed), cfg,
                     params, X, Y, tc)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    m = evaluate(trained, cfg, Xte, Yte, seed + 100, y_std=np.ones((1, 1)),
                 num_samples=500, device=device)

    def gen():
        # the reference's one evaluation key, seed + 100, for every bound
        return torch.Generator(device=device).manual_seed(seed + 100)

    # bound values on one large batch, the same params, both objectives,
    # per point (elbo returns the full-dataset scale)
    nb = min(2048, X.shape[0])
    xb, yb = X[:nb], Y[:nb]
    cfg_vi = dataclasses.replace(cfg, objective="vi")
    cfg_iw = dataclasses.replace(cfg, objective="iw", num_iw_samples=20)
    with torch.no_grad():
        elbo_vi = float(elbo(trained, cfg_vi, xb, yb, gen()))
        bound_iw20 = float(elbo(trained, cfg_iw, xb, yb, gen()))
    out = {
        "tag": tag, "configuration": configuration, "mode": mode, "K": K,
        "test_loglik": m["test_loglik"], "test_rmse": m["test_rmse"],
        "elbo_vi": elbo_vi / cfg.num_data,
        "bound_iw20": bound_iw20 / cfg.num_data,
        "ess20": iw_diagnostics(trained, cfg, xb[:512], yb[:512], gen()),
        "train_s": dt,
        "steps_per_s": -(-iterations // chunk) * chunk / dt,
    }
    print(f"  {tag:28s} NLL={-out['test_loglik']:+.3f} "
          f"rmse={out['test_rmse']:.3f} ELBO/n={out['elbo_vi']:+.3f} "
          f"IW20/n={out['bound_iw20']:+.3f} ESS={out['ess20']:.1f} "
          f"({dt:.0f}s, {out['steps_per_s']:.0f} steps/s)", flush=True)
    return out


def points(rows) -> dict:
    """Whether the reference's points (1) and (2) hold on these rows; a
    point whose rows are missing is None."""
    nll = {r["tag"]: -r["test_loglik"] for r in rows}
    need1 = ["bimodal/LG-VI", "bimodal/LG-IW20", "bimodal/LGG-VI",
             "bimodal/LGG-IW20", "bimodal/LG-IW1", "bimodal/LG-IW5"]
    need2 = ["bimodal/LGG-VI", "bimodal/GG-VI"]
    p1 = p2 = None
    if all(t in nll for t in need1):
        p1 = bool(nll["bimodal/LG-IW20"] < nll["bimodal/LG-VI"]
                  and nll["bimodal/LGG-IW20"] < nll["bimodal/LGG-VI"]
                  and nll["bimodal/LG-IW1"] >= nll["bimodal/LG-IW5"]
                  >= nll["bimodal/LG-IW20"])
    if all(t in nll for t in need2):
        p2 = bool(abs(nll["bimodal/LGG-VI"] - nll["bimodal/GG-VI"])
                  <= COLLAPSE_NATS)
    return {"1": p1, "2": p2}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iterations", type=int, default=20000)
    p.add_argument("--n_train", type=int, default=2000)
    p.add_argument("--n_test", type=int, default=2000)
    p.add_argument("--M", type=int, default=64)
    p.add_argument("--quick", action="store_true",
                   help="tiny shapes / few steps (smoke only)")
    p.add_argument("--out", default="IW_VS_VI",
                   help="output path without suffix: <out>.json, <out>.md")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of every run's build, training and "
                        "evaluation (the reference's runs are seed 0); "
                        "the data stay seed 0's")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch "
                        "versions of the kernels")
    args = p.parse_args(argv)
    if args.quick:
        args.iterations, args.n_train, args.n_test, args.M = 500, 256, 256, 16
    return args


def main(argv=None) -> dict:
    """The reference's 14 runs in its order (l.151-164); writes and
    returns the record."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    rows = []
    for bimodal in (True, False):
        name = "bimodal" if bimodal else "unimodal"
        data = standardized(args.n_train, args.n_test, 0, bimodal)
        print(f"[{name}]", flush=True)
        kw = dict(iterations=args.iterations, M=args.M, seed=args.seed,
                  device=device)
        for conf in CONFIGS:
            rows.append(run_one(f"{name}/{conf}-VI", conf, "VI", 1, data,
                                **kw))
            rows.append(run_one(f"{name}/{conf}-IW20", conf, "IW", 20, data,
                                **kw))
        if bimodal:  # K-scan (paper Fig. 2 analog)
            for K in K_SCAN:
                rows.append(run_one(f"{name}/LG-IW{K}", "LG", "IW", K, data,
                                    **kw))
    record = {
        "date": datetime.datetime.now().isoformat(timespec="seconds"),
        "backend": backend(device),
        "n_train": args.n_train, "n_test": args.n_test, "M": args.M,
        "iterations": args.iterations, "seed": args.seed,
        "points": points(rows), "rows": rows,
    }
    with open(args.out + ".json", "w") as f:
        json.dump(record, f, indent=1)
    write_md(args.out + ".md", record)
    print(f"wrote {args.out}.md / .json")
    return record


def _holds(value) -> str:
    return {True: "holds", False: "does not hold", None: "not measured"}[value]


def write_md(path: str, record: dict) -> None:
    """The reference's two tables (l.167-198), then the points."""
    by = {r["tag"]: r for r in record["rows"]}

    def nll(tag):
        r = by.get(tag)
        return f"{-r['test_loglik']:+.3f}" if r else "-"

    lines = [
        "# IW vs VI adjudication (bimodal benchmark + unimodal control)",
        "",
        f"N={record['n_train']} train / {record['n_test']} test, "
        f"M={record['M']}, {record['iterations']} iterations, seed "
        f"{record['seed']}, "
        "natgrad(final)+Adam, standardized units, mixture test NLL with "
        "S=500 prior samples (LOWER is better). Generator: scaled-up "
        "toy_1d two-branch heteroscedastic density; the unimodal control "
        "keeps one branch.",
        "",
        f"{record['date']}, backend={record['backend']}.",
        "",
        "| config | bimodal VI | bimodal IW20 | unimodal VI | unimodal IW20 |",
        "|---|---|---|---|---|",
    ]
    for conf in CONFIGS:
        lines.append(
            f"| {conf} | {nll(f'bimodal/{conf}-VI')} | "
            f"{nll(f'bimodal/{conf}-IW20')} | {nll(f'unimodal/{conf}-VI')} | "
            f"{nll(f'unimodal/{conf}-IW20')} |")
    lines += ["", "## K-scan (bimodal, LG)", "",
              "| K | test NLL | IW20 bound/n | ESS(K=20) |",
              "|---|---|---|---|"]
    for tag in KSCAN_TAGS:
        r = by.get(tag)
        if r:
            lines.append(f"| {tag.split('-')[-1]} | {-r['test_loglik']:+.3f} "
                         f"| {r['bound_iw20']:+.3f} | {r['ess20']:.1f} |")
    lines += ["", "## Seconds per run", "",
              "| run | train s | steps/s |", "|---|---|---|"]
    lines += [f"| {r['tag']} | {r['train_s']:.1f} | {r['steps_per_s']:.0f} |"
              for r in record["rows"]]
    p = record["points"]
    lines += [
        "",
        "## The reference's points, read from these rows",
        "",
        f"1. IW20's test NLL below VI's on bimodal LG and on bimodal LGG, "
        f"and the LG test NLL not rising from IW1 to IW5 to IW20: "
        f"**{_holds(p['1'])}**.",
        f"2. Bimodal LGG-VI within {COLLAPSE_NATS} nats of GG-VI (VI "
        f"collapses the structure it cannot use): **{_holds(p['2'])}**.",
    ]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
