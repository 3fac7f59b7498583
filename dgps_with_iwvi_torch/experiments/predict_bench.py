#!/usr/bin/env python
"""Serving throughput of the mixture-predictive scorer (port of
benchmarks/predict_bench.py).

The flagship model (LGG, IW, M=128, K=20) at its initial parameters
scores S=100 prior samples per point (``predict_y_and_log_density``, the
reference's evaluation protocol run as a production scorer) on
N=7372 x 8 synthetic rows, ``y = sin(x_0) + 0.1 noise`` as the
reference draws them (l.36-39). The rows come from a numpy generator of
seed 0, as the reference's key is: its ``jax.random`` draws cannot be
made without JAX, and the table measures rates, not values.

Per batch size (128, 512, 2048, 8192), through the graphed scorer
(``serving.GraphedScore``: one CUDA graph replay per request, the
counterpart of the reference's jitted scorer): three warm-up and discard
calls, then the median of 7 blocking calls (the call and a synchronize)
and the points/s of 8 requests enqueued before one synchronize (the
median of 3). Then the exported artifact at B=8192, as l.85-107 does:
``export_scorer`` -> ``save_scorer`` -> ``load_scorer`` ->
``ServingArtifact.score(..., depth=8)`` over 8 batches, host table in and
every result back on the host. Writes ``SERVING_H100.md`` into ``--out``
(default: the working directory), with the card's name and power limit.

    python -m dgps_with_iwvi_torch.experiments.predict_bench \\
        [--out DIR] [--batches 128,512,2048,8192] [--rounds 7] \\
        [--device cpu]

On ``--device cpu`` the scorer runs eagerly on the host (no graph): for
rehearsal only, its rates are the host's.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from dgps_with_iwvi_torch.device import backend, resolve_device
from dgps_with_iwvi_torch.models import BuildArgs, build_model
from dgps_with_iwvi_torch.ops.precision import f32_reductions
from dgps_with_iwvi_torch.serving import (GraphedScore, export_scorer,
                                          load_scorer, make_scorer_fn,
                                          save_scorer)

HEADER = ["| batch | blocking ms/call | points/s blocking | points/s "
          "pipelined (8 in flight) |", "|---|---|---|---|"]
M, S = 128, 100  # inducing points, samples scored per point
DEPTH = 8
BATCHES = (128, 512, 2048, 8192)
ARTIFACT_BATCH = 8192


def data(n: int = 7372, d: int = 8, seed: int = 0):
    """X [n, d] ~ N(0, 1), Y = sin(X_0) + 0.1 N(0, 1), float32."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    Y = (np.sin(X[:, :1]) + 0.1 * rng.standard_normal((n, 1))
         ).astype(np.float32)
    return X, Y


def _tile(A, rows: int):
    return np.tile(A, (max(1, rows // len(A) + 1), 1))[:rows]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def _batch_row(score, X, Y, B: int, rounds: int, device) -> tuple:
    """(row, outputs finite) of batch size B: three warm-up calls, the
    median of `rounds` blocking calls, the median of 3 rounds of DEPTH
    requests enqueued before one synchronize."""
    xb = torch.as_tensor(_tile(X, B), device=device)
    yb = torch.as_tensor(_tile(Y, B), device=device)
    for w in range(3):  # warm-up and capture, discarded
        score(xb, yb, w)
    _sync(device)
    ts = []
    for r in range(rounds):
        t0 = time.perf_counter()
        m, v, ld = score(xb, yb, 100 + r)
        _sync(device)
        ts.append(time.perf_counter() - t0)
    finite = all(bool(torch.isfinite(t).all()) for t in (m, v, ld))
    ms = float(np.median(ts)) * 1e3
    pts = []
    for r in range(3):
        t0 = time.perf_counter()
        for i in range(DEPTH):
            score(xb, yb, 200 + r * DEPTH + i)
        _sync(device)
        pts.append(DEPTH * B / (time.perf_counter() - t0))
    return {"batch": B, "blocking_ms": ms, "blocking_ms_all": ts,
            "points_per_s_blocking": B / ms * 1e3,
            "points_per_s_pipelined": float(np.median(pts)),
            "points_per_s_pipelined_all": pts}, finite


def run(out_dir: str = ".", batches=BATCHES, rounds: int = 7,
        device="cuda") -> dict:
    """The table and the artifact's rate (module docstring); writes
    SERVING_H100.md into `out_dir` and returns the record."""
    device = resolve_device(device)
    X, Y = data()
    args = BuildArgs(configuration="LGG", mode="IW",
                     num_inducing=M, num_iw_samples=20)
    config, params = build_model(0, args, X, Y, device=device)
    fn = make_scorer_fn(params, config, S, device=device)
    score = (GraphedScore(fn, X.shape[1], 1, device)
             if device.type == "cuda" else fn)
    lines = list(HEADER)
    print(lines[0])
    print(lines[1])
    rows, finite = [], True
    with torch.no_grad(), f32_reductions():
        for B in batches:
            row, ok = _batch_row(score, X, Y, B, rounds, device)
            rows.append(row)
            finite &= ok
            lines.append(f"| {B} | {row['blocking_ms']:.2f} | "
                         f"{row['points_per_s_blocking']:,.0f} | "
                         f"{row['points_per_s_pipelined']:,.0f} |")
            print(lines[-1], flush=True)
    B = ARTIFACT_BATCH
    exp = export_scorer(params, config, batch_size=B, d_in=X.shape[1],
                        d_out=1, num_samples=S)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "scorer.pt2")
        save_scorer(path, exp, num_samples=S, has_stats=False)
        art = load_scorer(path, device)
    Xb, Yb = _tile(X, B), _tile(Y, B)
    Xs, Ys = np.tile(Xb, (DEPTH, 1)), np.tile(Yb, (DEPTH, 1))
    art.score(Xb, Yb)  # first call, discarded
    arts = []
    for r in range(3):
        t0 = time.perf_counter()
        got = art.score(Xs, Ys, seed=300 + r * DEPTH, depth=DEPTH)
        arts.append(DEPTH * B / (time.perf_counter() - t0))
    finite &= all(bool(np.isfinite(v).all()) for v in got.values())
    art_rate = float(np.median(arts))
    card = backend(device)
    art_line = (f"\nExported-artifact path (torch.export program, "
                f"`dgp-serve-torch --export` / serving.py): **{art_rate:,.0f} "
                f"points/s** pipelined at B={B} through "
                f"ServingArtifact.score's padded host loop ({DEPTH} batches "
                f"in flight) — unlike the table above this END-TO-END "
                f"number includes per-batch host->device input upload and the "
                f"results' copy back to the host.")
    print(art_line, flush=True)
    path = os.path.join(out_dir, "SERVING_H100.md")
    with open(path, "w") as f:
        f.write("# Serving throughput (predict_y_and_log_density scorer)\n\n"
                f"Flagship LGG IWVI model at its initial parameters, "
                f"M={M}, S={S} mixture predictive, "
                f"on {card}; each request "
                + ("one CUDA graph replay (serving.GraphedScore)"
                   if device.type == "cuda" else "eager on the host")
                + ", blocking = the call and a "
                f"synchronize, pipelined = {DEPTH} requests enqueued before "
                f"one synchronize.\n\n" + "\n".join(lines) + "\n"
                + art_line + "\n")
    print("wrote", path)
    return {"backend": card, "rows": rows, "artifact_batch": B,
            "artifact_points_per_s": art_rate, "artifact_all": arts,
            "finite": finite, "path": path}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=".", help="directory of SERVING_H100.md")
    p.add_argument("--batches", default=",".join(map(str, BATCHES)))
    p.add_argument("--rounds", type=int, default=7)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    a = parse_args(argv)
    rec = run(a.out, [int(b) for b in a.batches.split(",")], a.rounds,
              a.device)
    if not rec["finite"]:
        raise RuntimeError("predict_bench: a scored value is not finite")
    return rec


if __name__ == "__main__":
    main()
