#!/usr/bin/env python
"""The five BASELINE.md parity configurations (port of
benchmarks/run_baseline_configs.py).

Each runs through the harness (``experiments.main.parse_args`` / ``run``,
that is ``dgp-train-torch``) with ``COMMON``'s flags, writes its row to
``--results_db`` and then one table, ``<out>.md``, with the reference's
columns (test NLL in original units, test RMSE, steps/s, training
seconds), and the rows as ``<out>.json``. The backend line holds the
card's name and power limit.

    python -m dgps_with_iwvi_torch.experiments.baseline_configs \\
        [--out DIR/RESULTS] [--results_db DIR/results.db] [--device cpu]

Without staged UCI files under ``~/.dgp_data`` each dataset resolves to
its name-seeded synthetic surrogate (``data.get_regression_data``), and
the rows say so (``synthetic_data``), as the reference's did.
"""

from __future__ import annotations

import argparse
import json
import time

from dgps_with_iwvi_torch.device import backend, resolve_device
from dgps_with_iwvi_torch.experiments.main import parse_args as main_args
from dgps_with_iwvi_torch.experiments.main import run

CONFIGS = [
    # (label, argv)
    ("1: SVGP G, energy", [
        "--dataset", "energy", "--configuration", "G", "--mode", "VI",
        "--M", "100", "--minibatch_size", "256", "--iterations", "15000"]),
    ("2: DGP GG (doubly-stochastic VI), kin8nm", [
        "--dataset", "kin8nm", "--configuration", "GG", "--mode", "VI",
        "--M", "128", "--iterations", "15000"]),
    ("3: LV-DGP LG + IWVI K=5, power", [
        "--dataset", "power", "--configuration", "LG", "--mode", "IW",
        "--K", "5", "--M", "128", "--iterations", "15000"]),
    ("4: 2-layer LV-DGP LGG, IWVI K=20, protein", [
        "--dataset", "protein", "--configuration", "LGG", "--mode", "IW",
        "--K", "20", "--M", "128", "--iterations", "15000"]),
    ("5: 3-layer LV-DGP LGGG, IWVI K=50, natgrad, year (full N=515345)", [
        "--dataset", "year", "--configuration", "LGGG", "--mode", "IW",
        "--K", "50", "--M", "128", "--iterations", "10000"]),
]

COMMON = ["--natgrad", "final", "--print_every", "5000",
          "--steps_per_call", "500"]

COLUMNS = ("| config | test NLL (orig units) | test RMSE | ELBO "
           "steps/s | train s |\n|---|---|---|---|---|\n")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--results_db", default="results.db")
    p.add_argument("--out", default="RESULTS",
                   help="output path without suffix: <out>.md, <out>.json")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch "
                        "versions of the kernels")
    return p.parse_args(argv)


def write_table(path: str, rows: list, backend_line: str) -> None:
    """The reference's RESULTS.md table (l.60-75)."""
    syn = all(r.get("synthetic_data") for r in rows)
    data = ("deterministic synthetic surrogates (no staged UCI files — "
            "see data/datasets.py; re-run with staged UCI files for "
            "published-number parity)" if syn else
            "staged UCI files where found, else synthetic surrogates "
            "(each row's synthetic_data in the .json)")
    with open(path, "w") as f:
        f.write("# BASELINE parity configs — results\n\n")
        f.write(f"Backend: {backend_line}; data: {data}.\n\n")
        f.write(COLUMNS)
        for r in rows:
            f.write(f"| {r['label']} | {r['test_loglik']:.4f} | "
                    f"{r['test_rmse']:.4f} | {r['steps_per_sec']:.0f} | "
                    f"{r['train_time_s']:.0f} |\n")


def main(argv=None) -> list:
    """Run the five configurations and write the table; returns the rows."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    rows = []
    for label, argv_c in CONFIGS:
        print(f"\n=== {label} ===", flush=True)
        t0 = time.time()
        row = run(main_args(argv_c + COMMON + [
            "--results_db", args.results_db, "--device", args.device]))
        row["label"] = label
        row["total_s"] = time.time() - t0
        rows.append(row)
    backend_line = backend(device)
    write_table(args.out + ".md", rows, backend_line)
    with open(args.out + ".json", "w") as f:
        json.dump({"backend": backend_line, "rows": rows}, f, indent=1)
    print(f"\nwrote {args.out}.md / .json")
    print(json.dumps([{k: r[k] for k in
                       ("label", "test_loglik", "test_rmse", "steps_per_sec")}
                      for r in rows], indent=1))
    return rows


if __name__ == "__main__":
    main()
