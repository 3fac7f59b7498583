#!/usr/bin/env python
"""Batch experiment runner: datasets x splits x configurations
(port of dgps_with_iwvi_tpu/experiments/run_suite.py).

Loops the grid through ``experiments.main.run`` and prints a summary
table. Rows already in the results database are skipped, so a sweep can
be resumed (``--no_skip_existing`` runs them again).

Example (a paper-style table over 3 splits, on the card):
    python -m dgps_with_iwvi_torch.experiments.run_suite \\
        --datasets energy,kin8nm,power --configurations G,GG,LG \\
        --modes VI,IW --splits 3 --iterations 20000
"""

from __future__ import annotations

import argparse
import itertools

from dgps_with_iwvi_torch.evaluation import Database
from dgps_with_iwvi_torch.experiments.main import \
    parse_args as parse_main_args, run


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--datasets", default="energy,kin8nm")
    p.add_argument("--configurations", default="G,LG")
    p.add_argument("--modes", default="IW")
    p.add_argument("--splits", type=int, default=1, help="splits 0..n-1")
    p.add_argument("--K", type=int, default=20)
    p.add_argument("--M", type=int, default=128)
    p.add_argument("--iterations", type=int, default=20000)
    p.add_argument("--results_db", default="results.db")
    p.add_argument("--skip_existing", dest="skip_existing",
                   action="store_true", default=True,
                   help="skip the cells already in --results_db (the "
                        "default, as in the reference)")
    p.add_argument("--no_skip_existing", dest="skip_existing",
                   action="store_false",
                   help="run every cell of the grid, also those already in "
                        "--results_db")
    p.add_argument("--extra", default="",
                   help="extra flags passed through to main, space-separated "
                        "(e.g. '--device cpu')")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    db = Database(args.results_db)
    grid = list(itertools.product(
        args.datasets.split(","), args.configurations.split(","),
        args.modes.split(","), range(args.splits)))
    done = {(r["dataset"], r["configuration"], r["mode"], r["split"])
            for r in db.read()}
    rows = []
    for dataset, configuration, mode, split in grid:
        key = (dataset, configuration, mode.upper(), split)
        if args.skip_existing and key in done:
            print(f"[skip] {key} already in {args.results_db}")
            continue
        argv_main = [
            "--dataset", dataset, "--configuration", configuration,
            "--mode", mode, "--split", str(split), "--K", str(args.K),
            "--M", str(args.M), "--iterations", str(args.iterations),
            "--results_db", args.results_db,
        ] + (args.extra.split() if args.extra else [])
        print(f"\n=== {key} ===", flush=True)
        rows.append(run(parse_main_args(argv_main)))

    if rows:
        print("\n| dataset | config | mode | split | NLL | RMSE | steps/s |")
        print("|---|---|---|---|---|---|---|")
        for r in rows:
            print(f"| {r['dataset']} | {r['configuration']} | {r['mode']} "
                  f"| {r['split']} | {r['test_loglik']:.4f} "
                  f"| {r['test_rmse']:.4f} | {r['steps_per_sec']:.0f} |")
    return rows


if __name__ == "__main__":
    main()
