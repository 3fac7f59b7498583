#!/usr/bin/env python
"""Render a ``run_suite`` results database into a paper-style markdown
table, datasets x configurations x modes (port of
benchmarks/render_suite.py).

    python -m dgps_with_iwvi_torch.experiments.render_suite [DB [OUT]]

DB defaults to ``suite.db`` and OUT to ``SUITE.md``, both in the working
directory. The two tables (test NLL, steps/s) have the reference's layout
and ordering; the closing paragraph points at the port's IW-vs-VI record.
"""

from __future__ import annotations

import sys

from dgps_with_iwvi_torch.evaluation import Database

DB = "suite.db"
OUT = "SUITE.md"


def _table(f, datasets, combos, by, cell) -> None:
    """One datasets x (configuration, mode) table of `cell` of each row,
    "—" where the grid has no row."""
    f.write("| dataset | " + " | ".join(f"{c} {m}" for c, m in combos)
            + " |\n")
    f.write("|---|" + "---|" * len(combos) + "\n")
    for ds in datasets:
        cells = [cell(by[(ds, c, m)]) if (ds, c, m) in by else "—"
                 for c, m in combos]
        f.write(f"| {ds} | " + " | ".join(cells) + " |\n")


def main(db_path: str = DB, out_path: str = OUT):
    rows = Database(db_path).read()
    if not rows:
        print("no rows in", db_path)
        return
    datasets = sorted({r["dataset"] for r in rows})
    combos = sorted({(r["configuration"], r["mode"]) for r in rows},
                    key=lambda c: (len(c[0]), c[0], c[1]))
    by = {(r["dataset"], r["configuration"], r["mode"]): r for r in rows}
    syn = any(r.get("synthetic_data") for r in rows)
    with open(out_path, "w") as f:
        f.write("# Configuration sweep — test NLL (original units)\n\n")
        f.write("Mean per-point mixture test log-likelihood (HIGHER is "
                "better), one 90/10 split, 15k iterations, M=128, K=20 for "
                "IW mode, natgrad(final)+Adam.\n")
        if syn:
            f.write("Data: deterministic synthetic surrogates "
                    "(zero-egress container) — these rows demonstrate the "
                    "full harness + training stability, NOT paper-number "
                    "parity; stage real UCI files and re-run for that.\n")
        f.write("\n")
        _table(f, datasets, combos, by, lambda r: f"{r['test_loglik']:.3f}")
        f.write("\n## steps/s (same grid)\n\n")
        _table(f, datasets, combos, by,
               lambda r: f"{r['steps_per_sec']:.0f}")
        f.write(ANALYSIS)
    print("wrote", out_path)


ANALYSIS = """
## On IW-vs-VI patterns in these tables (round-3 adjudication)

Where a GG/LGG **IW** column trails its **VI** counterpart on a unimodal
surrogate, that is a measured property of the objective, not a framework
bug — adjudicated by the IW-vs-VI experiment
(dgps_with_iwvi_torch/experiments/iw_vs_vi.py; the port's record on the
H100 is records/IW_VS_VI_H100.md). With no useful latent
variable, the K-sample logsumexp importance-weights the weight-1
inter-layer GP draws, pays only for the best of K, and collapses the
trained noise variance (~4x on GG-concrete), which the S-sample mixture
predictive then punishes; VI deep models instead posterior-collapse to
their best shallow submodel, which is optimal on unimodal targets. On the
paper's actual use case — latent-variable models on multimodal
conditionals — IW beats VI decisively and monotonically in K
(phase 14 of chip_smoke.py pins this on the card). A second r2
contributor, the off-spec final-layer skip mean function, was fixed in
round 3; tables rendered after that fix reflect the corrected model.
"""


if __name__ == "__main__":
    main(*sys.argv[1:])
