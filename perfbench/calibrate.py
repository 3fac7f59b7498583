#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from (not run by
the benchmark's own runs).

    python3 perfbench/calibrate.py --workload <cell> --seeds 12 \\
        --controls 3 --out <file.json>

In one process, for each of `--seeds` seeds: the program's numbers, from
a run of the cell with a window of `--window` seconds and a warm phase
of `--warm` seconds (the checked steps of a training cell, the sampled
calls of a scoring cell; the window's rate is not read). For the first
`--controls` of those seeds: each control the cell's driver declares
(``CONTROLS``, its numbers from ``control_numbers``), put in the
program's place and held to the float64 reference by the same
comparison. Writes {"program": [...], <control>: [...]} of {name:
number} per seed, and the largest and smallest reading of each.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

BASE_SEED = 7_000_000_000


def control_numbers(cell, mode: str) -> dict:
    """The numbers of one control or fault in the program's place, as the
    cell's driver declares it (``control_numbers``); a control whose
    factorization fails has failed every number (``NUMBERS``)."""
    import torch

    from perfbench import traffic

    drive = traffic.driver(cell.traffic["kind"])
    try:
        return drive.control_numbers(cell, mode)
    except torch.linalg.LinAlgError:
        return dict.fromkeys(drive.NUMBERS, float("inf"))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--base_seed", type=int, default=BASE_SEED)
    p.add_argument("--window", type=float, default=0.1)
    p.add_argument("--warm", type=float, default=0.0)
    p.add_argument("--out", required=True)
    a = p.parse_args(argv)
    import torch

    from perfbench import harness, inputs, traffic

    bench = harness.load_benchmark(ROOT)
    files = harness.files_of(ROOT, bench, a.workload)
    cfg = json.loads(files["config"].read_text())
    mix = dict(json.loads(files["traffic"].read_text()),
               warm_seconds=a.warm)
    device = torch.device("cuda")
    drive = traffic.driver(mix["kind"])
    modes = list(drive.CONTROLS)
    out = {"workload": a.workload, "card": torch.cuda.get_device_name(0),
           "program": [], **{mode: [] for mode in modes}}
    for j in range(a.seeds):
        seed = a.base_seed + j
        cell = traffic.Cell(a.workload, cfg, mix, inputs.Seeds.of(seed),
                            a.window, False, device, time.perf_counter())
        res = drive.run(cell)
        nums = {**res.numbers, **res.readings}
        out["program"].append({"seed": seed, **nums})
        print("program", seed, nums, file=sys.stderr, flush=True)
        if j < a.controls:
            for mode in modes:
                cell = traffic.Cell(a.workload, cfg, mix,
                                    inputs.Seeds.of(seed), 0.0, False,
                                    device, time.perf_counter())
                nums = control_numbers(cell, mode)
                out[mode].append({"seed": seed, **nums})
                print(mode, seed, nums, file=sys.stderr, flush=True)
    summary = {}
    for key in ["program"] + modes:
        rows = out[key]
        if not rows:
            continue
        names = [k for k in rows[0] if k != "seed"]
        summary[key] = {n: {"max": max(r[n] for r in rows),
                            "min": min(r[n] for r in rows)}
                        for n in names}
    out["summary"] = summary
    Path(a.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
