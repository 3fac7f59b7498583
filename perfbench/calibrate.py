#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from (not run by
the benchmark's own runs).

    python3 perfbench/calibrate.py --workload <cell> --seeds 12 \\
        --controls 3 --out <file.json>

In one process, for each of `--seeds` seeds: the program's numbers, from
a run of the cell with a window of `--window` seconds and a warm phase
of `--warm` seconds (the checked steps of a training cell, the sampled
calls of a scoring cell; the window's rate is not read). For the first `--controls` of those seeds: each
control, the reference put in the program's place and computed with its
products' operands rounded to TF32 and to bfloat16, and for a training
cell the fault that leaves half of each batch out (the objective's mean
over the other half), all held to the float64 reference by the same
comparison. Writes {"program": [...], "tf32": [...], "bf16": [...],
"half_batch": [...]} of {name: number} per seed, and the largest and
smallest reading of each.
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
    """The numbers of one control or fault in the program's place; a
    control whose factorization fails has failed every number."""
    import torch

    try:
        return _control_numbers(cell, mode)
    except torch.linalg.LinAlgError:
        return _inf(cell)


def _control_numbers(cell, mode: str) -> dict:
    from perfbench import check, traffic

    drive = traffic.driver(cell.traffic["kind"])
    data, weights = traffic.make_inputs(cell)
    if cell.traffic["kind"] == "train":
        draws = drive.draws(cell, data)
        ref = drive.reference(cell, data, weights, draws)
        got_draws, got_mode = draws, mode
        if mode == "half_batch":
            half = cell.traffic["minibatch_size"] // 2
            got_draws = [(idx[:half], [None if e is None else e[:, :half]
                                       for e in eps]) for idx, eps in draws]
            got_mode = "f64"
        got = drive.reference(cell, data, weights, got_draws, got_mode)
        # the control in the program's place: its own states after the
        # steps before each compared one, held to the reference there
        states = [drive.reference(cell, data, weights, got_draws[:t],
                                  got_mode)["params"]
                  for t in range(1, check.GRAD_STEPS)]
        got_grads = drive.step_grads(cell, data, weights, got["grads"][0],
                                     states, got_draws, got_mode)
        ref_grads = drive.step_grads(cell, data, weights, ref["grads"][0],
                                     states, draws)
        numbers, readings = check.train_numbers(
            got["losses"], got_grads, ref_grads, got["start"],
            got["params"], ref)
        return {**numbers, **readings}
    from perfbench import inputs

    tables = inputs.make_tables(data, cell.traffic["tables"],
                                cell.traffic["table_rows"],
                                cell.seeds.data + 1)
    pairs = [(drive.reference(cell, weights, tables, c, mode),
              drive.reference(cell, weights, tables, c))
             for c in range(cell.traffic["checked_calls"])]
    return check.score_numbers(pairs)[0]


def _inf(cell) -> dict:
    names = (("loss_gap", "grad_gap", "change_gap", "nat_change_gap")
             if cell.traffic["kind"] == "train"
             else ("mean_gap", "var_gap", "logdens_gap"))
    return dict.fromkeys(names, float("inf"))


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
    out = {"workload": a.workload, "card": torch.cuda.get_device_name(0),
           "program": [], "tf32": [], "bf16": []}
    modes = ["tf32", "bf16"]
    if mix["kind"] == "train":
        modes.append("half_batch")
        out["half_batch"] = []
    for j in range(a.seeds):
        seed = a.base_seed + j
        cell = traffic.Cell(a.workload, cfg, mix, inputs.Seeds.of(seed),
                            a.window, False, device, time.perf_counter())
        res = traffic.driver(mix["kind"]).run(cell)
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
