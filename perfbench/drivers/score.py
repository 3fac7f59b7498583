"""Scoring traffic (mix kind "score"): one client in a closed loop
calling ``serving.Scorer.score`` on host tables.

``tables`` host tables of ``table_rows`` rows, scored in turn with a new
seed per call (``Scorer.score`` seeds batch i with seed + i),
``batch_rows`` rows a batch, S = ``num_samples``; the first call of
set-up captures the batch's graph, and calls run on for ``warm_seconds``
more. A sample of ``checked_calls`` of the window's calls, drawn from
the seed as the window runs, is compared row by row. With one intra-op
thread (``run.py``) the loop held its tail from its first seconds.
"""

from __future__ import annotations

import copy
import time

import numpy as np
import torch

from perfbench import check, inputs, system, tracing, traffic
from perfbench.reference import dgp_ref

NUMBERS = ("mean_gap", "var_gap", "logdens_gap")
# the reference with its products' operands rounded to TF32 and to
# bfloat16
CONTROLS = ("tf32", "bf16")
DRIVES = "score"
REFERENCE = dgp_ref


def shrink(cfg: dict, mix: dict) -> tuple:
    """(cfg, mix) at the CPU tests' size: 2,000 rows, K=4, S=8 and two
    128-row tables of two batches, no warm phase."""
    cfg, mix = copy.deepcopy(cfg), copy.deepcopy(mix)
    cfg["dataset"].update(N=2000)
    cfg["model"].update(num_iw_samples=4)
    mix.update(num_samples=8, table_rows=128, batch_rows=64, tables=2,
               warm_seconds=0, reference_block_rows=32)
    return cfg, mix


def call_seed(cell: traffic.Cell, c: int) -> int:
    """The seed of call c; Scorer.score seeds its batch i with it + i."""
    per = cell.traffic["table_rows"] // cell.traffic["batch_rows"]
    return cell.seeds.run + per * c


def run(cell: traffic.Cell) -> traffic.Outcome:
    tr = cell.traffic
    data, weights = traffic.make_inputs(cell)
    specs, device = cell.specs, cell.device
    S, rows, batch = tr["num_samples"], tr["table_rows"], tr["batch_rows"]
    if rows % batch:
        raise ValueError("table_rows must be a multiple of batch_rows")
    config = system.port_config(cell.cfg, data.X.shape[1], 1,
                                data.X.shape[0])
    scorer = system.scorer(system.port_params(weights, specs), config, S,
                           device)
    tables = inputs.make_tables(data, tr["tables"], rows, cell.seeds.data + 1)
    cell.log("scorer and host tables made")
    j, warm0 = 0, None
    while j == 0 or time.perf_counter() - warm0 < tr["warm_seconds"]:
        Xw, Yw = tables[j % len(tables)]
        scorer.score(Xw, Yw, seed=call_seed(cell, -1 - j), max_batch=batch)
        if j == 0:
            warm0 = time.perf_counter()   # the first call captures
        j += 1
    traffic.sync(device)
    setup_s = time.perf_counter() - cell.t0
    cell.log("window opens after the warm calls")

    traced = tracing.Window(cell.trace)
    kept = Reservoir(tr["checked_calls"], cell.seeds.sample)
    lat, failed = [], 0
    traced.start()
    w0 = t = time.perf_counter()
    while True:
        c = len(lat)
        X, Y = tables[c % len(tables)]
        traced.enter("score.call")
        out = scorer.score(X, Y, seed=call_seed(cell, c), max_batch=batch)
        traced.exit()
        t1 = time.perf_counter()
        lat.append(t1 - t)
        t = t1
        kept.offer(c, out)
        if not all(np.isfinite(v).all() for v in out.values()):
            failed += 1
        if (len(lat) >= tr["traced_calls"] if cell.trace
                else t1 - w0 >= cell.seconds):
            break
    traffic.sync(device)
    trace = traced.stop()
    cell.log("window closed")
    cell.log("calls per 10 s of the window (n, median ms, p95 ms): "
             + traffic.blocks(lat, 10.0))
    n = len(lat)
    e2e = {"setup_s": setup_s, "score_rows_per_s": n * rows / (t - w0),
           "score_call_p95_ms": float(np.percentile(lat, 95)) * 1e3}
    peak = traffic.memory_peak(device)
    del scorer
    traffic.free(device)

    pairs = []
    for c, out in kept.items():
        got = [torch.as_tensor(out[k], device=device).double()
               for k in ("mean", "var", "log_density")]
        pairs.append((got, reference(cell, weights, tables, c)))
    numbers, readings = check.score_numbers(pairs)
    cell.log("reference done")
    return traffic.Outcome(setup_s, e2e, n, failed,
                           {"calls": n, "batches": n * rows // batch,
                            "rows": n * rows}, trace, peak, numbers,
                           readings)


class Reservoir:
    """k of the window's calls, each finished call equally likely to be
    kept, drawn from the seed (reservoir sampling), so that the window
    holds the results of k calls and not of all."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng(seed)
        self.slots: list = []

    def offer(self, c: int, out) -> None:
        if len(self.slots) < self.k:
            self.slots.append((c, out))
            return
        j = int(self.rng.integers(0, c + 1))
        if j < self.k:
            self.slots[j] = (c, out)

    def items(self) -> list:
        return sorted(self.slots, key=lambda s: s[0])


def reference(cell: traffic.Cell, weights, tables, c: int,
              mode="f64") -> tuple:
    """(mean, var, log_density) of call c's whole table, batch by batch,
    each batch's noise from a generator of its seed."""
    tr, device = cell.traffic, cell.device
    S, batch = tr["num_samples"], tr["batch_rows"]
    X, Y = tables[c % len(tables)]
    parts = []
    for i in range(tr["table_rows"] // batch):
        sl = slice(i * batch, (i + 1) * batch)
        gen = torch.Generator(device=device).manual_seed(
            call_seed(cell, c) + i)
        eps = dgp_ref.draw_score(gen, S, batch, cell.specs)
        parts.append(dgp_ref.score(
            weights, cell.specs, torch.as_tensor(X[sl], device=device),
            torch.as_tensor(Y[sl], device=device), eps,
            dgp_ref.Arith(mode), tr["reference_block_rows"]))
    return tuple(torch.cat(p) for p in zip(*parts))


def control_numbers(cell: traffic.Cell, mode: str) -> dict:
    """The numbers of one control in the program's place (``CONTROLS``):
    the reference in `mode` on the first ``checked_calls`` calls, held to
    the float64 reference by the same comparison."""
    data, weights = traffic.make_inputs(cell)
    tables = inputs.make_tables(data, cell.traffic["tables"],
                                cell.traffic["table_rows"],
                                cell.seeds.data + 1)
    pairs = [(reference(cell, weights, tables, c, mode),
              reference(cell, weights, tables, c))
             for c in range(cell.traffic["checked_calls"])]
    return check.score_numbers(pairs)[0]
