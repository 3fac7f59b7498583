"""Shared helpers of the benchmark's CPU tests: each cell of
BENCHMARK.json shrunk to a size a test run holds (the same layer stack,
widths, M, batch, mix and limits, over 2,000 rows, K=4 samples and
128-row tables), run on the CPU through the harness with the chip check
skipped."""

import json
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402

BENCH = harness.load_benchmark(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2 ** 33 + 7


def shrink(cfg: dict, mix: dict) -> tuple:
    cfg = json.loads(json.dumps(cfg))
    mix = json.loads(json.dumps(mix))
    cfg["dataset"].update(N=2000)
    cfg["model"].update(num_iw_samples=4)
    if mix["kind"] == "train":
        mix.update(steps_per_call=3, lead_in=[[1, 3], [3, 6]], warm_seconds=0)
    else:
        mix.update(num_samples=8, table_rows=128, batch_rows=64, tables=2,
                   warm_seconds=0,
                   reference_block_rows=32)
    return cfg, mix


@pytest.fixture
def tiny(tmp_path):
    """tiny(cell) -> (files for harness.run, cfg, mix) of the shrunk cell."""

    def make(cell):
        files = harness.files_of(ROOT, BENCH, cell)
        cfg, mix = shrink(json.loads(files["config"].read_text()),
                          json.loads(files["traffic"].read_text()))
        d = tmp_path / cell
        d.mkdir()
        (d / "c.json").write_text(json.dumps(cfg))
        (d / "t.json").write_text(json.dumps(mix))
        return (dict(files, config=d / "c.json", traffic=d / "t.json"),
                cfg, mix)

    return make


def run_tiny(files, cell, seconds=0.2, trace=False):
    return harness.run(ROOT, cell, SEED, seconds, trace, time.perf_counter(),
                       device="cpu", bench=BENCH, files=files)
