"""Shared helpers of the benchmark's CPU tests: each cell of
BENCHMARK.json shrunk to a size a test run holds (its driver's
``shrink``: the same layer stack, widths, M, batch, mix and limits, over
2,000 rows and K=4 samples), run on the CPU through the harness with the
chip check skipped."""

import json
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import harness, traffic  # noqa: E402

BENCH = harness.load_benchmark(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2 ** 33 + 7


def mix_of(cell: str) -> dict:
    return json.loads(harness.files_of(ROOT, BENCH, cell)["traffic"]
                      .read_text())


def driver_of(cell: str):
    """The driver module of a cell's traffic kind."""
    return traffic.driver(mix_of(cell)["kind"])


def shrink(cfg: dict, mix: dict) -> tuple:
    return traffic.driver(mix["kind"]).shrink(cfg, mix)


def check_cell_files(files: dict) -> None:
    """A cell's files are there: its configuration and mix, the driver of
    the mix's kind, a limit for each number that driver compares, and a
    reader for each of its per-layer metrics."""
    for key in ("config", "traffic", "limits"):
        assert files[key].is_file(), files[key]
    mix = json.loads(files["traffic"].read_text())
    drive = traffic.driver(mix["kind"])
    assert callable(drive.run)
    limits = json.loads(files["limits"].read_text())
    assert set(limits) == set(drive.NUMBERS)
    assert files["metrics"]
    for name, path in files["metrics"].items():
        assert path.is_file(), path
        assert callable(harness.load_reader(path))


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
