"""Every cell, configuration, mix and metric of BENCHMARK.json resolves
to its files, and the file keeps to the benchmark's contract."""

import json
import re

import pytest

from pb_tiny import BENCH, CELLS, ROOT, check_cell_files
from perfbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    check_cell_files(harness.files_of(ROOT, BENCH, cell))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_setup_another_e2e_and_a_layer_metric(cell):
    e2e, per_layer = harness.cell_metrics(BENCH, cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert per_layer
    for m in per_layer:
        assert m["moves"] in names


def test_configs_are_files_under_paths():
    for c in BENCH["configs"]:
        path = ROOT / c["file"]
        assert c["file"].startswith("perfbench/configs/") and path.is_file()
        cfg = json.loads(path.read_text())
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_names_units_and_bounds():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(set(names)) == len(names)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers <= {"scorer loop", "trainer", "graphs", "model",
                      "conditional", "kernels", "device"}
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    cells = set(CELLS)
    for m in BENCH["per_layer"]:
        assert m["workloads"] and set(m["workloads"]) <= cells
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")
