"""Resolve a cell of ``BENCHMARK.json`` to its files, run it once, and
assemble the result line.

Everything that belongs to one configuration, traffic mix, per-layer
metric or cell sits in files of its own, found by name:

- ``configs/<config>.json``: the configuration (the entry's ``file``);
- ``traffic/<traffic>.json``: the mix, read by the driver of its kind,
  ``drivers/<kind>.py`` (``traffic.driver``);
- ``metrics/<metric>.py``: a per-layer metric's reader, ``read(ctx)``,
  which returns a number or None where its trace holds nothing to read;
- ``limits/<cell>.json``: the limit of each number ``correct`` compares.

A later change adds a cell, configuration, mix or metric by adding files
and entries; no file here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

import torch

from . import check, inputs, tracing, traffic, work

HERE = Path(__file__).resolve().parent


def load_benchmark(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, cell: str) -> tuple:
    """(end-to-end entries, per-layer entries) that a cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    return e2e, [m for m in bench["per_layer"] if cell in m["workloads"]]


def files_of(root: Path, bench: dict, cell: str) -> dict:
    """The files a cell runs from: {"config", "traffic", "limits",
    "metrics": {name: path}} (the mix names its driver's file)."""
    w = cell_entry(bench, cell)
    _, per_layer = cell_metrics(bench, cell)
    return {"config": root / config_entry(bench, w["config"])["file"],
            "traffic": HERE / "traffic" / f"{w['traffic']}.json",
            "limits": HERE / "limits" / f"{cell}.json",
            "metrics": {m["name"]: HERE / "metrics" / f"{m['name']}.py"
                        for m in per_layer}}


def load_reader(path: Path):
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + path.stem.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader may read."""

    trace: tracing.Trace
    units: dict          # steps, or calls / batches / rows, in the window
    cfg: dict            # the configuration file
    traffic: dict        # the mix's file
    specs: list          # the layer stack (reference.dgp_ref.layer_specs)
    card: str            # torch.cuda.get_device_name()
    work: object         # the ``work`` module


def run(root: Path, cell: str, seed: int, seconds: float, trace: bool,
        t0: float, device="cuda", bench: dict | None = None,
        files: dict | None = None) -> dict:
    """One run of `cell`; returns the result line's object (the numbers
    compared last, under "checks")."""
    bench = load_benchmark(root) if bench is None else bench
    files = files_of(root, bench, cell) if files is None else files
    device = torch.device(device)
    cfg, mix = _read_json(files["config"]), _read_json(files["traffic"])
    limits = _read_json(files["limits"])
    c = traffic.Cell(cell, cfg, mix, inputs.Seeds.of(seed), seconds, trace,
                     device, t0)
    out = traffic.driver(mix["kind"]).run(c)
    e2e_entries, per_layer = cell_metrics(bench, cell)
    correct, checks = check.judge(out.numbers, limits)
    metrics = {}
    card = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": card, "count": 1, "memory_peak_bytes": out.memory_peak}
    result = {"correct": correct, "attempted": out.attempted,
              "failed": out.failed}
    if trace:
        ctx = Context(out.trace, out.units, cfg, mix, c.specs, card, work)
        for m in per_layer:
            value = load_reader(files["metrics"][m["name"]])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"] = out.trace.busy_ns() / 1e9
        dev["window_s"] = out.trace.window_s
        result.update(metrics=metrics, device=dev,
                      breakdown=tracing.breakdown(out.trace))
    else:
        for m in e2e_entries:
            metrics[m["name"]] = {"value": out.e2e[m["name"]],
                                  "unit": m["unit"]}
        result.update(metrics=metrics, device=dev)
    result["checks"] = checks
    return result
