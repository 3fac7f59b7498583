"""The general generator of traffic: what every kind of mix shares.

A mix (``traffic/<name>.json``) names its ``kind``; the driver of that
kind, ``drivers/<kind>.py``, is found by that name (``driver``), so a new
kind of traffic is a new file there. It declares all that the rest of
the benchmark knows of the kind:

- ``run(cell) -> Outcome``: one run;
- ``NUMBERS``: the names of the numbers ``correct`` compares, the keys
  of a cell's ``limits/<cell>.json``;
- ``CONTROLS``: the modes ``calibrate.py`` puts in the program's place;
- ``control_numbers(cell, mode)``: the numbers of one of them;
- ``shrink(cfg, mix)``: (cfg, mix) at the CPU tests' size;
- ``DRIVES``: the port's entry point it drives, "fit" or "score", where
  the tests plant their faults;
- ``REFERENCE``: the reference module it compares against.

Each driver makes its inputs and weights from the seed, warms up every
shape the mix uses (that is the set-up), then measures for the window's
seconds (``--trace 0``) or traces a fixed amount of the same
work (``--trace 1``). After the window it reads the device's memory
peak, frees the program's state and runs the reference on what the
window produced.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import inputs, system
from .reference import dgp_ref

DRIVERS = Path(__file__).resolve().parent / "drivers"


@dataclasses.dataclass
class Cell:
    name: str
    cfg: dict
    traffic: dict
    seeds: inputs.Seeds
    seconds: float
    trace: bool
    device: torch.device
    t0: float                      # the process's start, perf_counter

    def log(self, what: str) -> None:
        """A line on standard error: where the run is, and when."""
        print(f"perfbench: {what} at {time.perf_counter() - self.t0:.3f} s",
              file=sys.stderr, flush=True)

    @property
    def specs(self) -> list:
        return specs_of(self.cfg)


def specs_of(cfg: dict) -> list:
    """The layer stack of a configuration: its dataset's D inputs, and a
    final GP layer of ``model.outputs`` columns (1 where absent)."""
    model = cfg["model"]
    return dgp_ref.layer_specs(model, cfg["dataset"]["D"],
                               model.get("outputs", 1))


@dataclasses.dataclass
class Outcome:
    setup_s: float
    e2e: dict                      # end-to-end metric name -> value
    attempted: int
    failed: int
    units: dict                    # work in the traced window
    trace: object                  # tracing.Trace or None
    memory_peak: int
    numbers: dict                  # check name -> value
    readings: dict                 # figures kept beside them, not judged


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0


def free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def make_inputs(cell: Cell):
    """(data, weights) of a cell from its seed, on its device."""
    cell.log("torch imported")
    if cell.device.type == "cuda":
        system.build_all()
        cell.log("kernels built")
    ds, model = cell.cfg["dataset"], cell.cfg["model"]
    data = inputs.make_data(ds, cell.seeds.data, cell.device)
    weights = inputs.make_weights(cell.specs, model, data.X, 1,
                                  cell.seeds.weights)
    sync(cell.device)
    cell.log("data and weights made")
    return data, weights


def driver(kind: str):
    """The driver module of a mix's kind, ``drivers/<kind>.py``."""
    if not (DRIVERS / f"{kind}.py").is_file():
        raise KeyError(f"no driver {kind!r}: drivers/{kind}.py is missing")
    return importlib.import_module(f"perfbench.drivers.{kind}")


def blocks(lengths: list, span: float) -> str:
    """The window's calls or chunks (their lengths in seconds, in order)
    in blocks of `span` seconds: "n median p95 | ..." in ms, for the log:
    where a run reads off, whether one stretch of it did."""
    out, start, t = [], 0, 0.0
    for i, x in enumerate(lengths):
        t += x
        if t >= span or i == len(lengths) - 1:
            b = np.asarray(lengths[start:i + 1]) * 1e3
            out.append(f"{len(b)} {np.median(b):.3f} "
                       f"{np.percentile(b, 95):.3f}")
            start, t = i + 1, 0.0
    return " | ".join(out)
