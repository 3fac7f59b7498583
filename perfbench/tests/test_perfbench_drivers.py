"""A kind of traffic is one file, ``drivers/<kind>.py``, that declares
all the rest of the benchmark knows of it: every driver declares the
interface; a kind that exists only as new files (a stub, here) resolves
to its files and calibrates through its declarations alone; and the
training kind's draws at a full-batch mix are the ones the port's
full-batch step consumes."""

import copy
import json
import shutil
import time
import types

import pytest
import torch

from pb_tiny import (BENCH, ROOT, SEED, check_cell_files, driver_of,
                     mix_of, shrink)
from perfbench import calibrate, harness, inputs, system, traffic
from perfbench.reference import dgp_ref

KINDS = sorted(p.stem for p in traffic.DRIVERS.glob("*.py")
               if not p.stem.startswith("_"))


@pytest.mark.parametrize("kind", KINDS)
def test_every_driver_declares_the_interface(kind):
    drive = traffic.driver(kind)
    for fn in ("run", "control_numbers", "shrink"):
        assert callable(getattr(drive, fn)), fn
    assert drive.NUMBERS and all(isinstance(n, str) for n in drive.NUMBERS)
    assert drive.CONTROLS and all(isinstance(c, str) for c in drive.CONTROLS)
    assert drive.DRIVES in ("fit", "score")
    assert isinstance(drive.REFERENCE, types.ModuleType)


def _stub_driver():
    """A kind defined here alone: a multiclass scoring kind with one
    compared number and two controls, the second failing to factor."""
    stub = types.ModuleType("score_class")
    stub.NUMBERS = ("class_gap",)
    stub.CONTROLS = ("bf16", "singular")
    stub.DRIVES = "score"
    stub.REFERENCE = dgp_ref

    def run(cell):
        raise NotImplementedError

    def control_numbers(cell, mode):
        if mode == "singular":
            raise torch.linalg.LinAlgError("not positive definite")
        return {"class_gap": 0.5}

    def shrink_(cfg, mix):
        cfg, mix = copy.deepcopy(cfg), copy.deepcopy(mix)
        cfg["dataset"].update(N=2000)
        return cfg, dict(mix, table_rows=128)

    stub.run, stub.control_numbers, stub.shrink = run, control_numbers, \
        shrink_
    return stub


def test_a_new_kind_needs_only_new_files(tmp_path, monkeypatch):
    """The stub kind's cell, added as new files (its mix and limits) and
    BENCHMARK.json entries, resolves by name, shrinks and calibrates
    through its declarations, with no file of the harness edited."""
    here = tmp_path / "perfbench"
    for d in ("traffic", "limits", "metrics"):
        shutil.copytree(harness.HERE / d, here / d)
    cell, stub = "score_class.lgg-kin8nm.s100", _stub_driver()
    (here / "traffic" / "score_class.s100.json").write_text(json.dumps(
        {"kind": "score_class", "table_rows": 32768}))
    (here / "limits" / f"{cell}.json").write_text(
        json.dumps({"class_gap": 0.1}))
    bench = copy.deepcopy(BENCH)
    bench["workloads"].append({"name": cell, "config": "lgg-kin8nm",
                               "traffic": "score_class.s100", "chips": 1,
                               "why": "a stub"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "score.lgg-kin8nm.s100" in m.get("workloads", ()):
            m["workloads"].append(cell)
    orig = traffic.driver
    monkeypatch.setattr(traffic, "driver", lambda kind: stub
                        if kind == "score_class" else orig(kind))
    monkeypatch.setattr(harness, "HERE", here)

    files = harness.files_of(ROOT, bench, cell)
    check_cell_files(files)
    e2e, per_layer = harness.cell_metrics(bench, cell)
    assert {m["name"] for m in e2e} >= {"setup_s", "score_rows_per_s"}
    assert per_layer
    cfg, mix = shrink(json.loads(files["config"].read_text()),
                      json.loads(files["traffic"].read_text()))
    assert (cfg["dataset"]["N"], mix["table_rows"]) == (2000, 128)
    c = traffic.Cell(cell, cfg, mix, inputs.Seeds.of(SEED), 0.0, False,
                     torch.device("cpu"), time.perf_counter())
    assert calibrate.control_numbers(c, "bf16") == {"class_gap": 0.5}
    assert calibrate.control_numbers(c, "singular") == \
        {"class_gap": float("inf")}


def test_full_batch_draws_are_the_ports():
    """Step 1 of the port's full-batch step, drawing from a generator of
    the run's seed, is the float64 reference's on the training kind's
    draws of that mix within the cell's ``loss_gap`` limit; a mix whose
    minibatch is smaller than the training rows keeps its row draws."""
    from dgps_with_iwvi_torch import training

    name = "train.lgg-kin8nm.b8192"
    files = harness.files_of(ROOT, BENCH, name)
    cfg, mix = shrink(json.loads(files["config"].read_text()), mix_of(name))
    limit = json.loads(files["limits"].read_text())["loss_gap"]
    cell = traffic.Cell(name, cfg, mix, inputs.Seeds.of(SEED), 0.0, False,
                        torch.device("cpu"), time.perf_counter())
    data, weights = traffic.make_inputs(cell)
    n, specs = data.X.shape[0], cell.specs
    assert mix["minibatch_size"] >= n
    spec = cfg["train"]
    config = system.port_config(cfg, data.X.shape[1], 1, n)
    tc = training.TrainConfig(
        lr=spec["lr"], gamma=spec["gamma"], natgrad=spec["natgrad"],
        schedule=spec["schedule"], minibatch_size=mix["minibatch_size"],
        full_batch_precision=cfg["precision"]["full_batch_precision"])
    init, step, _, _ = training.make_trainer(config, tc)
    state = init(system.port_params(weights, specs))
    gen = torch.Generator().manual_seed(cell.seeds.run)
    _, loss = step(state, data.X, data.Y, gen)
    drive = driver_of(name)
    full = drive.draws(cell, data)
    assert all(torch.equal(idx, torch.arange(n)) for idx, _ in full)
    ref = dgp_ref.train(weights, specs, data.X, data.Y, full[:1], n,
                        spec["lr"], spec["gamma"], dgp_ref.Arith("f64"))
    assert abs(float(loss) - ref["losses"][0]) <= \
        limit * abs(ref["losses"][0])

    cell.traffic = dict(mix, minibatch_size=512)
    gen = torch.Generator().manual_seed(cell.seeds.run)
    K = cfg["model"]["num_iw_samples"]
    for (idx, eps), (idx0, eps0) in zip(
            drive.draws(cell, data),
            [dgp_ref.draw_train(gen, n, 512, K, specs)
             for _ in range(mix["checked_steps"])]):
        assert torch.equal(idx, idx0)
        assert all(torch.equal(e, e0) for e, e0 in zip(eps, eps0)
                   if e is not None)
