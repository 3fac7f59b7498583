"""The port's convergence gate (``experiments/quality_gate.py``) against
the reference's ``benchmarks/quality_gate.py``, on the CPU.

The reference's script is read, not imported (importing it sets JAX's
configuration and a compile-cache directory): its ``GATE_CONFIGS`` with
``ast``, its verdict arithmetic through the rows of its committed
records (the FAIL row LGG-kin8nm included), whose derived fields
``judge`` must give again from their raw values at rtol 1e-12 (the same
float64 arithmetic in the same order).
Then the CLI at a small size (M=16, 20 steps): the record's fields and
columns, ``--reuse_ref`` training no reference side, and the switch and
graph hygiene of the measurement, with the evaluation's CUDA graphs
replaced by a fake that records the gram switches of its capture; a
full-batch candidate trained exactly as the all-highest side; and the
sharded trainer's gate (``--mesh``): its flags against the reference's
parser, read with ``ast``, its refusals, one ``--quick`` run on two gloo
ranks with the reference's record fields and columns, and a rank that
raises.
"""

import ast
import json
import math
import os
from collections import OrderedDict

import numpy as np
import pytest

from dgps_with_iwvi_torch.evaluation import metrics
from dgps_with_iwvi_torch.experiments import quality_gate as qg
from dgps_with_iwvi_torch.ops import kernels
from dgps_with_iwvi_torch.utils import graphs
from torch_threads import one_thread  # noqa: F401  (autouse)

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks")
RECORDS = ("QUALITY_GATE.json", "QUALITY_GATE_solvebwd.json")
MESH_RECORD = "QUALITY_GATE_mesh.json"
# the mesh record's fields under the names of a gate row
MESH_AS_GATE_ROW = {"elbo_single": "elbo_ref",
                    "elbo_single_seed1": "elbo_ref_seed1",
                    "elbo_mesh": "elbo_cand", "nll_single": "nll_ref",
                    "nll_mesh": "nll_cand"}
# what the port's mesh row adds to the reference's fields
MESH_ROW_EXTRA = {"finite", "replicas_bitwise_equal", "steps_per_s_single",
                  "steps_per_s_single_seed1", "steps_per_s_mesh", "ranks"}
SMALL = dict(num_inducing=16)          # run_setting keywords of the tests
ITERS = ["--device", "cpu", "--iterations", "20"]
REF_COLUMNS = ("| config | verdict | ELBO/n ref | ELBO/n cand | dELBO rel "
               "| seed band | NLL ref | NLL cand | dNLL |")
ROW_FIELDS = {"config", "ok", "elbo_ref", "elbo_ref_seed1", "elbo_cand",
              "d_elbo_rel", "seed_band_rel", "tol_elbo_rel", "nll_ref",
              "nll_cand", "d_nll", "seed_band_nll", "tol_nll", "finite",
              "seconds"}


def _switches():
    return (kernels.GRAM_FWD_PRECISION, kernels.GRAM_BWD_RELAX,
            kernels.GRAM_KUF_RESIDUAL)


def test_gate_configs_equal_the_reference():
    with open(os.path.join(BENCH, "quality_gate.py")) as f:
        tree = ast.parse(f.read())
    ref = next(ast.literal_eval(node.value) for node in tree.body
               if isinstance(node, ast.Assign)
               and any(getattr(t, "id", None) == "GATE_CONFIGS"
                       for t in node.targets))
    assert qg.GATE_CONFIGS == ref


def _mesh_record_as_gate_rows() -> tuple:
    """The mesh record as a gate record: its fields renamed, every run
    finite (its ``ok`` says so), and the tolerances of the reference's
    defaults, which the mesh run took."""
    with open(os.path.join(BENCH, MESH_RECORD)) as f:
        rec = json.load(f)
    defaults = qg.parse_args([])
    rec["tolerances"] = {"elbo_rel": defaults.rel_tol,
                         "nll_nats": defaults.nll_tol}
    rec["rows"] = [dict({MESH_AS_GATE_ROW.get(k, k): v
                         for k, v in row.items()}, finite=True)
                   for row in rec["rows"]]
    return rec


def _record_rows():
    recs = []
    for name in RECORDS:
        with open(os.path.join(BENCH, name)) as f:
            recs.append((name, json.load(f)))
    recs.append((MESH_RECORD, _mesh_record_as_gate_rows()))
    for name, rec in recs:
        for row in rec["rows"]:
            yield pytest.param(rec, row, id=f"{name}:{row['config']}")


@pytest.mark.parametrize("rec,row", list(_record_rows()))
def test_judge_reproduces_the_reference_records(rec, row):
    """Every derived field and the verdict from the row's raw values;
    seed 1's NLL is rebuilt at the recorded band, as the reference's
    --reuse_ref rebuilds it."""
    ref = {"elbo_per_point": row["elbo_ref"], "test_nll": row["nll_ref"],
           "finite": row["finite"]}
    ref2 = {"elbo_per_point": row["elbo_ref_seed1"],
            "test_nll": row["nll_ref"] + row["seed_band_nll"],
            "finite": row["finite"]}
    cand = {"elbo_per_point": row["elbo_cand"], "test_nll": row["nll_cand"],
            "finite": row["finite"]}
    tol = rec["tolerances"]
    got = qg.judge(ref, ref2, cand, tol["elbo_rel"], tol["nll_nats"])
    for key in ("d_elbo_rel", "seed_band_rel", "tol_elbo_rel", "d_nll",
                "seed_band_nll", "tol_nll"):
        np.testing.assert_allclose(got[key], row[key], rtol=1e-12,
                                   err_msg=key)
    assert got["ok"] is row["ok"]
    assert rec["pass"] is all(r["ok"] for r in rec["rows"])


@pytest.mark.parametrize("bad", ["ref", "ref2", "cand", "nan"])
def test_judge_fails_a_non_finite_run(bad):
    sides = {s: {"elbo_per_point": -0.5, "test_nll": 0.1, "finite": True}
             for s in ("ref", "ref2", "cand")}
    if bad == "nan":
        sides["cand"]["elbo_per_point"] = math.nan
    else:
        sides[bad]["finite"] = False
    v = qg.judge(sides["ref"], sides["ref2"], sides["cand"], 1e-3, 5e-3)
    assert v["ok"] is False
    assert v["finite"] is (bad == "nan")


def test_quick_and_subsets_follow_the_reference():
    a = qg.parse_args(["--quick", "--iterations", "7"])
    assert (a.iterations, a.rel_tol, a.nll_tol) == (500, 0.2, 0.5)
    a = qg.parse_args([])
    assert (a.iterations, a.minibatch, a.rel_tol, a.nll_tol, a.out,
            a.device) == (15000, 512, 1e-3, 0.005, "QUALITY_GATE", "cuda")
    assert [g[0] for g in qg.selected_configs("LGG-kin8nm,ADAM")] == [
        "LGG-kin8nm natgrad", "GG-energy ADAM-ONLY"]
    assert qg.selected_configs(None) == qg.GATE_CONFIGS
    with pytest.raises(ValueError, match="selects none"):
        qg.selected_configs("LLLL")


def _count_runs(monkeypatch) -> list:
    """Every run_setting call's keywords, and the gram switches in force
    when its training ran."""
    calls = []
    run, fit = qg.run_setting, qg.fit

    def counted(*gc, **kw):
        calls.append(dict(kw, label=gc[0]))
        return run(*gc, **kw)

    def fit_spy(*a, **kw):
        calls[-1]["training_switches"] = _switches()
        return fit(*a, **kw)

    monkeypatch.setattr(qg, "run_setting", counted)
    monkeypatch.setattr(qg, "fit", fit_spy)
    return calls


def test_main_writes_the_record_and_reuse_trains_no_reference(
        tmp_path, monkeypatch):
    calls = _count_runs(monkeypatch)
    out = str(tmp_path / "gate")
    configs = ["--configs", "LG-energy,GG-energy"]
    verdict = qg.main(ITERS + configs + ["--out", out], **SMALL)
    assert len(calls) == 6
    ref_runs = [c for c in calls if c["var_precision"] == "highest"]
    assert [c.get("seed", 0) for c in ref_runs] == [0, 1, 0, 1]
    assert all(c["solve_precision"] == "highest" and c["gram_kres"] is False
               and c["training_switches"] == ("highest", False, False)
               for c in ref_runs)
    with open(out + ".json") as f:
        rec = json.load(f)
    assert rec == json.loads(json.dumps(verdict))
    assert set(rec) == {"date", "candidate", "reference", "iterations",
                        "tolerances", "backend", "pass", "rows"}
    assert rec["backend"] == "cpu" and rec["iterations"] == 20
    assert rec["reference"] == {"var_precision": "highest",
                                "solve_precision": "highest"}
    assert [r["config"] for r in rec["rows"]] == ["LG-energy natgrad",
                                                  "GG-energy ADAM-ONLY"]
    for r in rec["rows"]:
        assert ROW_FIELDS <= set(r)
        assert r["finite"] and all(
            r[k] > 0 for k in ("steps_per_s_ref", "steps_per_s_ref_seed1",
                               "steps_per_s_cand"))
        assert r["ok"] == qg.judge(
            {"elbo_per_point": r["elbo_ref"], "test_nll": r["nll_ref"],
             "finite": True},
            {"elbo_per_point": r["elbo_ref_seed1"],
             "test_nll": r["nll_ref"] + r["seed_band_nll"], "finite": True},
            {"elbo_per_point": r["elbo_cand"], "test_nll": r["nll_cand"],
             "finite": True}, 1e-3, 5e-3)["ok"]
    assert rec["pass"] is all(r["ok"] for r in rec["rows"])
    with open(out + ".md") as f:
        md = f.read()
    assert md.startswith("# Quality gate — " + ("PASS" if rec["pass"]
                                                 else "FAIL"))
    assert REF_COLUMNS in md and "backend=cpu" in md
    assert md.count("\n| ") == 3   # the header and two rows

    calls.clear()
    out2 = str(tmp_path / "gate_reused")
    again = qg.main(ITERS + configs + ["--reuse_ref", out + ".json",
                                       "--out", out2], **SMALL)
    assert len(calls) == 2
    assert all(c["var_precision"] == "default" for c in calls)
    assert again["candidate"]["reused_ref"] is True
    for r, r2 in zip(rec["rows"], again["rows"], strict=True):
        assert (r2["elbo_ref"], r2["elbo_ref_seed1"], r2["nll_ref"]) == (
            r["elbo_ref"], r["elbo_ref_seed1"], r["nll_ref"])
        # the candidate is the same seed and setting again: the same run
        assert (r2["elbo_cand"], r2["nll_cand"]) == (r["elbo_cand"],
                                                     r["nll_cand"])
        assert r2["steps_per_s_ref"] is None
    with open(out2 + ".md") as f:
        assert "reused, reused" in f.read()


@pytest.mark.parametrize("flags,match", [
    (["--iterations", "30"], "iterations"),
    (["--minibatch", "256"], "minibatch"),
    (["--reference", "production"], "all-highest"),
])
def test_reuse_ref_refuses_another_protocol(tmp_path, flags, match):
    prev = {"candidate": {"minibatch": 512}, "iterations": 20,
            "reference": {"var_precision": "highest"}, "rows": []}
    path = tmp_path / "prev.json"
    path.write_text(json.dumps(prev))
    args = qg.parse_args(ITERS + flags + ["--reuse_ref", str(path)])
    with pytest.raises(ValueError, match=match):
        qg.reused_references(str(path), args)


class TaggedGraph:
    """``utils.graphs.Graph`` on the CPU, tagged with the gram switches in
    force at its capture, which a CUDA graph bakes in: the first call runs
    for real, each replay runs the call again. ``used`` records the tag
    of every call."""

    used: list = []

    def __init__(self, fn, *, device, generators=()):
        self.fn, self.switches = fn, _switches()
        TaggedGraph.used.append(self.switches)
        self.first = fn()

    def replay(self):
        TaggedGraph.used.append(self.switches)
        return self.fn()


def test_measurement_runs_under_highest_on_no_stale_graph(tmp_path,
                                                          monkeypatch):
    """A candidate with --gram_fwd_precision high: its training runs under
    'high', every measurement under the all-highest switches, the
    switches come back to the caller's, and no measurement replays an
    evaluation graph captured under other switches, though the cache
    holds one for the same program."""
    monkeypatch.setattr(metrics, "_programs", OrderedDict())
    monkeypatch.setattr(metrics, "_replays", lambda device, mesh: True)
    monkeypatch.setattr(graphs, "Graph", TaggedGraph)
    TaggedGraph.used = []
    earlier = ("high", True, True)   # the caller's; monkeypatch restores
    for name, value in zip(("GRAM_FWD_PRECISION", "GRAM_BWD_RELAX",
                            "GRAM_KUF_RESIDUAL"), earlier):
        monkeypatch.setattr(kernels, name, value)
    calls = _count_runs(monkeypatch)
    seen = []
    elbo, evaluate = qg.elbo, qg.evaluate

    def elbo_spy(params, config, *a, **kw):
        seen.append(("elbo", _switches(), config.var_precision,
                     config.solve_precision))
        return elbo(params, config, *a, **kw)

    def evaluate_spy(params, config, *a, **kw):
        seen.append(("evaluate", _switches(), config.var_precision,
                     config.solve_precision))
        return evaluate(params, config, *a, **kw)

    monkeypatch.setattr(qg, "elbo", elbo_spy)
    monkeypatch.setattr(qg, "evaluate", evaluate_spy)
    label = "GG-energy ADAM-ONLY"
    prev = {"candidate": {"minibatch": 512}, "iterations": 20,
            "reference": {"var_precision": "highest"},
            "rows": [{"config": label, "elbo_ref": -1.0,
                      "elbo_ref_seed1": -1.001, "nll_ref": 0.5,
                      "seed_band_nll": 0.01, "finite": True}]}
    ref = tmp_path / "ref.json"
    ref.write_text(json.dumps(prev))
    argv = ITERS + ["--configs", "GG-energy", "--reuse_ref", str(ref)]
    qg.main(argv + ["--out", str(tmp_path / "a")], **SMALL)
    assert _switches() == earlier
    # the graphs of the cached programs, retagged as captured by an
    # earlier caller under other switches
    stale = ("highest", True, True)
    programs = metrics.eval_programs()
    assert programs
    for program in programs:
        for graph in program.graphs.graphs():
            graph.switches = stale
    TaggedGraph.used, seen[:] = [], []
    qg.main(argv + ["--gram_fwd_precision", "high", "--out",
                    str(tmp_path / "b")], **SMALL)
    assert _switches() == earlier
    assert [c["training_switches"] for c in calls] == [
        ("highest", False, "auto"), ("high", False, "auto")]
    assert len(seen) == 9 and all(
        s[1:] == (qg.HIGHEST_SWITCHES, "highest", "highest") for s in seen)
    assert TaggedGraph.used and set(TaggedGraph.used) == {
        qg.HIGHEST_SWITCHES}


def _reference_flag_defaults(flags) -> dict:
    """{flag: default} of the reference's ``add_argument`` calls, read
    from its source."""
    with open(os.path.join(BENCH, "quality_gate.py")) as f:
        tree = ast.parse(f.read())
    found = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", None) == "add_argument"
                and node.args and isinstance(node.args[0], ast.Constant)
                and node.args[0].value in flags):
            found[node.args[0].value] = next(
                ast.literal_eval(kw.value) for kw in node.keywords
                if kw.arg == "default")
    return found


def test_mesh_flags_follow_the_reference():
    ref = _reference_flag_defaults({"--mesh", "--mesh_config"})
    a = qg.parse_args([])
    assert (a.mesh, a.mesh_config) == (ref["--mesh"], ref["--mesh_config"])
    assert ref == {"--mesh": None, "--mesh_config": "LG-energy natgrad"}
    # --quick first (reference l.327-330), then the mesh takes the run
    a = qg.parse_args(["--mesh", "2x5", "--quick", "--minibatch", "64"])
    assert (a.iterations, a.rel_tol, a.nll_tol) == (500, 0.2, 0.5)
    assert qg.mesh_plan(a) == (2, 5, qg.GATE_CONFIGS[0])
    assert qg.mesh_plan(qg.parse_args(
        ["--mesh", "1X20", "--mesh_config", "LGG-kin8nm natgrad"])) == (
        1, 20, qg.GATE_CONFIGS[2])


@pytest.mark.parametrize("flags,match", [
    (["--mesh", "2x5", "--mesh_config", "LG-energy"], "is none of"),
    (["--mesh", "2x3"], "k=3 does not divide the 5 samples"),
    (["--mesh", "1x2", "--mesh_config", "GG-energy ADAM-ONLY"],
     "k=2 does not divide the 1 samples"),
    (["--mesh", "2x5", "--reuse_ref", "prev.json"], "--reuse_ref"),
    (["--mesh", "two"], "want DPxK"),
    (["--mesh", "0x5"], ">= 1"),
])
def test_mesh_gate_refuses(flags, match):
    """Refused by main before any run trains or any rank starts."""
    with pytest.raises(ValueError, match=match):
        qg.main(flags + ["--device", "cpu"],
                num_inducing="a run would fail on this")


@pytest.mark.parametrize("label", ["LGG-kin8nm natgrad",
                                   "GG-energy ADAM-ONLY"])
def test_full_batch_candidate_trains_as_the_highest_side(label):
    """At minibatch >= N, ``full_batch_precision="auto"`` escalates the
    candidate to the all-highest classes: its run equals the reference
    side's bit for bit (the reference's B=8192 rows read dELBO 0.00e+00),
    where with the escalation off it does not."""
    gc = next(g for g in qg.GATE_CONFIGS if g[0] == label)
    kw = dict(iterations=10, device="cpu", num_inducing=16, max_n=100,
              minibatch=512)
    ref = qg.run_setting(*gc, var_precision="highest",
                         solve_precision="highest", gram_kres=False, **kw)
    cand = dict(var_precision="default", solve_precision="high",
                solve_bwd="auto", gram_kres="auto", **kw)
    got = qg.run_setting(*gc, **cand)
    off = qg.run_setting(*gc, full_batch="off", **cand)
    for key in ("elbo_per_point", "test_nll", "test_rmse"):
        assert got[key] == ref[key], key
    assert off["elbo_per_point"] != ref["elbo_per_point"]


def test_mesh_gate_on_two_cpu_ranks(tmp_path):
    """``--mesh 2x1 --quick`` on the CPU: two gloo ranks spawned through
    ``parallel.launch.spawn_ranks``; the record has the reference's
    fields (plus the port's steps/s and ranks) and columns, a finite
    mesh ELBO, and both ranks' trained parameters bitwise equal."""
    out = str(tmp_path / "gate")
    verdict = qg.main(["--mesh", "2x1", "--quick", "--device", "cpu",
                       "--out", out], num_inducing=16, max_n=300)
    with open(os.path.join(BENCH, MESH_RECORD)) as f:
        ref = json.load(f)
    with open(out + "_mesh.json") as f:
        rec = json.load(f)
    assert rec == json.loads(json.dumps(verdict))
    assert set(rec) == set(ref)
    row, ref_row = rec["rows"][0], ref["rows"][0]
    assert set(row) == set(ref_row) | MESH_ROW_EXTRA
    assert (rec["mesh"], rec["config"], rec["iterations"],
            rec["backend"]) == ({"dp": 2, "k": 1}, "LG-energy natgrad", 500,
                                "gloo, cpu")
    assert math.isfinite(row["elbo_mesh"]) and row["finite"]
    assert [r["rank"] for r in row["ranks"]] == [0, 1]
    assert row["ranks"][0]["digest"] == row["ranks"][1]["digest"]
    assert row["replicas_bitwise_equal"] is True
    assert all(r["launches"] == {} for r in row["ranks"])  # plain versions
    assert all(row[k] > 0 for k in ("steps_per_s_single",
                                     "steps_per_s_single_seed1",
                                     "steps_per_s_mesh"))
    v = qg.judge(
        {"elbo_per_point": row["elbo_single"], "test_nll": row["nll_single"],
         "finite": True},
        {"elbo_per_point": row["elbo_single_seed1"],
         "test_nll": row["nll_single"] + row["seed_band_nll"],
         "finite": True},
        {"elbo_per_point": row["elbo_mesh"], "test_nll": row["nll_mesh"],
         "finite": True}, 0.2, 0.5)
    assert rec["pass"] is row["ok"] is v["ok"]
    with open(os.path.join(BENCH, "QUALITY_GATE_mesh.md")) as f:
        ref_md = f.read().splitlines()
    with open(out + "_mesh.md") as f:
        md = f.read().splitlines()
    assert md[0] == "# Sharded-trainer convergence gate — " + (
        "PASS" if rec["pass"] else "FAIL")
    assert "backend=gloo, cpu (2x1 mesh, 2 ranks on the CPU)" in md[2]
    header = next(i for i, ln in enumerate(ref_md) if ln.startswith("|"))
    assert md[header].startswith(ref_md[header])
    assert len(md) == len(ref_md) and md[-1].startswith(
        "| LG-energy natgrad | ")


def test_mesh_gate_fails_on_a_rank_that_raises(tmp_path):
    out = str(tmp_path / "gate")
    with pytest.raises(Exception, match="a fault planted in rank 1"):
        qg.main(["--mesh", "2x1", "--iterations", "2", "--device", "cpu",
                 "--out", out], fail_rank=1, num_inducing=8, max_n=64)
    assert not os.path.exists(out + "_mesh.json")
