"""The port's BASELINE configuration runner and suite renderer
(``experiments/baseline_configs.py``, ``experiments/render_suite.py``)
against the reference's ``benchmarks/run_baseline_configs.py`` and
``benchmarks/render_suite.py``, on the CPU.

The runner's configurations are read from the reference's source with
``ast`` (importing it would import the reference's harness); its table's
columns likewise. The renderer is held byte for byte to the reference's,
loaded from its file, on the same databases: the committed suite grid and
a small one with a hole and real-data rows. Only the closing paragraph,
which names each package's own records, differs.
"""

import ast
import importlib.util
import json
import os
import shutil

import pytest

from dgps_with_iwvi_torch.evaluation import Database
from dgps_with_iwvi_torch.experiments import baseline_configs as bc
from dgps_with_iwvi_torch.experiments import render_suite as rs
from torch_threads import one_thread  # noqa: F401  (autouse)

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks")


def _assigned(tree, name):
    return next(node.value for node in tree.body
                if isinstance(node, ast.Assign)
                and any(getattr(t, "id", None) == name
                        for t in node.targets))


def _reference_runner():
    with open(os.path.join(BENCH, "run_baseline_configs.py")) as f:
        return ast.parse(f.read())


def test_configs_and_common_equal_the_reference():
    tree = _reference_runner()
    assert bc.CONFIGS == ast.literal_eval(_assigned(tree, "CONFIGS"))
    common = _assigned(tree, "COMMON").elts
    # "--results_db" and its path, which the port takes from its own flag
    i = next(i for i, e in enumerate(common)
             if getattr(e, "value", None) == "--results_db")
    assert bc.COMMON == [ast.literal_eval(e)
                         for e in common[:i] + common[i + 2:]]


def _reference_columns() -> str:
    return next(n.value for n in ast.walk(_reference_runner())
                if isinstance(n, ast.Constant) and isinstance(n.value, str)
                and n.value.startswith("| config |"))


def test_one_config_writes_the_reference_table(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(bc, "CONFIGS", bc.CONFIGS[:1])
    # argparse keeps the last of a repeated flag: these shrink the run
    monkeypatch.setattr(bc, "COMMON", bc.COMMON + [
        "--iterations", "20", "--steps_per_call", "10", "--max_n", "300",
        "--M", "16"])
    rows = bc.main(["--device", "cpu"])
    assert [r["label"] for r in rows] == ["1: SVGP G, energy"]
    r = rows[0]
    assert (r["dataset"], r["configuration"], r["mode"], r["M"],
            r["minibatch_size"], r["iterations"]) == ("energy", "G", "VI", 16,
                                                      256, 20)
    assert len(Database("results.db").read()) == 1
    with open("RESULTS.md") as f:
        md = f.read()
    assert md.startswith("# BASELINE parity configs — results\n\n"
                         "Backend: cpu; data: ")
    assert _reference_columns() in md
    assert md.endswith(f"| 1: SVGP G, energy | {r['test_loglik']:.4f} | "
                       f"{r['test_rmse']:.4f} | {r['steps_per_sec']:.0f} | "
                       f"{r['train_time_s']:.0f} |\n")
    with open("RESULTS.json") as f:
        saved = json.load(f)
    assert saved["backend"] == "cpu"
    assert saved["rows"] == json.loads(json.dumps(rows))


def _reference_renderer():
    spec = importlib.util.spec_from_file_location(
        "reference_render_suite", os.path.join(BENCH, "render_suite.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _small_db(path):
    db = Database(path)
    for ds, conf, mode, ll in (("energy", "G", "VI", -0.25),
                               ("energy", "LGG", "IW", 0.125),
                               ("kin8nm", "GG", "VI", 1.0625)):
        db.write_result({"dataset": ds, "split": 0, "configuration": conf,
                         "mode": mode, "test_loglik": ll,
                         "steps_per_sec": 1234.5, "synthetic_data": False})
    return path


@pytest.mark.parametrize("which", ["suite.db", "small"])
def test_render_suite_tables_equal_the_reference(tmp_path, which):
    if which == "small":
        db = _small_db(str(tmp_path / "small.db"))
    else:
        db = str(tmp_path / "suite.db")
        shutil.copy(os.path.join(BENCH, "suite.db"), db)
    ref = _reference_renderer()
    ref.main(db, str(tmp_path / "ref.md"))
    rs.main(db, str(tmp_path / "port.md"))
    texts = []
    for name, analysis in (("ref.md", ref.ANALYSIS), ("port.md",
                                                      rs.ANALYSIS)):
        with open(tmp_path / name, encoding="utf-8") as f:
            text = f.read()
        assert text.endswith(analysis)
        texts.append(text[:-len(analysis)])
    assert texts[0] == texts[1]
    assert texts[1].count("\n| dataset |") == 2
    assert which == "suite.db" or "—" in texts[1]   # the small grid's hole
    assert "IW_VS_VI_H100.md" in rs.ANALYSIS
    assert "benchmarks/" not in rs.ANALYSIS


def test_render_suite_empty_db_writes_nothing(tmp_path):
    out = tmp_path / "SUITE.md"
    rs.main(str(tmp_path / "empty.db"), str(out))
    assert not out.exists()
