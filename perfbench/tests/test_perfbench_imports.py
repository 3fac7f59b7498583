"""What a run loads: nothing of JAX or the JAX package, in the process
that runs a cell, and nothing of the program in the reference. Each is
checked in a fresh interpreter, after the code has run, so that a lazy
import inside the port shows too."""

import json
import subprocess
import sys

import pytest

from pb_tiny import ROOT, tiny  # noqa: F401

FORBIDDEN = {"jax", "jaxlib", "flax", "dgps_with_iwvi_tpu"}


def _modules(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax(tiny):
    files, _, _ = tiny("train.lgg-kin8nm.b512")
    sfiles, _, _ = tiny("score.lgg-kin8nm.s100")
    code = f"""
import runpy, time
from pathlib import Path
runpy.run_path("perfbench/run.py", run_name="perfbench_run")
from perfbench import harness
root = Path({str(ROOT)!r})
for cell, f in (("train.lgg-kin8nm.b512", {json.dumps({k: str(v) for k, v in files.items() if k != 'metrics'})}),
                ("score.lgg-kin8nm.s100", {json.dumps({k: str(v) for k, v in sfiles.items() if k != 'metrics'})})):
    f = {{k: Path(v) for k, v in f.items()}}
    f["metrics"] = {{}}
    out = harness.run(root, cell, 5, 0.1, False, time.perf_counter(),
                      device="cpu", files=f)
    assert out["correct"], out
"""
    mods = _modules(code)
    assert "dgps_with_iwvi_torch" in mods
    assert not mods & FORBIDDEN, mods & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    code = """
import torch
from perfbench.reference import dgp_ref
model = {"configuration": "LGGG", "d_w": 1, "inner_dim_cap": 3}
specs = dgp_ref.layer_specs(model, 4, 1)
g = torch.Generator().manual_seed(0)
w = {"layers": [], "likelihood": {"raw_noise_variance": torch.tensor(-3.0)}}
for s in specs:
    if s[0] == "L":
        w["layers"].append({k: 0.1 * torch.randn(shape, generator=g)
                            for k, shape in (("W1", (5, 6)), ("b1", (6,)),
                            ("W2", (6, 6)), ("b2", (6,)), ("Wmu", (6, 1)),
                            ("bmu", (1,)), ("Wlv", (6, 1)), ("blv", (1,)))})
    else:
        w["layers"].append({"raw_variance": torch.tensor(0.5),
                            "raw_lengthscales": torch.ones(s[1]),
                            "Z": torch.randn(8, s[1], generator=g),
                            "q_mu": torch.randn(8, s[2], generator=g),
                            "q_sqrt": torch.eye(8).expand(s[2], 8, 8) * 0.3})
X, Y = torch.randn(20, 4, generator=g), torch.randn(20, 1, generator=g)
draws = [dgp_ref.draw_train(g, 20, 6, 3, specs) for _ in range(2)]
dgp_ref.train(w, specs, X, Y, draws, 20, 5e-3, 1e-2, dgp_ref.Arith("f64"))
dgp_ref.score(w, specs, X, Y, dgp_ref.draw_score(g, 4, 20, specs),
              dgp_ref.Arith("bf16"))
"""
    mods = _modules(code)
    assert "torch" in mods
    assert not mods & (FORBIDDEN | {"dgps_with_iwvi_torch"})


def test_without_a_card_the_run_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "train.lgg-kin8nm.b512", "--seed", "3", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_cell_on_the_card_is_correct():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "score.lgg-kin8nm.s100", "--seed", str(2 ** 33 + 1), "--seconds",
         "2", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
