#!/usr/bin/env python
"""The convergence quality gate (port of benchmarks/quality_gate.py).

Float64 tests on the CPU cannot catch a regression in matmul precision;
only a trained A/B against a known-good setting can (reference l.4-9).
Each of ``GATE_CONFIGS`` trains ``--iterations`` steps (15,000) at
minibatch 512 under the reference setting (every class ``highest``, at
two seeds: their distance is the seed band) and under the candidate (by
default the port's shipped precision defaults), from the same seed and
data. PASS iff on every configuration all losses are finite and the
candidate's converged ELBO per point and test NLL lie within
max(floor, 1.5 x the reference's seed band) of the reference's
(``judge``; floors 1e-3 relative and 0.005 nats).

    python -m dgps_with_iwvi_torch.experiments.quality_gate
    python -m dgps_with_iwvi_torch.experiments.quality_gate \\
        --var_precision high                   # gate a change
    python -m dgps_with_iwvi_torch.experiments.quality_gate --quick \\
        --device cpu --configs "GG-energy"      # a smoke run on the CPU

Training goes through ``training.fit``, so on the card every step
replays one CUDA graph, as users train. Both sides are measured at
``highest`` (reference l.115-134): the bound averaged over 8 noise seeds
on the first min(2048, N) training rows, and ``evaluate``'s test NLL and
RMSE at S=100. ``fit`` reports one mean loss per chunk, so "finite" reads
the chunk means: a step's NaN or inf shows in its chunk's mean.

The module switches of ``ops.kernels`` (the gram's precision classes and
its residual) are set for each run and restored after it, and every
measurement runs with them at their all-``highest`` values on an empty
evaluation cache (``evaluation.metrics``): a CUDA graph bakes the
switches in force at its capture, so no measurement replays a graph
captured under other switches.

Writes ``<out>.json`` and ``<out>.md`` (``--out``, default
``QUALITY_GATE`` in the working directory) with the reference's fields
and columns, plus seconds and steps/s per run; the ``backend`` field
holds the card's name and power limit. The exit code is 0 only on a PASS.

Not ported, by design: the TPU switches ``--qvar_bf16_residual``,
``--qvar_pallas_train``, ``--epi_pallas``, ``--epi_train`` and
``--kuf_bf16`` (the port has no such knobs: K2/K3 take every whitened
step at the ``default`` class and the Kuf residual stays float32), and
``--mesh``, the sharded trainer's gate (two ranks on one card
time-slice it). The reference's all-``highest`` side sets its
``GRAM_KUF_RESIDUAL`` to the string "off", which its switch reads by its
truth as on; this side sets False, the plain autograd path that the
reference's ``--gram_kres`` help names.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import subprocess
import sys
import time

import numpy as np
import torch

from dgps_with_iwvi_torch.data import get_regression_data
from dgps_with_iwvi_torch.device import resolve_device
from dgps_with_iwvi_torch.evaluation import evaluate, metrics
from dgps_with_iwvi_torch.experiments.main import gram_switches
from dgps_with_iwvi_torch.models import BuildArgs, build_model, elbo
from dgps_with_iwvi_torch.training import TrainConfig, fit

# (label, dataset, configuration, mode, K, natgrad): reference l.69-82
GATE_CONFIGS = [
    ("LG-energy natgrad", "energy", "LG", "IW", 5, "final"),
    ("LG-kin8nm natgrad", "kin8nm", "LG", "IW", 5, "final"),
    ("LGG-kin8nm natgrad", "kin8nm", "LGG", "IW", 20, "final"),
    ("GG-energy ADAM-ONLY", "energy", "GG", "VI", 1, "none"),
    ("LGGG-year natgrad", "year", "LGGG", "IW", 50, "final"),
]

# (GRAM_FWD_PRECISION, GRAM_BWD_RELAX, GRAM_KUF_RESIDUAL) of the
# all-highest setting: every measurement runs under them
HIGHEST_SWITCHES = ("highest", False, False)
KRES = {"auto": "auto", "on": True, "off": False}


def measure(params, config, data, X, Y, device) -> dict:
    """ELBO per point and test metrics of trained `params`, at ``highest``
    on both sides (reference l.115-134): the mean of 8 bounds on the
    first min(2048, N) rows, noise seeds 100..107, over num_data; the
    test NLL and RMSE of ``evaluate`` at S=100, seed 100."""
    cfg_eval = dataclasses.replace(config, var_precision="highest",
                                   solve_precision="highest")
    nb = min(2048, X.shape[0])
    with gram_switches(*HIGHEST_SWITCHES):
        metrics.drop_programs()  # no graph captured under other switches
        with torch.no_grad():
            bounds = [float(elbo(params, cfg_eval, X[:nb], Y[:nb],
                                 torch.Generator(device=device)
                                 .manual_seed(100 + i)))
                      for i in range(8)]
        m = evaluate(params, cfg_eval, data.X_test, data.Y_test, 100,
                     y_std=data.Y_std, num_samples=100, device=device)
    return {"elbo_per_point": float(np.mean(bounds)) / config.num_data,
            "test_nll": -m["test_loglik"], "test_rmse": m["test_rmse"]}


def run_setting(label, dataset, conf, mode, K, natgrad, *, var_precision,
                solve_precision, iterations, seed=0, solve_bwd="same",
                gram_fwd="highest", minibatch=512, full_batch="auto",
                gram_kres="auto", device="cuda", num_inducing=128,
                max_n=None) -> dict:
    """Train one gate configuration from `seed` under one setting and
    measure it (reference l.84-134). The gram switches hold `gram_fwd`
    and `gram_kres` (True, False or "auto") for the build and the
    training only. `num_inducing` and `max_n` shrink the run (tests)."""
    device = resolve_device(device)
    data = get_regression_data(dataset, 0, max_n=max_n)
    X = torch.as_tensor(data.X_train, device=device)
    Y = torch.as_tensor(data.Y_train, device=device)
    build = BuildArgs(configuration=conf, mode=mode,
                      num_inducing=num_inducing, num_iw_samples=K,
                      var_precision=var_precision,
                      solve_precision=solve_precision)
    losses = []
    with gram_switches(gram_fwd, False, gram_kres):
        config, params = build_model(seed, build, X, Y, device=device)
        tc = TrainConfig(lr=5e-3, gamma=1e-2, natgrad=natgrad,
                         minibatch_size=minibatch, iterations=iterations,
                         steps_per_call=min(500, iterations),
                         solve_bwd_precision=solve_bwd,
                         full_batch_precision=full_batch)
        t0 = time.perf_counter()
        trained, _ = fit(torch.Generator(device=device).manual_seed(seed),
                         config, params, X, Y, tc,
                         callback=lambda s, loss, _st: losses.append(loss))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        train_s = time.perf_counter() - t0
    return {**measure(trained, config, data, X, Y, device),
            "finite": bool(np.all(np.isfinite(losses))),
            "train_s": train_s, "steps_per_s": iterations / train_s}


def judge(ref: dict, ref2: dict, cand: dict, rel_tol: float,
          nll_tol: float) -> dict:
    """The verdict of one configuration (reference l.396-404): the
    candidate's gaps to the reference against max(floor, 1.5 x the
    band between the reference's two seeds); ELBO gaps relative to the
    reference's |ELBO per point|."""
    scale = max(abs(ref["elbo_per_point"]), 1e-9)
    band = abs(ref2["elbo_per_point"] - ref["elbo_per_point"]) / scale
    band_nll = abs(ref2["test_nll"] - ref["test_nll"])
    tol_elbo = max(rel_tol, 1.5 * band)
    tol_nll = max(nll_tol, 1.5 * band_nll)
    d_elbo = abs(cand["elbo_per_point"] - ref["elbo_per_point"]) / scale
    d_nll = abs(cand["test_nll"] - ref["test_nll"])
    finite = ref["finite"] and ref2["finite"] and cand["finite"]
    return {"ok": bool(finite and d_elbo <= tol_elbo and d_nll <= tol_nll),
            "d_elbo_rel": d_elbo, "seed_band_rel": band,
            "tol_elbo_rel": tol_elbo, "d_nll": d_nll,
            "seed_band_nll": band_nll, "tol_nll": tol_nll,
            "finite": finite}


def backend(device: torch.device) -> str:
    """'cpu', or the card's name and power limit (as nvidia-smi gives it;
    the name alone where nvidia-smi does not answer)."""
    if device.type != "cuda":
        return "cpu"
    name = torch.cuda.get_device_name(device)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return name
    limit = out.stdout.strip()
    return f"{name}, {limit}" if out.returncode == 0 and limit else name


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--var_precision", default="default",
                   choices=["highest", "high", "default"],
                   help="candidate q-variance matmul class")
    p.add_argument("--solve_precision", default="high",
                   choices=["highest", "high", "default"],
                   help="candidate solve-path class")
    p.add_argument("--solve_bwd_precision", default="auto",
                   choices=["auto", "same", "high", "default"],
                   help="candidate class of the solve path's transposed "
                        "dots (TrainConfig.solve_bwd_precision); the "
                        "all-highest reference runs 'same'")
    p.add_argument("--gram_fwd_precision", default="highest",
                   choices=["highest", "high"],
                   help="candidate kernels.GRAM_FWD_PRECISION ('high': "
                        "the bf16x3 split); the reference runs 'highest'")
    p.add_argument("--gram_kres", default="auto",
                   choices=["auto", "on", "off"],
                   help="candidate kernels.GRAM_KUF_RESIDUAL: whether the "
                        "RBF gram keeps its output as its backward "
                        "residual ('auto': by size); the all-highest "
                        "reference runs the plain autograd path")
    p.add_argument("--full_batch_precision", default="auto",
                   choices=["auto", "off"],
                   help="candidate TrainConfig.full_batch_precision")
    p.add_argument("--minibatch", type=int, default=512,
                   help="training minibatch of every gate run")
    p.add_argument("--iterations", type=int, default=15000)
    p.add_argument("--rel_tol", type=float, default=1e-3,
                   help="floor of |ELBO_cand - ELBO_ref| / |ELBO_ref|")
    p.add_argument("--nll_tol", type=float, default=0.005,
                   help="floor of |NLL_cand - NLL_ref| (nats)")
    p.add_argument("--configs", default=None,
                   help="comma-separated substrings selecting a subset of "
                        "GATE_CONFIGS (e.g. 'LGG-kin8nm'): a diagnostic, "
                        "not a verdict on the whole stack")
    p.add_argument("--quick", action="store_true",
                   help="smoke mode: 500 iterations, tolerances 0.2 and 0.5")
    p.add_argument("--reuse_ref", default=None, metavar="VERDICT_JSON",
                   help="take the all-highest reference rows (both seeds) "
                        "from an earlier verdict instead of training them; "
                        "its minibatch and iterations must match")
    p.add_argument("--reference", default="highest",
                   choices=["highest", "production"],
                   help="'highest': the all-highest run (gates the whole "
                        "candidate stack); 'production': the shipped "
                        "defaults (isolates one knob)")
    p.add_argument("--out", default="QUALITY_GATE",
                   help="output path without suffix: <out>.json, <out>.md")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch "
                        "versions of the kernels")
    args = p.parse_args(argv)
    if args.quick:
        args.iterations, args.rel_tol, args.nll_tol = 500, 0.2, 0.5
    return args


def reused_references(path: str, args) -> dict:
    """{label: row} of an earlier verdict, checked as the reference
    checks it (l.332-342)."""
    with open(path) as f:
        prev = json.load(f)
    if prev["candidate"]["minibatch"] != args.minibatch:
        raise ValueError(f"--reuse_ref: minibatch "
                         f"{prev['candidate']['minibatch']} in {path}, "
                         f"{args.minibatch} here")
    if prev["iterations"] != args.iterations:
        raise ValueError(f"--reuse_ref: {prev['iterations']} iterations in "
                         f"{path}, {args.iterations} here")
    if (prev["reference"].get("var_precision") != "highest"
            or args.reference != "highest"):
        raise ValueError("--reuse_ref requires all-highest references on "
                         "both sides")
    return {r["config"]: r for r in prev["rows"]}


def selected_configs(configs: str | None) -> list:
    if not configs:
        return GATE_CONFIGS
    sel = [s.strip() for s in configs.split(",")]
    chosen = [g for g in GATE_CONFIGS if any(s in g[0] for s in sel)]
    if not chosen:
        raise ValueError(f"--configs {configs!r} selects none of "
                         f"{[g[0] for g in GATE_CONFIGS]}")
    return chosen


def write_outputs(out: str, verdict: dict, args) -> None:
    """<out>.json, and <out>.md in the reference's form with seconds and
    steps/s per run after its columns."""
    with open(out + ".json", "w") as f:
        json.dump(verdict, f, indent=1)
    ok_all = verdict["pass"]
    versus = ("all-HIGHEST" if args.reference == "highest"
              else "production defaults")
    with open(out + ".md", "w") as f:
        f.write(f"# Quality gate — {'PASS' if ok_all else 'FAIL'}\n\n"
                f"{verdict['date']}, backend={verdict['backend']}, "
                f"candidate var={args.var_precision} "
                f"solve={args.solve_precision} "
                f"solve_bwd={args.solve_bwd_precision} "
                f"gram_fwd={args.gram_fwd_precision} "
                f"gram_kres={args.gram_kres} "
                f"full_batch={args.full_batch_precision} vs {versus} "
                f"(minibatch {args.minibatch}), {args.iterations} steps. "
                "Tolerance per config = max(floor, 1.5x the reference's "
                f"own seed-to-seed band); floors: ELBO rel {args.rel_tol}, "
                f"NLL {args.nll_tol} nats. Bound values are 8-key MC "
                "averages. Steps/s: ref, ref seed 1, cand (training only, "
                "capture included).\n\n"
                "| config | verdict | ELBO/n ref | ELBO/n cand | dELBO rel "
                "| seed band | NLL ref | NLL cand | dNLL | s | steps/s |\n"
                "|---|---|---|---|---|---|---|---|---|---|---|\n")
        for r in verdict["rows"]:
            rates = ", ".join("reused" if v is None else f"{v:.1f}"
                              for v in (r["steps_per_s_ref"],
                                        r["steps_per_s_ref_seed1"],
                                        r["steps_per_s_cand"]))
            f.write(f"| {r['config']} | {'PASS' if r['ok'] else 'FAIL'} | "
                    f"{r['elbo_ref']:+.4f} | {r['elbo_cand']:+.4f} | "
                    f"{r['d_elbo_rel']:.2e} | {r['seed_band_rel']:.2e} | "
                    f"{r['nll_ref']:+.4f} | {r['nll_cand']:+.4f} | "
                    f"{r['d_nll']:.4f} | {r['seconds']:.0f} | {rates} |\n")


def main(argv=None, **setting) -> dict:
    """Run the gate of `argv` (the CLI's flags) and write its record;
    returns the verdict. `setting`: keywords for every ``run_setting``
    (tests shrink the runs with ``num_inducing=`` and ``max_n=``)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    reuse = (reused_references(args.reuse_ref, args) if args.reuse_ref
             else None)
    gate_configs = selected_configs(args.configs)
    run_kw = dict(minibatch=args.minibatch, iterations=args.iterations,
                  device=device, **setting)
    if args.reference == "production":
        ref_kw = dict(var_precision="default", solve_precision="high")
    else:
        ref_kw = dict(var_precision="highest", solve_precision="highest",
                      gram_kres=False)
    rows, ok_all = [], True
    for gc in gate_configs:
        label = gc[0]
        t0 = time.time()
        if reuse is not None and label in reuse:
            pr = reuse[label]
            ref = {"elbo_per_point": pr["elbo_ref"],
                   "test_nll": pr["nll_ref"], "finite": pr["finite"],
                   "steps_per_s": None}
            # only seed 1's band is kept: a value at the recorded
            # distance, as the reference rebuilds it (l.366-370)
            ref2 = {"elbo_per_point": pr["elbo_ref_seed1"],
                    "test_nll": pr["nll_ref"] + pr["seed_band_nll"],
                    "finite": pr["finite"], "steps_per_s": None}
        else:
            ref = run_setting(*gc, **ref_kw, **run_kw)
            ref2 = run_setting(*gc, seed=1, **ref_kw, **run_kw)
        cand = run_setting(*gc, var_precision=args.var_precision,
                           solve_precision=args.solve_precision,
                           solve_bwd=args.solve_bwd_precision,
                           gram_fwd=args.gram_fwd_precision,
                           full_batch=args.full_batch_precision,
                           gram_kres=KRES[args.gram_kres], **run_kw)
        v = judge(ref, ref2, cand, args.rel_tol, args.nll_tol)
        ok_all = ok_all and v["ok"]
        rows.append({
            "config": label, "ok": v["ok"],
            "elbo_ref": ref["elbo_per_point"],
            "elbo_ref_seed1": ref2["elbo_per_point"],
            "elbo_cand": cand["elbo_per_point"],
            "d_elbo_rel": v["d_elbo_rel"],
            "seed_band_rel": v["seed_band_rel"],
            "tol_elbo_rel": v["tol_elbo_rel"],
            "nll_ref": ref["test_nll"], "nll_cand": cand["test_nll"],
            "d_nll": v["d_nll"], "seed_band_nll": v["seed_band_nll"],
            "tol_nll": v["tol_nll"], "finite": v["finite"],
            "seconds": time.time() - t0,
            "steps_per_s_ref": ref["steps_per_s"],
            "steps_per_s_ref_seed1": ref2["steps_per_s"],
            "steps_per_s_cand": cand["steps_per_s"],
        })
        print(f"  {label:24s} {'PASS' if v['ok'] else 'FAIL'} "
              f"dELBO={v['d_elbo_rel']:.2e} (band {v['seed_band_rel']:.2e}) "
              f"dNLL={v['d_nll']:.4f} (band {v['seed_band_nll']:.4f}) "
              f"({rows[-1]['seconds']:.0f}s, candidate "
              f"{cand['steps_per_s']:.1f} steps/s)", flush=True)

    verdict = {
        "date": datetime.datetime.now().isoformat(timespec="seconds"),
        "candidate": {"var_precision": args.var_precision,
                      "solve_precision": args.solve_precision,
                      "minibatch": args.minibatch,
                      "solve_bwd_precision": args.solve_bwd_precision,
                      "gram_fwd_precision": args.gram_fwd_precision,
                      "full_batch_precision": args.full_batch_precision,
                      "gram_kres": args.gram_kres,
                      "reused_ref": bool(args.reuse_ref)},
        "reference": ({"var_precision": "highest",
                       "solve_precision": "highest"}
                      if args.reference == "highest" else
                      {"var_precision": "default", "solve_precision": "high",
                       "note": "production defaults — single-knob gate"}),
        "iterations": args.iterations,
        "tolerances": {"elbo_rel": args.rel_tol, "nll_nats": args.nll_tol},
        "backend": backend(device),
        "pass": ok_all,
        "rows": rows,
    }
    write_outputs(args.out, verdict, args)
    print(f"gate: {'PASS' if ok_all else 'FAIL'} -> {args.out}.md")
    return verdict


if __name__ == "__main__":
    sys.exit(0 if main()["pass"] else 1)
