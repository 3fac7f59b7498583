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

``--mesh DPxK`` gates the sharded trainer instead (reference
l.138-209, ``run_mesh_gate``): ``--mesh_config`` (default LG-energy
natgrad) trains at seeds 0 and 1 in this process and through
``fit(mesh=)`` on dp x k spawned ranks, all at the production defaults
and minibatch 512; the mesh run must land within the single-device seed
band. It writes ``<out>_mesh.json`` and ``<out>_mesh.md``.

    python -m dgps_with_iwvi_torch.experiments.quality_gate --mesh 2x5
    python -m dgps_with_iwvi_torch.experiments.quality_gate --mesh 2x1 \
        --quick --device cpu                   # two gloo ranks on the CPU

Not ported, by design: the TPU switches ``--qvar_bf16_residual``,
``--qvar_pallas_train``, ``--epi_pallas``, ``--epi_train`` and
``--kuf_bf16`` (the port has no such knobs: K2/K3 take every whitened
step at the ``default`` class and the Kuf residual stays float32). The
reference's all-``highest`` side sets its ``GRAM_KUF_RESIDUAL`` to the
string "off", which its switch reads by its truth as on; this side sets
False, the plain autograd path that the reference's ``--gram_kres``
help names.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from dgps_with_iwvi_torch.data import get_regression_data
from dgps_with_iwvi_torch.device import backend, resolve_device
from dgps_with_iwvi_torch.evaluation import evaluate, metrics
from dgps_with_iwvi_torch.experiments.main import gram_switches
from dgps_with_iwvi_torch.models import BuildArgs, build_model, elbo
from dgps_with_iwvi_torch.ops.hopper import build as hopper_build
from dgps_with_iwvi_torch.parallel import launch, make_mesh, sharding
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
# both sides of the mesh gate: the production defaults (reference
# l.153-158), with run_setting's other defaults
MESH_SETTING = dict(var_precision="default", solve_precision="high")
# the sharded side fails past this many seconds
MESH_TIMEOUT_S = 4 * 3600


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
                max_n=None, mesh=None) -> dict:
    """Train one gate configuration from `seed` under one setting and
    measure it (reference l.84-134). The gram switches hold `gram_fwd`
    and `gram_kres` (True, False or "auto") for the build and the
    training only. `num_inducing` and `max_n` shrink the run (tests).

    With `mesh` (``parallel.make_mesh``, called on every rank) the run
    trains through ``fit(mesh=)`` from a CPU generator seeded alike on
    every rank; rank 0 alone measures, while the others wait at a
    barrier, and every rank's row holds the ``digest`` of its trained
    parameters."""
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
        generator = torch.Generator(device=device if mesh is None
                                    else "cpu").manual_seed(seed)
        t0 = time.perf_counter()
        trained, _ = fit(generator, config, params, X, Y, tc,
                         callback=lambda s, loss, _st: losses.append(loss),
                         mesh=mesh)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        train_s = time.perf_counter() - t0
    row = {"finite": bool(np.all(np.isfinite(losses))),
           "train_s": train_s, "steps_per_s": iterations / train_s}
    if mesh is None:
        return {**measure(trained, config, data, X, Y, device), **row}
    row["digest"] = sharding.state_digest(trained)
    if dist.get_rank() == 0:
        row.update(measure(trained, config, data, X, Y, device))
    dist.barrier()
    return row


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
    p.add_argument("--mesh", default=None, metavar="DPxK",
                   help="gate the sharded trainer instead: train one gate "
                        "configuration through fit(mesh=) on DP x K "
                        "spawned ranks and judge it against the "
                        "single-device runs' seed band, both sides at the "
                        "production defaults (the candidate flags are "
                        "ignored); writes <out>_mesh.json/.md")
    p.add_argument("--mesh_config", default="LG-energy natgrad",
                   help="--mesh: the GATE_CONFIGS label to run (its K "
                        "must divide over the mesh's k axis)")
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


def mesh_plan(args) -> tuple:
    """(dp, k, gate configuration) of ``--mesh``/``--mesh_config``;
    raises ValueError for a malformed mesh, an unknown label, a k that
    does not divide the configuration's samples per row (K for IW, S=1
    for VI), or ``--reuse_ref`` (the mesh gate trains its own
    references)."""
    try:
        dp, k = (int(n) for n in args.mesh.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh {args.mesh!r}: want DPxK, e.g. 2x5"
                         ) from None
    if dp < 1 or k < 1:
        raise ValueError(f"--mesh {args.mesh!r}: both sizes must be >= 1")
    gc = next((g for g in GATE_CONFIGS if g[0] == args.mesh_config), None)
    if gc is None:
        raise ValueError(f"--mesh_config {args.mesh_config!r} is none of "
                         f"{[g[0] for g in GATE_CONFIGS]}")
    samples = gc[4] if gc[3] == "IW" else 1
    if samples % k:
        raise ValueError(f"--mesh {args.mesh}: k={k} does not divide the "
                         f"{samples} samples per row of {gc[0]}")
    if args.reuse_ref:
        raise ValueError("--reuse_ref does not apply to --mesh: the mesh "
                         "gate trains its own single-device runs")
    return dp, k, gc


def _launch_counts() -> dict:
    """This process's hand-kernel launches, by kernel and by variant."""
    counts = {**hopper_build.launches(), **hopper_build.variant_launches()}
    return {k: v for k, v in counts.items() if v}


def _mesh_rank(rank: int, world: int, dp: int, k: int, gc, tmp: str,
               device: str, iterations: int, threads: int, setting: dict,
               fail_rank) -> None:
    """One rank of the mesh gate, spawned by ``run_mesh_gate``: joins the
    world through a file store in `tmp`, trains `gc` through
    ``run_setting(mesh=)`` and writes its row, its launches and the
    backend to tmp/rank<r>.json. `fail_rank`: the rank that raises before
    training (a planted fault, for tests)."""
    torch.set_num_threads(threads)
    device = resolve_device(device)   # no card where one was asked: raise
    backend_name = launch.join_group(rank, world, tmp, device)
    try:
        if rank == fail_rank:
            raise RuntimeError(f"a fault planted in rank {rank}")
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        row = run_setting(*gc, **MESH_SETTING, iterations=iterations,
                          device=device, mesh=make_mesh(dp, k, device=device),
                          **setting)
        row.update(rank=rank, backend=backend_name,
                   launches=_launch_counts())
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(row, f)
    finally:
        dist.destroy_process_group()


def run_mesh_gate(args, device: torch.device, setting: dict,
                  fail_rank=None) -> dict:
    """The sharded trainer's convergence gate (reference l.138-209):
    `args.mesh_config` at seeds 0 and 1 in this process, then at seed 0
    on dp x k ranks through ``fit(mesh=)`` (``_mesh_rank``), judged by
    ``judge`` against the single-device seed band; PASS also needs every
    rank's trained parameters bitwise equal. A rank that fails or
    outlasts MESH_TIMEOUT_S raises here. Writes <out>_mesh.json/.md."""
    dp, k, gc = mesh_plan(args)
    world = dp * k
    kw = dict(**MESH_SETTING, iterations=args.iterations, device=device,
              **setting)
    t0 = time.time()
    ref = run_setting(*gc, **kw)
    ref2 = run_setting(*gc, seed=1, **kw)
    with tempfile.TemporaryDirectory(prefix="quality_gate_mesh_") as tmp:
        launch.spawn_ranks(
            _mesh_rank, world, dp, k, gc, tmp, str(device), args.iterations,
            max(1, torch.get_num_threads() // world), setting, fail_rank,
            timeout_s=MESH_TIMEOUT_S)
        ranks = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    cand = ranks[0]
    cand["finite"] = all(r["finite"] for r in ranks)
    v = judge(ref, ref2, cand, args.rel_tol, args.nll_tol)
    agree = len({r["digest"] for r in ranks}) == 1
    ok = v["ok"] and agree
    verdict = {
        "date": datetime.datetime.now().isoformat(timespec="seconds"),
        "mesh": {"dp": dp, "k": k}, "config": gc[0],
        "iterations": args.iterations,
        "backend": f"{cand['backend']}, {backend(device)}",
        "pass": ok,
        "rows": [{"config": gc[0], "ok": ok,
                  "elbo_single": ref["elbo_per_point"],
                  "elbo_single_seed1": ref2["elbo_per_point"],
                  "elbo_mesh": cand["elbo_per_point"],
                  "d_elbo_rel": v["d_elbo_rel"],
                  "seed_band_rel": v["seed_band_rel"],
                  "tol_elbo_rel": v["tol_elbo_rel"],
                  "nll_single": ref["test_nll"],
                  "nll_mesh": cand["test_nll"], "d_nll": v["d_nll"],
                  "seed_band_nll": v["seed_band_nll"],
                  "tol_nll": v["tol_nll"], "seconds": time.time() - t0,
                  "finite": v["finite"], "replicas_bitwise_equal": agree,
                  "steps_per_s_single": ref["steps_per_s"],
                  "steps_per_s_single_seed1": ref2["steps_per_s"],
                  "steps_per_s_mesh": cand["steps_per_s"],
                  "ranks": [{key: r[key] for key in (
                      "rank", "digest", "finite", "train_s", "launches")}
                      for r in ranks]}],
    }
    out = args.out + "_mesh"
    write_mesh_outputs(out, verdict, world, device)
    r = verdict["rows"][0]
    print(f"mesh gate: {'PASS' if ok else 'FAIL'} "
          f"dELBO={r['d_elbo_rel']:.2e} (band {r['seed_band_rel']:.2e}) "
          f"dNLL={r['d_nll']:.4f} (band {r['seed_band_nll']:.4f}), "
          f"replicas equal {agree}, steps/s {r['steps_per_s_single']:.1f}, "
          f"{r['steps_per_s_single_seed1']:.1f}, {r['steps_per_s_mesh']:.1f} "
          f"-> {out}.md ({r['seconds']:.0f}s)", flush=True)
    return verdict


def write_mesh_outputs(out: str, verdict: dict, world: int,
                       device: torch.device) -> None:
    """<out>.json, and <out>.md in the reference's form with seconds and
    steps/s after its columns."""
    with open(out + ".json", "w") as f:
        json.dump(verdict, f, indent=1)
    r = verdict["rows"][0]
    dp, k = verdict["mesh"]["dp"], verdict["mesh"]["k"]
    mark = "PASS" if verdict["pass"] else "FAIL"
    where = "cuda:0" if device.type == "cuda" else "the CPU"
    with open(out + ".md", "w") as f:
        f.write(
            f"# Sharded-trainer convergence gate — {mark}\n\n"
            f"{verdict['date']}, backend={verdict['backend']} ({dp}x{k} "
            f"mesh, {world} ranks on {where}), config {r['config']}, "
            f"{verdict['iterations']} steps, production precision defaults "
            "both sides. The sharded trajectory (rows over 'dp', samples "
            "over 'k', all-reduced grads) must land within 1.5x the "
            "single-device seed-to-seed band — a TRAJECTORY property; the "
            "test suite pins only step-granular exactness. Replicas "
            f"bitwise equal at the end: {r['replicas_bitwise_equal']}. "
            "Steps/s: single, single seed 1, mesh (training only; single "
            "graphed, capture included; mesh eager, rank 0).\n\n"
            "| config | verdict | ELBO/n single | ELBO/n seed1 | ELBO/n "
            "mesh | dELBO rel | band | NLL single | NLL mesh | dNLL | s "
            "| steps/s |\n"
            "|---|---|---|---|---|---|---|---|---|---|---|---|\n"
            f"| {r['config']} | {'PASS' if r['ok'] else 'FAIL'} | "
            f"{r['elbo_single']:+.4f} | {r['elbo_single_seed1']:+.4f} | "
            f"{r['elbo_mesh']:+.4f} | {r['d_elbo_rel']:.2e} | "
            f"{r['seed_band_rel']:.2e} | {r['nll_single']:+.4f} | "
            f"{r['nll_mesh']:+.4f} | {r['d_nll']:.4f} | {r['seconds']:.0f} "
            f"| {r['steps_per_s_single']:.1f}, "
            f"{r['steps_per_s_single_seed1']:.1f}, "
            f"{r['steps_per_s_mesh']:.1f} |\n")


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


def main(argv=None, *, fail_rank=None, **setting) -> dict:
    """Run the gate of `argv` (the CLI's flags) and write its record;
    returns the verdict. `setting`: keywords for every ``run_setting``
    (tests shrink the runs with ``num_inducing=`` and ``max_n=``);
    `fail_rank`: with ``--mesh``, the rank that raises (tests)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        hopper_build.build_all()   # nvcc here, not in a run's timed fit
    if args.mesh:
        return run_mesh_gate(args, device, setting, fail_rank)
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
