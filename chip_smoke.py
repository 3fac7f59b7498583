#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100), kernels included.

    python3 chip_smoke.py [--out DIR] [--profile]
    python3 chip_smoke.py --ab PARENT --out DIR

The second form compares this tree with a checkout of another commit at
PARENT on one card (``ab_kernels``, ``ab_runs``) and writes DIR/ab.json.

Phases, each of which fails the run (non-zero exit) when it fails:

1. device: the card's name and power limit, the TF32 flags (TF32 on for
   f32 matmuls fails the run: it is none of the port's precision classes);
2. build: every csrc/*.cu by its own nvcc, all at once, timed as set-up;
3. kernels: each hand-written kernel, in every variant, against its plain
   PyTorch version on the same inputs on the card, with the tolerance
   stated per case: K1 on the served model's own Kuu grams and on a
   natgrad precision P (G=1, two levels), plus its jitter ladder on a
   rank-deficient gram, with an empty kernel's time beside K1's; K2
   (epilogue with mean, without mean, q-variance only) at the serving
   shape (M=128, B=8192, S=100), and with mean at the training step's
   shapes A [20,128,512] and [20,128,8192] (root D=8, cov D=1), at ragged
   N (1, 63, 65, 1000), M = 20, 100 and 264, D = 3 and 16 and L = 1, and
   two launches bitwise equal; K3 (its backward, in the same three
   forms) at the training shapes A [20,128,512] and [20,128,8192], at
   M=100, and two launches bitwise equal at both shapes; K4
   (``serve_cond``, with and without the sample) and K5
   (``conditional``, fused and sample, with the residuals Kxz and A) at
   the serving and training shapes (K5 'fused' with residuals at the
   Adam-only step's [10240, 8], D=1), a ragged N, M=100 and M=200, K5's
   sample element by element against the plain Philox stream, the
   recovered noise over 8.4M draws (mean, variance, share beyond 3 within
   5 standard errors), one seed bitwise repeatable and two seeds apart;
   and K1-K4 at the IW-vs-VI experiment's shapes (M=16 for phase 14's
   pin, M=64 for the full-size runs: K1 grams, K2/K3 'epi' at D=1, K4/K5
   on the S=500 test sets with d_in=2; K4 below M=64 held element by
   element to the bound of its bf16 rounding, ``_k4_flip_check``, with
   the planted faults that check catches);
4. serving: the LGG model of phase 3, built from a seed on bench.py's
   synthetic data, 8 requests of
   B=8192 at S=100 scored through ``serving.Scorer`` with
   ``serve_pallas=False`` (the K2 route); the kernel launch counts of that
   run must be positive, one batch must agree with the same batch through
   the plain versions on the card, and a small batch with the port's CPU
   path (the path the CPU tests hold to the JAX reference); then the same
   requests on the default config, whose ``serve_pallas="auto"`` takes
   K4 (2 launches and one K1 per request), and with ``use_pallas`` (one
   K5 'sample' and one K5 'fused' per request), each against the plain
   versions on the card;
5. training: the flagship step (LGG, IW K=20, M=128, B=512, natgrad on
   the final layer) on synthetic data of kin8nm's shape; one step's loss
   and gradients through the kernels against the plain versions on the
   card, 200 timed steps whose K1, K2 and K3 launch counts rise by 2 each
   per step, and 20 steps at B=8192 with the same counts; then with
   ``use_pallas`` (the inner layer in K5 'sample'), natgrad final (per
   step K5 'sample', K2 and K3 once, K1 twice) and Adam alone (the final
   layer in K5 'fused' and its backward), each with one step against the
   plain versions;
6. harness: ``experiments.main.run`` as a user runs it, on the kin8nm
   surrogate (LGG IW K=20 M=128 B=512, natgrad final, 400 steps, S=100 at
   evaluation, results and checkpoints in a temporary directory): K1, K2
   and K3 launched twice per step, K4 twice per test chunk, a test NLL
   above the untrained model's, a results row that fills the schema, and
   a run resumed from the step-200 checkpoint whose step-400 state equals
   the straight run's bit for bit;
7. serve: ``experiments.serve.run`` (dgp-serve-torch) on phase 6's
   step-400 checkpoint at S=100: the test split and an .npz table of
   8 x 8192 raw rows on the live path (one K1 and two K4 per batch, the
   .npz bitwise equal to the same batches through ``make_scorer_fn``, the
   test split's mean log-density equal to phase 6's test loglik), then a
   fixed-batch and a polymorphic 'cuda' artifact (``--export``,
   ``--from_export``): no hand kernel launched, the fixed one within 1e-5
   of max|value| of the live path on the plain versions fed the
   artifact's noise, the polymorphic one scoring a 1-row last chunk; the
   points/s of the live path, the artifact and ``--transport bfloat16``;
8. families: ``experiments.main.run`` on the kin8nm surrogate as in phase
   6 (300 steps) with (a) ``--kernel matern52+linear`` (K1 on its Kuu,
   and on rank-deficient linear, polynomial and constant grams up the
   jitter ladder, at the plain version's level; K1, K2 and K3 twice per
   step, evaluation on K1 and K2, no K4; one step at a random q(u)
   against the plain versions; test NLL above the untrained model's) and
   (b) ``--likelihood multiclass --num_classes 3`` on the class surrogate
   (K2 and K3 at a final layer of D=3 and K4 'infer' at D=3 held to their
   plain versions in phase 3; launches as phase 6's; one step against
   the plain versions, its gradients held to the same step in float64;
   test accuracy above 0.40 and test NLL above the untrained model's),
   then ``experiments.serve.run`` on (b)'s checkpoint: [n, 3] class
   probabilities, one K1 and two K4 per batch, the test split's mean
   log-density equal to (b)'s test loglik;
9. breadth: ``experiments.main.run`` as in phase 8 (300 steps) with (a)
   ``--feature multiscale`` and two ``--prior`` flags (K1, K2 'epi' and
   K3 'epi' twice per step, evaluation on K1 and K2, no K4 or K5; the
   windows moved) and (b) ``--no_white`` (K1, K2 'qvar' and K3 'qvar'
   twice per step, evaluation on K1 and K2 'qvar'; K2/K3 'qvar' also held
   to their plain versions in phase 3 at this model's own A = Kuu^-1 Kuf),
   each with one step at a random q(u) against the plain versions and a
   test NLL above the untrained model's; ``experiments.serve.run`` on
   (b)'s checkpoint (one K1 per batch, K2 'qvar' per layer and batch, the
   test split's mean log-density equal to (b)'s test loglik); then
   ``predict_f_full_cov`` on (a)'s model (its diagonal equal to
   ``predict_f``'s variance, symmetric, no eigenvalue below -1e-4 of its
   largest diagonal), ``predict_f_samples`` and ``predict_y_samples`` on
   phase 6's checkpoint (one K1 and K4 'sample' and 'infer' per call,
   sample means within 5 standard errors of the mixture mean) and
   ``dispatch_sample_observations`` of every family (10^6 draws each,
   mean and variance within 5 standard errors of the analytic values);
10. parallel: two ranks spawned on the one card (``torch.multiprocessing``,
   both on cuda:0, gloo through a ``FileStore``: the model math and every
   kernel on the card, the collectives through the host), the flagship
   configuration on the kin8nm surrogate: (a) one sharded step with
   injected draws on the 2x1 and the 1x2 mesh, K1, K2 and K3 twice each
   per rank, its summed loss and gradients held to the same step in one
   process on the card and to the sharded step on the plain versions at
   phase 5's gates; then ``use_pallas`` on 2x1, K5 'sample' once per rank,
   against the one-process step on each rank's rows and noise generator;
   (b) ``fit(mesh=)`` for 100 steps on 1x2 (K split over the ranks): the
   replicas bitwise equal after every chunk, the loss falling, and a run
   resumed from the step-50 checkpoint bitwise equal to the straight run;
   (c) ``evaluate(mesh=)`` on the test split within rtol 1e-6 of the
   unsharded ``evaluate``, K1 and K4 on each rank; (d)
   ``experiments.main.run --shard --n_k 2``: one results row, from rank 0,
   test loglik above the untrained model's; ``experiments.serve.run
   --shard`` on its checkpoint, its .npz within rtol 1e-6 of the unsharded
   scoring; (e) a world of one rank on NCCL: one ``fit(mesh=)`` chunk
   whose mean loss equals the single-device chunk's on the same draws.
   Launches are counted per rank around the sharded paths only; the
   two-rank steps/s is printed as two processes time-sliced on one card,
   not a scaling figure;
11. flops and demos: (a) ``utils.flops.step_cost`` of the flagship step
   at B=512 and B=8192, per class equal to the pinned figures of
   ``tests/test_torch_flops.py``, and the MFU and adjusted MFU at phase
   5's steps/s (B=512, B=8192, use_pallas B=512) and, with --profile, at
   its device-busy time per step; (b) the results rows of phases 6, 8, 9
   and 10 carry a finite ``flops_per_step`` equal to step_cost's figure
   for that run and ``mfu``/``mfu_adjusted`` in (0, 1) (checked in those
   phases); (c) the demos ``demos.toy_1d`` and ``demos.multitask_icm``
   on the card, cut to 300 of their 3000 and 4000 steps: launches exact
   per step and per prediction (see ``demos_phase``), the loss falling,
   the predictions within 1e-3 of |x|+1 of the plain versions' on the
   same trained parameters, multitask's learned noise stds beside the
   true ones; the plots written where matplotlib imports;
12. graphs: the CUDA graphs that ``fit`` and ``Scorer`` replay on the card
   (``utils/graphs.py``) against the eager calls, in turns (eager, graph,
   eager, graph) within this call: the flagship step (natgrad final) at
   B=512 (100 steps a turn) and B=8192 (20) and with ``use_pallas`` at
   B=512, from equal states and generator states, the losses of each
   pair of turns and every state leaf afterwards bitwise equal; the 8
   requests of phase 4 on its three routes through ``make_scorer_fn``
   eagerly and through ``Scorer``, every output bitwise equal; launches
   exact per step and request in every turn; steps/s, points/s, the
   capture time, the peak memory of the first chunk and, with --profile,
   the idle share of a replayed chunk; then ``evaluation.evaluate``'s
   chunks (``GraphedEval``) on a table of 51,630 new rows of phase 6's
   surrogate at S=100 in 4096-row chunks, on four routes: phase 6's
   step-400 model on the default route (K4) and the K2 route, phase 9's
   ``--no_white`` model and phase 8's multiclass model; eager chunks
   against one replay per chunk in turns, every point's log-density and
   mean and every metric bitwise, launches equal to the eager call's and
   to the capture's tally per chunk; ``evaluate`` itself; phase 6's
   step-200 model then replays the default route's graph (no new
   capture) and equals its eager evaluation; points/s, the capture time
   and the memory the cache holds.
13. quality gate: ``experiments.quality_gate.main --quick`` (500 steps,
   the reference's quick tolerances 0.2 and 0.5) on LGG-kin8nm natgrad
   and GG-energy ADAM-ONLY: the port's shipped defaults against its
   all-``highest`` setting at two seeds, trained through ``fit`` (graphed)
   and measured at ``highest``. One line per configuration (verdict, both
   gaps, seconds, steps/s); a FAIL or a non-finite loss fails the run.
   Launches counted per run: a candidate run launches K1 twice per step
   (once with Adam alone), K2 'epi' and K3 'epi' once per GP layer per
   step, and K1 once per measured bound (8) and per test chunk, and once
   for natgrad's canonical q(u); an all-``highest`` run the same K1 and no
   K2 or K3 (kernels line paths ``gate_candidate`` and ``gate_highest``).
   The year configuration is left out: its k-means++ initialization
   alone takes minutes on the host per run.
14. iw_vs_vi: the reference's pin of the paper's claim
   (tests/test_iw_quality.py:26-33) through
   ``experiments.iw_vs_vi.run_one``: bimodal data (256 train, 512 test
   rows), LG, M=16, 1500 steps, VI against IW with K=10, at seeds 0, 1, 2
   and 3. One line per seed (both NLLs, both IW20 bounds, ESS, seconds
   per run); fails unless the mean NLL gap over the seeds is above the
   reference's 0.05 nats and the mean IW20 bound of the IW-trained
   parameters is above the VI-trained ones'. Then one 500-step run at
   the full experiment's shape (bimodal N=2000, LGG IW20, M=64, minibatch
   512 < N). Launches counted per run (``_pin_want``; kernels line paths
   ``iw_vs_vi_train`` and ``iw_vs_vi_eval``): training K1 twice per step
   and once more, and K2/K3 'epi' per GP layer and step only below N (the
   pin's full-batch step, B = N = 256, runs at 'highest', so no K2/K3);
   evaluation K1, K4 'infer' and K4 'sample' per inner GP layer once per
   test chunk and per bound.
15. measure: the reference's measurement tools as the package has them
   (``experiments.profile_step``, ``roofline``, ``peak_probe``,
   ``predict_bench``) on the flagship step at B=512 (kin8nm surrogate,
   LGG IW K=20 M=128): ``profile_step`` over replayed steps, whose hand
   kernels' launches per step (``build.launch_costs``) must be K1 2, K2
   'epi' 2 and K3 'epi' 2; ``roofline``, whose hand-kernel rows must move
   the bytes and do the operations that ``ops/hopper/cost.py`` gives for
   the step's shapes, each bound at the sum of its launches' bounds,
   none reading faster than that bound / 1.05 (a faster one means the
   cost model counts wrong), and every tensor list resolved, the
   optimizer's foreach rows moving bytes; ``peak_probe --quick``, no
   reading past 105% of the data sheet; ``predict_bench`` at B=8192
   only, 3 rounds, every scored value finite. Launches exact per tool
   (kernels line paths ``measure_profile``, ``measure_roofline``,
   ``measure_predict``).

``fit``, ``Scorer`` and ``evaluate`` replay CUDA graphs on the card, so
phases 4, 6-9 and 11 (and phase 7's live path) run graphed, with their
launch gates unchanged; phase 5 times ``step_fn`` eagerly and phase 10's
``fit(mesh=)`` and ``evaluate(mesh=)`` stay eager. Phase 7 also prints
the card's busy share of a batch of ``ServingArtifact.score`` (the device
time of one program call against the wall time per batch).

Prints one ``{"kernels": [...]}`` line (launches counted on every path
above, by path; phase 10's by rank), then the card's name and power limit, then
``{"ok": true, "device": {...}}`` as the last line. Exits
non-zero without a result where CUDA is unavailable or the package is not
beside this script. ``--out DIR`` also writes the whole record to
``DIR/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import inspect
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

S_SERVE, B_SERVE, M, D_X = 100, 8192, 128, 8
REQUESTS = 8
EPS32 = 2.0 ** -24  # unit roundoff of float32


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn over `iters` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int = 10) -> float:
    """Device time of fn per call, its calls back to back with no gap: a
    spin kernel (``torch.cuda._sleep``) queued ahead of the start event
    lasts longer than the host's enqueue of all `iters` calls, so that the
    events time the device's work alone. ``time_ms`` times the host instead
    where enqueueing a call takes longer than its kernels."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0  # enqueue and run: an upper bound
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * (1.5 * host_s + 1e-3)))  # cycles, <= 2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def chol_library(torch, K, jit):
    """K1's function in library calls: the factors of K [G, M, M] plus
    each jitter of the ladder times I, and their inverses."""
    m = K.shape[-1]
    Kj = K[None] + jit.reshape(-1, 1, 1, 1) * torch.eye(m, device=K.device)
    Lc, _ = torch.linalg.cholesky_ex(Kj)
    return torch.linalg.solve_triangular(
        Lc, torch.eye(m, device=K.device).expand_as(Lc), upper=False)


def _chol_case(torch, chol, linalg, K, jit) -> dict:
    """K1 against its plain version on K [G, M, M] over the ladder `jit`:
    the same first usable level per matrix, L and Linv within the
    first-order forward error bound m*u*cond(K + jitter I)*max|plain| at
    the selected level, and the kernel's own residuals within backward
    error bounds: |L L^T - Kj| <= m*u*max(|L||L|^T) and
    |L Linv - I| <= m*u*max(|L||Linv|)."""
    L_all, Li_all = chol.chol_inv(K, jit)
    Lp_all, Lip_all = chol.chol_inv_plain(K, jit)
    lvl, lvl_p = linalg._first_ok_level(L_all), linalg._first_ok_level(Lp_all)
    if not torch.equal(lvl, lvl_p):
        fail(f"chol_inv picks ladder levels {lvl.tolist()}, the plain "
             f"version {lvl_p.tolist()}")
    L, Li = linalg._pick(L_all, lvl), linalg._pick(Li_all, lvl)
    Lp, Lip = linalg._pick(Lp_all, lvl), linalg._pick(Lip_all, lvl)
    m = K.shape[-1]
    eye = torch.eye(m, dtype=torch.float64, device=K.device)
    Kj = K.double() + jit.double()[lvl][:, None, None] * eye
    cond = float(torch.linalg.cond(Kj).max())
    err_l, err_i = max_err(L, Lp), max_err(Li, Lip)
    tol_l = m * EPS32 * cond * float(Lp.abs().max())
    tol_i = m * EPS32 * cond * float(Lip.abs().max())
    Ld, Lid = L.double(), Li.double()
    res_k = float((Ld @ Ld.mT - Kj).abs().max())
    tol_k = m * EPS32 * float((Ld.abs() @ Ld.abs().mT).max())
    res_i = float((Ld @ Lid - eye).abs().max())
    tol_ri = m * EPS32 * float((Ld.abs() @ Lid.abs()).max())
    if not (err_l <= tol_l and err_i <= tol_i and res_k <= tol_k
            and res_i <= tol_ri):
        fail(f"chol_inv: |dL| {err_l} (tol {tol_l}), |dLinv| {err_i} "
             f"(tol {tol_i}), |LL^T-K| {res_k} (tol {tol_k}), "
             f"|L Linv-I| {res_i} (tol {tol_ri})")
    for X in (L_all, Li_all):
        if float(torch.triu(X, 1).abs().max()) != 0.0:
            fail("chol_inv left non-zeros above the diagonal")
    return {"levels": lvl.tolist(), "cond": cond,
            "max_abs_err_L": err_l, "max_abs_err_Linv": err_i,
            "tol_L": tol_l, "tol_Linv": tol_i,
            "max_rel_err": max(err_l / float(Lp.abs().max()),
                               err_i / float(Lip.abs().max())),
            "residual_LLt": res_k, "tol_LLt": tol_k,
            "residual_LLinv": res_i, "tol_LLinv": tol_ri}


def natgrad_precision(torch, params, gen):
    """A natgrad P [1, M, M] as training/natgrad.py factors it: S^-1 of the
    final layer's q(u) plus 2 gamma H (gamma 1e-2, H a random PSD matrix of
    unit scale), symmetrized."""
    lq = params["layers"][-1]["q_sqrt"].double()            # [1, M, M]
    Sinv = torch.cholesky_inverse(lq)
    B = torch.randn(lq.shape, generator=gen, device="cuda").double()
    P = Sinv + 2.0 * 1e-2 * (B @ B.mT) / lq.shape[-1]
    return (0.5 * (P + P.mT)).float()


def one_launch_wall_ms(torch, fn, reps: int = 21) -> float:
    """Median host time of one call of fn up to its synchronize."""
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return sorted(walls)[reps // 2]


def launch_floor(torch) -> dict:
    """The time of an empty kernel (``torch.cuda._sleep(0)``, a kernel that
    spins for 0 cycles), timed as the kernels are: back to back by CUDA
    events, and one launch on the host clock up to its synchronize."""
    def empty():
        torch.cuda._sleep(0)
    return {"ms": time_ms(torch, empty, 200),
            "one_launch_wall_ms": one_launch_wall_ms(torch, empty)}


def chol_phase(torch, hopper, linalg, gen, Kuu, jitter, tries, P) -> dict:
    """K1 against its plain version on the served model's stacked Kuu
    grams (G=2 GP layers, M=128) over its jitter ladder, which is what
    the serving path factors, and on natgrad's P (G=1, 2 levels from
    1e-12); then on a well-conditioned SPD batch and on a rank-deficient
    gram that has to climb the ladder. Beside K1's time, an empty kernel's
    (``launch_floor``)."""
    chol = hopper.chol
    G = Kuu.shape[0]
    jit = linalg._jitter_ladder(jitter, tries, Kuu.dtype, Kuu.device)
    served = _chol_case(torch, chol, linalg, Kuu, jit)
    jit_ng = linalg._jitter_ladder(1e-12, 2, P.dtype, P.device)
    natgrad = _chol_case(torch, chol, linalg, P, jit_ng)
    A = torch.randn((G, M, M), generator=gen, device="cuda")
    Kspd = A @ A.transpose(-1, -2) + M * torch.eye(M, device="cuda")
    spd = _chol_case(torch, chol, linalg, Kspd, jit)

    # the IW-vs-VI experiment's grams: M=16 (phase 14's pin, one GP
    # layer) and M=64 (the full-size runs, up to two GP layers)
    small_m = {}
    for g, m in ((1, 16), (2, 64)):
        A = torch.randn((g, m, m), generator=gen, device="cuda")
        small_m[f"[{g},{m},{m}]"] = _chol_case(
            torch, chol, linalg, A @ A.transpose(-1, -2) + m * torch.eye(
                m, device="cuda"), jit)

    # rank-deficient gram: the ladder must climb to a usable factor
    v = torch.randn((M, 2), generator=gen, device="cuda")
    Kd = (v @ v.T)[None]
    Ld, Lid = linalg.chol_and_inverse(Kd, 1e-6, 6)
    dd = torch.diagonal(Ld, dim1=-2, dim2=-1)
    if not (bool(torch.isfinite(Ld).all()) and bool((dd > 0).all())
            and bool(torch.isfinite(Lid).all())):
        fail("chol_and_inverse on a rank-deficient gram is not finite")
    lvl = linalg._first_ok_level(chol.chol_inv(
        Kd, linalg._jitter_ladder(1e-6, 6, Kd.dtype, Kd.device))[0])
    lvl_p = linalg._first_ok_level(chol.chol_inv_plain(
        Kd, linalg._jitter_ladder(1e-6, 6, Kd.dtype, Kd.device))[0])

    ms = time_ms(torch, lambda: chol.chol_inv(Kuu, jit), 50)
    spd_ms = time_ms(torch, lambda: chol.chol_inv(Kspd, jit), 50)
    plain_ms = time_ms(torch, lambda: chol.chol_inv_plain(Kuu, jit), 20)
    library_ms = time_ms(torch, lambda: chol_library(torch, Kuu, jit), 20)
    floor = launch_floor(torch)
    # the function: G factors and their inverses (ops/hopper/cost.py, the
    # package's one cost model and table of peaks, as for every kernel)
    cost = hopper.cost
    b_ms, b_by = cost.bound(*cost.chol_inv(G, M, len(jit)))
    ng_b_ms, ng_b_by = cost.bound(*cost.chol_inv(1, M, len(jit_ng)))
    natgrad.update(
        shape=f"natgrad P [1,{M},{M}] f32 x {len(jit_ng)} jitter levels",
        ms=time_ms(torch, lambda: chol.chol_inv(P, jit_ng), 50),
        plain_ms=time_ms(torch, lambda: chol.chol_inv_plain(P, jit_ng), 20),
        library_ms=time_ms(torch, lambda: chol_library(torch, P, jit_ng),
                           20), bound_ms=ng_b_ms,
        bound_by=ng_b_by)
    return {
        "name": "chol_inv", "route": "cuda",
        "source": "dgps_with_iwvi_torch/csrc/chol_inv.cu",
        "replaces": "dgps_with_iwvi_tpu/ops/pallas/chol.py:101",
        "shape": f"served Kuu [{G},{M},{M}] f32 x {len(jit)} jitter levels",
        "max_abs_err": max(served["max_abs_err_L"],
                           served["max_abs_err_Linv"],
                           natgrad["max_abs_err_L"],
                           natgrad["max_abs_err_Linv"]),
        "max_rel_err": max([served["max_rel_err"], natgrad["max_rel_err"]]
                           + [c["max_rel_err"] for c in small_m.values()]),
        "tol": "m*u*cond(K+jI)*max|plain| at the selected level",
        "served_kuu": served, "natgrad_p": natgrad,
        "one_launch_wall_ms": one_launch_wall_ms(
            torch, lambda: chol.chol_inv(Kuu, jit)),
        "empty_kernel_ms": floor["ms"],
        "empty_kernel_one_launch_wall_ms": floor["one_launch_wall_ms"],
        "spd": dict(spd, ms=spd_ms), "small_m": small_m,
        "rank_deficient_level": int(lvl[0]),
        "rank_deficient_level_plain": int(lvl_p[0]),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": library_ms,
        "library": "torch.linalg.cholesky_ex + solve_triangular",
    }


EPI_CASES = [
    # (label, D, cov, form): form "epi" (mean + sumsq), "ps" (sumsq, no
    # mean) or "qvar" (q-variance only)
    ("inner layer: root D=8, mean+sumsq", 8, False, "epi"),
    ("final layer: root D=1, mean+sumsq", 1, False, "epi"),
    ("cov D=8, mean+sumsq", 8, True, "epi"),
    ("_ps_kernel: root D=8, sumsq", 8, False, "ps"),
    ("_ps_kernel: cov D=1, sumsq", 1, True, "ps"),
    ("q-variance only (_qvar_kernel): root D=8", 8, False, "qvar"),
    ("q-variance only (_qvar_kernel): cov D=1", 1, True, "qvar"),
    ("q-variance only (_qvar_kernel): root D=1", 1, False, "qvar"),
]
K2_REPLACES = {"epi": "dgps_with_iwvi_tpu/ops/pallas/qvar.py:429",
               "ps": "dgps_with_iwvi_tpu/ops/pallas/qvar.py:437",
               "qvar": "dgps_with_iwvi_tpu/ops/pallas/qvar.py:96"}
K3_REPLACES = {"epi": "dgps_with_iwvi_tpu/ops/pallas/qvar.py:567",
               "ps": "dgps_with_iwvi_tpu/ops/pallas/qvar.py:685",
               "qvar": "dgps_with_iwvi_tpu/ops/pallas/qvar.py:224"}


def _epi_inputs(torch, gen, L, D, N, cov, m=M):
    A = torch.randn((L, m, N), generator=gen, device="cuda") / math.sqrt(m)
    R = torch.tril(torch.randn((D, m, m), generator=gen, device="cuda"))
    W = 0.1 * R + torch.eye(m, device="cuda")
    if cov:
        W = W @ W.transpose(-1, -2)
    q_mu = torch.randn((m, D), generator=gen, device="cuda")
    return A, W, q_mu


def _epi_call(qvar, A, W, q_mu, cov, form, plain):
    if form == "epi":
        f = qvar.epi_plain if plain else qvar.epi_fused
        return f(A, W, q_mu, cov)
    if form == "ps":
        f = qvar.ps_plain if plain else qvar.ps_fused
        return f(A, W, cov)
    f = qvar.qvar_plain if plain else qvar.qvar_fused
    return (f(A, W, cov),)


def _compare(torch, what, got, ref, names, rel_tol):
    """Kernel outputs against plain ones: (errs, rels) by output; fails
    past rel_tol[name] * max|plain|."""
    errs, rels = {}, {}
    for name, g, r in zip(names, got, ref):
        if g.shape != r.shape or not bool(torch.isfinite(g).all()):
            fail(f"{what}: {name} shape {tuple(g.shape)} vs "
                 f"{tuple(r.shape)} or non-finite")
        err, tol = max_err(g, r), rel_tol[name] * float(r.abs().max())
        if not err <= tol:
            fail(f"{what} {name}: max |err| {err} > {tol} "
                 f"({rel_tol[name]} max|plain|)")
        errs[name], rels[name] = err, err / float(r.abs().max())
    return errs, rels


def _epi_check(torch, qvar, label, A, W, q_mu, cov, form):
    """Kernel against plain on the same inputs: (errs, rels) by output."""
    got = _epi_call(qvar, A, W, q_mu, cov, form, plain=False)
    ref = _epi_call(qvar, A, W, q_mu, cov, form, plain=True)
    names = {"epi": ("qv", "ss", "mean"), "ps": ("qv", "ss"),
             "qvar": ("qv",)}[form]
    # both sides multiply the same bf16-rounded operands into f32; only the
    # order of the f32 sums differs
    return _compare(torch, f"epilogue [{label}]", got, ref, names,
                    {"qv": 1e-4, "ss": 1e-5, "mean": 1e-4})


def _entry(name, source, replaces, cases, tol, library_ms=None):
    """One row of the kernels line from its cases (the first is the one
    timed on the main path's shape)."""
    main = cases[0]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "shape": main["shape"],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "max_rel_err": max(c["max_rel_err"] for c in cases),
            "tol": tol, "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": library_ms, "cases": cases}


def _epi_case(torch, qvar, gen, label, Lx, N, D, cov, form) -> dict:
    """K2 against its plain version on A [Lx, M, N], W [D, M, M]: errors,
    times and the bound on the same inputs."""
    A, W, q_mu = _epi_inputs(torch, gen, Lx, D, N, cov)
    return _epi_case_on(torch, qvar, label, A, W, q_mu, cov, form)


def _epi_case_on(torch, qvar, label, A, W, q_mu, cov, form) -> dict:
    """_epi_case on given inputs A [Lx, M, N], W [D, M, M]."""
    Lx, N, D = A.shape[0], A.shape[-1], W.shape[0]
    errs, rels = _epi_check(torch, qvar, label, A, W, q_mu, cov, form)
    iters = 10 if Lx * N >= 1 << 18 else 50
    ms = time_ms(torch, lambda: _epi_call(qvar, A, W, q_mu, cov, form,
                                          False), iters)
    plain_ms = time_ms(torch, lambda: _epi_call(qvar, A, W, q_mu, cov, form,
                                                True), 3, 1)
    dev_ms = device_ms(torch, lambda: _epi_call(qvar, A, W, q_mu, cov, form,
                                                False))
    from dgps_with_iwvi_torch.ops.hopper import cost

    b_ms, b_by = cost.bound(*cost.epilogue(Lx, A.shape[-2], N, D, form))
    del A, W, q_mu
    torch.cuda.empty_cache()
    return {"case": label, "shape": f"A [{Lx},{M},{N}], W [{D},{M},{M}]",
            "max_abs_err": max(errs.values()),
            "max_rel_err": max(rels.values()), "errs": errs, "ms": ms,
            "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by}


EPI_TRAIN_CASES = [
    # (label, D, cov): the training step's two K2 launches
    ("training inner layer: root D=8, mean+sumsq", 8, False),
    ("training final layer (natgrad): cov D=1, mean+sumsq", 1, True),
    ("multiclass final layer (natgrad): cov D=3, mean+sumsq", 3, True),
]


EPI_EDGE_CASES = [
    # (L, M, N, D, cov, form): ragged N (one column, 64 +- 1, a last tile
    # of 104), M below 128 and the chunked M > 128, D below and above a
    # group of 8 outputs, a single L
    (2, M, 1, 8, False, "epi"), (2, M, 63, 8, False, "epi"),
    (2, M, 65, 1, True, "epi"), (2, M, 1000, 1, True, "ps"),
    (2, 20, 1000, 8, False, "epi"), (2, 100, 1000, 8, True, "epi"),
    (2, 264, 1000, 8, False, "epi"), (2, 264, 1000, 1, True, "epi"),
    (2, M, 1000, 3, False, "qvar"), (2, M, 1000, 16, False, "epi"),
    (1, M, 1000, 8, True, "epi"),
    # the IW-vs-VI experiment's training steps at M=64, B=512: the natgrad
    # final layer under IW20 (L=20) and VI (L=1), an inner layer (root
    # D=1); and M=16 at B=256
    (20, 64, 512, 1, True, "epi"), (1, 64, 512, 1, True, "epi"),
    (20, 64, 512, 1, False, "epi"), (10, 16, 256, 1, True, "epi"),
]


def non_white_qvar_inputs(torch) -> dict:
    """{"train": [(label, A, W, cov)], "eval": [...]}: the q-variance
    inputs of both GP layers of phase 9(b)'s model (LGG --no_white, IW
    K=20, M=128, B=512, natgrad final, on the kin8nm surrogate, built from
    the harness's seed) at a random q(u), as ``ops.conditionals._q_variance``
    receives them on the plain versions: A = Kuu^-1 Kuf, which carries
    Kuu's condition number. "train": one training step, A [20,128,512]
    with the inner layer's root W (D=8) and the final layer's natgrad
    covariance (D=1). "eval": evaluation's one chunk (and each served
    batch) of the 820 test rows at S=100, A [100,128,820], where both
    layers hold a root (D=8 and D=1: natgrad's S goes back to a q_sqrt
    before evaluation)."""
    from dgps_with_iwvi_torch import training as train
    from dgps_with_iwvi_torch.data import get_regression_data
    from dgps_with_iwvi_torch.experiments.main import seeds
    from dgps_with_iwvi_torch.models import (BuildArgs, build_model,
                                             predict_y_and_log_density)
    from dgps_with_iwvi_torch.ops import conditionals
    from dgps_with_iwvi_torch.ops.hopper import build

    tmp = tempfile.mkdtemp(prefix="chip_smoke_data_")
    try:
        data = get_regression_data("kin8nm", 0,
                                   data_dir=os.path.join(tmp, "none"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    X = torch.as_tensor(data.X_train).cuda()
    Y = torch.as_tensor(data.Y_train).cuda()
    config, params = build_model(
        seeds(0)[0], BuildArgs(configuration="LGG", mode="IW",
                               num_inducing=M, num_iw_samples=L_TRAIN,
                               white=False), X, Y, device="cuda")
    random_q(torch, params)
    tc = train.TrainConfig(natgrad="final", minibatch_size=B_TRAIN)
    state = train.make_trainer(config, tc)[0](params)
    captured, real = [], conditionals._q_variance

    def record(A, q_sqrt, q_S, var_precision):
        W, cov = ((q_S, True) if q_S is not None
                  else (torch.tril(q_sqrt), False))
        captured.append((A.detach().clone(), W.detach().clone(), cov))
        return real(A, q_sqrt, q_S, var_precision)

    conditionals._q_variance = record
    X_test = torch.as_tensor(data.X_test).cuda()
    Y_test = torch.as_tensor(data.Y_test).cuda()
    try:
        with build.plain_versions():
            train.loss_and_grads(config, tc, state, X, Y,
                                 torch.Generator(device="cuda").manual_seed(3))
            with torch.no_grad():
                predict_y_and_log_density(
                    params, config, X_test, Y_test,
                    torch.Generator(device="cuda").manual_seed(4),
                    HARNESS_SAMPLES)
    finally:
        conditionals._q_variance = real
    want = {"train": [("non-whitened inner layer: root D=8, A = Kuu^-1 Kuf",
                       (L_TRAIN, M, B_TRAIN, 8, M, M, False)),
                      ("non-whitened final layer (natgrad): cov D=1, "
                       "A = Kuu^-1 Kuf", (L_TRAIN, M, B_TRAIN, 1, M, M, True))],
            "eval": [("non-whitened evaluation inner layer: root D=8, "
                      "820 test rows x S=100",
                      (HARNESS_SAMPLES, M, HARNESS_TEST_ROWS, 8, M, M, False)),
                     ("non-whitened evaluation final layer: root D=1, "
                      "820 test rows x S=100",
                      (HARNESS_SAMPLES, M, HARNESS_TEST_ROWS, 1, M, M, False))]}
    shapes = [tuple(A.shape) + tuple(W.shape) + (cov,)
              for A, W, cov in captured]
    if shapes != [sh for rows in want.values() for _, sh in rows]:
        fail(f"non-whitened model: q-variance inputs of shapes {shapes}")
    it = iter(captured)
    return {k: [(lb,) + next(it) for lb, _ in rows]
            for k, rows in want.items()}


def epilogue_phase(torch, hopper, gen, non_white) -> list:
    """K2 against its plain version at the serving shape S=100, B=8192,
    M=128 (errors and times on the same inputs), at the training step's
    shapes A [20,128,512] and [20,128,8192], the q-variance-only variant
    at a non-whitened model's own A in a training step and in evaluation
    (``non_white_qvar_inputs``, its main path), on a ragged N and at the edge cases of EPI_EDGE_CASES; two
    launches bitwise equal; one kernels-line row per variant."""
    qvar = hopper.qvar
    cases = {"epi": [], "ps": [], "qvar": []}
    for label, A, W, cov in non_white["train"] + non_white["eval"]:
        cases["qvar"].append(_epi_case_on(torch, qvar, label, A, W, None, cov,
                                          "qvar"))
        cases["qvar"][-1]["max_abs_A"] = float(A.abs().max())
    for label, D, cov, form in EPI_CASES:
        cases[form].append(_epi_case(torch, qvar, gen, label, S_SERVE,
                                     B_SERVE, D, cov, form))
    for n in (B_TRAIN, B_BIG):
        for label, D, cov in EPI_TRAIN_CASES:
            cases["epi"].append(_epi_case(torch, qvar, gen, label, L_TRAIN,
                                          n, D, cov, "epi"))
    A, W, q_mu = _epi_inputs(torch, gen, 2, 8, 1000, False)
    ragged, _ = _epi_check(torch, qvar, "ragged N=1000, root D=8", A, W,
                           q_mu, False, "epi")
    edges = {}
    for L, m, n, d, cov, form in EPI_EDGE_CASES:
        label = f"L={L} M={m} N={n} D={d} {'cov' if cov else 'root'} {form}"
        A, W, q_mu = _epi_inputs(torch, gen, L, d, n, cov, m)
        edges[label], _ = _epi_check(torch, qvar, label, A, W, q_mu, cov,
                                     form)
    # fixed-order sums, no atomics: two launches are bitwise equal
    determinism = {}
    for L, n, d, cov in ((S_SERVE, B_SERVE, 8, False),
                         (L_TRAIN, B_TRAIN, 8, False),
                         (L_TRAIN, B_BIG, 1, True)):
        A, W, q_mu = _epi_inputs(torch, gen, L, d, n, cov)
        a, b = qvar.epi_fused(A, W, q_mu, cov), qvar.epi_fused(A, W, q_mu, cov)
        for name, x, y in zip(("qv", "ss", "mean"), a, b):
            if not torch.equal(x, y):
                fail(f"epilogue is not deterministic: {name} differs between "
                     f"two launches (A [{L},{M},{n}], D={d}, cov={cov})")
        determinism[f"A [{L},{M},{n}] D={d} {'cov' if cov else 'root'}"] = \
            "bitwise equal"
    del A, W, q_mu
    torch.cuda.empty_cache()
    rows = [_entry(f"epilogue:{form}", "dgps_with_iwvi_torch/csrc/epilogue.cu",
                   K2_REPLACES[form], cases[form],
                   "qv 1e-4, ss 1e-5, mean 1e-4 x max|plain|")
            for form in ("epi", "ps", "qvar")]
    rows[0]["ragged_errs"] = ragged
    rows[0]["edge_errs"] = edges
    rows[0]["determinism"] = determinism
    return rows


BWD_FORMS = [
    # (label, form, D, cov)
    ("epi, root D=8 (inner layer)", "epi", 8, False),
    ("epi, cov D=1 (natgrad final layer)", "epi", 1, True),
    ("epi, cov D=3 (multiclass natgrad final layer)", "epi", 3, True),
    ("ps, root D=8", "ps", 8, False),
    ("qvar only, root D=8", "qvar", 8, False),
]
L_TRAIN, B_TRAIN, B_BIG = 20, 512, 8192


def _bwd_inputs(torch, gen, L, m, n, d, cov):
    A, W, q_mu = _epi_inputs(torch, gen, L, d, n, cov, m)
    g_qv, g_mn = (torch.randn((L, d, n), generator=gen, device="cuda")
                  for _ in range(2))
    g_ss = torch.randn((L, n), generator=gen, device="cuda")
    return A, W, q_mu, g_qv, g_ss, g_mn


def _bwd_call(qvar, form, A, W, q_mu, g_qv, g_ss, g_mn, cov, plain):
    if form == "epi":
        f = qvar.epi_bwd_plain if plain else qvar.epi_bwd_fused
        return f(A, W, q_mu, g_qv, g_ss, g_mn, cov)
    if form == "ps":
        f = qvar.ps_bwd_plain if plain else qvar.ps_bwd_fused
        return f(A, W, g_qv, g_ss, cov)
    f = qvar.qvar_bwd_plain if plain else qvar.qvar_bwd_fused
    return f(A, W, g_qv, cov)


def _bwd_padded_plain(torch, qvar, form, A, W, q_mu, g_qv, g_ss, g_mn, cov,
                      m_to=128):
    """The plain version of K3's inputs zero-padded from M to m_to rows (A,
    q_mu) and rows and columns (W), its outputs cut back to M: the same
    function, zero rows adding nothing to any sum. At an M that is not a
    multiple of 8, cuBLAS takes another kernel for the plain version's bf16
    products, whose order of sums over M moves some elements of T across a
    bf16 rounding boundary against K3's (which pads M to 128 with zeros);
    dt then differs by a bf16 unit there, and dA by up to 5e-4 of its
    largest value, with K3's earlier five-launch design as with this one
    (``ab_kernels`` records both)."""
    F = torch.nn.functional
    m, p = A.shape[-2], m_to - A.shape[-2]
    out = _bwd_call(qvar, form, F.pad(A, (0, 0, 0, p)), F.pad(W, (0, p, 0, p)),
                    F.pad(q_mu, (0, 0, 0, p)), g_qv, g_ss, g_mn, cov,
                    plain=True)
    cut = (out[0][..., :m, :], out[1][:, :m, :m])
    return cut + ((out[2][:m],) if len(out) > 2 else ())


def _rel_errs(got, ref) -> list:
    return [max_err(g, r) / float(r.abs().max()) for g, r in zip(got, ref)]


def epilogue_bwd_phase(torch, hopper, gen, non_white) -> tuple:
    """K3 against its plain version in every form at the training shapes
    A [20,128,512] and [20,128,8192], the q-variance-only form first at a
    non-whitened step's own A (``non_white_qvar_inputs``, its main path),
    at M=100, and its determinism."""
    qvar, cost = hopper.qvar, hopper.cost
    names = {"epi": ("dA", "dW", "dq_mu"), "ps": ("dA", "dW"),
             "qvar": ("dA", "dW")}
    # both sides round the same operands to bf16 into f32 products; the
    # order of the f32 sums differs, and where it moves T across a bf16
    # rounding boundary, dt moves by one bf16 unit. dA sums M*D products per
    # element; dW and dq_mu sum 20*N over the whole grid (per-tile blocks
    # and a fixed-order sum of partials against one cuBLAS reduction):
    # measured 1.8e-4 of max|plain| at N=8192 on an H100
    tol = {"dA": 1e-4, "dW": 1e-3, "dq_mu": 1e-3}
    cases = {"epi": [], "ps": [], "qvar": []}
    for label, A, W, cov in non_white["train"]:
        d = W.shape[0]
        g_qv = torch.randn((L_TRAIN, d, B_TRAIN), generator=gen,
                           device="cuda")
        args = (A, W, None, g_qv, None, None)
        got = _bwd_call(qvar, "qvar", *args, cov, plain=False)
        ref = _bwd_call(qvar, "qvar", *args, cov, plain=True)
        errs, rels = _compare(torch, f"epilogue_bwd [{label}]", got, ref,
                              names["qvar"], tol)
        b_ms, b_by = cost.bound(*cost.epilogue_bwd(L_TRAIN, M, B_TRAIN, d,
                                                   "qvar"))
        cases["qvar"].append({
            "case": label, "shape": f"A [{L_TRAIN},{M},{B_TRAIN}], W "
            f"[{d},{M},{M}]", "max_abs_err": max(errs.values()),
            "max_rel_err": max(rels.values()), "errs": errs,
            "max_abs_A": float(A.abs().max()),
            "ms": time_ms(torch, lambda: _bwd_call(qvar, "qvar", *args, cov,
                                                   False), 20),
            "device_ms": device_ms(torch, lambda: _bwd_call(
                qvar, "qvar", *args, cov, False)),
            "plain_ms": time_ms(torch, lambda: _bwd_call(
                qvar, "qvar", *args, cov, True), 3, 1),
            "bound_ms": b_ms, "bound_by": b_by})
    for n in (B_TRAIN, B_BIG):
        for label, form, d, cov in BWD_FORMS:
            args = _bwd_inputs(torch, gen, L_TRAIN, M, n, d, cov)
            got = _bwd_call(qvar, form, *args, cov, plain=False)
            ref = _bwd_call(qvar, form, *args, cov, plain=True)
            errs, rels = _compare(torch, f"epilogue_bwd [{label}, N={n}]",
                                  got, ref, names[form], tol)
            ms = time_ms(torch, lambda: _bwd_call(qvar, form, *args, cov,
                                                  False), 20)
            plain_ms = time_ms(torch, lambda: _bwd_call(qvar, form, *args,
                                                        cov, True), 3, 1)
            b_ms, b_by = cost.bound(*cost.epilogue_bwd(L_TRAIN, M, n, d,
                                                       form))
            cases[form].append({
                "case": label, "shape": f"A [{L_TRAIN},{M},{n}], W "
                f"[{d},{M},{M}]", "max_abs_err": max(errs.values()),
                "max_rel_err": max(rels.values()), "errs": errs, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by})
            del args, got, ref
            torch.cuda.empty_cache()
    # M=100: one chunk padded with zeros in the kernel, held to the plain
    # version of the zero-padded inputs (_bwd_padded_plain); the reading
    # against the unpadded plain version is recorded
    args = _bwd_inputs(torch, gen, L_TRAIN, 100, B_TRAIN, 8, False)
    got = _bwd_call(qvar, "epi", *args, False, plain=False)
    m100, _ = _compare(torch, "epilogue_bwd [M=100, epi root D=8]", got,
                       _bwd_padded_plain(torch, qvar, "epi", *args, False),
                       names["epi"], tol)
    m100["rel_vs_unpadded_plain"] = _rel_errs(
        got, _bwd_call(qvar, "epi", *args, False, plain=True))
    # the IW-vs-VI experiment's shapes: M=64 at B=512 (natgrad final layer,
    # cov D=1, and an inner layer, root D=1) and M=16 at B=256
    small_m = {}
    for L, m, n, cov in ((20, 64, 512, True), (20, 64, 512, False),
                         (10, 16, 256, True)):
        label = f"L={L} M={m} N={n} D=1 {'cov' if cov else 'root'} epi"
        args = _bwd_inputs(torch, gen, L, m, n, 1, cov)
        got = _bwd_call(qvar, "epi", *args, cov, plain=False)
        small_m[label], _ = _compare(
            torch, f"epilogue_bwd [{label}]", got,
            _bwd_padded_plain(torch, qvar, "epi", *args, cov), names["epi"],
            tol)
    # no float atomics: two launches give bitwise-equal sums over the grid
    determinism = {}
    for n in (B_TRAIN, B_BIG):
        for cov in (False, True):
            args = _bwd_inputs(torch, gen, L_TRAIN, M, n, 8, cov)
            a = qvar.epi_bwd_fused(*args, cov)
            b = qvar.epi_bwd_fused(*args, cov)
            for name, x, y in zip(names["epi"], a, b):
                if not torch.equal(x, y):
                    fail(f"epilogue_bwd is not deterministic: {name} differs "
                         f"between two launches (cov={cov}, N={n})")
            determinism[f"{'cov' if cov else 'root'} N={n}"] = \
                "bitwise equal"
    rows = [_entry(f"epilogue_bwd:{form}",
                   "dgps_with_iwvi_torch/csrc/epilogue_bwd.cu",
                   K3_REPLACES[form], cases[form],
                   "dA 1e-4, dW and dq_mu 1e-3 x max|plain|")
            for form in cases]
    return rows, {"m100_errs": m100, "small_m_errs": small_m,
                  "determinism": determinism}


# the harness phase's evaluation: the kin8nm surrogate's 820 test rows go
# through in one chunk at S=100, so K4 sees N = 82,000 rows, whose last
# 128-row tile is partial (82,000 = 640 x 128 + 80)
HARNESS_TEST_ROWS, HARNESS_SAMPLES = 820, 100
FUSED_CASES = [
    # (label, N, d_in, M, D, layer): layer names the main path's shapes
    ("serving inner layer", S_SERVE * B_SERVE, D_X + 1, M, D_X, "inner"),
    ("serving final layer", S_SERVE * B_SERVE, D_X, M, 1, "final"),
    ("training inner layer", 20 * 512, D_X + 1, M, D_X, "train"),
    ("training final layer (Adam only)", 20 * 512, D_X, M, 1, "train_final"),
    ("harness test set inner layer", HARNESS_TEST_ROWS * HARNESS_SAMPLES,
     D_X + 1, M, D_X, None),
    ("harness test set final layer", HARNESS_TEST_ROWS * HARNESS_SAMPLES,
     D_X, M, 1, None),
    ("multiclass test set final layer, D=3",
     HARNESS_TEST_ROWS * HARNESS_SAMPLES, D_X, M, 3, "multiclass"),
    ("ragged N=1000", 1000, D_X + 1, M, D_X, None),
    ("M=100", 1000, D_X + 1, 100, D_X, None),
    ("M=200", 1000, D_X + 1, 200, D_X, None),
    # the IW-vs-VI experiment's evaluation at S=500: LG's final layer
    # (input x and w, d_in=2) on phase 14's 512 test rows at M=16 (K4 held
    # by ``_k4_flip_check``) and on the full size's 2000 rows at M=64
    ("iw_vs_vi pin test set final layer, M=16", 500 * 512, 2, 16, 1, None),
    ("iw_vs_vi test set final layer, M=64", 500 * 2000, 2, 64, 1, None),
]
K4_REPLACES = "dgps_with_iwvi_tpu/ops/pallas/serve_cond.py:73"
K5_REPLACES = {"fused": "dgps_with_iwvi_tpu/ops/pallas/conditional.py:51",
               "sample": "dgps_with_iwvi_tpu/ops/pallas/conditional.py:93"}
# K5 is true f32 on both sides: only the order of the f32 sums differs. K4
# rounds the same operands to bf16 as its plain version, but A comes out of
# sums in another order, and where that moves an element of A across a bf16
# rounding boundary, bf16(A) moves by one bf16 unit and the q-variance by up
# to 2^-8 of one of its M terms; the sample carries that through its sd.
# The largest reading on the H100 was 8.7e-4 of max|plain| (var, serving
# inner layer); the sample's and var's limit sits a little over twice that
K4_TOL = {"sample": 2e-3, "mean": 1e-4, "var": 2e-3}
# That limit holds from M=64 up (8.4e-4 at M=64). With fewer terms one
# flipped bf16(A) element is a larger share of the q-variance: on an H100
# 80GB HBM3 at 700 W, K4's var lay 2.9e-3 of max|plain| from its plain
# version at M=16, while both lay 4.7e-3 from the unrounded float64
# function, equal to four digits. Below K4_FLAT_M, ``_k4_flip_check``
# holds var and the sample element by element to the bound of at most
# FLIPS_PER_ROW such flips in a row; at most FLIP_SHARE of all elements,
# and TILE_SHARE of one K4 tile's, may differ by more than K4_TOL's mean
# share of max|plain|: flips are scattered, a fault of a tile or warp is
# not.
K4_FLAT_M = 64
BF16_ULP = 2.0 ** -7   # a bf16 unit, relative to |x|, at most
FLIPS_PER_ROW = 2
FLIP_SHARE = 0.005
K4_TILE_ROWS = 128     # rows of one K4 tile (csrc/serve_cond.cu chain_kernel)
K4_WARP_ROWS = 16      # rows of one warp (kRows)
TILE_SHARE = 1 / 16    # 8 rows of a tile: half a warp's
# planted faults of _k4_fault_probe: relative sizes 1e-6 .. 1
FAULT_LADDER = [10.0 ** (e / 4) for e in range(-24, 1)]
K5_TOL = {"sample": 1e-5, "mean": 1e-5, "var": 1e-5, "kxz": 1e-5, "a": 1e-5}


def _cond_inputs(torch, gen, n, m, d_in, d):
    """Scaled xs, zs, var, Linv (of a random SPD gram), q_mu, Lq on the
    card."""
    xs = 0.5 * torch.randn((n, d_in), generator=gen, device="cuda")
    zs = 0.5 * torch.randn((m, d_in), generator=gen, device="cuda")
    var = torch.tensor(1.7, device="cuda")
    R = torch.randn((m, m), generator=gen, device="cuda", dtype=torch.float64)
    eye = torch.eye(m, device="cuda", dtype=torch.float64)
    linv = (3.0 * torch.linalg.inv(torch.linalg.cholesky(R @ R.T + m * eye))
            ).float()
    q_mu = torch.randn((m, d), generator=gen, device="cuda")
    lq = 0.3 * torch.tril(torch.randn((d, m, m), generator=gen, device="cuda"))
    return xs, zs, var, linv, q_mu, lq


def _k4_flip_limits(torch, ref, args, eps) -> tuple:
    """Per-element limits of ``_k4_flip_check`` for K4's outputs `ref`
    (its plain version's) on `args`, with `eps` or None: (names, limit,
    slack, dist). One bf16(A) element a_j that the two sides round to
    neighbouring values moves by u_j <= BF16_ULP |a_j|, and the q-variance
    sum_k t_dk^2 (t_d = bf16(A) tril(bf16(Lq_d))) by at most
    b_j = sum_d 2 u_j |(t_d tril(Lq_d)^T)_j| + 2 u_j^2 |row j of Lq_d|^2
    (the square term doubled for the cross term of two flips). A row's
    var limit is the sum of its FLIPS_PER_ROW largest b_j plus `slack`,
    K4_TOL's mean share of max|plain| for the order of the f32 sums; the
    sample's adds |eps| times the sd's share of it; the mean's is the
    slack. `dist`: each side's mean and var from the unrounded float64
    function relative to max|plain|, filled by ``_k4_flip_check``."""
    xs, zs, var, linv, q_mu, lq = (t.double() for t in args)
    d2 = torch.clamp((xs * xs).sum(1, keepdim=True) - 2.0 * xs @ zs.T
                     + (zs * zs).sum(1)[None], min=0.0)
    a = (var * torch.exp(-0.5 * d2)) @ linv.T                 # [N, M]
    ltri = torch.tril(lq.to(torch.bfloat16).double())        # [D, M, M]
    t = a.to(torch.bfloat16).double()[None] @ ltri           # [D, N, M]
    u = BF16_ULP * a.abs()
    b = (2.0 * u[None] * (t @ ltri.transpose(-1, -2)).abs()
         + 2.0 * u[None] ** 2 * (ltri * ltri).sum(-1)[:, None]).sum(0)
    flips = torch.topk(b, min(FLIPS_PER_ROW, b.shape[1]), dim=1).values.sum(
        1, keepdim=True)                                     # [N, 1]
    unrounded = {"mean": a @ q_mu, "var": torch.clamp(
        var - (a * a).sum(1, keepdim=True), min=0.0)
        + (a[None] @ torch.tril(lq)).square().sum(-1).T}
    del a, t, u, b
    names = (("sample",) if eps is not None else ()) + ("mean", "var")
    out = dict(zip(names, ref))
    slack = {k: K4_TOL["mean"] * float(v.abs().max()) for k, v in out.items()}
    dv = flips + slack["var"]
    limit = {"mean": torch.full_like(flips, slack["mean"]), "var": dv}
    if eps is not None:
        sd = torch.sqrt(torch.clamp(out["var"].double(), min=1e-12))
        limit["sample"] = (slack["mean"] + slack["sample"] + eps.abs().double()
                           * torch.minimum(dv / sd, torch.sqrt(dv)))
    return names, limit, slack, unrounded


def _k4_flip_verdict(torch, names, got, ref, limit, slack) -> tuple:
    """(problems, errs, shares) of `got` against `ref` under the limits of
    ``_k4_flip_limits``: an output fails where an element is past its
    limit, or more than FLIP_SHARE of all its elements or TILE_SHARE of
    one K4 tile's are past the slack. `shares`: by output, the share of
    all elements past the slack and the largest share of one tile's."""
    problems, errs, shares = [], {}, {}
    for name, g, r in zip(names, got, ref):
        if g.shape != r.shape or not bool(torch.isfinite(g).all()):
            problems.append(f"{name} shape {tuple(g.shape)} vs "
                            f"{tuple(r.shape)} or non-finite")
            continue
        diff = (g.double() - r.double()).abs()
        over = int((diff > limit[name]).sum())
        moved = (diff > slack[name]).double()
        pad = -moved.shape[0] % K4_TILE_ROWS
        tiles = torch.nn.functional.pad(moved, (0, 0, 0, pad)).reshape(
            -1, K4_TILE_ROWS * moved.shape[1]).mean(1)
        share, tile = float(moved.mean()), float(tiles.max())
        shares[name] = {"all": share, "tile": tile}
        errs[name] = float(diff.max())
        if over or share > FLIP_SHARE or tile > TILE_SHARE:
            problems.append(
                f"{name}: {over} elements past the bf16 flip bound, a share "
                f"{share} past {K4_TOL['mean']} of max|plain| (at most "
                f"{FLIP_SHARE}), {tile} of one tile's (at most "
                f"{TILE_SHARE}), max |err| {errs[name]}")
    return problems, errs, shares


def _k4_fault_probe(torch, names, got, ref, limit, slack) -> dict:
    """The smallest planted fault of FAULT_LADDER that
    ``_k4_flip_verdict`` fails, on K4's own var: every row scaled by
    (1 + d), one K4 tile's K4_TILE_ROWS rows or one warp's K4_WARP_ROWS
    scaled by (1 + d), one row's var (the row whose limit is the
    median's) shifted by d max|plain|;
    with the quantiles of the var limit relative to max|plain|, which
    say which fault of one element passes."""
    i = names.index("var")
    v, top = got[i], float(ref[i].abs().max())
    rel = (limit["var"].flatten() / top).cpu()
    mid = int(torch.argsort(rel)[rel.numel() // 2])
    faults = {
        "every row x (1+d)": lambda d: v * (1.0 + d),
        f"one {K4_TILE_ROWS}-row tile x (1+d)": lambda d: torch.cat(
            [v[:K4_TILE_ROWS] * (1.0 + d), v[K4_TILE_ROWS:]]),
        f"one warp's {K4_WARP_ROWS} rows x (1+d)": lambda d: torch.cat(
            [v[:K4_WARP_ROWS] * (1.0 + d), v[K4_WARP_ROWS:]]),
        "one element + d max|plain|": lambda d: v.index_put(
            (torch.tensor([mid], device=v.device),),
            v[mid] + d * top),
    }
    caught = {}
    for label, plant in faults.items():
        caught[label] = None
        for d in FAULT_LADDER:
            bad = list(got)
            bad[i] = plant(d)
            if _k4_flip_verdict(torch, names, bad, ref, limit, slack)[0]:
                caught[label] = d
                break
    q = torch.quantile(rel.double(), torch.tensor([0.5, 0.99, 1.0],
                                                  dtype=torch.float64))
    return {"smallest_caught": caught,
            "var_limit_rel_quantiles": {"median": float(q[0]),
                                        "p99": float(q[1]),
                                        "max": float(q[2])}}


def _k4_flip_check(torch, what, got, ref, args, eps, probe=False) -> tuple:
    """K4 against its plain version below K4_FLAT_M, where the two may
    round an element of A to neighbouring bf16 values: fails unless
    ``_k4_flip_verdict`` passes under ``_k4_flip_limits``. Returns (errs,
    rels) by output as ``_compare`` does, and a record: each output's
    shares past the slack, each side's distance from the unrounded float64
    function relative to max|plain|, and with `probe` the planted faults
    that the check catches (``_k4_fault_probe``)."""
    names, limit, slack, unrounded = _k4_flip_limits(torch, ref, args, eps)
    problems, errs, shares = _k4_flip_verdict(torch, names, got, ref, limit,
                                              slack)
    if problems:
        fail(f"{what}: " + "; ".join(problems))
    out = dict(zip(names, ref))
    rec = {"share_past_slack": shares, "share_limits": {
        "all": FLIP_SHARE, "tile": TILE_SHARE}}
    for side, outs in (("kernel", got), ("plain", ref)):
        for k, v in zip(names, outs):
            if k in unrounded:
                rec[f"vs_unrounded_f64_{side}_{k}"] = (
                    float((v.double() - unrounded[k]).abs().max())
                    / float(out[k].abs().max()))
    if probe:
        rec["fault_probe"] = _k4_fault_probe(torch, names, got, ref, limit,
                                             slack)
    rels = {k: errs[k] / float(out[k].abs().max()) for k in errs}
    return errs, rels, rec


def fused_phase(torch, hopper, gen) -> tuple:
    """K4 (with and without the sample) and K5 (fused and sample, with
    their residuals) against their plain versions at the serving and
    training shapes, a ragged N, M=100 and M=200; K5's sample element by
    element against the plain Philox stream; the recovered eps over 8.4M
    draws; two launches with one seed bitwise equal, two seeds apart."""
    from dgps_with_iwvi_torch.ops.hopper import build

    k4, k5, cost = hopper.serve_cond, hopper.conditional, hopper.cost
    cases = {"serve_cond:sample": [], "serve_cond:infer": [],
             "conditional:fused": [], "conditional:sample": []}
    seed = torch.tensor(2 ** 40 + 12345, dtype=torch.int64, device="cuda")
    for label, n, d_in, m, d, layer in FUSED_CASES:
        args = _cond_inputs(torch, gen, n, m, d_in, d)
        eps = torch.randn((n, d), generator=gen, device="cuda")
        shape = f"xs [{n},{d_in}], M={m}, D={d}"

        def k4_call(with_eps, plain=False):
            if plain:
                with build.plain_versions():
                    return k4.fused_conditional_infer(*args, eps if with_eps
                                                      else None)
            return k4.fused_conditional_infer(*args, eps if with_eps else None)

        def k5_call(s, residuals, plain=False):
            if plain:
                with build.plain_versions():
                    out = k5.fused_forward(*args, s, residuals=residuals)
            else:
                out = k5.fused_forward(*args, s, residuals=residuals)
            return [t for t in (out[2], out[0], out[1], out[3], out[4])
                    if t is not None]

        for name, with_eps in (("serve_cond:sample", True),
                               ("serve_cond:infer", False)):
            names = (("sample",) if with_eps else ()) + ("mean", "var")
            flip = None
            if m < K4_FLAT_M:
                errs, rels, flip = _k4_flip_check(
                    torch, f"serve_cond [{label}]", k4_call(with_eps),
                    k4_call(with_eps, True), args, eps if with_eps else None,
                    probe=not with_eps)
            else:
                errs, rels = _compare(torch, f"serve_cond [{label}]",
                                      k4_call(with_eps),
                                      k4_call(with_eps, True), names, K4_TOL)
            case = {"case": label, "shape": shape, "errs": errs,
                    "rels": rels, "max_abs_err": max(errs.values()),
                    "max_rel_err": max(rels.values())}
            if flip is not None:
                case["flip_check"] = flip
            if (layer == "inner") == with_eps and layer in ("inner", "final"):
                case["ms"] = time_ms(torch, lambda: k4_call(with_eps), 10)
                case["device_ms"] = device_ms(torch,
                                              lambda: k4_call(with_eps))
                case["plain_ms"] = time_ms(torch, lambda: k4_call(with_eps,
                                                                  True), 2, 1)
                case["bound_ms"], case["bound_by"] = cost.bound(
                    *cost.serve_cond(n, d_in, m, d, with_eps))
                cases[name].insert(0, case)
            else:
                if layer == "multiclass" and not with_eps:
                    # the new shape of the families phase, timed as well
                    case["ms"] = time_ms(torch, lambda: k4_call(False), 10)
                    case["device_ms"] = device_ms(torch,
                                                  lambda: k4_call(False))
                    case["plain_ms"] = time_ms(
                        torch, lambda: k4_call(False, True), 2, 1)
                    case["bound_ms"], case["bound_by"] = cost.bound(
                        *cost.serve_cond(n, d_in, m, d, False))
                cases[name].append(case)
        for name, s in (("conditional:fused", None),
                        ("conditional:sample", seed)):
            names = (("sample",) if s is not None else ()) + (
                "mean", "var", "kxz", "a")
            errs, rels = _compare(torch, f"conditional [{label}]",
                                  k5_call(s, True), k5_call(s, True, True),
                                  names, K5_TOL)
            case = {"case": label, "shape": shape, "errs": errs,
                    "rels": rels, "max_abs_err": max(errs.values()),
                    "max_rel_err": max(rels.values())}
            is_main = (layer == "final") if s is None else (layer == "inner")
            is_train = (layer == "train_final") if s is None else (
                layer == "train")
            if is_main or is_train:
                # prediction runs without residuals; training writes them
                res = is_train
                case["residuals"] = res
                case["ms"] = time_ms(torch, lambda: k5_call(s, res), 5)
                case["device_ms"] = device_ms(torch, lambda: k5_call(s, res))
                case["plain_ms"] = time_ms(torch, lambda: k5_call(s, res,
                                                                  True), 2, 1)
                case["bound_ms"], case["bound_by"] = cost.bound(
                    *cost.conditional(n, d_in, m, d, s is not None, res))
                if is_main:
                    case["ms_with_residuals"] = time_ms(
                        torch, lambda: k5_call(s, True), 5)
            if is_main:
                cases[name].insert(0, case)
            else:
                cases[name].append(case)
        del args, eps
        torch.cuda.empty_cache()

    # the in-kernel noise: recovered eps = (sample - mean) / sd
    args = _cond_inputs(torch, gen, 1 << 20, M, D_X + 1, D_X)
    mean, v, samp = k5.fused_forward(*args, seed, residuals=False)[:3]
    rec_eps = ((samp - mean) / torch.sqrt(v))[v > 0].double()
    n_draws = rec_eps.numel()
    p3 = 2.6997961e-3
    moments = {"draws": n_draws, "mean": float(rec_eps.mean()),
               "var": float(rec_eps.var()),
               "beyond_3": float((rec_eps.abs() > 3).double().mean())}
    limits = {"mean": 5 / n_draws ** 0.5, "var": 5 * (2.0 / n_draws) ** 0.5,
              "beyond_3": 5 * (p3 * (1 - p3) / n_draws) ** 0.5}
    if not (n_draws >= 8_000_000
            and abs(moments["mean"]) <= limits["mean"]
            and abs(moments["var"] - 1.0) <= limits["var"]
            and abs(moments["beyond_3"] - p3) <= limits["beyond_3"]):
        fail(f"conditional:sample noise is not standard normal: {moments} "
             f"(5 standard errors: {limits})")
    again = k5.fused_forward(*args, seed, residuals=False)[2]
    other = k5.fused_forward(*args, seed + 1, residuals=False)[2]
    if not torch.equal(again, samp):
        fail("conditional:sample: two launches with one seed differ")
    if torch.equal(other, samp):
        fail("conditional:sample: two seeds give the same draws")
    checks = {"eps_moments": moments, "five_se": limits,
              "same_seed": "bitwise equal", "other_seed": "differs"}
    del args, samp, mean, v, rec_eps, again, other
    torch.cuda.empty_cache()

    src4 = "dgps_with_iwvi_torch/csrc/serve_cond.cu"
    src5 = "dgps_with_iwvi_torch/csrc/conditional.cu"
    rows = [_entry(name, src4, K4_REPLACES, cases[name],
                   "sample 2e-3, mean 1e-4, var 2e-3 x max|plain|")
            for name in ("serve_cond:sample", "serve_cond:infer")]
    rows += [_entry(name, src5, K5_REPLACES[name.split(":")[1]], cases[name],
                    "every output 1e-5 x max|plain|")
             for name in ("conditional:fused", "conditional:sample")]
    return rows, checks


def synthetic(seed: int = 0):
    """bench.py's serving data: X ~ N(0, 1) [B, 8], Y = sin(X0) + 0.1 e."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((B_SERVE, D_X)).astype(np.float32)
    Y = (np.sin(X[:, :1]) + 0.1 * rng.standard_normal((B_SERVE, 1))
         ).astype(np.float32)
    return X, Y


def random_q(torch, params):
    """A random q(u) from seed 1 on the GP layers 1 and 2 of an LGG
    model, in place: q_mu ~ 0.5 N(0, 1) and q_sqrt = 0.02 tril(N(0, 1))
    + (0.3, 0.5) I. At q_sqrt = I the whitened prior and q-variance terms
    cancel exactly, and the hyperparameter gradients are rounding noise
    in either path."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    for i, scale in ((1, 0.3), (2, 0.5)):
        lp = params["layers"][i]
        lp["q_mu"] = 0.5 * torch.randn(lp["q_mu"].shape, generator=gen,
                                       device="cuda")
        lp["q_sqrt"] = (0.02 * torch.tril(torch.randn(
            lp["q_sqrt"].shape, generator=gen, device="cuda"))
            + scale * torch.eye(M, device="cuda"))


def served_model(torch):
    """(X, Y, config, params, build_s): LGG built from seed 0 on bench.py's
    synthetic data, with a random q(u) from seed 1, on the card."""
    from dgps_with_iwvi_torch.models import BuildArgs, build_model

    X, Y = synthetic(0)
    args = BuildArgs(configuration="LGG", mode="IW", num_inducing=M,
                     num_iw_samples=20)
    t0 = time.perf_counter()
    config, params = build_model(0, args, X[:2048], Y[:2048], device="cuda")
    # random q(u) from the seed, so the mean and every variance term count
    random_q(torch, params)
    torch.cuda.synchronize()
    return X, Y, config, params, time.perf_counter() - t0


def served_kuu(torch, config, params):
    """The stacked Kuu grams that prefactor_gp_layers factors in one K1
    launch, [G, M, M]."""
    from dgps_with_iwvi_torch.models.layers import GPLayerConfig, layer_Kuu

    return torch.stack([layer_Kuu(params["layers"][i], cfg)
                        for i, cfg in enumerate(config.layers)
                        if isinstance(cfg, GPLayerConfig)])


def _requests(X, Y):
    """(Xs, Ys, stats): REQUESTS batches of B_SERVE rows like bench.py's
    data, and the build split's normalization statistics."""
    from dgps_with_iwvi_torch.serving import NormalizationStats

    rng = np.random.default_rng(1)
    n = REQUESTS * B_SERVE
    Xs = rng.standard_normal((n, D_X)).astype(np.float32)
    Ys = (np.sin(Xs[:, :1]) + 0.1 * rng.standard_normal((n, 1))
          ).astype(np.float32)
    stats = NormalizationStats(X.mean(0, keepdims=True),
                               X.std(0, keepdims=True),
                               Y.mean(0, keepdims=True),
                               Y.std(0, keepdims=True))
    return Xs, Ys, stats


def _served_agreement(out, plain, what, tol=1e-3) -> dict:
    """The first batches of a served run against the same batches through
    the plain versions on the card: same rounding classes on both paths;
    the f32 sums run in another order and the difference passes through
    the inner layer's sample."""
    agree = {}
    for k in ("mean", "var", "log_density"):
        a, b = out[k][:plain[k].shape[0]], plain[k]
        err = float(np.max(np.abs(a - b) / (1.0 + np.abs(b))))
        if not err <= tol:
            fail(f"{what} {k}: kernels vs plain versions differ by {err} "
                 f"(tol {tol}, |a-b|/(1+|b|))")
        agree[k] = err
    return agree


def slice_phase(torch, model, rec: dict, profile: bool) -> dict:
    """The served model on the K2 route (``serve_pallas=False``)."""
    import dataclasses

    from dgps_with_iwvi_torch.experiments import profile_step
    from dgps_with_iwvi_torch.models import predict_y_and_log_density
    from dgps_with_iwvi_torch.ops.hopper import build
    from dgps_with_iwvi_torch.params import params_to_device
    from dgps_with_iwvi_torch.serving import Scorer

    X, Y, config, params, build_s = model
    config = dataclasses.replace(config, serve_pallas=False)
    n = REQUESTS * B_SERVE
    Xs, Ys, stats = _requests(X, Y)
    scorer = Scorer(params, config, S_SERVE, stats, device="cuda")
    scorer.score(Xs[:B_SERVE], Ys[:B_SERVE], seed=0)          # warm-up

    build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = scorer.score(Xs, Ys, seed=100, max_batch=B_SERVE)
    serve_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = _path_counts(build)
    for name in ("chol_inv", "epilogue:epi"):
        if counts.get(name, 0) <= 0:
            fail(f"kernel {name} was not launched on the serving path")
    for k, v in out.items():
        if v.shape[0] != n or not np.all(np.isfinite(v)):
            fail(f"served {k} has shape {v.shape} or non-finite values")
    if not np.all(out["var"] > 0):
        fail("served variances are not positive")

    # plain versions on the card, same batch, same generator seed
    with build.plain_versions():
        scorer.score(Xs[:B_SERVE], Ys[:B_SERVE], seed=100)    # warm-up
        t0 = time.perf_counter()
        plain = scorer.score(Xs[:2 * B_SERVE], Ys[:2 * B_SERVE], seed=100)
        plain_s = time.perf_counter() - t0
    agree = _served_agreement(out, plain, "serving")

    # a small batch against the port's CPU path (held to JAX by the tests)
    Bs, Ss = 256, 8
    xb = torch.from_numpy((Xs[:Bs] - stats.x_mean) / stats.x_std)
    yb = torch.from_numpy((Ys[:Bs] - stats.y_mean) / stats.y_std)
    g = torch.Generator().manual_seed(3)
    eps = [torch.randn((Ss, Bs, 1), generator=g),
           torch.randn((Ss, Bs, config.layers[1].d_out), generator=g), None]
    (mg, vg), ldg = predict_y_and_log_density(
        params, config, xb.cuda(), yb.cuda(), None, Ss,
        eps=[e if e is None else e.cuda() for e in eps])
    (mc, vc), ldc = predict_y_and_log_density(
        params_to_device(params, "cpu"), config, xb, yb, None, Ss, eps=eps)
    cpu_err = {k: float(np.max(np.abs(a.cpu().numpy() - b.numpy())
                               / (1.0 + np.abs(b.numpy()))))
               for k, a, b in (("mean", mg, mc), ("var", vg, vc),
                               ("log_density", ldg, ldc))}
    for k, err in cpu_err.items():
        if not err <= 1e-3:
            fail(f"card vs CPU path, {k}: {err} > 1e-3")

    if profile:
        rec["profile"] = profile_step.profile_serve(scorer, Xs, Ys,
                                                    B_SERVE)
    return {
        "model": "LGG d_x=8 M=128 inner width 8, random q(u) from seed 1",
        "build_s": build_s, "requests": REQUESTS, "batch": B_SERVE,
        "samples": S_SERVE, "serve_s": serve_s,
        "points_per_s": n / serve_s,
        "plain_points_per_s": 2 * B_SERVE / plain_s,
        "peak_mem_gib": peak_gb,
        "launches": counts,
        "vs_plain_on_card": agree, "vs_cpu_path": cpu_err,
        "mean_log_density": float(np.mean(out["log_density"])),
    }


PALLAS_SERVE = [
    # (label, DGPConfig fields replaced, launches per request); the
    # default config's serve_pallas="auto" takes K4 in inference
    ("serve_pallas", {},
     {"serve_cond:sample": 1, "serve_cond:infer": 1, "chol_inv": 1}),
    ("use_pallas", {"use_pallas": True, "serve_pallas": False},
     {"conditional:sample": 1, "conditional:fused": 1, "chol_inv": 1}),
]


def pallas_serving_phase(torch, model, profile: bool) -> dict:
    """The served model of phase 4 on its default config (serve_pallas
    "auto": K4 takes both layers) and with use_pallas=True (K5 'sample'
    the inner layer, K5 'fused' the final one): the same 8 requests
    through ``Scorer``, whose
    launch counts must be exactly the listed ones per request; the first
    two batches against the plain versions on the card (the same
    generator seeds: the same noise, and for K5 the same Philox stream).
    With `profile`, device time by kernel over two requests per route."""
    import dataclasses

    from dgps_with_iwvi_torch.experiments import profile_step
    from dgps_with_iwvi_torch.ops.hopper import build
    from dgps_with_iwvi_torch.serving import Scorer

    X, Y, config, params, _ = model
    Xs, Ys, stats = _requests(X, Y)
    n = REQUESTS * B_SERVE
    out = {}
    for label, fields, want in PALLAS_SERVE:
        cfg = dataclasses.replace(config, **fields)
        scorer = Scorer(params, cfg, S_SERVE, stats, device="cuda")
        scorer.score(Xs[:B_SERVE], Ys[:B_SERVE], seed=0)      # warm-up
        build.reset_launches()
        t0 = time.perf_counter()
        res = scorer.score(Xs, Ys, seed=100, max_batch=B_SERVE)
        serve_s = time.perf_counter() - t0
        counts = {k: v for k, v in _path_counts(build).items() if v}
        if counts != {k: v * REQUESTS for k, v in want.items()}:
            fail(f"serving {label}: launches {counts} in {REQUESTS} "
                 f"requests, want per request {want}")
        for k, v in res.items():
            if v.shape[0] != n or not np.all(np.isfinite(v)):
                fail(f"serving {label}: {k} has shape {v.shape} or "
                     "non-finite values")
        if not np.all(res["var"] > 0):
            fail(f"serving {label}: variances are not positive")
        with build.plain_versions():
            scorer.score(Xs[:B_SERVE], Ys[:B_SERVE], seed=100)  # warm-up
            t0 = time.perf_counter()
            plain = scorer.score(Xs[:2 * B_SERVE], Ys[:2 * B_SERVE],
                                 seed=100)
            plain_s = time.perf_counter() - t0
        out[label] = {"points_per_s": n / serve_s, "serve_s": serve_s,
                      "plain_points_per_s": 2 * B_SERVE / plain_s,
                      "launches": counts,
                      "vs_plain_on_card": _served_agreement(
                          res, plain, f"serving {label}"),
                      "mean_log_density": float(np.mean(res["log_density"]))}
        if label == "serve_pallas":
            # K4 draws the K2 route's noise, so the two differ only by
            # K4's bf16x3 gram and its order of sums: recorded, not gated
            default = Scorer(params, dataclasses.replace(
                config, serve_pallas=False), S_SERVE, stats,
                device="cuda").score(Xs[:2 * B_SERVE], Ys[:2 * B_SERVE],
                                     seed=100)
            out[label]["vs_k2_route"] = {
                k: float(np.max(np.abs(res[k][:2 * B_SERVE] - default[k])
                                / (1.0 + np.abs(default[k]))))
                for k in ("mean", "var", "log_density")}
        if profile:
            prof = profile_step.profile_serve(scorer, Xs, Ys, B_SERVE)
            prof["idle_share_vs_unprofiled_wall"] = (
                1.0 - prof["device_ms_per_request"] * REQUESTS
                / (serve_s * 1e3))
            out[label]["profile"] = prof
    return out


N_KIN8NM, D_KIN8NM = 7372, 8
TRAIN_STEPS, BIG_STEPS = 200, 20


def _path_counts(build) -> dict:
    """Launches since the last reset, by kernel variant."""
    counts = build.variant_launches()
    counts["chol_inv"] = build.launches()["chol_inv"]
    return counts


# a step through the kernels against the same step on other terms: the
# same rounding classes on both paths; the f32 sums run in another order,
# and a bf16 rounding boundary crossed by dt or ga moves one product term
# by a bf16 unit: the bf16 class of the reference's tolerance
# (tests/test_pallas_epilogue.py:115-117)
STEP_LOSS_TOL, STEP_GRAD_TOL = 1e-4, 2e-2


def _step_leaves(loss, g_nat, g_rest) -> tuple:
    """(loss, [(name, gradient)]) of a loss_and_grads result."""
    def tensors(tree, path):
        if isinstance(tree, dict):
            return [x for k, v in tree.items()
                    for x in tensors(v, f"{path}.{k}")]
        if isinstance(tree, (list, tuple)):
            return [x for i, v in enumerate(tree)
                    for x in tensors(v, f"{path}[{i}]")]
        return [] if tree is None else [(path, tree)]

    return loss, tensors(g_nat, "natvars") + tensors(g_rest, "rest")


def _step_gaps(got, ref) -> tuple:
    """(relative loss gap, {leaf: max gap / max|ref|}) of two
    ``_step_leaves`` results."""
    loss_rel = abs(float(got[0]) - float(ref[0])) / abs(float(ref[0]))
    return loss_rel, {name: max_err(a, b) / max(float(b.abs().max()), 1e-30)
                      for (name, a), (_, b) in zip(got[1], ref[1])}


def _grad_agreement(torch, train, config, tc, state, X, Y, idx, eps,
                    gen_seed=None, exact_params=None):
    """One step's loss and every gradient through the kernels and through
    the plain versions on the card, same state, rows and noise: the noise
    `eps`, or (gen_seed) draws from a generator seeded alike for both, so
    that K5's in-kernel stream and its plain version draw the same.

    With `exact_params` (the parameters `state` was made from), the same
    step also runs in float64 on the plain versions, and each gradient is
    held to that exact one instead: the kernels' error within 2e-2 of the
    leaf's largest exact value, or within twice the float32 plain
    versions' own error. A leaf whose exact gradient sits below float32's
    rounding of the terms that cancel into it is missed by both paths;
    kernels against plain versions cannot hold it at any limit."""
    from dgps_with_iwvi_torch.ops.hopper import build

    def run():
        gen = (None if gen_seed is None else
               torch.Generator(device="cuda").manual_seed(gen_seed))
        return _step_leaves(*train.loss_and_grads(config, tc, state, X, Y,
                                                  gen, idx=idx, eps=eps))

    loss_k, g_k = run()
    with build.plain_versions():
        loss_p, g_p = run()
    loss_rel, by_leaf = _step_gaps((loss_k, g_k), (loss_p, g_p))
    grad_rel = max(by_leaf.values())
    exact = None
    if exact_params is not None:
        def f64(tree):
            if isinstance(tree, dict):
                return {k: f64(v) for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return type(tree)(f64(v) for v in tree)
            return tree.double() if tree.is_floating_point() else tree

        state64 = train.make_trainer(config, tc)[0](f64(exact_params))
        with build.plain_versions():
            _, g_64 = _step_leaves(*train.loss_and_grads(
                config, tc, state64, X.double(), Y.double(), None, idx=idx,
                eps=[None if e is None else e.double() for e in eps]))
        exact = {}
        for (name, a), (_, b), (_, c) in zip(g_k, g_p, g_64):
            scale = max(float(c.abs().max()), 1e-300)
            exact[name] = {"kernels": max_err(a, c) / scale,
                           "plain": max_err(b, c) / scale,
                           "max_abs_float64": scale}
        # in units of the 2e-2 limit below
        grad_rel = 2e-2 * max(e["kernels"] / max(2e-2, 2.0 * e["plain"])
                              for e in exact.values())
    if not (loss_rel <= STEP_LOSS_TOL and grad_rel <= STEP_GRAD_TOL):
        fail(f"train step: kernels vs plain versions differ: loss {loss_rel} "
             f"(tol 1e-4 rel), gradients {grad_rel} (tol 2e-2 of max|g|): "
             + json.dumps(exact or by_leaf))
    rec = {"loss": float(loss_k), "loss_rel_err": loss_rel,
           "max_grad_err_over_max_grad": max(by_leaf.values()),
           "by_leaf": by_leaf,
           "tol": "loss 1e-4 rel; each gradient 2e-2 x max|plain|"}
    if exact is not None:
        rec["tol"] = ("loss 1e-4 rel; each gradient against float64: "
                      "max(2e-2, 2 x the plain versions' error) x "
                      "max|exact|")
        rec["vs_float64"] = exact
    return rec


def _steps_per_s(torch, step, state, X, Y, gen, steps):
    """(state, steps/s, losses) over `steps` steps ending in a sync."""
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, loss = step(state, X, Y, gen)
        losses.append(loss)
    losses = torch.stack(losses)
    torch.cuda.synchronize()
    return state, steps / (time.perf_counter() - t0), losses


def flagship_model(torch):
    """(config, params, X, Y): the flagship LGG (IW K=20, M=128) built from
    seed 0 on synthetic data of kin8nm's shape, with a random q(u) away
    from its initialization, as after some training; on the card."""
    from dgps_with_iwvi_torch.models import BuildArgs, build_model

    rng = np.random.default_rng(2)
    Xn = rng.standard_normal((N_KIN8NM, D_KIN8NM)).astype(np.float32)
    Yn = (np.sin(Xn[:, :1]) + 0.1 * rng.standard_normal((N_KIN8NM, 1))
          ).astype(np.float32)
    args = BuildArgs(configuration="LGG", mode="IW", num_inducing=M,
                     num_iw_samples=L_TRAIN)
    config, params = build_model(0, args, Xn, Yn, device="cuda")
    random_q(torch, params)
    return config, params, torch.from_numpy(Xn).cuda(), \
        torch.from_numpy(Yn).cuda()


def train_phase(torch, card: str, profile: bool) -> dict:
    """The flagship training step: LGG, IW K=20, M=128, natgrad on the
    final layer, Adam on the rest, on synthetic data of kin8nm's shape.
    One step through the kernels against the same step through the plain
    versions; then TRAIN_STEPS timed steps at B=512 whose K1, K2 and K3
    launch counts must rise by 2 each per step, and BIG_STEPS at B=8192 on
    the data tiled past 8192 rows (as bench.py does)."""
    import dataclasses

    from dgps_with_iwvi_torch import training as train
    from dgps_with_iwvi_torch.experiments import profile_step
    from dgps_with_iwvi_torch.ops.hopper import build

    config, params, X, Y = flagship_model(torch)
    tc = train.TrainConfig(lr=5e-3, gamma=1e-2, natgrad="final",
                           minibatch_size=B_TRAIN)
    init, step, _, params_fn = train.make_trainer(config, tc)
    state = init(params)
    gen = torch.Generator(device="cuda").manual_seed(0)
    idx = torch.randint(0, N_KIN8NM, (B_TRAIN,), generator=gen,
                        device="cuda")
    eps = [torch.randn((L_TRAIN, B_TRAIN, 1), generator=gen, device="cuda"),
           torch.randn((L_TRAIN, B_TRAIN, config.layers[1].d_out),
                       generator=gen, device="cuda"), None]
    agree = _grad_agreement(torch, train, config, tc, state, X, Y, idx, eps)

    for _ in range(10):                                      # warm-up
        state, _ = step(state, X, Y, gen)
    build.reset_launches()
    state, rate, losses = _steps_per_s(torch, step, state, X, Y, gen,
                                       TRAIN_STEPS)
    counts = _path_counts(build)
    want = {"chol_inv": 2, "epilogue:epi": 2, "epilogue_bwd:epi": 2}
    for name, per_step in want.items():
        if counts.get(name, 0) != per_step * TRAIN_STEPS:
            fail(f"train: {name} launched {counts.get(name, 0)} times in "
                 f"{TRAIN_STEPS} steps, want {per_step} per step")
    if not bool(torch.isfinite(losses).all()):
        fail("train: a loss is not finite")
    canon = params_fn(state)
    q = canon["layers"][2]["q_sqrt"]
    if not bool(torch.isfinite(q).all()):
        fail("train: the final layer's q_sqrt is not finite")
    rec = {"model": "LGG d_x=8 M=128 IW K=20, natgrad final, "
           "synthetic kin8nm-shaped data [7372, 8]",
           "vs_plain_on_card": agree, "steps": TRAIN_STEPS,
           "steps_per_s_b512": rate, "launches": counts,
           "loss_first": float(losses[0]), "loss_last": float(losses[-1])}
    if profile:
        rec["profile_b512"] = profile_step.profile_train(step, state, X, Y,
                                                         gen)
    rec["use_pallas"] = _pallas_train(torch, train, build, config, params, X,
                                      Y, tc, idx)

    reps = (B_BIG + N_KIN8NM - 1) // N_KIN8NM + 1
    Xb, Yb = X.repeat(reps, 1), Y.repeat(reps, 1)
    cfg_big = dataclasses.replace(config, num_data=Xb.shape[0])
    tc_big = dataclasses.replace(tc, minibatch_size=B_BIG)
    init_b, step_b, _, _ = train.make_trainer(cfg_big, tc_big)
    state_b = init_b(params)
    for _ in range(3):                                       # warm-up
        state_b, _ = step_b(state_b, Xb, Yb, gen)
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    state_b, rate_big, losses_b = _steps_per_s(torch, step_b, state_b, Xb,
                                               Yb, gen, BIG_STEPS)
    counts_b = _path_counts(build)
    for name, per_step in want.items():
        if counts_b.get(name, 0) != per_step * BIG_STEPS:
            fail(f"train B={B_BIG}: {name} launched {counts_b.get(name, 0)} "
                 f"times in {BIG_STEPS} steps, want {per_step} per step")
    if not bool(torch.isfinite(losses_b).all()):
        fail("train B=8192: a loss is not finite")
    rec.update({"steps_b8192": BIG_STEPS, "steps_per_s_b8192": rate_big,
                "launches_b8192": counts_b,
                "peak_mem_gib_b8192":
                torch.cuda.max_memory_allocated() / 2 ** 30})
    if profile:
        rec["profile_b8192"] = profile_step.profile_train(
            step_b, state_b, Xb, Yb, gen, steps=3)
    print(f"train: {rate:.1f} steps/s at B={B_TRAIN}, {rate_big:.2f} "
          f"steps/s at B={B_BIG} (LGG IW K={L_TRAIN} M={M}, natgrad final) "
          f"on {card}")
    for label, r in rec["use_pallas"].items():
        print(f"train use_pallas, {label}: {r['steps_per_s_b512']:.1f} "
              f"steps/s at B={B_TRAIN} on {card}")
    return rec


PALLAS_TRAIN = [
    # (label, natgrad, timed steps, launches per step): natgrad's q_cov keeps
    # the final layer on K2/K3; Adam alone takes it through K5 'fused'
    ("natgrad final", "final", 100,
     {"conditional:sample": 1, "epilogue:epi": 1, "epilogue_bwd:epi": 1,
      "chol_inv": 2}),
    ("Adam only", "none", 50,
     {"conditional:sample": 1, "conditional:fused": 1, "chol_inv": 1}),
]


def _pallas_train(torch, train, build, config, params, X, Y, tc, idx) -> dict:
    """The flagship step with use_pallas=True: the inner layer's conditional
    and sample in K5 'sample' (its backward in plain f32), with natgrad on
    the final layer and with Adam alone. Per variant: one step's loss and
    gradients against the plain versions (the same generator seed, so the
    same Philox stream), then timed steps whose launch counts must be
    exactly the listed ones per step."""
    import dataclasses

    cfg = dataclasses.replace(config, use_pallas=True)
    out = {}
    for label, natgrad, steps, want in PALLAS_TRAIN:
        tc_l = dataclasses.replace(tc, natgrad=natgrad)
        init, step, _, _ = train.make_trainer(cfg, tc_l)
        state = init(params)
        agree = _grad_agreement(torch, train, cfg, tc_l, state, X, Y, idx,
                                None, gen_seed=3)
        gen = torch.Generator(device="cuda").manual_seed(0)
        for _ in range(5):                                   # warm-up
            state, _ = step(state, X, Y, gen)
        build.reset_launches()
        state, rate, losses = _steps_per_s(torch, step, state, X, Y, gen,
                                           steps)
        counts = {k: v for k, v in _path_counts(build).items() if v}
        if counts != {k: v * steps for k, v in want.items()}:
            fail(f"train use_pallas ({label}): launches {counts} in {steps} "
                 f"steps, want per step {want}")
        if not bool(torch.isfinite(losses).all()):
            fail(f"train use_pallas ({label}): a loss is not finite")
        out[label] = {"vs_plain_on_card": agree, "steps": steps,
                      "steps_per_s_b512": rate, "launches": counts,
                      "loss_first": float(losses[0]),
                      "loss_last": float(losses[-1])}
    return out


HARNESS_STEPS, HARNESS_RESUME_AT = 400, 200
HARNESS_ARGS = ["--dataset", "kin8nm", "--configuration", "LGG", "--mode",
                "IW", "--K", "20", "--M", "128", "--minibatch_size", "512",
                "--natgrad", "final", "--iterations", str(HARNESS_STEPS),
                "--steps_per_call", "100", "--num_predict_samples",
                str(HARNESS_SAMPLES),
                "--print_every", "100", "--ckpt_every",
                str(HARNESS_RESUME_AT)]
EVAL_BATCH = 4096  # evaluate's default batch_size


def _checkpoint_leaves(path: str, torch) -> list:
    """(name, value) of every leaf of a saved checkpoint."""
    def leaves(tree, name):
        if isinstance(tree, dict):
            return [x for k in sorted(tree, key=str)
                    for x in leaves(tree[k], f"{name}.{k}")]
        if isinstance(tree, (list, tuple)):
            return [x for i, v in enumerate(tree)
                    for x in leaves(v, f"{name}[{i}]")]
        return [(name, tree)]

    return leaves(torch.load(path, map_location="cpu", weights_only=True),
                  "")


def harness_phase(torch, card: str, tmp: str) -> dict:
    """The UCI harness on the card, as a user runs it: ``experiments.main
    .run`` on the kin8nm surrogate (8192 x 8: 7372 train and 820 test
    rows), LGG IW K=20 M=128, B=512, natgrad final, 400 steps in chunks of
    100, S=100 at evaluation. Its K1, K2 and K3 launches must rise by 2
    each per training step, and evaluation launch K4 twice per test chunk
    (and K1 once), the final ELBO on the first 512 rows once more (K1 once
    more for the canonical form of the trained q(u)); its
    test NLL must beat the untrained model's on the same rows, and its
    sqlite row must carry every column of the schema. Then a second run
    restored from the step-200 checkpoint must end at step 400 with a
    state (parameters, natgrad blocks, Adam's moments, the generator)
    bitwise equal to the straight run's. Runs in `tmp`, which the caller
    keeps for the serve phase (the straight run's checkpoints in tmp/a)."""
    import contextlib
    import sqlite3

    from dgps_with_iwvi_torch.data import native_loader
    from dgps_with_iwvi_torch.evaluation import Database
    from dgps_with_iwvi_torch.evaluation.database import SCHEMA
    from dgps_with_iwvi_torch.experiments import main as harness
    from dgps_with_iwvi_torch.ops.hopper import build

    db = os.path.join(tmp, "results.db")
    straight, resumed = os.path.join(tmp, "a"), os.path.join(tmp, "b")

    def args(ckpt_dir, *extra):
        # an empty data directory: the name-seeded surrogate
        return harness.parse_args(HARNESS_ARGS + [
            "--data_dir", os.path.join(tmp, "data"), "--results_db", db,
            "--ckpt_dir", ckpt_dir, *extra])

    exp = harness.setup(args(straight))
    n_test = exp.data.X_test.shape[0]
    untrained = harness.evaluate_model(args(straight), exp, exp.params)
    want_flops = expected_flops(harness, args(straight), exp)
    del exp
    chunks = -(-n_test // EVAL_BATCH)
    if min(n_test, EVAL_BATCH) != HARNESS_TEST_ROWS:
        fail(f"harness: evaluation chunks of {min(n_test, EVAL_BATCH)} "
             f"rows, but the K4 phase holds K4 to its plain version at "
             f"{HARNESS_TEST_ROWS} rows x S={HARNESS_SAMPLES}")

    def want(steps):
        # K1 also once for the trained q(u)'s canonical form, once per
        # test chunk and once for the final ELBO
        return {"chol_inv": 2 * steps + 1 + chunks + 1,
                "epilogue:epi": 2 * steps, "epilogue_bwd:epi": 2 * steps,
                "serve_cond:sample": chunks + 1,
                "serve_cond:infer": chunks + 1}

    build.reset_launches()
    row = harness.run(args(straight))
    counts = {k: v for k, v in _path_counts(build).items() if v}
    if counts != want(HARNESS_STEPS):
        fail(f"harness: launches {counts}, want {want(HARNESS_STEPS)} "
             f"({HARNESS_STEPS} steps, {chunks} test chunk(s))")
    for key in ("test_loglik", "test_rmse", "elbo"):
        if not math.isfinite(row[key]):
            fail(f"harness: {key} = {row[key]} is not finite")
    if not row["test_loglik"] > untrained["test_loglik"]:
        fail(f"harness: test loglik {row['test_loglik']} is not above "
             f"the untrained model's {untrained['test_loglik']}")
    if not row["synthetic_data"] or row["backend"] != "cuda":
        fail(f"harness: ran on {row['backend']}, synthetic "
             f"{row['synthetic_data']}")
    flops_rec = row_flops(row, want_flops, "harness")
    with contextlib.closing(sqlite3.connect(":memory:")) as conn:
        conn.executescript(SCHEMA)
        schema = conn.execute("PRAGMA table_info(regression)").fetchall()
    with contextlib.closing(sqlite3.connect(db)) as conn:
        table = conn.execute("PRAGMA table_info(regression)").fetchall()
    rows = Database(db).read("kin8nm")
    if table != schema or len(rows) != 1 or any(
            rows[0][c] is None for c in Database._COLS):
        fail(f"harness: the results row {rows} does not fill the schema "
             f"{[c[1] for c in schema]}")

    os.makedirs(resumed)
    for name in (f"step_{HARNESS_RESUME_AT}.pt", "build_args.json"):
        shutil.copy(os.path.join(straight, name), resumed)
    build.reset_launches()
    row_resumed = harness.run(args(resumed, "--resume"))
    counts_resumed = {k: v for k, v in _path_counts(build).items() if v}
    if counts_resumed != want(HARNESS_STEPS - HARNESS_RESUME_AT):
        fail(f"harness resume: launches {counts_resumed}, want "
             f"{want(HARNESS_STEPS - HARNESS_RESUME_AT)}")
    end = f"step_{HARNESS_STEPS}.pt"
    a = _checkpoint_leaves(os.path.join(straight, end), torch)
    b = _checkpoint_leaves(os.path.join(resumed, end), torch)
    if [n for n, _ in a] != [n for n, _ in b]:
        fail("harness resume: the two checkpoints differ in structure")
    differ = [n for (n, x), (_, y) in zip(a, b)
              if not (torch.equal(x, y) if isinstance(x, torch.Tensor)
                      else x == y)]
    if differ:
        fail(f"harness resume: the resumed state differs from the "
             f"straight run's at step {HARNESS_STEPS} in {differ}")
    rec = {"run": "experiments.main.run " + " ".join(HARNESS_ARGS),
           "n_test": n_test, "test_chunks": chunks,
           "native_kmeans": native_loader.native_available(),
           "test_loglik": row["test_loglik"], "test_rmse": row["test_rmse"],
           "untrained_test_loglik": untrained["test_loglik"],
           "untrained_test_rmse": untrained["test_rmse"],
           "elbo": row["elbo"], "steps_per_s": row["steps_per_sec"],
           "train_time_s": row["train_time_s"],
           "steps_per_s_wall": HARNESS_STEPS / row["train_time_s"],
           "launches": counts, "row_flops": flops_rec,
           "resumed": {"from_step": HARNESS_RESUME_AT,
                       "test_loglik": row_resumed["test_loglik"],
                       "steps_per_s": row_resumed["steps_per_sec"],
                       "launches": counts_resumed,
                       "state_bitwise_equal": True,
                       "leaves_compared": len(a)}}
    print(f"harness: kin8nm surrogate, LGG IW K=20 M=128 B=512, "
          f"{HARNESS_STEPS} steps: test_loglik {row['test_loglik']:.4f} "
          f"(untrained {untrained['test_loglik']:.4f}), test_rmse "
          f"{row['test_rmse']:.4f}, {row['steps_per_sec']:.1f} steps/s "
          f"(median of the chunks after the first), "
          f"{HARNESS_STEPS / row['train_time_s']:.1f} over the whole "
          f"{row['train_time_s']:.2f} s of training; "
          f"resumed from step {HARNESS_RESUME_AT}: state bitwise equal; "
          f"on {card}")
    return rec


SERVE_TABLE_BATCHES = 8   # the .npz table: 8 x B_SERVE rows
SERVE_ARTIFACT_TOL = 1e-5  # artifact vs the plain live path, of max|value|


def _serve_counts(build, fn) -> tuple:
    """(result of fn(), its launches by kernel variant, nonzero only)."""
    build.reset_launches()
    res = fn()
    return res, {k: v for k, v in _path_counts(build).items() if v}


def _scorer_side(torch, serve, args, Xn, Yn, d_out=1):
    """The CLI's live scoring redone through ``make_scorer_fn`` (the
    function ``Scorer`` wraps): the same padded batches of the
    standardized table (Xn, Yn), the same chunk seeds, then the CLI's
    un-normalization. Returns the dict the CLI writes."""
    from dgps_with_iwvi_torch.data import get_regression_data
    from dgps_with_iwvi_torch.evaluation.metrics import chunk_seed
    from dgps_with_iwvi_torch.experiments.main import seeds
    from dgps_with_iwvi_torch.serving import make_scorer_fn

    data = get_regression_data("kin8nm", 0, data_dir=args.data_dir)
    config, params, _ = serve._restore(args, data, torch.device("cuda"))
    n, d_in = Xn.shape
    bs = min(args.batch_size, n)
    padded = np.zeros((-(-n // bs) * bs, d_in + d_out), np.float32)
    padded[:n, :d_in], padded[:n, d_in:] = Xn, Yn
    host = torch.from_numpy(padded)
    fn = make_scorer_fn(params, config, args.num_predict_samples,
                        device="cuda")
    parts = []
    with torch.no_grad():
        for start in range(0, n, bs):
            b = host[start:start + bs].cuda()
            m, v, ld = fn(b[:, :d_in], b[:, d_in:],
                          chunk_seed(seeds(args.seed)[2], start))
            keep = min(bs, n - start)
            parts.append(torch.cat([m[:keep], v[:keep], ld[:keep, None]], 1))
    res = torch.cat(parts).cpu().numpy()
    y_std = np.asarray(data.Y_std).reshape(1, -1)
    y_mean = np.asarray(data.Y_mean).reshape(1, -1)
    return {"mean": res[:, :d_out] * y_std + y_mean,
            "var": res[:, d_out:2 * d_out] * y_std ** 2,
            "log_density": res[:, 2 * d_out] - float(np.sum(np.log(y_std)))}


def _artifact_reference(torch, serve, args, table, batch, seed):
    """The artifact's function on the live path: make_scorer_fn with the
    train statistics, serve_pallas off, under the plain versions, fed
    ``artifact_noise(seed + i)`` for batch i of `batch` padded rows."""
    import dataclasses

    from dgps_with_iwvi_torch.data import get_regression_data
    from dgps_with_iwvi_torch.ops.hopper import build
    from dgps_with_iwvi_torch.serving import (NormalizationStats,
                                              artifact_noise, make_scorer_fn)

    data = get_regression_data("kin8nm", 0, data_dir=args.data_dir)
    config, params, _ = serve._restore(args, data, torch.device("cuda"))
    config = dataclasses.replace(config, serve_pallas=False)
    fn = make_scorer_fn(params, config, args.num_predict_samples,
                        NormalizationStats.from_dataset(data), device="cuda")
    X, Y = (np.asarray(a, np.float32) for a in table)
    n = X.shape[0]
    parts = []
    with torch.no_grad(), build.plain_versions():
        for i, start in enumerate(range(0, n, batch)):
            keep = min(batch, n - start)
            xb = torch.zeros((batch, X.shape[1]), device="cuda")
            yb = torch.zeros((batch, Y.shape[1]), device="cuda")
            xb[:keep] = torch.from_numpy(X[start:start + keep]).cuda()
            yb[:keep] = torch.from_numpy(Y[start:start + keep]).cuda()
            eps = artifact_noise(seed + i, config, args.num_predict_samples,
                                 batch, "cuda")
            m, v, ld = fn(xb, yb, seed + i, eps=eps)
            parts.append(torch.cat([m[:keep], v[:keep], ld[:keep, None]], 1))
    res = torch.cat(parts).cpu().numpy()
    return {"mean": res[:, :1], "var": res[:, 1:2], "log_density": res[:, 2]}


def serve_phase(torch, card: str, tmp: str, harness: dict) -> dict:
    """``experiments.serve.run`` (dgp-serve-torch) on the harness phase's
    step-400 checkpoint (tmp/a), as a user runs it, at S=100:

    (a) live scoring of the kin8nm surrogate's test split (one batch of
    820 rows, evaluation's chunk) and of an .npz table of 8 x 8192 raw
    rows tiled from it, at --batch_size 8192: one K1 and two K4 launches
    per batch (the warm-up batch included) and one K1 for the restored
    q(u)'s canonical form; each .npz equal bit for bit to the same
    batches and seeds scored through ``make_scorer_fn`` and
    un-normalized; the test split's mean log-density equal to the
    harness's test loglik (the same chunk, seed and kernels: the points
    are equal, the means differ by the order of f32 sums, 1e-6).

    (b) --export of a fixed-batch (8192) and a polymorphic (--batch_size
    0) artifact for 'cuda', then --from_export: the table through the
    fixed one equals the live path on the plain versions with
    serve_pallas off, fed ``artifact_noise``, to 1e-5 of max|value|
    (bitwise expected), with no hand kernel launched; the polymorphic one
    scores a table of 2 x 8192 + 1 rows (a 1-row last chunk) and agrees
    with the fixed one there to 1e-5.

    (c) points/s of the live path (K4) and the artifact, and of the live
    path with --transport bfloat16 against float32: recorded, no limit.
    """
    from dgps_with_iwvi_torch.experiments import serve
    from dgps_with_iwvi_torch.models import build_config, load_build_args
    from dgps_with_iwvi_torch.ops.hopper import build
    from dgps_with_iwvi_torch.serving import artifact_noise, load_scorer

    data_dir = os.path.join(tmp, "data")
    common = ["--dataset", "kin8nm", "--data_dir", data_dir, "--ckpt_dir",
              os.path.join(tmp, "a"), "--num_predict_samples",
              str(HARNESS_SAMPLES)]

    def run(*flags):
        return serve.run(serve.parse_args(common + list(flags)))

    def load(name):
        with np.load(os.path.join(tmp, name)) as z:
            return {k: z[k] for k in z.files}

    def want(batches):
        return {"chol_inv": batches + 2, "serve_cond:sample": batches + 1,
                "serve_cond:infer": batches + 1}

    def bitwise(got, ref, what):
        for k in ("mean", "var", "log_density"):
            if not np.array_equal(got[k], ref[k]):
                fail(f"serve {what}: {k} differs from the scorer-side "
                     f"scoring (max |d| "
                     f"{float(np.max(np.abs(got[k] - ref[k])))})")

    from dgps_with_iwvi_torch.data import get_regression_data

    data = get_regression_data("kin8nm", 0, data_dir=data_dir)
    X_raw = np.asarray(data.X_test) * data.X_std + data.X_mean
    Y_raw = np.asarray(data.Y_test) * data.Y_std + data.Y_mean
    n_test = X_raw.shape[0]
    reps = -(-SERVE_TABLE_BATCHES * B_SERVE // n_test)
    n_tab = SERVE_TABLE_BATCHES * B_SERVE
    tab = (np.tile(X_raw, (reps, 1))[:n_tab], np.tile(Y_raw, (reps, 1))[:n_tab])
    np.savez(os.path.join(tmp, "table.npz"), X=tab[0], Y=tab[1])
    # the CLI scores a polymorphic artifact in ServingArtifact.score's
    # default chunks; two of them and a 1-row tail
    from dgps_with_iwvi_torch.serving import ServingArtifact

    chunk = inspect.signature(ServingArtifact.score).parameters[
        "max_batch"].default
    if chunk != B_SERVE:
        fail(f"serve: the artifact's default chunk {chunk} is not the fixed "
             f"artifact's batch {B_SERVE}; their seeds would not align")
    n_poly = 2 * chunk + 1
    np.savez(os.path.join(tmp, "table_poly.npz"), X=tab[0][:n_poly],
             Y=tab[1][:n_poly])

    # (a) live scoring
    res_test, counts_test = _serve_counts(build, lambda: run(
        "--output", os.path.join(tmp, "test.npz")))
    if counts_test != want(1):
        fail(f"serve test split: launches {counts_test}, want {want(1)}")
    test = load("test.npz")
    args_test = serve.parse_args(common)
    bitwise(test, _scorer_side(torch, serve, args_test, data.X_test,
                               data.Y_test), "test split")
    ld_mean = float(np.mean(test["log_density"].astype(np.float64)))
    ld_gap = abs(ld_mean - harness["test_loglik"])
    if not ld_gap <= 1e-6 * max(1.0, abs(harness["test_loglik"])):
        fail(f"serve test split: mean log-density {ld_mean} against the "
             f"harness's test loglik {harness['test_loglik']}")

    table_flags = ["--input", os.path.join(tmp, "table.npz"),
                   "--batch_size", str(B_SERVE)]
    res_live, counts_live = _serve_counts(build, lambda: run(
        *table_flags, "--output", os.path.join(tmp, "live.npz")))
    if counts_live != want(SERVE_TABLE_BATCHES):
        fail(f"serve table: launches {counts_live}, want "
             f"{want(SERVE_TABLE_BATCHES)}")
    live = load("live.npz")
    for k in ("mean", "var", "log_density"):
        if live[k].shape[0] != n_tab or not np.all(np.isfinite(live[k])):
            fail(f"serve table: {k} has shape {live[k].shape} or "
                 "non-finite values")
    bitwise(live, _scorer_side(
        torch, serve, serve.parse_args(common + table_flags),
        (tab[0] - data.X_mean) / data.X_std,
        (tab[1] - data.Y_mean) / data.Y_std), "table")
    res_bf16 = run(*table_flags, "--transport", "bfloat16", "--output",
                   os.path.join(tmp, "live_bf16.npz"))
    live_bf16 = load("live_bf16.npz")
    # back in model units, where the cast rounded: one bf16 unit of each
    y_std, y_mean = float(data.Y_std.ravel()[0]), float(data.Y_mean.ravel()[0])
    model_units = {"mean": lambda a: (a - y_mean) / y_std,
                   "var": lambda a: a / y_std ** 2,
                   "log_density": lambda a: a + math.log(y_std)}
    bf16_err = {}
    for k, f in model_units.items():
        a, b = f(live_bf16[k].astype(np.float64)), f(live[k].astype(
            np.float64))
        bf16_err[k] = float(np.max(np.abs(a - b) / (np.abs(b) + 1e-9)))
    if not max(bf16_err.values()) <= 2.0 ** -8:
        fail(f"serve --transport bfloat16: {bf16_err} beyond one bf16 unit")

    # (b) the artifacts
    fixed_path = os.path.join(tmp, "scorer.pt2")
    poly_path = os.path.join(tmp, "scorer_poly.pt2")
    t0 = time.perf_counter()
    exp_fixed = run("--export", fixed_path, "--export_platforms", "cuda",
                    "--batch_size", str(B_SERVE))
    export_s = time.perf_counter() - t0
    exp_poly = run("--export", poly_path, "--export_platforms", "cuda",
                   "--batch_size", "0")
    if exp_fixed["batch_size"] != B_SERVE or not exp_poly[
            "polymorphic_batch"] or exp_fixed["platforms"] != ["cuda"]:
        fail(f"serve --export: meta {exp_fixed} / {exp_poly}")
    res_art, counts_art = _serve_counts(build, lambda: run(
        "--from_export", fixed_path, "--input",
        os.path.join(tmp, "table.npz"), "--output",
        os.path.join(tmp, "art.npz")))
    if counts_art:
        fail(f"serve --from_export launched hand kernels: {counts_art}")
    art = load("art.npz")
    ref = _artifact_reference(torch, serve, serve.parse_args(common), tab,
                              B_SERVE, 0)
    art_err, art_bitwise = {}, True
    for k in ("mean", "var", "log_density"):
        err = float(np.max(np.abs(art[k] - ref[k])))
        art_err[k] = err / float(np.max(np.abs(ref[k])))
        art_bitwise &= bool(np.array_equal(art[k], ref[k]))
        if not art_err[k] <= SERVE_ARTIFACT_TOL:
            fail(f"serve artifact: {k} differs from the plain live path "
                 f"by {art_err[k]} of max|value| (tol "
                 f"{SERVE_ARTIFACT_TOL})")
    # where the artifact's time goes: one program call at the table's
    # batch, and the Philox draws it makes inside (artifact_noise)
    loaded = load_scorer(fixed_path, device="cuda")
    cfg = build_config(load_build_args(os.path.join(tmp, "a")), D_KIN8NM, 1,
                       N_KIN8NM)
    xb = torch.zeros((B_SERVE, D_KIN8NM), device="cuda")
    yb = torch.zeros((B_SERVE, 1), device="cuda")
    seed_t = torch.zeros((), dtype=torch.int64, device="cuda")
    with torch.no_grad():
        art_batch_ms = time_ms(torch, lambda: loaded._fn(xb, yb, seed_t), 5)
        art_noise_ms = time_ms(torch, lambda: artifact_noise(
            seed_t, cfg, HARNESS_SAMPLES, B_SERVE), 5)
        # the card's busy share of a batch of ServingArtifact.score: the
        # device time of one program call (calls queued behind a spin
        # kernel) against the wall time per batch of scoring the table
        art_device_ms = device_ms(torch, lambda: loaded._fn(xb, yb, seed_t),
                                  5)
    walls = []
    for _ in range(3):  # the first a warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded.score(*tab)
        walls.append((time.perf_counter() - t0) * 1e3 / SERVE_TABLE_BATCHES)
    art_wall_ms = min(walls[1:])
    art_busy = art_device_ms / art_wall_ms
    del loaded
    _, counts_poly = _serve_counts(build, lambda: run(
        "--from_export", poly_path, "--input",
        os.path.join(tmp, "table_poly.npz"), "--output",
        os.path.join(tmp, "poly.npz")))
    poly = load("poly.npz")
    poly_err = {}
    for k in ("mean", "var", "log_density"):
        if poly[k].shape[0] != n_poly or not np.all(np.isfinite(poly[k])):
            fail(f"serve polymorphic artifact: {k} has shape "
                 f"{poly[k].shape} or non-finite values")
        # the fixed artifact scored these rows in batches 0-2 with the
        # same seeds; a point's noise does not depend on the batch size
        scale = float(np.max(np.abs(art[k][:n_poly])))
        poly_err[k] = float(np.max(np.abs(poly[k] - art[k][:n_poly]))) / scale
        if counts_poly or not poly_err[k] <= SERVE_ARTIFACT_TOL:
            fail(f"serve polymorphic artifact: {k} against the fixed one "
                 f"{poly_err[k]} of max|value|, launches {counts_poly}")

    rec = {"run": "experiments.serve.run " + " ".join(common),
           "test_rows": n_test, "table_rows": n_tab, "batch": B_SERVE,
           "samples": HARNESS_SAMPLES,
           "test_mean_log_density": ld_mean,
           "harness_test_loglik": harness["test_loglik"],
           "test_loglik_gap": ld_gap,
           "live_points_per_s": res_live["points_per_sec"],
           "live_bf16_points_per_s": res_bf16["points_per_sec"],
           "artifact_points_per_s": res_art["points_per_sec"],
           "test_split_points_per_s": res_test["points_per_sec"],
           "bf16_transport_rel_err": bf16_err,
           "artifact_vs_plain_live": art_err,
           "artifact_bitwise": art_bitwise,
           "poly_vs_fixed": poly_err, "poly_rows": n_poly,
           "export_s": export_s, "artifact_batch_ms": art_batch_ms,
           "artifact_noise_ms": art_noise_ms,
           "artifact_device_ms_per_batch": art_device_ms,
           "artifact_wall_ms_per_batch": walls[1:],
           "artifact_busy_share": art_busy,
           "launches": counts_live, "launches_test_split": counts_test,
           "launches_artifact": counts_art}
    print(f"serve CLI: {n_tab} rows at S={HARNESS_SAMPLES}, batch "
          f"{B_SERVE}: live (K4) {res_live['points_per_sec']:.0f} points/s "
          f"(--transport bfloat16 {res_bf16['points_per_sec']:.0f}), "
          f"artifact {res_art['points_per_sec']:.0f} ({art_batch_ms:.2f} "
          f"ms per batch, its Philox draws {art_noise_ms:.2f}; device "
          f"{art_device_ms:.2f} of {art_wall_ms:.2f} ms wall per batch of "
          f"ServingArtifact.score, busy share {art_busy:.3f}); artifact vs "
          f"plain "
          f"live path {max(art_err.values()):.3g} of max|value| (bitwise "
          f"{art_bitwise}); test mean log-density {ld_mean:.6f} vs harness "
          f"{harness['test_loglik']:.6f}; on {card}")
    return rec


FAMILY_STEPS = 300
FAMILY_ARGS = ["--dataset", "kin8nm", "--configuration", "LGG", "--mode",
               "IW", "--K", "20", "--M", "128", "--minibatch_size", "512",
               "--natgrad", "final", "--iterations", str(FAMILY_STEPS),
               "--steps_per_call", "100", "--num_predict_samples",
               str(HARNESS_SAMPLES), "--print_every", "100"]
FAMILY_RUNS = [
    # (label, flags): (a) a composite non-RBF kernel on the K2 route,
    # (b) a final layer of C=3 outputs on the default route (K4 at
    # evaluation and serving)
    ("regression", ["--kernel", "matern52+linear"]),
    ("multiclass", ["--likelihood", "multiclass", "--num_classes", "3"]),
]
RANK_DEFICIENT_KINDS = ("linear", "polynomial", "constant")


def _family_kuu_checks(torch, exp) -> dict:
    """K1 against its plain version on the model's stacked Kuu (the
    matern52+linear grams of both GP layers) over the model's ladder, and
    on the rank-deficient grams of RANK_DEFICIENT_KINDS at the inner
    layer's Z (rank <= 9 for linear, 1 for constant at M=128) over a
    6-level ladder from 1e-6, where each must find a usable level, the
    plain version's."""
    from dgps_with_iwvi_torch.ops import hopper, kernels, linalg

    cfg = exp.config
    ladder = linalg._jitter_ladder(cfg.jitter, cfg.jitter_tries,
                                   torch.float32, "cuda")
    out = {"model_kuu": _chol_case(torch, hopper.chol, linalg,
                                   served_kuu(torch, cfg, exp.params),
                                   ladder)}
    Z = exp.params["layers"][1]["Z"]
    ladder6 = linalg._jitter_ladder(1e-6, 6, torch.float32, "cuda")
    for kind in RANK_DEFICIENT_KINDS:
        Kd = kernels.K(kernels.kernel_params(kind, Z.shape[1],
                                             device=Z.device), Z, Z,
                       kind=kind)[None]
        case = _chol_case(torch, hopper.chol, linalg, Kd, ladder6)
        L_all = hopper.chol.chol_inv(Kd, ladder6)[0]
        if not bool(linalg._chol_ok(L_all).any()):
            fail(f"families: no level of the ladder factors the {kind} Kuu")
        out[kind] = case
    return out


def families_phase(torch, card: str, tmp: str) -> dict:
    """The kernel and likelihood families through ``experiments.main.run``
    on the kin8nm surrogate, as phase 6 runs it (LGG IW K=20 M=128 B=512,
    natgrad final, S=100 at evaluation), FAMILY_STEPS steps each:

    (a) ``--kernel matern52+linear``: K1 on the model's Kuu and on
    rank-deficient grams (``_family_kuu_checks``); one step at a random
    q(u) against the plain versions on the card (loss 1e-4, gradients
    2e-2 of max); K1, K2 and K3 twice per step, and evaluation and the
    final ELBO on K1 and K2 (a non-RBF kernel takes no K4); test NLL above
    the untrained model's.

    (b) ``--likelihood multiclass --num_classes 3`` on the class
    surrogate: the same step, its gradients held to the float64 step
    (``_grad_agreement``); launches as phase 6's (K2 and K3 at
    the final layer's D=3, K4 'infer' at D=3 in evaluation); test
    accuracy above 0.40 (chance 1/3) and test NLL above the untrained
    model's. Then ``experiments.serve.run`` on its step-300 checkpoint:
    the test split as [n, 3] class probabilities, one K1 and two K4 per
    batch (the warm-up included) and one K1 for the restored q(u), the
    mean log-density within 1e-6 of (b)'s test loglik."""
    from dgps_with_iwvi_torch import training as train
    from dgps_with_iwvi_torch.experiments import main as harness
    from dgps_with_iwvi_torch.experiments import serve
    from dgps_with_iwvi_torch.ops.hopper import build

    data_dir = os.path.join(tmp, "data")
    rec = {}
    for label, flags in FAMILY_RUNS:
        multiclass = label == "multiclass"
        ckpt = os.path.join(tmp, f"family_{label}")
        args = harness.parse_args(FAMILY_ARGS + flags + [
            "--data_dir", data_dir, "--results_db",
            os.path.join(tmp, "families.db"), "--ckpt_dir", ckpt,
            "--ckpt_every", str(FAMILY_STEPS)])
        exp = harness.setup(args)
        n_test = exp.data.X_test.shape[0]
        chunks = -(-n_test // EVAL_BATCH)
        untrained = harness.evaluate_model(args, exp, exp.params)
        out = {"run": "experiments.main.run " + " ".join(FAMILY_ARGS + flags),
               "n_test": n_test}
        if not multiclass:
            out["k1"] = _family_kuu_checks(torch, exp)

        # one step at a random q(u), kernels against the plain versions
        params = dict(exp.params, layers=[dict(lp) for lp in
                                          exp.params["layers"]])
        random_q(torch, params)
        tc = train.TrainConfig(lr=args.lr, gamma=args.gamma,
                               natgrad=args.natgrad,
                               minibatch_size=args.minibatch_size)
        state = train.make_trainer(exp.config, tc)[0](params)
        g = torch.Generator(device="cuda").manual_seed(0)
        B = args.minibatch_size
        idx = torch.randint(0, exp.X.shape[0], (B,), generator=g,
                            device="cuda")
        eps = [torch.randn((L_TRAIN, B, 1), generator=g, device="cuda"),
               torch.randn((L_TRAIN, B, exp.config.layers[1].d_out),
                           generator=g, device="cuda"), None]
        # (b): at this q(u) the final layer's kernel-variance gradient
        # sits below float32's rounding (the record's vs_float64 shows
        # it), so the step is held to the same step in float64
        out["vs_plain_on_card"] = _grad_agreement(
            torch, train, exp.config, tc, state, exp.X, exp.Y, idx, eps,
            exact_params=params if multiclass else None)
        want_flops = expected_flops(harness, args, exp)
        del exp, params, state

        S = FAMILY_STEPS
        want = {"chol_inv": 2 * S + 1 + chunks + 1,
                "epilogue:epi": 2 * S, "epilogue_bwd:epi": 2 * S}
        if multiclass:
            want.update({"serve_cond:sample": chunks + 1,
                         "serve_cond:infer": chunks + 1})
        else:  # evaluation's chunks and the final ELBO: K2 at both layers
            want["epilogue:epi"] += 2 * (chunks + 1)
        build.reset_launches()
        row = harness.run(args)
        counts = {k: v for k, v in _path_counts(build).items() if v}
        if counts != want:
            fail(f"families ({label}): launches {counts}, want {want} "
                 f"({S} steps, {chunks} test chunk(s))")
        if not all(math.isfinite(row[k]) for k in ("test_loglik", "elbo")):
            fail(f"families ({label}): test loglik {row['test_loglik']} or "
                 f"ELBO {row['elbo']} is not finite")
        out["row_flops"] = row_flops(row, want_flops, f"families ({label})")
        if not row["test_loglik"] > untrained["test_loglik"]:
            fail(f"families ({label}): test loglik {row['test_loglik']} is "
                 f"not above the untrained model's "
                 f"{untrained['test_loglik']}")
        if multiclass and not row["test_accuracy"] > 0.40:
            fail(f"families ({label}): test accuracy {row['test_accuracy']}"
                 " is not above 0.40")
        out.update({
            "test_loglik": row["test_loglik"],
            "untrained_test_loglik": untrained["test_loglik"],
            "test_rmse": row["test_rmse"],
            "test_accuracy": row.get("test_accuracy"),
            "untrained_test_accuracy": untrained.get("test_accuracy"),
            "elbo": row["elbo"], "steps_per_s": row["steps_per_sec"],
            "train_time_s": row["train_time_s"], "launches": counts})
        acc = (f", test accuracy {row['test_accuracy']:.4f} (untrained "
               f"{untrained['test_accuracy']:.4f})" if multiclass else "")
        print(f"families {label} ({' '.join(flags)}): {S} steps at "
              f"{row['steps_per_sec']:.1f} steps/s, test_loglik "
              f"{row['test_loglik']:.4f} (untrained "
              f"{untrained['test_loglik']:.4f}){acc}; launches "
              f"{json.dumps(counts)}; on {card}")
        rec[label] = out

    # the multiclass checkpoint through the serve CLI
    pred = os.path.join(tmp, "family_multiclass.npz")
    res, counts = _serve_counts(build, lambda: serve.run(serve.parse_args([
        "--dataset", "kin8nm", "--data_dir", data_dir, "--ckpt_dir",
        os.path.join(tmp, "family_multiclass"), "--num_predict_samples",
        str(HARNESS_SAMPLES), "--output", pred])))
    want = {"chol_inv": 3, "serve_cond:sample": 2, "serve_cond:infer": 2}
    if counts != want:
        fail(f"families serve: launches {counts}, want {want}")
    with np.load(pred) as z:
        mean, ld = z["mean"], z["log_density"]
    n_test = rec["multiclass"]["n_test"]
    if mean.shape != (n_test, 3) or not np.all(np.isfinite(mean)):
        fail(f"families serve: mean of shape {mean.shape}, want "
             f"({n_test}, 3), finite")
    ld_mean = float(np.mean(ld.astype(np.float64)))
    ref = rec["multiclass"]["test_loglik"]
    gap = abs(ld_mean - ref)
    if not gap <= 1e-6 * max(1.0, abs(ref)):
        fail(f"families serve: mean log-density {ld_mean} against the "
             f"run's test loglik {ref}")
    rec["serve"] = {"test_mean_log_density": ld_mean, "test_loglik_gap": gap,
                    "mean_row_sum_max_dev": float(np.max(np.abs(
                        mean.sum(1) - 1.0))),
                    "points_per_s": res["points_per_sec"],
                    "launches": counts}
    print(f"families serve: the multiclass checkpoint's test split as "
          f"[{n_test}, 3] class probabilities, mean log-density "
          f"{ld_mean:.6f} vs the run's {ref:.6f}; launches "
          f"{json.dumps(counts)}; on {card}")
    return rec


BREADTH_RUNS = [
    # (label, flags): (a) multiscale windows with two priors, whitened, on
    # the K2 route (no K4, no K5: both assume plain inducing points);
    # (b) the non-whitened parameterization, whose q-variance takes K2/K3's
    # q-variance-only variant
    ("multiscale", ["--feature", "multiscale", "--prior",
                    "kernel_variance=gamma(2,3)", "--prior",
                    "noise_variance=lognormal(-2,1)"]),
    ("no_white", ["--no_white"]),
]
FULL_COV_ROWS, FULL_COV_SAMPLES = 512, 10
OBS_DRAWS = 1_000_000
OBS_F, OBS_F_CLASSES = 0.3, (0.2, -0.5, 1.0)


def _restore(torch, tmp, ckpt):
    """(config, params, data) of the latest checkpoint in `ckpt`, rebuilt
    from its build_args.json on its family's data as dgp-serve-torch does
    (one K1 launch: the canonical form of the natgrad block)."""
    from dgps_with_iwvi_torch.experiments import serve
    from dgps_with_iwvi_torch.experiments.main import load_data

    args = serve.parse_args(["--dataset", "kin8nm", "--data_dir",
                             os.path.join(tmp, "data"), "--ckpt_dir", ckpt])
    likelihood, num_classes = serve._family(args)
    data = load_data(likelihood, "kin8nm", 0, num_classes=num_classes,
                     data_dir=args.data_dir)
    config, params, _ = serve._restore(args, data, torch.device("cuda"))
    return config, params, data


def _full_cov_check(torch, config, params, X) -> dict:
    """predict_f_full_cov at FULL_COV_ROWS rows and S=FULL_COV_SAMPLES on
    the card: its diagonal against predict_f's variance on the same noise,
    within 1e-4 of max|var| at the model's classes (the q-variance at bf16
    through K2, the solve path at bf16x3) and within 1e-5 with both at
    'highest', the full covariance's own class, where only the order of
    f32 sums differs; symmetric (1e-6 of the largest diagonal), its
    smallest eigenvalue >= -1e-4 of the largest diagonal."""
    import dataclasses

    from dgps_with_iwvi_torch.models import (layer_noise, predict_f,
                                             predict_f_full_cov)

    S = FULL_COV_SAMPLES
    eps = layer_noise(config, (S,), X.shape[0],
                      torch.Generator(device="cuda").manual_seed(5))
    exact = dataclasses.replace(config, var_precision="highest",
                                solve_precision="highest")
    with torch.no_grad():
        mean, cov = predict_f_full_cov(params, exact, X, None, S, eps=eps)
        fmean, fvar = predict_f(params, exact, X, None, S, eps=eps)
        _, fvar_model = predict_f(params, config, X, None, S, eps=eps)
        ms = time_ms(torch, lambda: predict_f_full_cov(params, config, X,
                                                       None, S, eps=eps), 3)
    want = (S, fmean.shape[-1], X.shape[0], X.shape[0])
    if tuple(cov.shape) != want or not bool(torch.isfinite(cov).all()):
        fail(f"breadth full cov: shape {tuple(cov.shape)} (want {want}) or "
             "non-finite")
    diag = torch.diagonal(cov, dim1=-2, dim2=-1).transpose(-1, -2)
    scale = float(fvar.abs().max())
    diag_err = max_err(diag, fvar)
    model_err = max_err(diag, fvar_model)
    mean_err = max_err(mean, fmean)
    top = float(diag.abs().max())
    asym = max_err(cov, cov.transpose(-1, -2))
    eig_min = float(torch.linalg.eigvalsh(cov.double()).min())
    if not (diag_err <= 1e-5 * scale and model_err <= 1e-4 * scale
            and asym <= 1e-6 * top and eig_min >= -1e-4 * top):
        fail(f"breadth full cov: diagonal vs predict_f's variance "
             f"{diag_err} at 'highest' (limit {1e-5 * scale}) and "
             f"{model_err} at the model's classes (limit {1e-4 * scale}), "
             f"asymmetry {asym} (limit {1e-6 * top}), smallest eigenvalue "
             f"{eig_min} (limit {-1e-4 * top})")
    return {"shape": list(cov.shape), "diag_vs_predict_f_var": diag_err,
            "max_var": scale, "mean_vs_predict_f": mean_err,
            "diag_vs_predict_f_var_at_model_classes": model_err,
            "asymmetry": asym, "min_eigenvalue": eig_min,
            "max_diag": top, "ms": ms}


def _sampling_check(torch, build, config, params, X) -> dict:
    """predict_f_samples and predict_y_samples at S=HARNESS_SAMPLES on the
    test rows X of a whitened points model: one K1, K4 'sample' and K4
    'infer' per call. The function draws equal predict_f's
    fmean + safe_sqrt(fvar) z on the same noise at f32 rounding (1e-6 of
    the largest |draw|); both draws' sample means are within 5 standard
    errors of the mixture mean at every row."""
    from dgps_with_iwvi_torch.models import (layer_noise, predict_f,
                                             predict_f_samples,
                                             predict_y_samples)
    from dgps_with_iwvi_torch.ops import conditionals, likelihoods

    S, B = HARNESS_SAMPLES, X.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(6)
    eps = layer_noise(config, (S,), B, gen)
    z = torch.randn((S, B, 1), generator=gen, device="cuda")
    with torch.no_grad():
        build.reset_launches()
        fs = predict_f_samples(params, config, X, None, S, eps=eps,
                               sample_eps=z)
        ys = predict_y_samples(params, config, X, gen, S, eps=eps,
                               sample_eps=z)
        counts = {k: v for k, v in _path_counts(build).items() if v}
        fmean, fvar = predict_f(params, config, X, None, S, eps=eps)
        s2 = likelihoods.noise_variance(params["likelihood"])
        ms = time_ms(torch, lambda: predict_y_samples(
            params, config, X, gen, S, eps=eps, sample_eps=z), 5)
    want = {"chol_inv": 2, "serve_cond:sample": 2, "serve_cond:infer": 2}
    if counts != want:
        fail(f"breadth predict: launches {counts}, want {want}")
    want_fs = fmean + conditionals.safe_sqrt(fvar) * z
    f_err = max_err(fs, want_fs)
    f_tol = 1e-6 * float(want_fs.abs().max())
    mix = fmean.mean(0)
    z_f = float(((fs.mean(0) - mix).abs()
                 / (fvar.sum(0).sqrt() / S)).max())
    z_y = float(((ys.mean(0) - mix).abs()
                 / ((fvar + s2).sum(0).sqrt() / S)).max())
    if not (f_err <= f_tol and z_f < 5.0 and z_y < 5.0
            and bool(torch.isfinite(ys).all())):
        fail(f"breadth predict: function draws {f_err} from fmean + "
             f"sqrt(fvar) z (limit {f_tol}); sample means {z_f} (f) and "
             f"{z_y} (y) standard errors from the mixture mean at the "
             "worst row")
    return {"launches": counts, "f_draws_vs_moments": f_err,
            "f_draws_limit": f_tol, "max_z_f": z_f, "max_z_y": z_y,
            "rows": B, "samples": S, "predict_y_samples_ms": ms}


def _obs_moments(kind, p, likelihoods):
    """(mean, variance) of one observation of `kind` at f = OBS_F
    (OBS_F_CLASSES for the class families) from the family's parameters
    `p` (floats)."""
    f = OBS_F
    pos = lambda r: 1e-6 + math.log1p(math.exp(r))   # noqa: E731
    if kind == "gaussian":
        return f, pos(p["raw_noise_variance"])
    if kind == "bernoulli":
        q = 0.5 * math.erfc(-f / math.sqrt(2.0))
        return q, q * (1 - q)
    if kind == "student_t":
        s, df = pos(p["raw_scale"]), p["df"]
        return f, s * s * df / (df - 2.0)
    if kind in ("poisson", "exponential"):
        return math.exp(f), math.exp(f) * (1.0 if kind == "poisson"
                                           else math.exp(f))
    if kind == "gamma":
        k = pos(p["raw_shape"])
        return k * math.exp(f), k * math.exp(2 * f)
    if kind == "beta":
        s, mu = pos(p["raw_scale"]), 1.0 / (1.0 + math.exp(-f))
        return mu, mu * (1 - mu) / (s + 1.0)
    if kind == "ordinal":
        cdf = [0.5 * math.erfc(-(e - f) / math.sqrt(2.0))
               for e in p["bin_edges"]]
        probs = np.diff([0.0] + cdf + [1.0])
    elif kind == "softmax":
        probs = np.exp(OBS_F_CLASSES) / np.sum(np.exp(OBS_F_CLASSES))
    else:
        C, eps = len(OBS_F_CLASSES), likelihoods.ROBUSTMAX_EPS
        probs = np.full(C, eps / (C - 1))
        probs[int(np.argmax(OBS_F_CLASSES))] = 1 - eps
    k = np.arange(len(probs))
    mean = float(np.sum(k * probs))
    return mean, float(np.sum(np.square(k - mean) * probs))


def _observation_draws(torch) -> dict:
    """``dispatch_sample_observations`` of every family on the card,
    OBS_DRAWS draws each from a generator: mean and variance within 5
    standard errors of the analytic values (the variance's from the
    sample's fourth central moment; student_t at df=10, where that moment
    is finite); switched_gaussian raises, as in the reference."""
    from dgps_with_iwvi_torch.ops import likelihoods

    out = {}
    gen = torch.Generator(device="cuda").manual_seed(7)
    for kind in likelihoods.LIKELIHOOD_KINDS:
        kw = ({"df": 10.0} if kind == "student_t" else
              {"num_classes": 4} if kind == "ordinal" else
              {"num_tasks": 2} if kind == "switched_gaussian" else {})
        p = likelihoods.init_params(kind, 0.2, device="cuda", **kw)
        if kind in ("multiclass", "softmax"):
            fs = torch.tensor(OBS_F_CLASSES, device="cuda").expand(
                OBS_DRAWS, 3).contiguous()
        else:
            fs = torch.full((OBS_DRAWS, 1), OBS_F, device="cuda")
        if kind == "switched_gaussian":
            try:
                likelihoods.dispatch_sample_observations(p, fs, gen,
                                                         kind=kind)
            except ValueError:
                out[kind] = "raises ValueError, as in the reference"
                continue
            fail("breadth draws: switched_gaussian sampling did not raise")
        y = likelihoods.dispatch_sample_observations(p, fs, gen, kind=kind)
        ms = time_ms(torch, lambda: likelihoods.dispatch_sample_observations(
            p, fs, gen, kind=kind), 5)
        x = y.double().flatten()
        c = x - x.mean()
        s2, m4 = float((c * c).mean()), float((c ** 4).mean())
        mean, var = _obs_moments(kind, {k: v.tolist() for k, v in p.items()},
                                 likelihoods)
        z_mean = abs(float(x.mean()) - mean) / math.sqrt(var / x.numel())
        z_var = abs(s2 - var) / math.sqrt(max(m4 - s2 * s2, 1e-300)
                                          / x.numel())
        if not (y.shape == (OBS_DRAWS, 1) and z_mean < 5.0 and z_var < 5.0):
            fail(f"breadth draws ({kind}): shape {tuple(y.shape)}, mean "
                 f"{float(x.mean())} vs {mean} ({z_mean:.2f} SE), variance "
                 f"{s2} vs {var} ({z_var:.2f} SE)")
        out[kind] = {"mean": float(x.mean()), "analytic_mean": mean,
                     "var": s2, "analytic_var": var, "z_mean": z_mean,
                     "z_var": z_var, "ms": ms}
    return out


def breadth_phase(torch, card: str, tmp: str) -> dict:
    """ROADMAP item 7's second half through ``experiments.main.run`` on the
    kin8nm surrogate, as phase 8 runs it (LGG IW K=20 M=128 B=512, natgrad
    final, FAMILY_STEPS steps, S=100 at evaluation):

    Each run first holds K1 to its plain version on the model's stacked
    Kuu (the window integrals for (a)), timed.

    (a) multiscale windows with a gamma prior on the kernel variances and
    a lognormal one on the noise: one step at a random q(u) against the
    plain versions on the card (``_grad_agreement``); K1, K2 'epi' and K3
    'epi' twice per step, evaluation and the final ELBO on K1 and K2
    'epi' (no K4, no K5); the windows moved in training; test NLL above
    the untrained model's.

    (b) ``--no_white``: the same step check; K1, K2 'qvar' and K3 'qvar'
    twice per step ('epi' none), evaluation on K1 and K2 'qvar'; test NLL
    above the untrained model's. Then ``experiments.serve.run`` on (b)'s
    checkpoint: one K1 per batch and one K2 'qvar' per GP layer and batch
    (the warm-up included), one K1 for the restored q(u); the test
    split's mean log-density within 1e-6 of (b)'s test loglik.

    (c) the predictives: ``predict_f_full_cov`` on (a)'s model
    (``_full_cov_check``); ``predict_f_samples`` and ``predict_y_samples``
    on phase 6's step-400 checkpoint (``_sampling_check``); the
    observation draws of every family (``_observation_draws``)."""
    from dgps_with_iwvi_torch import training as train
    from dgps_with_iwvi_torch.experiments import main as harness
    from dgps_with_iwvi_torch.experiments import serve
    from dgps_with_iwvi_torch.ops import hopper, linalg
    from dgps_with_iwvi_torch.ops.hopper import build

    data_dir = os.path.join(tmp, "data")
    rec = {}
    for label, flags in BREADTH_RUNS:
        ckpt = os.path.join(tmp, f"breadth_{label}")
        args = harness.parse_args(FAMILY_ARGS + flags + [
            "--data_dir", data_dir, "--results_db",
            os.path.join(tmp, "breadth.db"), "--ckpt_dir", ckpt,
            "--ckpt_every", str(FAMILY_STEPS)])
        exp = harness.setup(args)
        n_test = exp.data.X_test.shape[0]
        chunks = -(-n_test // EVAL_BATCH)
        untrained = harness.evaluate_model(args, exp, exp.params)
        out = {"run": "experiments.main.run " + " ".join(FAMILY_ARGS + flags),
               "n_test": n_test}
        # K1 on the step's stacked Kuu: the window integrals for (a)
        Kuu = served_kuu(torch, exp.config, exp.params)
        ladder = linalg._jitter_ladder(exp.config.jitter,
                                       exp.config.jitter_tries,
                                       torch.float32, "cuda")
        out["k1_kuu"] = dict(
            _chol_case(torch, hopper.chol, linalg, Kuu, ladder),
            ms=time_ms(torch, lambda: hopper.chol.chol_inv(Kuu, ladder), 50),
            plain_ms=time_ms(torch, lambda: hopper.chol.chol_inv_plain(
                Kuu, ladder), 5, 1),
            library_ms=time_ms(torch, lambda: chol_library(torch, Kuu,
                                                           ladder), 20))
        params = dict(exp.params, layers=[dict(lp) for lp in
                                          exp.params["layers"]])
        random_q(torch, params)
        tc = train.TrainConfig(lr=args.lr, gamma=args.gamma,
                               natgrad=args.natgrad,
                               minibatch_size=args.minibatch_size)
        state = train.make_trainer(exp.config, tc)[0](params)
        g = torch.Generator(device="cuda").manual_seed(0)
        B = args.minibatch_size
        idx = torch.randint(0, exp.X.shape[0], (B,), generator=g,
                            device="cuda")
        eps = [torch.randn((L_TRAIN, B, 1), generator=g, device="cuda"),
               torch.randn((L_TRAIN, B, exp.config.layers[1].d_out),
                           generator=g, device="cuda"), None]
        out["vs_plain_on_card"] = _grad_agreement(
            torch, train, exp.config, tc, state, exp.X, exp.Y, idx, eps)
        scales0 = [lp["raw_Z_scales"].clone() for lp in exp.params["layers"]
                   if "raw_Z_scales" in lp]
        want_flops = expected_flops(harness, args, exp)
        del exp, params, state

        S = FAMILY_STEPS
        form = "epi" if label == "multiscale" else "qvar"
        want = {"chol_inv": 2 * S + 1 + chunks + 1,
                f"epilogue:{form}": 2 * S + 2 * (chunks + 1),
                f"epilogue_bwd:{form}": 2 * S}
        build.reset_launches()
        row = harness.run(args)
        counts = {k: v for k, v in _path_counts(build).items() if v}
        if counts != want:
            fail(f"breadth ({label}): launches {counts}, want {want} ({S} "
                 f"steps, {chunks} test chunk(s))")
        if not all(math.isfinite(row[k]) for k in ("test_loglik", "elbo")):
            fail(f"breadth ({label}): test loglik {row['test_loglik']} or "
                 f"ELBO {row['elbo']} is not finite")
        out["row_flops"] = row_flops(row, want_flops, f"breadth ({label})")
        if not row["test_loglik"] > untrained["test_loglik"]:
            fail(f"breadth ({label}): test loglik {row['test_loglik']} is "
                 f"not above the untrained model's "
                 f"{untrained['test_loglik']}")
        if scales0:
            trained = [t for n, t in _checkpoint_leaves(
                os.path.join(ckpt, f"step_{S}.pt"), torch)
                if n.endswith("raw_Z_scales")]
            moved = max(float((t.cuda() - t0).abs().max())
                        for t, t0 in zip(trained, scales0))
            if len(trained) != len(scales0) or not moved > 1e-3:
                fail(f"breadth ({label}): the multiscale windows moved by "
                     f"{moved} in training ({len(trained)} of "
                     f"{len(scales0)} layers found)")
            out["raw_Z_scales_max_move"] = moved
        out.update({
            "test_loglik": row["test_loglik"],
            "untrained_test_loglik": untrained["test_loglik"],
            "test_rmse": row["test_rmse"], "elbo": row["elbo"],
            "steps_per_s": row["steps_per_sec"],
            "train_time_s": row["train_time_s"], "launches": counts})
        print(f"breadth {label} ({' '.join(flags)}): {S} steps at "
              f"{row['steps_per_sec']:.1f} steps/s, test_loglik "
              f"{row['test_loglik']:.4f} (untrained "
              f"{untrained['test_loglik']:.4f}); launches "
              f"{json.dumps(counts)}; on {card}")
        rec[label] = out

    # (b)'s checkpoint through the serve CLI
    pred = os.path.join(tmp, "breadth_no_white.npz")
    res, counts = _serve_counts(build, lambda: serve.run(serve.parse_args([
        "--dataset", "kin8nm", "--data_dir", data_dir, "--ckpt_dir",
        os.path.join(tmp, "breadth_no_white"), "--num_predict_samples",
        str(HARNESS_SAMPLES), "--output", pred])))
    want = {"chol_inv": 3, "epilogue:qvar": 4}
    if counts != want:
        fail(f"breadth serve: launches {counts}, want {want}")
    with np.load(pred) as z:
        ld = z["log_density"]
    ld_mean = float(np.mean(ld.astype(np.float64)))
    ref = rec["no_white"]["test_loglik"]
    gap = abs(ld_mean - ref)
    if not gap <= 1e-6 * max(1.0, abs(ref)):
        fail(f"breadth serve: mean log-density {ld_mean} against the run's "
             f"test loglik {ref}")
    rec["serve"] = {"test_mean_log_density": ld_mean, "test_loglik_gap": gap,
                    "points_per_s": res["points_per_sec"],
                    "launches": counts}

    # (c) the predictives
    config, params, data = _restore(torch, tmp,
                                    os.path.join(tmp, "breadth_multiscale"))
    X = torch.as_tensor(data.X_test[:FULL_COV_ROWS]).cuda()
    rec["full_cov"] = _full_cov_check(torch, config, params, X)
    config, params, data = _restore(torch, tmp, os.path.join(tmp, "a"))
    rec["sampling"] = _sampling_check(torch, build, config, params,
                                      torch.as_tensor(data.X_test).cuda())
    rec["observation_draws"] = _observation_draws(torch)
    print(f"breadth serve: (b)'s test split, mean log-density {ld_mean:.6f} "
          f"vs the run's {ref:.6f}; launches {json.dumps(counts)}; "
          f"full cov {json.dumps(rec['full_cov'])}; sampling "
          f"{json.dumps(rec['sampling'])}; on {card}")
    return rec


PARALLEL_RANKS = 2
PARALLEL_MESHES = [(2, 1), (1, 2)]        # (n_dp, n_k) of phase 10(a)
PARALLEL_STEPS, PARALLEL_RESUME_AT, PARALLEL_CHUNK = 100, 50, 25
PARALLEL_CLI_STEPS, NCCL_STEPS = 200, 10
PARALLEL_TIMEOUT_S = 300
PARALLEL_EVAL_RTOL = 1e-6   # the reference's float32 gate, test_parallel.py:362
PARALLEL_STEP_WANT = {"chol_inv": 2, "epilogue:epi": 2, "epilogue_bwd:epi": 2}


def _check(ok: bool, msg: str) -> None:
    """fail() inside a rank: the rank exits non-zero, which the parent
    sees and fails on."""
    if not ok:
        fail(f"parallel rank: {msg}")


def _counted(build, counts: dict, label: str, fn):
    """Run fn with every launch count set to 0 just before and read just
    after; the counts go to counts[label]. Returns fn's result."""
    build.reset_launches()
    out = fn()
    counts[label] = {k: v for k, v in _path_counts(build).items() if v}
    return out


def _want_counts(counts: dict, label: str, want: dict) -> None:
    _check(counts[label] == want,
           f"{label}: launches {counts[label]}, want {want}")


def _parallel_step_checks(torch, build, counts, config, params, X, Y, mesh,
                          tag: str) -> dict:
    """Phase 10(a) on one mesh: one sharded step with injected draws
    (launches counted, K1, K2 and K3 twice each), then, from the same
    state and draws, the summed loss and gradients held to the same step
    in one process on the card and to the sharded step on the plain
    versions, at the step gates."""
    from dgps_with_iwvi_torch import training as train
    from dgps_with_iwvi_torch.models import layer_noise
    from dgps_with_iwvi_torch.parallel import sharding
    from dgps_with_iwvi_torch.parallel.mesh import coordinate, mesh_shape

    n_dp, n_k = mesh_shape(mesh)
    i_dp, i_k = coordinate(mesh)
    N, K = X.shape[0], config.num_iw_samples
    n_local, b_local, k_local = -(-N // n_dp), B_TRAIN // n_dp, K // n_k
    g = torch.Generator(device="cuda").manual_seed(0)
    idx = [torch.randint(0, n_local, (b_local,), generator=g, device="cuda")
           for _ in range(n_dp)]
    eps = layer_noise(config, (K,), B_TRAIN, g)
    gidx = torch.cat([sharding.global_row_ids(i, r, n_local, N)
                      for i, r in enumerate(idx)])
    my_eps = [None if e is None else
              e[i_k * k_local:(i_k + 1) * k_local,
                i_dp * b_local:(i_dp + 1) * b_local] for e in eps]
    tc = train.TrainConfig(lr=5e-3, gamma=1e-2, natgrad="final",
                           minibatch_size=B_TRAIN)
    init, step, _, _ = sharding.make_parallel_trainer(config, tc, mesh)
    Xl, Yl = sharding.shard_arrays(mesh, X, Y)
    state = sharding.replicate(mesh, init(params))
    _counted(build, counts, tag, lambda: step(state, Xl, Yl, idx=idx[i_dp],
                                              eps=my_eps))
    _want_counts(counts, tag, PARALLEL_STEP_WANT)

    state = sharding.replicate(mesh, init(params))

    def sharded():
        return _step_leaves(*sharding.loss_and_grads(
            config, tc, mesh, state, Xl, Yl, idx=idx[i_dp], eps=my_eps))

    got = sharded()
    with build.plain_versions():
        plain = sharded()
    single = _step_leaves(*train.loss_and_grads(
        config, tc, train.make_trainer(config, tc)[0](params), X, Y,
        idx=gidx, eps=eps))
    out = {}
    for name, ref in (("vs_one_process", single), ("vs_plain", plain)):
        loss_rel, by_leaf = _step_gaps(got, ref)
        _check(loss_rel <= STEP_LOSS_TOL
               and max(by_leaf.values()) <= STEP_GRAD_TOL,
               f"{tag} {name}: loss {loss_rel}, gradients "
               f"{max(by_leaf.values())} (tol {STEP_LOSS_TOL}, "
               f"{STEP_GRAD_TOL}): {json.dumps(by_leaf)}")
        out[name] = {"loss_rel_err": loss_rel,
                     "max_grad_err_over_max_grad": max(by_leaf.values())}
    out["loss"] = float(got[0])
    return out


def _parallel_pallas_check(torch, build, counts, config, params, X, Y,
                           mesh) -> dict:
    """Phase 10(a) with use_pallas on the 2x1 mesh: one generator-driven
    sharded step (the inner layer's noise drawn inside K5 'sample' from
    each rank's own noise generator), counted, then its summed loss and
    gradients against the same step in one process: the mean over 'dp' of
    the single-device step on each rank's rows with that rank's noise
    generator (scale N/B_local each, so the mean is the global step)."""
    import dataclasses

    from dgps_with_iwvi_torch import training as train
    from dgps_with_iwvi_torch.parallel import sharding
    from dgps_with_iwvi_torch.parallel.mesh import mesh_shape

    cfg = dataclasses.replace(config, use_pallas=True)
    n_dp, _ = mesh_shape(mesh)
    N = X.shape[0]
    n_local, b_local = -(-N // n_dp), B_TRAIN // n_dp
    tc = train.TrainConfig(lr=5e-3, gamma=1e-2, natgrad="final",
                           minibatch_size=B_TRAIN)
    init, step, _, _ = sharding.make_parallel_trainer(cfg, tc, mesh)
    Xl, Yl = sharding.shard_arrays(mesh, X, Y)
    state = sharding.replicate(mesh, init(params))
    _counted(build, counts, "use_pallas_2x1", lambda: step(
        state, Xl, Yl, torch.Generator().manual_seed(7)))
    _want_counts(counts, "use_pallas_2x1", {
        "conditional:sample": 1, "epilogue:epi": 1, "epilogue_bwd:epi": 1,
        "chol_inv": 2})

    state = sharding.replicate(mesh, init(params))
    got = _step_leaves(*sharding.loss_and_grads(
        cfg, tc, mesh, state, Xl, Yl, torch.Generator().manual_seed(7)))
    seed = sharding.draw_step_seed(torch.Generator().manual_seed(7))
    tc_rank = dataclasses.replace(tc, minibatch_size=b_local)
    state1 = train.make_trainer(cfg, tc_rank)[0](params)
    parts = []
    for i in range(n_dp):
        rows, noise = sharding.rank_generators(seed, i, 0, "cuda")
        r = torch.randint(0, n_local, (b_local,), generator=rows,
                          device="cuda")
        parts.append(_step_leaves(*train.loss_and_grads(
            cfg, tc_rank, state1, X, Y, noise,
            idx=sharding.global_row_ids(i, r, n_local, N))))
    single = (sum(float(p[0]) for p in parts) / n_dp,
              [(name, sum(p[1][j][1] for p in parts) / n_dp)
               for j, (name, _) in enumerate(parts[0][1])])
    loss_rel, by_leaf = _step_gaps(got, single)
    _check(loss_rel <= STEP_LOSS_TOL
           and max(by_leaf.values()) <= STEP_GRAD_TOL,
           f"use_pallas 2x1 vs one process: loss {loss_rel}, gradients "
           f"{max(by_leaf.values())}: {json.dumps(by_leaf)}")
    return {"loss": float(got[0]), "vs_one_process": {
        "loss_rel_err": loss_rel,
        "max_grad_err_over_max_grad": max(by_leaf.values())}}


def _parallel_fit(torch, build, counts, config, params, X, Y, mesh,
                  tmp) -> dict:
    """Phase 10(b): fit(mesh=) for PARALLEL_STEPS steps on the 1x2 mesh
    (K split over the ranks) in chunks of PARALLEL_CHUNK, saving at
    PARALLEL_RESUME_AT; the replicas bitwise equal after every chunk; the
    loss falling; then the run resumed from that checkpoint, whose end
    state equals the straight run's bit for bit. Returns the trained
    parameters too."""
    from dgps_with_iwvi_torch import training as train
    from dgps_with_iwvi_torch.parallel import sharding
    from dgps_with_iwvi_torch.training.checkpoint import (restore_checkpoint,
                                                          save_checkpoint)

    tc = train.TrainConfig(lr=5e-3, gamma=1e-2, natgrad="final",
                           minibatch_size=B_TRAIN, iterations=PARALLEL_STEPS,
                           steps_per_call=PARALLEL_CHUNK)
    ckpt = os.path.join(tmp, "parallel_fit")
    gen = torch.Generator().manual_seed(11)
    seen = []

    def callback(step, loss, state):
        seen.append((step, loss, sharding.replicas_agree(mesh, state)))
        if step == PARALLEL_RESUME_AT:
            save_checkpoint(ckpt, step, state, gen, mesh=mesh)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trained, state = _counted(build, counts, "fit", lambda: train.fit(
        gen, config, params, X, Y, tc, callback=callback, mesh=mesh))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    _want_counts(counts, "fit", {"chol_inv": 2 * PARALLEL_STEPS + 1,
                                 "epilogue:epi": 2 * PARALLEL_STEPS,
                                 "epilogue_bwd:epi": 2 * PARALLEL_STEPS})
    _check(all(agree for _, _, agree in seen),
           f"fit: replicas differ after a chunk: {seen}")
    _check(seen[-1][1] < seen[0][1], f"fit: the loss did not fall: {seen}")
    straight = sharding.state_digest(state)

    init = sharding.make_parallel_trainer(config, tc, mesh)[0]
    like = {"state": init(params), "generator": torch.Generator()}
    restored = restore_checkpoint(ckpt, PARALLEL_RESUME_AT, like, mesh=mesh)
    rest_steps = PARALLEL_STEPS - PARALLEL_RESUME_AT
    _, resumed = _counted(build, counts, "fit_resumed", lambda: train.fit(
        restored["generator"], config, params, X, Y, tc,
        state=restored["state"], mesh=mesh))
    _want_counts(counts, "fit_resumed", {"chol_inv": 2 * rest_steps + 1,
                                         "epilogue:epi": 2 * rest_steps,
                                         "epilogue_bwd:epi": 2 * rest_steps})
    _check(sharding.state_digest(resumed) == straight,
           "fit: the run resumed from step "
           f"{PARALLEL_RESUME_AT} differs from the straight run")
    return {"steps": PARALLEL_STEPS, "seconds": seconds,
            "steps_per_s": PARALLEL_STEPS / seconds,
            "chunk_losses": [loss for _, loss, _ in seen],
            "replicas_bitwise_equal_every_chunk": True,
            "resumed_from": PARALLEL_RESUME_AT,
            "resumed_bitwise_equal": True}, trained


def _parallel_evaluate(torch, build, counts, config, trained, data,
                       mesh) -> dict:
    """Phase 10(c): evaluate(mesh=) on the test split against the
    unsharded evaluate on the card (PARALLEL_EVAL_RTOL), K1 and K4 on
    each rank; and the cost of drawing a chunk's whole noise on each
    rank, timed against drawing the rank's share."""
    from dgps_with_iwvi_torch.evaluation import evaluate
    from dgps_with_iwvi_torch.models import layer_noise

    kw = dict(y_std=data.Y_std, num_samples=HARNESS_SAMPLES, device="cuda")
    Xt = torch.as_tensor(data.X_test).float()
    Yt = torch.as_tensor(data.Y_test).float()
    got = _counted(build, counts, "evaluate", lambda: evaluate(
        trained, config, Xt, Yt, 3, mesh=mesh, **kw))
    _want_counts(counts, "evaluate", {"chol_inv": 1, "serve_cond:sample": 1,
                                      "serve_cond:infer": 1})
    ref = evaluate(trained, config, Xt, Yt, 3, **kw)
    gaps = {k: abs(got[k] - ref[k]) / abs(ref[k]) for k in ref}
    _check(max(gaps.values()) <= PARALLEL_EVAL_RTOL,
           f"evaluate(mesh=) {got} vs unsharded {ref}")
    n = Xt.shape[0]
    g = torch.Generator(device="cuda")
    whole = time_ms(torch, lambda: layer_noise(
        config, (HARNESS_SAMPLES,), n, g.manual_seed(0)), 20)
    share = time_ms(torch, lambda: layer_noise(
        config, (HARNESS_SAMPLES,), -(-n // PARALLEL_RANKS),
        g.manual_seed(0)), 20)
    return {"metrics": got, "unsharded": ref, "rel_gaps": gaps,
            "tol": f"rtol {PARALLEL_EVAL_RTOL}",
            "noise_ms_whole_chunk": whole, "noise_ms_rank_share": share,
            "rows": n}


def _parallel_cli(torch, build, counts, tmp, rank: int) -> dict:
    """Phase 10(d): experiments.main.run --shard --n_k 2 (one row, from
    rank 0; test loglik above the untrained model's), then
    experiments.serve.run --shard on its checkpoint, whose .npz equals
    the unsharded scoring of the same rows within PARALLEL_EVAL_RTOL of
    each array's largest |value|."""
    import torch.distributed as dist

    from dgps_with_iwvi_torch.evaluation import Database
    from dgps_with_iwvi_torch.experiments import main as harness
    from dgps_with_iwvi_torch.experiments import serve

    db = os.path.join(tmp, "parallel.db")
    ckpt = os.path.join(tmp, "parallel_cli")
    flags = ["--iterations", str(PARALLEL_CLI_STEPS), "--data_dir",
             os.path.join(tmp, "data"), "--results_db", db, "--ckpt_dir",
             ckpt, "--ckpt_every", str(PARALLEL_CLI_STEPS), "--shard",
             "--n_k", "2"]
    args = harness.parse_args(FAMILY_ARGS + flags)
    exp = harness.setup(args)
    untrained = harness.evaluate_model(args, exp, exp.params)
    chunks = -(-exp.data.X_test.shape[0] // EVAL_BATCH)
    world = dist.get_world_size()
    want_flops = expected_flops(harness, args, exp, (world // 2, 2))
    del exp
    row = _counted(build, counts, "cli_train",
                   lambda: harness.run(args))
    steps = PARALLEL_CLI_STEPS
    _want_counts(counts, "cli_train", {
        "chol_inv": 2 * steps + 1 + chunks + 1, "epilogue:epi": 2 * steps,
        "epilogue_bwd:epi": 2 * steps, "serve_cond:sample": chunks + 1,
        "serve_cond:infer": chunks + 1})
    _check(row["test_loglik"] > untrained["test_loglik"],
           f"cli: test loglik {row['test_loglik']} not above the untrained "
           f"{untrained['test_loglik']}")
    dist.barrier()
    n_rows = len(Database(db).read("kin8nm"))
    _check(n_rows == 1, f"cli: {n_rows} results rows, want 1")

    sharded = os.path.join(tmp, "parallel_sharded.npz")
    single = os.path.join(tmp, "parallel_single.npz")
    base = ["--dataset", "kin8nm", "--data_dir", os.path.join(tmp, "data"),
            "--ckpt_dir", ckpt, "--num_predict_samples",
            str(HARNESS_SAMPLES)]
    _counted(build, counts, "cli_serve", lambda: serve.run(serve.parse_args(
        base + ["--output", sharded, "--shard"])))
    _want_counts(counts, "cli_serve", {"chol_inv": 3,
                                       "serve_cond:sample": 2,
                                       "serve_cond:infer": 2})
    out = {"test_loglik": row["test_loglik"],
           "untrained_test_loglik": untrained["test_loglik"],
           "steps_per_s": row["steps_per_sec"], "results_rows": n_rows,
           "row_flops": row_flops(row, want_flops, "cli", _check)}
    if rank == 0:
        serve.run(serve.parse_args(base + ["--output", single]))
        a, b = np.load(sharded), np.load(single)
        _check(sorted(a.files) == sorted(b.files), "serve: other arrays")
        gaps = {k: float(np.max(np.abs(a[k] - b[k]))
                         / max(float(np.max(np.abs(b[k]))), 1e-30))
                for k in a.files}
        _check(max(gaps.values()) <= PARALLEL_EVAL_RTOL,
               f"serve --shard vs unsharded: {gaps}")
        out["serve_rel_gaps"] = gaps
    dist.barrier()
    return out


def _nccl_world_of_one(torch, build, counts, config, params, X, Y,
                       tmp) -> dict:
    """Phase 10(e): a world of one rank on the NCCL backend runs one
    fit(mesh=) chunk; its mean loss equals the single-device chunk's on
    the same draws (each step's rows and noise from that step's seed, as
    the sharded step derives them) at the step's loss gate."""
    import torch.distributed as dist

    from dgps_with_iwvi_torch import training as train
    from dgps_with_iwvi_torch.parallel import make_mesh, sharding

    tc = train.TrainConfig(lr=5e-3, gamma=1e-2, natgrad="final",
                           minibatch_size=B_TRAIN, iterations=NCCL_STEPS,
                           steps_per_call=NCCL_STEPS)
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(tmp, "nccl.store"), 1), rank=0, world_size=1)
    try:
        backend = dist.get_backend()
        seen = []
        _counted(build, counts, "nccl_fit", lambda: train.fit(
            torch.Generator().manual_seed(13), config, params, X, Y, tc,
            callback=lambda s, loss, st: seen.append(loss),
            mesh=make_mesh(device="cuda")))
    finally:
        dist.destroy_process_group()
    _want_counts(counts, "nccl_fit", {"chol_inv": 2 * NCCL_STEPS + 1,
                                      "epilogue:epi": 2 * NCCL_STEPS,
                                      "epilogue_bwd:epi": 2 * NCCL_STEPS})
    init, step, _, _ = train.make_trainer(config, tc)
    state = init(params)
    gen = torch.Generator().manual_seed(13)
    losses = []
    for _ in range(NCCL_STEPS):
        rows, noise = sharding.rank_generators(
            sharding.draw_step_seed(gen), 0, 0, "cuda")
        idx = torch.randint(0, X.shape[0], (B_TRAIN,), generator=rows,
                            device="cuda")
        state, loss = step(state, X, Y, noise, idx=idx)
        losses.append(float(loss))
    single = float(np.mean(losses))
    rel = abs(seen[0] - single) / abs(single)
    _check(rel <= STEP_LOSS_TOL, f"nccl: chunk mean loss {seen[0]} vs the "
           f"single-device chunk's {single}")
    return {"backend": backend, "steps": NCCL_STEPS,
            "mean_loss": seen[0], "single_device_mean_loss": single,
            "loss_rel_err": rel}


def _parallel_rank(rank: int, world: int, tmp: str) -> None:
    """One rank of phase 10, spawned by the parent: cuda:0, gloo through a
    FileStore in `tmp`; writes its record to tmp/parallel_rank<r>.json."""
    import torch
    import torch.distributed as dist

    from dgps_with_iwvi_torch.data import get_regression_data
    from dgps_with_iwvi_torch.models import BuildArgs, build_model
    from dgps_with_iwvi_torch.ops.hopper import build
    from dgps_with_iwvi_torch.parallel import make_mesh, sharding

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(tmp, "parallel.store"), world), rank=rank,
        world_size=world)
    counts, rec = {}, {"rank": rank}
    try:
        data = get_regression_data("kin8nm", 0,
                                   data_dir=os.path.join(tmp, "data"))
        X = torch.as_tensor(data.X_train).float().cuda()
        Y = torch.as_tensor(data.Y_train).float().cuda()
        config, params = build_model(0, BuildArgs(
            configuration="LGG", mode="IW", num_inducing=M,
            num_iw_samples=L_TRAIN), X, Y, device="cuda")
        random_q(torch, params)
        meshes = {shape: make_mesh(*shape, device="cuda")
                  for shape in PARALLEL_MESHES}
        sharding.replicate(meshes[(2, 1)], params)
        rec["steps"] = {
            f"{a}x{b}": _parallel_step_checks(
                torch, build, counts, config, params, X, Y, meshes[(a, b)],
                f"step_{a}x{b}") for a, b in PARALLEL_MESHES}
        rec["use_pallas"] = _parallel_pallas_check(
            torch, build, counts, config, params, X, Y, meshes[(2, 1)])
        rec["fit"], trained = _parallel_fit(
            torch, build, counts, config, params, X, Y, meshes[(1, 2)], tmp)
        rec["evaluate"] = _parallel_evaluate(
            torch, build, counts, config, trained, data, meshes[(1, 2)])
        rec["cli"] = _parallel_cli(torch, build, counts, tmp, rank)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        rec["nccl"] = _nccl_world_of_one(torch, build, counts, config,
                                         params, X, Y, tmp)
    rec["counts"] = counts
    rec["launches"] = {}
    for section in counts.values():
        for k, v in section.items():
            rec["launches"][k] = rec["launches"].get(k, 0) + v
    with open(os.path.join(tmp, f"parallel_rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def parallel_phase(torch, card: str, tmp: str) -> dict:
    """Phase 10: PARALLEL_RANKS ranks spawned on the one card (gloo, the
    collectives through the host); each runs the checks of
    ``_parallel_rank``. Fails if a rank fails, exits non-zero or outlasts
    PARALLEL_TIMEOUT_S."""
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    torch.cuda.empty_cache()
    ctx = mp.start_processes(_parallel_rank, args=(PARALLEL_RANKS, tmp),
                             nprocs=PARALLEL_RANKS, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + PARALLEL_TIMEOUT_S
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                fail(f"parallel: the ranks ran past {PARALLEL_TIMEOUT_S} s")
    except ProcessException as e:
        fail(f"parallel: a rank failed: {e}")
    ranks = []
    for r in range(PARALLEL_RANKS):
        with open(os.path.join(tmp, f"parallel_rank{r}.json")) as f:
            ranks.append(json.load(f))
    fits = [r["fit"]["chunk_losses"] for r in ranks]
    if fits[0] != fits[1]:
        fail(f"parallel: the ranks saw different losses: {fits}")
    r0 = ranks[0]
    print(f"parallel: fit(mesh=) 1x2, {r0['fit']['steps_per_s']:.1f} "
          f"steps/s over {PARALLEL_STEPS} steps: two processes "
          f"time-sliced on one card, gloo through the host (not a scaling "
          f"figure); LGG IW K={L_TRAIN} M={M} B={B_TRAIN}; on {card}")
    print(f"parallel: evaluate(mesh=) test loglik "
          f"{r0['evaluate']['metrics']['test_loglik']:.6f} (unsharded "
          f"{r0['evaluate']['unsharded']['test_loglik']:.6f}); CLI test "
          f"loglik {r0['cli']['test_loglik']:.4f} (untrained "
          f"{r0['cli']['untrained_test_loglik']:.4f}); NCCL world of one "
          f"loss gap {r0['nccl']['loss_rel_err']:.2e}; on {card}")
    return {"ranks": ranks,
            "launches": [r["launches"] for r in ranks]}


AB_ORDER = ("parent", "change", "change", "parent")
AB_COND_CASES = [
    # (label, N, d_in, M, D, kernel, sample, residuals, iterations)
    ("'sample', serving inner layer", S_SERVE * B_SERVE, D_X + 1, M, D_X,
     "K4", True, False, 10),
    ("'infer', serving final layer", S_SERVE * B_SERVE, D_X, M, 1, "K4",
     False, False, 10),
    ("'sample', serving inner layer", S_SERVE * B_SERVE, D_X + 1, M, D_X,
     "K5", True, False, 5),
    ("'fused', serving final layer", S_SERVE * B_SERVE, D_X, M, 1, "K5",
     False, False, 5),
    ("'sample' with residuals, training", 20 * 512, D_X + 1, M, D_X, "K5",
     True, True, 50),
    ("'fused' with residuals, Adam-only training", 20 * 512, D_X, M, 1,
     "K5", False, True, 50),
]


# ---- phase 11: the FLOP count and the demos --------------------------------

# the flagship step's products per class (LGG, IW K=20, M=128, natgrad
# final, kin8nm's shape; B=8192 on the rows tiled past 8192): the pinned
# figures of tests/test_torch_flops.py, equal there to the reference's
# parse of its lowered chunk_fn
FLAGSHIP_FLOPS = {
    512: {"default": 9_135_144_960, "high": 2_084_044_800,
          "highest": 185_794_560},
    8192: {"default": 146_162_319_360, "high": 33_344_716_800,
           "highest": 2_191_196_160},
}
# the demos' runs, cut from the reference's 3000 and 4000 iterations
DEMO_STEPS = {"toy_1d": 300, "multitask": 300}
DEMO_CHUNK = 100
# the served route's gate, |a-b| / (1 + |b|), against float64; or twice
# the plain versions' own float32 gap to float64 where that is larger
# (toy_1d's trained Kuu has a condition number near 1e9: every float32
# route of its predictions sits ~1e-2 from float64)
DEMO_TOL = 1e-3


def expected_flops(harness, args, exp, mesh_shape=None) -> float:
    """step_cost's FLOPs per step for the run of `args` on `exp`'s model
    (one rank's step on a mesh of `mesh_shape`)."""
    from dgps_with_iwvi_torch.training import TrainConfig
    from dgps_with_iwvi_torch.utils.flops import step_cost

    tc = TrainConfig(natgrad=args.natgrad, schedule=args.schedule,
                     minibatch_size=args.minibatch_size,
                     solve_bwd_precision=args.solve_bwd_precision)
    with harness.gram_switches(args.gram_fwd_precision, args.gram_bwd_relax):
        return step_cost(exp.config, tc, exp.X.shape[0], dtype=exp.dtype,
                         mesh_shape=mesh_shape)["flops"]


def row_flops(row: dict, want: float, what: str, check=None) -> dict:
    """A results row's FLOP fields: flops_per_step finite and equal to
    step_cost's figure for the run, mfu and mfu_adjusted in (0, 1)."""
    check = check or (lambda ok, msg: ok or fail(msg))
    got = row["flops_per_step"]
    check(isinstance(got, (int, float)) and math.isfinite(got)
          and got == want, f"{what}: flops_per_step {got}, want {want}")
    for k in ("mfu", "mfu_adjusted"):
        check(row[k] is not None and 0.0 < row[k] < 1.0,
              f"{what}: {k} = {row[k]} is not in (0, 1)")
    return {k: row[k] for k in ("flops_per_step", "mfu", "mfu_adjusted")}


def _demo_predictions(torch, build, predict, params) -> tuple:
    """(arrays, launches) of predict(params) through the kernels, and per
    output the largest |a-b| / (1+|b|) of: the kernels against the plain
    versions, both against the plain versions in float64 on the same
    parameters, and each output's gate (DEMO_TOL)."""
    from dgps_with_iwvi_torch import params as tparams

    build.reset_launches()
    got = predict(params)
    counts = {k: v for k, v in _path_counts(build).items() if v}
    with build.plain_versions():
        plain = predict(params)
        exact = predict(tparams.params_from_numpy(
            tparams.params_to_numpy(params), "cuda", dtype=torch.float64))

    def gap(a, b):
        return float(np.max(np.abs(a - b) / (1.0 + np.abs(b))))

    gaps = {}
    for k, b in exact.items():
        if isinstance(b, np.ndarray) and b.dtype.kind == "f" and k in (
                "draws", "traversal", "mean", "var", "B", "noise_variance"):
            g = {"vs_plain": gap(got[k], plain[k]),
                 "vs_float64": gap(got[k], b),
                 "plain_vs_float64": gap(plain[k], b)}
            g["gate"] = max(DEMO_TOL, 2.0 * g["plain_vs_float64"])
            gaps[k] = g
    return got, counts, gaps


def demos_phase(torch, card: str) -> dict:
    """The two demos' compute halves on the card at a cut length (toy_1d
    300 of its 3000 steps, multitask 300 of 4000), in chunks of 100.

    Launches, written before the first run: both train full-batch, so the
    classes escalate to 'highest' and K2/K3 decline every training step.
    toy_1d (LG, natgrad final): per step K1 twice (the Kuu factor and the
    natgrad precision's factor), once more for the trained q(u)'s
    canonical form; per predict_f (the draws, S=60, and the traversal,
    S=7, each one batched GIVEN call) K1 once and K4 'infer' once (rbf,
    whitened, M=32). multitask (G, VI, Adam only): per step K1 once; per
    predict_f (one per task) K1 once and K2 'epi' once at M=32 (the
    coregion product is no rbf, so K4 declines). The loss falls from the
    first chunk to the last; the predictions through the kernels are
    within 1e-3 of |x|+1 of the same predictions through the plain
    versions in float64 on the same trained parameters, or within twice
    the plain versions' own float32 gap where that is larger (toy_1d's
    trained Kuu is near-singular, so every float32 route of it is ~1e-2
    off); the learned noise stds are printed beside the true ones. The
    plots are written where matplotlib imports."""
    from dgps_with_iwvi_torch.demos import multitask_icm, toy_1d
    from dgps_with_iwvi_torch.ops.hopper import build

    steps, rec = DEMO_STEPS, {}
    try:
        import matplotlib  # noqa: F401
        plots = True
    except ImportError:
        plots = False
    runs = [
        ("toy_1d", lambda: toy_1d.compute(
            steps["toy_1d"], device="cuda", chunk=DEMO_CHUNK),
         {"chol_inv": 2 * steps["toy_1d"] + 1},
         lambda r, p: toy_1d.predict(p, r["config"], r["ws"], "cuda"),
         {"chol_inv": 2, "serve_cond:infer": 2}, toy_1d),
        ("multitask", lambda: multitask_icm.compute(
            steps["multitask"], device="cuda", chunk=DEMO_CHUNK),
         {"chol_inv": steps["multitask"]},
         lambda r, p: multitask_icm.predict(p, r["config"], "cuda"),
         {"chol_inv": 3, "epilogue:epi": 3}, multitask_icm),
    ]
    for label, compute, train_want, predict, predict_want, mod in runs:
        t0 = time.perf_counter()
        build.reset_launches()
        r = compute()
        counts = {k: v for k, v in _path_counts(build).items() if v}
        want = {k: train_want.get(k, 0) + predict_want.get(k, 0)
                for k in {**train_want, **predict_want}}
        if counts != want:
            fail(f"demo {label}: launches {counts}, want {want} "
                 f"({steps[label]} steps, then the predictions)")
        losses = r["losses"]
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            fail(f"demo {label}: chunk losses {losses.tolist()} do not fall")
        got, pcounts, gaps = _demo_predictions(
            torch, build, lambda p: predict(r, p), r["params"])
        if pcounts != predict_want:
            fail(f"demo {label}: prediction launches {pcounts}, want "
                 f"{predict_want}")
        bad = {k: g for k, g in gaps.items()
               if not g["vs_float64"] <= g["gate"]}
        if bad:
            fail(f"demo {label}: the kernels' predictions off float64 "
                 f"beyond their gate: {bad} (|a-b|/(1+|b|))")
        out = {"steps": steps[label], "launches": counts,
               "launches_per_prediction": pcounts,
               "chunk_losses": losses.tolist(), "vs_plain_on_card": gaps,
               "seconds": time.perf_counter() - t0}
        if label == "multitask":
            out["noise_sd"] = np.sqrt(r["noise_variance"]).tolist()
            out["true_sd"] = list(multitask_icm.TRUE_STDS)
            print(f"demo multitask: learned noise sd "
                  f"{np.round(out['noise_sd'], 3).tolist()} (true "
                  f"{out['true_sd']}) after {steps[label]} steps on {card}")
        else:
            out["noise_sd"] = float(np.sqrt(r["noise_variance"]))
        if plots:
            out["png"] = mod.plot(r, os.path.join(
                tempfile.gettempdir(), f"{label}_torch.png"))
        print(f"demo {label}: {steps[label]} steps, chunk losses "
              f"{np.round(losses, 3).tolist()}, launches {counts}, per "
              f"prediction {pcounts}, vs plain {gaps}, "
              f"{out['seconds']:.1f} s; plot "
              f"{'written' if plots else 'skipped: no matplotlib'} on {card}")
        rec[label] = out
    return rec


def flops_phase(torch, card: str, rec: dict) -> dict:
    """(a) step_cost of the flagship at B=512 and B=8192 on this machine,
    held to the pinned per-class figures exactly; MFU and adjusted MFU at
    phase 5's measured steps/s (B=512, B=8192, use_pallas B=512), and at
    the device-busy time per step where --profile measured it; (b) the
    results rows of phases 6, 8, 9 and 10 (checked there, listed here);
    (c) the demos (``demos_phase``)."""
    from dgps_with_iwvi_torch.models import BuildArgs, build_config
    from dgps_with_iwvi_torch.training import TrainConfig
    from dgps_with_iwvi_torch.utils import flops

    name, peak = flops.device_peak("cuda")
    if peak is None:
        fail(f"flops: no peak for {name!r} (utils/flops.py PEAK_FLOPS)")
    args = BuildArgs(configuration="LGG", mode="IW", num_inducing=M,
                     num_iw_samples=L_TRAIN)
    reps = (B_BIG + N_KIN8NM - 1) // N_KIN8NM + 1
    t = rec["train"]
    shapes = [
        (B_TRAIN, N_KIN8NM, [
            ("B=512", t["steps_per_s_b512"], t.get("profile_b512")),
            ("use_pallas B=512",
             t["use_pallas"]["natgrad final"]["steps_per_s_b512"], None)]),
        (B_BIG, N_KIN8NM * reps, [
            ("B=8192", t["steps_per_s_b8192"], t.get("profile_b8192"))]),
    ]
    out = {"peak_bf16": peak, "steps": {}}
    for B, n, rates in shapes:
        config = build_config(args, D_KIN8NM, 1, n)
        tc = TrainConfig(lr=5e-3, gamma=1e-2, natgrad="final",
                         minibatch_size=B)
        t0 = time.perf_counter()
        cost = flops.step_cost(config, tc, n)
        count_ms = (time.perf_counter() - t0) * 1e3
        if cost["flops_by_class"] != FLAGSHIP_FLOPS[B]:
            fail(f"flops: the flagship at B={B} counts "
                 f"{cost['flops_by_class']}, pinned {FLAGSHIP_FLOPS[B]}")
        print(f"flops: flagship step at B={B}: {json.dumps(cost)} "
              f"(counted in {count_ms:.3f} ms) on {card}")
        for label, sps, prof in rates:
            e = {"flops_per_step": cost["flops"],
                 "adjusted_flops_per_step": cost["adjusted_flops"],
                 "steps_per_s": sps,
                 "mfu": cost["flops"] * sps / peak,
                 "mfu_adjusted": cost["adjusted_flops"] * sps / peak}
            line = (f"flops: {label}: {sps:.2f} steps/s -> mfu "
                    f"{e['mfu']:.6f}, mfu_adjusted {e['mfu_adjusted']:.6f}")
            if prof:
                busy = 1e3 / prof["device_ms_per_step"]
                e.update(device_busy_steps_per_s=busy,
                         mfu_device_busy=cost["flops"] * busy / peak,
                         mfu_adjusted_device_busy=(
                             cost["adjusted_flops"] * busy / peak))
                line += (f"; at the device-busy time per step "
                         f"({prof['device_ms_per_step']:.3f} ms): mfu "
                         f"{e['mfu_device_busy']:.6f}, mfu_adjusted "
                         f"{e['mfu_adjusted_device_busy']:.6f}")
            print(f"{line} on {card}")
            out["steps"][label] = e
    out["rows"] = {
        "harness": rec["harness"]["row_flops"],
        **{f"{phase}_{k}": v["row_flops"]
           for phase in ("families", "breadth")
           for k, v in rec[phase].items()
           if isinstance(v, dict) and "row_flops" in v},
        **{f"parallel_cli_rank{r}": rk["cli"]["row_flops"]
           for r, rk in enumerate(rec["parallel"]["ranks"])}}
    print("flops: results rows " + json.dumps(out["rows"]) + f" on {card}")
    out["demos"] = demos_phase(torch, card)
    return out


GRAPH_TURNS = ("eager", "graph", "eager", "graph")
# (label, batch, DGPConfig fields replaced, steps per turn, launches per
# step): the flagship step (natgrad final) at B=512 and B=8192 and with
# use_pallas, as in phase 5
GRAPH_TRAIN = [
    ("flagship B=512", B_TRAIN, {}, 100,
     {"chol_inv": 2, "epilogue:epi": 2, "epilogue_bwd:epi": 2}),
    ("flagship B=8192", B_BIG, {}, 20,
     {"chol_inv": 2, "epilogue:epi": 2, "epilogue_bwd:epi": 2}),
    ("use_pallas B=512", B_TRAIN, {"use_pallas": True}, 100,
     {"conditional:sample": 1, "epilogue:epi": 1, "epilogue_bwd:epi": 1,
      "chol_inv": 2}),
]
# (label, DGPConfig fields replaced, launches per request): phases 4's
# three serving routes
GRAPH_SERVE = [
    ("K2 route", {"serve_pallas": False},
     {"chol_inv": 1, "epilogue:epi": 2}),
    ("default (K4)", {},
     {"serve_cond:sample": 1, "serve_cond:infer": 1, "chol_inv": 1}),
    ("use_pallas", {"use_pallas": True, "serve_pallas": False},
     {"conditional:sample": 1, "conditional:fused": 1, "chol_inv": 1}),
]


def _graph_train_case(torch, train, build, model, label, batch, fields,
                      steps, want, profile) -> dict:
    """One training case of phase 12: the eager chunk (make_trainer's
    loop of step_fn) and the graphed chunk (``graphed_chunk_fn``, what fit
    runs on the card) from equal states and generator states, in turns;
    after each pair of turns the losses and every state leaf equal
    bitwise; launches per step exact in every turn; MFU at each turn's
    rate (``utils.flops``)."""
    import dataclasses

    from dgps_with_iwvi_torch.experiments import profile_step
    from dgps_with_iwvi_torch.utils import flops

    config, params, X, Y = model
    if batch > X.shape[0]:  # the data tiled past the batch, as bench.py
        reps = (batch + X.shape[0] - 1) // X.shape[0] + 1
        X, Y = X.repeat(reps, 1), Y.repeat(reps, 1)
    config = dataclasses.replace(config, num_data=X.shape[0], **fields)
    tc = train.TrainConfig(lr=5e-3, gamma=1e-2, natgrad="final",
                           minibatch_size=batch, steps_per_call=steps)
    init, step, chunk, _ = train.make_trainer(config, tc)
    state = {"eager": init(params), "graph": init(params)}
    gens = {k: torch.Generator(device="cuda").manual_seed(0)
            for k in state}
    fns = {"eager": chunk,
           "graph": train.graphed_chunk_fn(step, tc, state["graph"], X, Y,
                                           gens["graph"])}
    # the first chunk of each side outside the turns: the graph's holds
    # its warm-up step and its capture
    firsts = {}
    for side in ("eager", "graph"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state[side], firsts[side] = fns[side](state[side], X, Y, gens[side])
        torch.cuda.synchronize()
        firsts[side + "_s"] = time.perf_counter() - t0
        firsts[side + "_peak_gib"] = (torch.cuda.max_memory_allocated()
                                      / 2 ** 30)
        # what the allocator holds after it: the graph's private pool and
        # the capture stream's cache beside what is live
        firsts[side + "_reserved_gib"] = (torch.cuda.memory_reserved()
                                          / 2 ** 30)
    if not torch.equal(firsts["eager"], firsts["graph"]):
        fail(f"graphs, train {label}: the first graphed chunk's losses "
             "differ from the eager chunk's")
    captured = fns["graph"].graphs.graphs()
    if len(captured) != 1:
        fail(f"graphs, train {label}: {len(captured)} graphs, want 1")
    turns = []
    for i, side in enumerate(GRAPH_TURNS):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        t0 = time.perf_counter()
        state[side], losses = fns[side](state[side], X, Y, gens[side])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: v for k, v in _path_counts(build).items() if v}
        if counts != {k: v * steps for k, v in want.items()}:
            fail(f"graphs, train {label} ({side}): launches {counts} in "
                 f"{steps} steps, want per step {want}")
        if not bool(torch.isfinite(losses).all()):
            fail(f"graphs, train {label} ({side}): a loss is not finite")
        turns.append({"side": side, "steps_per_s": steps / wall,
                      "launches": counts,
                      "peak_mem_gib": torch.cuda.max_memory_allocated()
                      / 2 ** 30, "losses": losses})
    for e, g in ((turns[0], turns[1]), (turns[2], turns[3])):
        if not torch.equal(e.pop("losses"), g.pop("losses")):
            fail(f"graphs, train {label}: replayed losses differ from the "
                 "eager steps'")
    leaves = [_state_leaves(state[side]) for side in ("eager", "graph")]
    differ = [i for i, (a, b) in enumerate(zip(*leaves)) if not
              torch.equal(a, b)]
    if differ or not torch.equal(gens["eager"].get_state(),
                                 gens["graph"].get_state()):
        fail(f"graphs, train {label}: after {3 * steps} steps the graphed "
             f"state differs from the eager one in leaves {differ} (or the "
             "generator)")
    cost = flops.step_cost(config, tc, X.shape[0])
    _, peak = flops.device_peak("cuda")
    rates = {side: [t["steps_per_s"] for t in turns if t["side"] == side]
             for side in ("eager", "graph")}
    rec = {"batch": batch, "steps_per_turn": steps, "turns": turns,
           "eager_steps_per_s": rates["eager"],
           "graph_steps_per_s": rates["graph"],
           "flops_per_step": cost["flops"],
           "mfu": {side: [cost["flops"] * r / peak for r in v]
                   for side, v in rates.items()},
           "mfu_adjusted": {side: [cost["adjusted_flops"] * r / peak
                                   for r in v]
                            for side, v in rates.items()},
           "capture_s": captured[0].capture_s,
           "first_chunk_s": {k: firsts[k + "_s"] for k in state},
           "first_chunk_peak_mem_gib": {k: firsts[k + "_peak_gib"]
                                        for k in state},
           "reserved_after_first_chunk_gib": {
               k: firsts[k + "_reserved_gib"] for k in state},
           "launches_per_replay": dict(captured[0].launches),
           "bitwise_equal_after_steps": 3 * steps,
           "first_chunk_steps": steps,
           "leaves_compared": len(leaves[0])}
    if profile:
        rec["profile_graph"] = profile_step.profile_chunk(
            fns["graph"], state["graph"], X, Y, gens["graph"], steps)
    return rec


def _state_leaves(state) -> list:
    """Every tensor of a TrainState: rest, natvars, Adam's moments."""
    from dgps_with_iwvi_torch.training import train

    opt = state.opt_state.state_dict()["state"]
    return (train._leaves(state.rest) + train._leaves(state.natvars)
            + [t for s in opt.values() for t in s.values()])


def _graph_serve_case(torch, serving, build, model, label, fields,
                      want) -> dict:
    """One serving route of phase 12: ``score_table`` over make_scorer_fn's
    eager calls against ``Scorer.score`` (a replayed graph per request),
    the same REQUESTS batches and seeds, in turns: outputs bitwise equal,
    launches per request exact in every turn."""
    import dataclasses

    X, Y, config, params, _ = model
    cfg = dataclasses.replace(config, **fields)
    Xs, Ys, stats = _requests(X, Y)
    n = REQUESTS * B_SERVE
    fn = serving.make_scorer_fn(params, cfg, S_SERVE, stats, device="cuda")
    scorer = serving.Scorer(params, cfg, S_SERVE, stats, device="cuda")
    batches = serving.fixed_batches(n, B_SERVE)

    def eager(x, y, seed):
        return serving.score_table(
            lambda i, xb, yb: fn(xb, yb, seed + i), x, y, D_X, 1,
            serving.fixed_batches(len(x), B_SERVE), torch.device("cuda"))

    sides = {"eager": eager,
             "graph": lambda x, y, seed: scorer.score(x, y, seed=seed,
                                                      max_batch=B_SERVE)}
    firsts = {}
    for side, f in sides.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f(Xs[:B_SERVE], Ys[:B_SERVE], 0)
        firsts[side] = time.perf_counter() - t0
    captured = scorer._graphed.graphs.graphs()
    turns, outs = [], {}
    for i, side in enumerate(GRAPH_TURNS):
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        out = sides[side](Xs, Ys, 100 + i // 2)
        wall = time.perf_counter() - t0
        counts = {k: v for k, v in _path_counts(build).items() if v}
        if counts != {k: v * len(batches) for k, v in want.items()}:
            fail(f"graphs, serve {label} ({side}): launches {counts} in "
                 f"{len(batches)} requests, want per request {want}")
        outs[(side, i // 2)] = out
        turns.append({"side": side, "points_per_s": n / wall,
                      "launches": counts})
    for r in range(2):
        for k in ("mean", "var", "log_density"):
            if not np.array_equal(outs[("eager", r)][k],
                                  outs[("graph", r)][k]):
                fail(f"graphs, serve {label}: replayed {k} differs from "
                     "the eager requests'")
    return {"turns": turns,
            "eager_points_per_s": [t["points_per_s"] for t in turns
                                   if t["side"] == "eager"],
            "graph_points_per_s": [t["points_per_s"] for t in turns
                                   if t["side"] == "graph"],
            "capture_s": captured[0].capture_s,
            "first_request_s": firsts,
            "launches_per_replay": dict(captured[0].launches)}


EVAL_TABLE_ROWS = 51_630  # year's test split: 12 chunks of 4096, 2478 left
EVAL_TABLE_SEED = 1
EVAL_SEED = 11
# (label, phase's checkpoint directory in the run's tmp, DGPConfig fields
# replaced): evaluation's four routes
GRAPH_EVAL = [
    ("default (K4)", "a", {}),
    ("K2 route", "a", {"serve_pallas": False}),
    ("--no_white", "breadth_no_white", {}),
    ("multiclass", "family_multiclass", {}),
]


def surrogate_table(rows: int, seed: int):
    """`rows` new points of phase 6's data, the kin8nm surrogate
    (``data.datasets._synthetic_regression``): its random-feature function
    and noise at inputs drawn from `seed`. The surrogate's own rows are
    regenerated first and must equal it. Returns raw X [rows, 8], raw y
    [rows] and the surrogate's own raw y (the multiclass loader bins by
    its quantiles)."""
    import hashlib

    from dgps_with_iwvi_torch.data import datasets

    n, d = datasets.UCI_REGISTRY["kin8nm"]
    X0, Y0 = datasets._synthetic_regression("kin8nm", n, d)
    rng = np.random.RandomState(int.from_bytes(
        hashlib.sha256(b"kin8nm").digest()[:4], "little"))
    X_own = rng.randn(n, d)
    omega = rng.randn(d, 64) / np.sqrt(d)
    b = rng.uniform(0, 2 * np.pi, 64)
    w = rng.randn(64) / np.sqrt(64)

    def draw(X, r):
        f = np.cos(X @ omega + b) @ w
        return f + (0.1 + 0.1 * (np.tanh(f) + 1.0)) * r.randn(len(f))

    if not (np.array_equal(X_own, X0)
            and np.array_equal(draw(X_own, rng), Y0[:, 0])):
        fail("graphs, eval: the surrogate's generator is not the one "
             "this table replays")
    new = np.random.RandomState(seed)
    X = new.randn(rows, d)
    return X, draw(X, new), Y0[:, 0]


def _eval_inputs(torch, config, data, table) -> tuple:
    """(X, Y) device tensors of the raw table in the model's units: X
    standardized by the train split; Y standardized (regression) or the
    multiclass loader's quantile bins of the surrogate's y."""
    X, y, y_own = table
    Xt = ((X - data.X_mean) / data.X_std).astype(np.float32)
    if config.likelihood == "multiclass":
        C = config.layers[-1].d_out
        edges = np.quantile(y_own, np.linspace(0, 1, C + 1)[1:-1])
        Yt = np.searchsorted(edges, y).astype(np.float32)[:, None]
    else:
        Yt = ((y[:, None] - data.Y_mean) / data.Y_std).astype(np.float32)
    return torch.from_numpy(Xt).cuda(), torch.from_numpy(Yt).cuda()


def _pool_bytes(torch, graph):
    """Bytes of the segments of `graph`'s private memory pool (a
    ``utils.graphs.Graph``), or None where the snapshot names no pool."""
    pool = tuple(graph._graph.pool())
    segs = [seg for seg in torch.cuda.memory_snapshot()
            if tuple(seg.get("segment_pool_id") or ()) == pool]
    return sum(seg["total_size"] for seg in segs) if segs else None


def _same_eval(a, b) -> bool:
    """Points (log-density, mean) bitwise and metrics equal (NaN = NaN)."""
    (pa, ma), (pb, mb) = a, b
    return (all(np.array_equal(x, y) for x, y in zip(pa, pb))
            and ma.keys() == mb.keys()
            and all(ma[k] == mb[k] or (math.isnan(ma[k])
                                       and math.isnan(mb[k])) for k in ma))


def _graph_eval_case(torch, metrics, build, label, config, params, X, Y,
                     y_std, other) -> dict:
    """One route of evaluation in phase 12: ``evaluate``'s chunks eagerly
    (``metrics._points`` with ``graphed=False``, the CPU and mesh path)
    against one replay of the cached ``GraphedEval`` per chunk, the same
    table and seed, in turns: every point's log-density and mean and every
    metric bitwise, launches equal to the eager call's and to the
    capture's tally per chunk, no new capture after the first call. Then
    ``evaluate`` itself, and, with `other` parameters, a call that must
    replay the same graph and equal eager evaluation of them."""
    S, bs, n = HARNESS_SAMPLES, EVAL_BATCH, X.shape[0]
    chunks = -(-n // bs)
    Yn = Y.cpu().numpy()
    lik = config.likelihood

    def run(graphed, p=params):
        points = metrics._points(p, config, X, Y, EVAL_SEED, S, bs, None,
                                 graphed)
        return points, metrics._metrics(*points, Yn, y_std, lik)

    def timed(graphed, p=params):
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        out = run(graphed, p)
        wall = time.perf_counter() - t0
        return out, wall, {k: v for k, v in _path_counts(build).items()
                           if v}

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()
    eager0, eager_s, eager_counts = timed(False)
    graph0, graph_s, graph_counts = timed(True)
    program = metrics.eval_programs()[-1]
    captured = program.graphs.graphs()
    if len(captured) != 1:
        fail(f"graphs, eval {label}: {len(captured)} graphs, want 1")
    graph = captured[0]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved_delta = torch.cuda.memory_reserved() - reserved0
    static = sum(t.numel() * t.element_size() for t in
                 metrics._leaves(program.params) + [program.x, program.y])
    per_chunk = dict(graph.launches)
    if graph_counts != eager_counts or eager_counts != {
            k: v * chunks for k, v in per_chunk.items() if ":" in k
            or k == "chol_inv"}:
        fail(f"graphs, eval {label}: launches {graph_counts} graphed, "
             f"{eager_counts} eager, per replay {per_chunk} x {chunks}")
    if not _same_eval(eager0, graph0):
        fail(f"graphs, eval {label}: the first graphed call differs from "
             "the eager one")
    turns, outs = [], {}
    for i, side in enumerate(GRAPH_TURNS):
        out, wall, counts = timed(side == "graph")
        if counts != eager_counts:
            fail(f"graphs, eval {label} ({side}): launches {counts}, want "
                 f"{eager_counts}")
        outs[(side, i // 2)] = out
        turns.append({"side": side, "points_per_s": n / wall,
                      "launches": counts})
    for r in range(2):
        if not (_same_eval(outs[("eager", r)], outs[("graph", r)])
                and _same_eval(outs[("eager", r)], eager0)):
            fail(f"graphs, eval {label}: replayed points or metrics differ "
                 "from the eager chunks'")
    public = metrics.evaluate(params, config, X, Y, EVAL_SEED, y_std=y_std,
                              num_samples=S, likelihood=lik)
    if not _same_eval((eager0[0], public), eager0):
        fail(f"graphs, eval {label}: evaluate's metrics {public} differ "
             f"from the eager chunks' {eager0[1]}")
    rec = {"rows": n, "chunks": chunks, "batch": bs, "samples": S,
           "turns": turns,
           "eager_points_per_s": [t["points_per_s"] for t in turns
                                  if t["side"] == "eager"],
           "graph_points_per_s": [t["points_per_s"] for t in turns
                                  if t["side"] == "graph"],
           "first_call_s": {"eager": eager_s, "graph": graph_s},
           "capture_s": graph.capture_s,
           "pool_bytes": _pool_bytes(torch, graph),
           "static_bytes": static,
           "reserved_after_first_calls_bytes": reserved_delta,
           "launches_per_replay": per_chunk,
           "metrics": eager0[1], "bitwise_equal": True}
    if other is not None:
        got, _, counts = timed(True, other)
        want, _, _ = timed(False, other)
        if metrics.eval_programs()[-1] is not program or \
                program.graphs.graphs() != [graph]:
            fail(f"graphs, eval {label}: the second parameters made a new "
                 "program or graph")
        if counts != eager_counts or not _same_eval(got, want) or \
                _same_eval(got, eager0):
            fail(f"graphs, eval {label}: the second parameters' replay "
                 f"({counts}) is not the eager evaluation of them")
        rec["other_params"] = {"metrics": got[1], "bitwise_equal": True,
                               "new_capture": False}
    return rec


def graphs_phase(torch, card: str, model, profile: bool, tmp: str) -> dict:
    """12. graphs: eager against graphed steps and requests in turns
    (eager, graph, eager, graph) within this call."""
    from dgps_with_iwvi_torch import serving
    from dgps_with_iwvi_torch import training as train
    from dgps_with_iwvi_torch.ops.hopper import build

    flag = flagship_model(torch)
    out = {"train": {}, "serve": {}}
    for label, batch, fields, steps, want in GRAPH_TRAIN:
        out["train"][label] = r = _graph_train_case(
            torch, train, build, flag, label, batch, fields, steps, want,
            profile)
        print(f"graphs, train {label}: eager "
              + ", ".join(f"{v:.1f}" for v in r["eager_steps_per_s"])
              + " / graph " + ", ".join(f"{v:.1f}" for v in
                                        r["graph_steps_per_s"])
              + f" steps/s; capture {r['capture_s']:.2f} s; peak "
              f"{r['first_chunk_peak_mem_gib']['eager']:.2f} / "
              f"{r['first_chunk_peak_mem_gib']['graph']:.2f} GiB, reserved "
              f"{r['reserved_after_first_chunk_gib']['eager']:.2f} / "
              f"{r['reserved_after_first_chunk_gib']['graph']:.2f} GiB "
              f"(first chunk, eager / graph); MFU eager "
              + ", ".join(f"{v:.5f}" for v in r["mfu"]["eager"])
              + " / graph " + ", ".join(f"{v:.5f}" for v in
                                        r["mfu"]["graph"])
              + f"; bitwise equal; on {card}")
    for label, fields, want in GRAPH_SERVE:
        out["serve"][label] = r = _graph_serve_case(
            torch, serving, build, model, label, fields, want)
        print(f"graphs, serve {label}: eager "
              + ", ".join(f"{v:.0f}" for v in r["eager_points_per_s"])
              + " / graph " + ", ".join(f"{v:.0f}" for v in
                                        r["graph_points_per_s"])
              + f" points/s; capture {r['capture_s']:.2f} s; bitwise "
              f"equal; on {card}")
    out["eval"] = eval_graphs(torch, card, tmp)
    return out


def eval_graphs(torch, card: str, tmp: str) -> dict:
    """Phase 12's evaluation cases: phase 6's model at step 400 on the
    default route (K4) and the K2 route, phase 9's --no_white model and
    phase 8's multiclass model, each scoring a table of EVAL_TABLE_ROWS
    new rows of the kin8nm surrogate at S=100 in 4096-row chunks; the
    default route then takes phase 6's step-200 model as the second
    parameters."""
    import dataclasses

    from dgps_with_iwvi_torch.evaluation import metrics
    from dgps_with_iwvi_torch.ops.hopper import build

    table = surrogate_table(EVAL_TABLE_ROWS, EVAL_TABLE_SEED)
    step200 = os.path.join(tmp, "eval_step200")
    os.makedirs(step200, exist_ok=True)
    for name in (f"step_{HARNESS_RESUME_AT}.pt", "build_args.json"):
        shutil.copy(os.path.join(tmp, "a", name), step200)
    out = {}
    for label, ckpt, fields in GRAPH_EVAL:
        config, params, data = _restore(torch, tmp, os.path.join(tmp, ckpt))
        config = dataclasses.replace(config, **fields)
        X, Y = _eval_inputs(torch, config, data, table)
        other = (_restore(torch, tmp, step200)[1] if label == "default (K4)"
                 else None)
        out[label] = r = _graph_eval_case(
            torch, metrics, build, label, config, params, X, Y,
            data.Y_std, other)
        pool = ("not measured" if r["pool_bytes"] is None
                else f"{r['pool_bytes'] / 2 ** 30:.3f} GiB")
        print(f"graphs, eval {label}: {r['rows']} rows, {r['chunks']} "
              "chunks at S=100: eager "
              + ", ".join(f"{v:.0f}" for v in r["eager_points_per_s"])
              + " / graph " + ", ".join(f"{v:.0f}" for v in
                                        r["graph_points_per_s"])
              + f" points/s; first call {r['first_call_s']['eager']:.3f} "
              f"/ {r['first_call_s']['graph']:.3f} s (eager / graph, "
              f"capture {r['capture_s']:.3f} s); pool {pool}, static "
              f"{r['static_bytes'] / 2 ** 20:.1f} MiB, reserved after the "
              f"first calls "
              f"{r['reserved_after_first_calls_bytes'] / 2 ** 30:.3f} GiB; "
              f"per replay {r['launches_per_replay']}; bitwise "
              f"equal{'; step-200 params replayed bitwise' if other else ''}"
              f"; on {card}")
    programs = metrics.eval_programs()
    pools = [_pool_bytes(torch, g) for p in programs
             for g in p.graphs.graphs()]
    out["cache"] = {
        "programs": len(programs), "limit": metrics.EVAL_GRAPHS,
        "pool_bytes": (None if None in pools else sum(pools)),
        "static_bytes": sum(t.numel() * t.element_size() for p in programs
                            for t in metrics._leaves(p.params)
                            + [p.x, p.y])}
    c = out["cache"]
    print(f"graphs, eval cache: {c['programs']} programs (limit "
          f"{c['limit']}), pools "
          + ("not measured" if c["pool_bytes"] is None
             else f"{c['pool_bytes'] / 2 ** 30:.3f} GiB")
          + f", static {c['static_bytes'] / 2 ** 20:.1f} MiB; on {card}")
    return out


# phase 13: the configurations of the quick gate, and its evaluation chunk
GATE_PHASE_CONFIGS = ("LGG-kin8nm natgrad", "GG-energy ADAM-ONLY")


def _gate_want(gc, steps: int, n_test: int, highest: bool) -> dict:
    """Launches of one gate run: the training's (K1 for the Kuu prefactor
    and, with natgrad, the natgrad step, plus once for the trained q(u)'s
    canonical form; K2/K3 'epi' per GP layer at the ``default`` class
    only) and the measurement's (K1 per bound and per test chunk)."""
    _, _, conf, _, _, natgrad = gc
    ng = natgrad != "none"
    want = {"chol_inv": (1 + ng) * steps + ng + 8 + -(-n_test // EVAL_BATCH)}
    if not highest:
        layers = conf.count("G")
        want["epilogue:epi"] = want["epilogue_bwd:epi"] = layers * steps
    return want


def gate_phase(torch, card: str, tmp: str) -> dict:
    """13. quality gate: the quick gate on GATE_PHASE_CONFIGS, launches
    counted per run and per side."""
    from dgps_with_iwvi_torch.data import get_regression_data
    from dgps_with_iwvi_torch.experiments import quality_gate as qg
    from dgps_with_iwvi_torch.ops.hopper import build

    runs = []
    run_setting = qg.run_setting

    def counted(*gc, **kw):
        build.reset_launches()
        out = run_setting(*gc, **kw)
        counts = {k: v for k, v in _path_counts(build).items() if v}
        highest = kw["var_precision"] == "highest"
        n_test = get_regression_data(gc[1], 0).X_test.shape[0]
        want = _gate_want(gc, kw["iterations"], n_test, highest)
        if counts != want:
            fail(f"gate: {gc[0]} ({'highest' if highest else 'candidate'}, "
                 f"seed {kw.get('seed', 0)}): launches {counts}, want "
                 f"{want}")
        runs.append({"config": gc[0], "highest": highest,
                     "seed": kw.get("seed", 0), "launches": counts,
                     "steps_per_s": out["steps_per_s"],
                     "train_s": out["train_s"], "finite": out["finite"]})
        return out

    qg.run_setting = counted
    try:
        verdict = qg.main(["--quick", "--configs", ",".join(
            GATE_PHASE_CONFIGS), "--out", os.path.join(tmp, "gate")])
    finally:
        qg.run_setting = run_setting
    sides = {"gate_candidate": {}, "gate_highest": {}}
    for r in runs:
        side = sides["gate_highest" if r["highest"] else "gate_candidate"]
        for k, v in r["launches"].items():
            side[k] = side.get(k, 0) + v
    for row in verdict["rows"]:
        rates = [r["steps_per_s"] for r in runs
                 if r["config"] == row["config"]]
        print(f"gate: {row['config']}: {'PASS' if row['ok'] else 'FAIL'} "
              f"dELBO rel {row['d_elbo_rel']:.3e} (tol "
              f"{row['tol_elbo_rel']:.3e}), dNLL {row['d_nll']:.4f} (tol "
              f"{row['tol_nll']:.4f}), {row['seconds']:.1f} s, steps/s "
              + ", ".join(f"{v:.1f}" for v in rates)
              + f" (ref, ref seed 1, cand; {verdict['iterations']} steps, "
              f"graphed, capture included); finite {row['finite']}; on "
              f"{card}")
    if not verdict["pass"]:
        fail("gate: FAIL on "
             + ", ".join(r["config"] for r in verdict["rows"] if not r["ok"]))
    if not verdict["backend"].startswith(torch.cuda.get_device_name(0)):
        fail(f"gate: measured on {verdict['backend']!r}, not the card")
    return {"verdict": verdict, "runs": runs, "launches": sides}


# phase 14: the reference's pin of the paper's claim
# (tests/test_iw_quality.py:26-33), at four seeds fixed here
PIN_SEEDS = (0, 1, 2, 3)
PIN_DATA = (256, 512, 0)        # standardized(n_train, n_test, seed)
PIN_M, PIN_STEPS, PIN_K = 16, 1500, 10
PIN_MARGIN = 0.05               # nats: the reference's NLL margin
PIN_BOUNDS = 3                  # elbo VI, elbo IW20, iw_diagnostics
# one run at the full experiment's shape (bimodal N=2000/2000, M=64,
# minibatch 512 < N), cut to one 500-step chunk: the path of the
# published rows, LGG IW20 (two GP layers)
FULL_DATA = (2000, 2000, 0)
FULL_CONF, FULL_K, FULL_M, FULL_STEPS = "LGG", 20, 64, 500


def _pin_want(steps: int, n_train: int, n_test: int,
              conf: str = "LG") -> tuple:
    """Launches of one run of ``run_one``: (training, evaluation).
    Training: K1 for the Kuu prefactor (every layer's in one batch) and
    for the natgrad step on every step, and once for the trained q(u)'s
    canonical form; K2/K3 'epi' once per GP layer and step, only on a
    minibatch below N, since a full-batch step (min(512, N) = N, as at the
    pin) rises to the 'highest' classes. Evaluation, in no-grad on the
    card: per S=500 test chunk and per bound (PIN_BOUNDS), K1 once, K4
    'infer' once (the final layer) and K4 'sample' once per inner GP
    layer."""
    layers = conf.count("G")
    train = {"chol_inv": 2 * steps + 1}
    if min(512, n_train) < n_train:
        train["epilogue:epi"] = train["epilogue_bwd:epi"] = layers * steps
    calls = -(-n_test // EVAL_BATCH) + PIN_BOUNDS
    evals = {"chol_inv": calls, "serve_cond:infer": calls}
    if layers > 1:
        evals["serve_cond:sample"] = (layers - 1) * calls
    return train, evals


def iw_vs_vi_phase(torch, card: str) -> dict:
    """14. iw_vs_vi: ``experiments.iw_vs_vi.run_one`` on the reference's
    pin (bimodal data, LG, M=16, 1500 steps, VI against IW with K=10) at
    each of PIN_SEEDS; fails unless the mean NLL gap (VI minus IW) is
    above PIN_MARGIN and the mean IW20 bound of the IW-trained parameters
    is above the VI-trained ones'. Then one run at the full experiment's
    shape (FULL_*), whose minibatch is below N, with finite outputs.
    Launches counted per run: training (``fit``, build included) and
    evaluation (``evaluate`` and the bounds), kernels line paths
    ``iw_vs_vi_train`` / ``iw_vs_vi_eval``."""
    from dgps_with_iwvi_torch.experiments import iw_vs_vi as ivv
    from dgps_with_iwvi_torch.ops.hopper import build

    sides = {"iw_vs_vi_train": {}, "iw_vs_vi_eval": {}}
    fit = ivv.fit
    seg = {}

    def counted_fit(*a, **kw):
        out = fit(*a, **kw)
        seg["train"] = {k: v for k, v in _path_counts(build).items() if v}
        build.reset_launches()
        return out

    def counted_run(tag, conf, mode, K, data, steps, m, seed):
        """run_one with its launches held to ``_pin_want``'s."""
        want_train, want_eval = _pin_want(steps, len(data[0]),
                                          len(data[2]), conf)
        build.reset_launches()
        t0 = time.perf_counter()
        out = ivv.run_one(tag, conf, mode, K, data, iterations=steps, M=m,
                          seed=seed)
        out["run_s"] = time.perf_counter() - t0
        got_eval = {k: v for k, v in _path_counts(build).items() if v}
        for what, got, want in (("training", seg["train"], want_train),
                                ("evaluation", got_eval, want_eval)):
            if got != want:
                fail(f"iw_vs_vi: {tag}: {what} launches {got}, want {want}")
        for side, counts in (("iw_vs_vi_train", seg["train"]),
                             ("iw_vs_vi_eval", got_eval)):
            for k, v in counts.items():
                sides[side][k] = sides[side].get(k, 0) + v
        out["launches"] = {"train": seg["train"], "eval": got_eval}
        return out

    runs = []
    ivv.fit = counted_fit
    try:
        data = ivv.standardized(*PIN_DATA, bimodal=True)
        for seed in PIN_SEEDS:
            pair = {}
            for mode, K in (("VI", 1), ("IW", PIN_K)):
                tag = f"LG-{mode}{K if mode == 'IW' else ''} seed {seed}"
                pair[mode] = counted_run(tag, "LG", mode, K, data,
                                         PIN_STEPS, PIN_M, seed)
            vi, iw = pair["VI"], pair["IW"]
            row = {"seed": seed, "nll_vi": -vi["test_loglik"],
                   "nll_iw": -iw["test_loglik"],
                   "bound_iw20_vi": vi["bound_iw20"],
                   "bound_iw20_iw": iw["bound_iw20"],
                   "ess20_vi": vi["ess20"], "ess20_iw": iw["ess20"],
                   "run_s_vi": vi["run_s"], "run_s_iw": iw["run_s"],
                   "steps_per_s_vi": vi["steps_per_s"],
                   "steps_per_s_iw": iw["steps_per_s"]}
            runs.append(row)
            print(f"iw_vs_vi: seed {seed}: NLL VI {row['nll_vi']:+.4f} IW"
                  f"{PIN_K} {row['nll_iw']:+.4f} (gap "
                  f"{row['nll_vi'] - row['nll_iw']:+.4f}); IW20 bound/n "
                  f"VI-trained {row['bound_iw20_vi']:+.4f} IW-trained "
                  f"{row['bound_iw20_iw']:+.4f}; ESS(K=20) "
                  f"{row['ess20_vi']:.1f} / {row['ess20_iw']:.1f}; "
                  f"{row['run_s_vi']:.1f} / {row['run_s_iw']:.1f} s per run "
                  f"({row['steps_per_s_vi']:.0f} / "
                  f"{row['steps_per_s_iw']:.0f} steps/s, {PIN_STEPS} steps "
                  f"graphed, capture included); on {card}")
        tag = f"bimodal/{FULL_CONF}-IW{FULL_K} ({FULL_STEPS} steps)"
        full = counted_run(tag, FULL_CONF, "IW", FULL_K,
                           ivv.standardized(*FULL_DATA, bimodal=True),
                           FULL_STEPS, FULL_M, 0)
    finally:
        ivv.fit = fit
    bad = [k for k, v in full.items()
           if isinstance(v, float) and not np.isfinite(v)]
    if bad:
        fail(f"iw_vs_vi: {tag}: non-finite {bad}")
    print(f"iw_vs_vi: {tag} at N={FULL_DATA[0]}, M={FULL_M}, minibatch "
          f"512: NLL {-full['test_loglik']:+.4f}, IW20 bound/n "
          f"{full['bound_iw20']:+.4f}, {full['steps_per_s']:.0f} steps/s, "
          f"{full['run_s']:.1f} s; launches {json.dumps(full['launches'])}; "
          f"on {card}")
    gap = float(np.mean([r["nll_vi"] - r["nll_iw"] for r in runs]))
    b_vi = float(np.mean([r["bound_iw20_vi"] for r in runs]))
    b_iw = float(np.mean([r["bound_iw20_iw"] for r in runs]))
    print(f"iw_vs_vi: mean NLL gap {gap:+.4f} nats over seeds "
          f"{list(PIN_SEEDS)} (must exceed {PIN_MARGIN}); mean IW20 bound/n "
          f"IW-trained {b_iw:+.4f} vs VI-trained {b_vi:+.4f}")
    if not gap > PIN_MARGIN:
        fail(f"iw_vs_vi: mean NLL gap {gap} is not above {PIN_MARGIN}")
    if not b_iw > b_vi:
        fail(f"iw_vs_vi: mean IW20 bound of the IW-trained parameters "
             f"{b_iw} is not above the VI-trained ones' {b_vi}")
    pin_train, pin_eval = _pin_want(PIN_STEPS, PIN_DATA[0], PIN_DATA[1])
    return {"runs": runs, "mean_nll_gap": gap, "mean_bound_iw20_vi": b_vi,
            "mean_bound_iw20_iw": b_iw, "full_size_run": full,
            "launches": sides,
            "launches_per_run": {"train": pin_train, "eval": pin_eval}}


# phase 15: the reference's measurement tools, ported
# (experiments.profile_step, roofline, peak_probe, predict_bench)
MEASURE_STEPS, MEASURE_CALLS, MEASURE_EAGER = 20, 2, 3
MEASURE_STEP_WANT = {"chol_inv": 2, "epilogue:epi": 2, "epilogue_bwd:epi": 2}
MEASURE_BOUND_SLACK = 1.05   # a row faster than bound / 1.05 counts wrong


def _step_work(cost, config, tc) -> dict:
    """{kernel: [bytes, bf16 ops, f32 ops, bound ms]} of one flagship step
    from its shapes, the bound the sum of each launch's: K1 on the GP
    layers' Kuu grams (their jitter ladder) and on natgrad's P [D, M, M]
    of the final layer (two levels, ``training/natgrad.py``), K2 and K3
    'epi' per GP layer on A [K, M, B]."""
    from dgps_with_iwvi_torch.models.layers import GPLayerConfig

    gps = [c for c in config.layers if isinstance(c, GPLayerConfig)]
    m, k, b = gps[0].num_inducing, config.num_iw_samples, tc.minibatch_size

    def total(works):
        return [sum(w[i] for w in works) for i in range(3)] + [
            sum(cost.bound(*w)[0] for w in works)]

    return {"chol_inv": total([cost.chol_inv(len(gps), m,
                                             config.jitter_tries),
                               cost.chol_inv(gps[-1].d_out, m, 2)]),
            "epilogue": total([cost.epilogue(k, m, b, c.d_out, "epi")
                               for c in gps]),
            "epilogue_bwd": total([cost.epilogue_bwd(k, m, b, c.d_out, "epi")
                                   for c in gps])}


def _exact_counts(counts: dict, tool: str, steps: int) -> None:
    """Fail unless `counts` are MEASURE_STEP_WANT per step over `steps`."""
    want = {k: v * steps for k, v in MEASURE_STEP_WANT.items()}
    got = {k: v for k, v in counts.items() if v}
    if got != want:
        fail(f"measure: {tool} launched {got} in {steps} steps, want {want}")


def measure_phase(torch, card: str, tmp: str) -> dict:
    """15. measure: ``profile_step`` at B=512 (graphed; the hand kernels'
    launches per replay equal to the step's), ``roofline`` at B=512 (every
    hand-kernel row's bytes and operations equal to cost.py's for the
    step's shapes, none faster than its bound allows), ``peak_probe``
    --quick (no reading past 105% of the data sheet) and ``predict_bench``
    at B=8192 (3 rounds, finite outputs); launches counted per tool."""
    from dgps_with_iwvi_torch.experiments import (peak_probe, predict_bench,
                                                  profile_step, roofline)
    from dgps_with_iwvi_torch.ops.hopper import build, cost

    t0 = time.perf_counter()
    setup = profile_step.flagship(B_TRAIN, MEASURE_STEPS, "cuda")
    config, tc = setup[0], setup[4]
    launches = {}

    seconds = {"setup": time.perf_counter() - t0}
    build.reset_launches()
    prof = profile_step.run(calls=MEASURE_CALLS, setup=setup)
    launches["measure_profile"] = _path_counts(build)
    seconds["profile_step"] = time.perf_counter() - t0 - sum(seconds.values())
    per_step = {k: v["launches"]
                for k, v in prof["hand_kernels_per_step"].items()}
    if per_step != MEASURE_STEP_WANT:
        fail(f"measure: profile_step's hand-kernel launches per replayed "
             f"step {per_step}, want {MEASURE_STEP_WANT}")
    _exact_counts(launches["measure_profile"], "profile_step",
                  (2 + MEASURE_CALLS) * MEASURE_STEPS)

    build.reset_launches()
    roof = roofline.run(B_TRAIN, eager_steps=MEASURE_EAGER, top=30,
                        setup=setup, graphed=prof)
    launches["measure_roofline"] = _path_counts(build)
    seconds["roofline"] = time.perf_counter() - t0 - sum(seconds.values())
    _exact_counts(launches["measure_roofline"], "roofline",
                  3 * MEASURE_EAGER)
    want = _step_work(cost, config, tc)
    hand = {r["hand"]: r for r in roof["rows"] if r["hand"]}
    if set(hand) != set(want):
        fail(f"measure: roofline's hand-kernel rows {sorted(hand)}, want "
             f"{sorted(want)}")
    for name, (b, bf16, f32, b_ms) in want.items():
        r = hand[name]
        if not (math.isclose(r["bytes"], b, rel_tol=1e-12)
                and math.isclose(r["flops"], bf16 + f32, rel_tol=1e-12)
                and math.isclose(r["attainable_us"], 1e3 * b_ms,
                                 rel_tol=1e-12)):
            fail(f"measure: roofline's {name} row moves {r['bytes']} bytes, "
                 f"does {r['flops']} operations and is bound at "
                 f"{r['attainable_us']} us per step; cost.py gives {b}, "
                 f"{bf16 + f32} and {1e3 * b_ms} (its launches' bounds "
                 "summed) for the step's shapes")
        if r["us"] * MEASURE_BOUND_SLACK < r["attainable_us"]:
            fail(f"measure: {name} reads {r['us']:.2f} us per step, faster "
                 f"than its bound {r['attainable_us']:.2f} us allows: "
                 "cost.py counts wrong")

    lists = [r for r in roof["rows"] if "_foreach_" in r["op"]]
    if roof["unresolved_tensor_lists"] or not lists \
            or not all(r["bytes"] > 0 for r in lists):
        fail(f"measure: the optimizer's foreach rows "
             f"{[(r['op'], r['bytes']) for r in lists]} and "
             f"{roof['unresolved_tensor_lists']} op calls with a tensor "
             "list unresolved: every list must count its bytes")

    peaks = peak_probe.probe("cuda", quick=True)
    seconds["peak_probe"] = time.perf_counter() - t0 - sum(seconds.values())
    bad = peak_probe.check(peaks)
    if bad:
        fail("measure: peak_probe reads past 105% of the data sheet: "
             + "; ".join(bad))

    build.reset_launches()
    serve = predict_bench.run(out_dir=tmp, batches=[B_SERVE], rounds=3)
    launches["measure_predict"] = _path_counts(build)
    seconds["predict_bench"] = time.perf_counter() - t0 - sum(seconds.values())
    if not serve["finite"]:
        fail("measure: predict_bench scored a value that is not finite")
    for line in (profile_step.report(prof)[:2] + roof["lines"][-1:]
                 + peak_probe.report(peaks)):
        print(f"measure: {line}")
    row = serve["rows"][0]
    print(f"measure: predict_bench B={B_SERVE}: {row['blocking_ms']:.2f} ms "
          f"blocking, {row['points_per_s_pipelined']:,.0f} points/s "
          f"pipelined, artifact {serve['artifact_points_per_s']:,.0f} "
          f"points/s; on {card}")
    print("measure: seconds " + ", ".join(f"{k} {v:.1f}"
                                          for k, v in seconds.items()))
    return {"profile_step": prof, "seconds": seconds,
            "roofline": {k: v for k, v in roof.items() if k != "lines"},
            "peaks": peaks, "predict_bench": serve, "launches": launches,
            "phase_s": time.perf_counter() - t0}


def _parent_libs(hopper, build, parent: str) -> dict:
    """K1's to K5's libraries of the tree at `parent`, each
    built by its own nvcc from that tree's csrc/ into this tree's build
    directory and bound with this tree's signatures (the C interfaces are
    the same)."""
    import ctypes

    sigs = {"chol_inv": hopper.chol.SIGNATURES,
            "epilogue": hopper.qvar.SIGNATURES,
            "epilogue_bwd": hopper.qvar.BWD_SIGNATURES,
            "serve_cond": hopper.serve_cond.SIGNATURES,
            "conditional": hopper.conditional.SIGNATURES}
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in sigs:
        out = build.BUILD_DIR / f"ab-parent-lib{name}.so"
        src = os.path.join(parent, "dgps_with_iwvi_torch", "csrc",
                           f"{name}.cu")
        procs[name] = out, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            fail(f"nvcc of the parent's {name}.cu:\n{log}")
        lib = ctypes.CDLL(str(out))
        for fn, (argtypes, restype) in sigs[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        libs[name] = lib
    return libs


AB_EPI_CASES = [
    # (L, N, D, cov, iterations): K2 at the serving layers and the
    # training step's two launches at B=512 and 8192
    (S_SERVE, B_SERVE, 8, False, 10), (S_SERVE, B_SERVE, 1, False, 10),
    (20, 512, 8, False, 50), (20, 512, 1, True, 50),
    (20, 8192, 8, False, 20), (20, 8192, 1, True, 20),
]


def ab_kernels(torch, hopper, linalg, build, parent: str, model,
               gen) -> dict:
    """K1 (served Kuu, natgrad P), K2 (serving and training shapes), K3
    (every form at B=512 and 8192), K4
    and K5 (at the serving and training shapes) of the tree at `parent`
    and of this one, on the same inputs, timed in turns (parent, change,
    change, parent). The wrappers load a library through
    ``build.library``, which returns the one loaded under the kernel's
    name: each turn puts its tree's libraries there."""
    chol, qvar = hopper.chol, hopper.qvar
    k4, k5 = hopper.serve_cond, hopper.conditional
    libs = {"parent": _parent_libs(hopper, build, parent),
            "change": {"chol_inv": chol._lib(),
                       "epilogue": build.library(qvar.NAME, qvar.SIGNATURES),
                       "epilogue_bwd": build.library(qvar.BWD_NAME,
                                                     qvar.BWD_SIGNATURES),
                       "serve_cond": build.library(k4.NAME, k4.SIGNATURES),
                       "conditional": build.library(k5.NAME,
                                                    k5.SIGNATURES)}}
    config, params = model[2], model[3]
    Kuu = served_kuu(torch, config, params)
    jit = linalg._jitter_ladder(config.jitter, config.jitter_tries,
                                Kuu.dtype, Kuu.device)
    P = natgrad_precision(torch, params, gen)
    jit_ng = linalg._jitter_ladder(1e-12, 2, P.dtype, P.device)
    cases = [(f"K1 served Kuu [2,{M},{M}] x {len(jit)} levels",
              lambda: chol.chol_inv(Kuu, jit), 200),
             (f"K1 natgrad P [1,{M},{M}] x 2 levels",
              lambda: chol.chol_inv(P, jit_ng), 200)]
    for L, n, d, cov, iters in AB_EPI_CASES:
        args = _epi_inputs(torch, gen, L, d, n, cov)
        cases.append((f"K2 epi {'cov' if cov else 'root'} D={d}, "
                      f"A [{L},{M},{n}]",
                      lambda a=args, c=cov: qvar.epi_fused(*a, c), iters))
    for n in (B_TRAIN, B_BIG):
        for label, form, d, cov in BWD_FORMS:
            args = _bwd_inputs(torch, gen, L_TRAIN, M, n, d, cov)
            cases.append((f"K3 {label}, A [{L_TRAIN},{M},{n}]",
                          lambda f=form, a=args, c=cov: _bwd_call(
                              qvar, f, *a, c, plain=False), 20))
    seed = torch.tensor(2 ** 40 + 12345, dtype=torch.int64, device="cuda")
    for label, n, d_in, m, d, kern, sample, res, iters in AB_COND_CASES:
        args = _cond_inputs(torch, gen, n, m, d_in, d)
        if kern == "K4":
            eps = (torch.randn((n, d), generator=gen, device="cuda")
                   if sample else None)
            fn = (lambda a=args, e=eps: k4.fused_conditional_infer(*a, e))
        else:
            fn = (lambda a=args, s=seed if sample else None, r=res:
                  k5.fused_forward(*a, s, residuals=r))
        cases.append((f"{kern} {label}, xs [{n},{d_in}], M={m}, D={d}", fn,
                      iters))
    out = {}
    for label, fn, iters in cases:
        times = {"parent": [], "change": []}
        dev = {"parent": [], "change": []}
        for tree in AB_ORDER:
            build._libs.update(libs[tree])
            times[tree].append(time_ms(torch, fn, iters))
            dev[tree].append(device_ms(torch, fn))
        out[label] = dict(times, device_ms=dev)
    del cases
    # K3 at M=100 (epi, root D=8, A [20,100,512]) on three seeds: each
    # tree's dA, dW, dq_mu against the plain version and against the
    # plain version of the zero-padded inputs (relative to max|plain|)
    m100 = []
    for seed in range(3):
        g = torch.Generator(device="cuda").manual_seed(seed)
        args = _bwd_inputs(torch, g, L_TRAIN, 100, B_TRAIN, 8, False)
        ref = _bwd_call(qvar, "epi", *args, False, plain=True)
        ref_pad = _bwd_padded_plain(torch, qvar, "epi", *args, False)
        row = {}
        for tree in ("parent", "change"):
            build._libs.update(libs[tree])
            got = _bwd_call(qvar, "epi", *args, False, plain=False)
            row[tree] = {"vs_plain": _rel_errs(got, ref),
                         "vs_padded_plain": _rel_errs(got, ref_pad)}
        m100.append(row)
    out["K3 M=100 agreement"] = m100
    build._libs.update(libs["change"])
    torch.cuda.empty_cache()
    return out


def _ab_summary(tree: str, profiled: bool, rec: dict) -> dict:
    """The rates, kernel times and (profiled) device times of one
    chip_smoke.py record."""
    tr, ps = rec["train"], rec["pallas_serving"]
    s = {"tree": tree, "profile": profiled,
         "steps_per_s_b512": tr["steps_per_s_b512"],
         "steps_per_s_b8192": tr["steps_per_s_b8192"],
         "serve_default_points_per_s": ps["serve_pallas"]["points_per_s"],
         "serve_use_pallas_points_per_s": ps["use_pallas"]["points_per_s"],
         "train_use_pallas_steps_per_s": {
             k: v["steps_per_s_b512"] for k, v in tr["use_pallas"].items()},
         "serve_k2_route_points_per_s": rec["slice"]["points_per_s"],
         "kernels_ms": {k["name"]: k["ms"] for k in rec["kernels"]}}
    if profiled:
        for key in ("profile_b512", "profile_b8192"):
            p = tr[key]
            s[key] = {k: p[k] for k in ("device_ms_per_step",
                                        "wall_ms_per_step", "idle_share",
                                        "kernel_launches_per_step")}
            s[key]["kernels"] = p["kernels_ms_per_step"][:12]
        routes = [(ps["serve_pallas"]["profile"], "profile_serve_default"),
                  (ps["use_pallas"]["profile"], "profile_serve_use_pallas"),
                  (rec["profile"], "profile_serve_k2_route")]
        for sp, key in routes:
            s[key] = {k: sp[k] for k in ("device_ms_per_request",
                                         "wall_ms_per_request",
                                         "idle_share")}
            s[key]["kernels"] = sp["kernels_ms_per_request"][:8]
    return s


def ab_runs(parent: str, out_dir: str) -> list:
    """Both trees' chip_smoke.py whole, each in its own process, in turns
    (parent, change, change, parent), then each once with --profile."""
    trees = {"parent": os.path.abspath(parent),
             "change": os.path.dirname(os.path.abspath(__file__))}
    plan = [(t, False) for t in AB_ORDER] + [("parent", True),
                                             ("change", True)]
    runs = []
    for i, (tree, profiled) in enumerate(plan):
        rec_dir = os.path.abspath(os.path.join(
            out_dir, f"run{i}_{tree}" + ("_profile" if profiled else "")))
        cmd = [sys.executable, os.path.join(trees[tree], "chip_smoke.py"),
               "--out", rec_dir] + (["--profile"] if profiled else [])
        proc = subprocess.run(cmd, cwd=trees[tree], capture_output=True,
                              text=True, timeout=1200)
        if proc.returncode != 0:
            fail(f"chip_smoke.py of the {tree} tree failed:\n"
                 f"{proc.stderr[-3000:]}")
        with open(os.path.join(rec_dir, "chip_smoke.json")) as f:
            runs.append(_ab_summary(tree, profiled, json.load(f)))
    return runs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the record to DIR/"
                    "chip_smoke.json")
    ap.add_argument("--profile", action="store_true",
                    help="also trace two served requests per serving "
                    "route and five training steps with torch.profiler and "
                    "record device time by kernel and the idle share")
    ap.add_argument("--ab", metavar="PARENT",
                    help="instead of the smoke run, time this tree against "
                    "the checkout at PARENT on one card: K1 to K5 in turns "
                    "on the same inputs, then both trees' chip_smoke.py in "
                    "turns; needs --out (DIR/ab.json)")
    opts = ap.parse_args()
    if opts.ab and not opts.out:
        ap.error("--ab needs --out")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs an NVIDIA "
              "GPU", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "dgps_with_iwvi_torch")):
        print("chip_smoke: the dgps_with_iwvi_torch package is not beside "
              "this script", file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    from dgps_with_iwvi_torch.ops import hopper, linalg
    from dgps_with_iwvi_torch.ops.hopper import build

    card = card_line()
    rec = {"card": card, "torch": torch.__version__,
           "cuda": torch.version.cuda,
           "kind": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(),
           "allow_tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
           "allow_tf32_cudnn": torch.backends.cudnn.allow_tf32}
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; tf32 matmul "
          f"{rec['allow_tf32_matmul']} cudnn {rec['allow_tf32_cudnn']}")
    if rec["allow_tf32_matmul"]:
        fail("torch.backends.cuda.matmul.allow_tf32 is True")

    t0 = time.perf_counter()
    logs = build.build_all()
    rec["build_s"] = time.perf_counter() - t0
    rec["ptxas"] = {name: [ln.strip() for ln in log.splitlines()
                           if "registers" in ln or "spill" in ln]
                    for name, log in logs.items()}
    print(f"build: {rec['build_s']:.1f} s; " + json.dumps(rec["ptxas"]))

    gen = torch.Generator(device="cuda").manual_seed(0)
    model = served_model(torch)
    config = model[2]
    if opts.ab:
        ab = {"card": card, "kernels": ab_kernels(torch, hopper, linalg,
                                                  build, opts.ab, model, gen)}
        print("ab kernels: " + json.dumps(ab["kernels"]))
        del model
        torch.cuda.empty_cache()
        ab["runs"] = ab_runs(opts.ab, opts.out)
        print("ab runs: " + json.dumps(ab["runs"]))
        os.makedirs(opts.out, exist_ok=True)
        with open(os.path.join(opts.out, "ab.json"), "w") as f:
            json.dump(ab, f, indent=1)
        print(card)
        return 0
    k1 = chol_phase(torch, hopper, linalg, gen,
                    served_kuu(torch, config, model[3]), config.jitter,
                    config.jitter_tries,
                    natgrad_precision(torch, model[3], gen))
    non_white = non_white_qvar_inputs(torch)
    k2 = epilogue_phase(torch, hopper, gen, non_white)
    k3, rec["epilogue_bwd_checks"] = epilogue_bwd_phase(torch, hopper, gen,
                                                        non_white)
    del non_white
    torch.cuda.empty_cache()
    k45, rec["fused_checks"] = fused_phase(torch, hopper, gen)
    rec["slice"] = slice_phase(torch, model, rec, opts.profile)
    rec["pallas_serving"] = pallas_serving_phase(torch, model, opts.profile)
    rec["train"] = train_phase(torch, card, opts.profile)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_harness_")
    try:
        rec["harness"] = harness_phase(torch, card, tmp)
        rec["serve_cli"] = serve_phase(torch, card, tmp, rec["harness"])
        t0 = time.perf_counter()
        rec["families"] = families_phase(torch, card, tmp)
        rec["families"]["phase_s"] = time.perf_counter() - t0
        print(f"families: phase 8 took {rec['families']['phase_s']:.1f} s")
        t0 = time.perf_counter()
        rec["breadth"] = breadth_phase(torch, card, tmp)
        rec["breadth"]["phase_s"] = time.perf_counter() - t0
        print(f"breadth: phase 9 took {rec['breadth']['phase_s']:.1f} s")
        t0 = time.perf_counter()
        rec["parallel"] = parallel_phase(torch, card, tmp)
        rec["parallel"]["phase_s"] = time.perf_counter() - t0
        print(f"parallel: phase 10 took {rec['parallel']['phase_s']:.1f} s")
        t0 = time.perf_counter()
        rec["flops"] = flops_phase(torch, card, rec)
        rec["flops"]["phase_s"] = time.perf_counter() - t0
        print(f"flops: phase 11 took {rec['flops']['phase_s']:.1f} s")
        t0 = time.perf_counter()
        rec["graphs"] = graphs_phase(torch, card, model, opts.profile, tmp)
        rec["graphs"]["phase_s"] = time.perf_counter() - t0
        print(f"graphs: phase 12 took {rec['graphs']['phase_s']:.1f} s")
        t0 = time.perf_counter()
        rec["gate"] = gate_phase(torch, card, tmp)
        rec["gate"]["phase_s"] = time.perf_counter() - t0
        print(f"gate: phase 13 took {rec['gate']['phase_s']:.1f} s")
        t0 = time.perf_counter()
        rec["iw_vs_vi"] = iw_vs_vi_phase(torch, card)
        rec["iw_vs_vi"]["phase_s"] = time.perf_counter() - t0
        print(f"iw_vs_vi: phase 14 took {rec['iw_vs_vi']['phase_s']:.1f} s")
        rec["measure"] = measure_phase(torch, card, tmp)
        print(f"measure: phase 15 took {rec['measure']['phase_s']:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if opts.profile:
        # the profiler slows the host; against the unprofiled serve time
        wall = rec["slice"]["serve_s"] * 1e3 / REQUESTS
        rec["profile"]["idle_share_vs_unprofiled_wall"] = (
            1.0 - rec["profile"]["device_ms_per_request"] / wall)
        print("profile: " + json.dumps(rec["profile"]))
    paths = {"serve": rec["slice"]["launches"],
             "train": rec["train"]["launches"],
             "train_b8192": rec["train"]["launches_b8192"],
             "serve_pallas": rec["pallas_serving"]["serve_pallas"]["launches"],
             "predict_use_pallas":
                 rec["pallas_serving"]["use_pallas"]["launches"],
             "train_use_pallas":
                 rec["train"]["use_pallas"]["natgrad final"]["launches"],
             "train_use_pallas_adam":
                 rec["train"]["use_pallas"]["Adam only"]["launches"],
             "harness": rec["harness"]["launches"],
             "serve_cli_test_split": rec["serve_cli"]["launches_test_split"],
             "serve_cli": rec["serve_cli"]["launches"],
             "serve_cli_artifact": rec["serve_cli"]["launches_artifact"],
             "families_regression":
                 rec["families"]["regression"]["launches"],
             "families_multiclass":
                 rec["families"]["multiclass"]["launches"],
             "families_serve": rec["families"]["serve"]["launches"],
             "breadth_multiscale": rec["breadth"]["multiscale"]["launches"],
             "breadth_no_white": rec["breadth"]["no_white"]["launches"],
             "breadth_serve": rec["breadth"]["serve"]["launches"],
             "breadth_predict": rec["breadth"]["sampling"]["launches"],
             **{f"parallel_rank{r}": counts for r, counts in
                enumerate(rec["parallel"]["launches"])},
             "demo_toy_1d": rec["flops"]["demos"]["toy_1d"]["launches"],
             "demo_multitask":
                 rec["flops"]["demos"]["multitask"]["launches"],
             **{f"graphs_{kind}_{label}_{t['side']}{i // 2}": t["launches"]
                for kind in ("train", "serve", "eval")
                for label, r in rec["graphs"][kind].items()
                if "turns" in r
                for i, t in enumerate(r["turns"])},
             **rec["gate"]["launches"],
             **rec["iw_vs_vi"]["launches"],
             **rec["measure"]["launches"]}
    for k in (k1, *k2, *k3, *k45):
        by_path = {p: counts.get(k["name"], 0) for p, counts in paths.items()}
        k["launches"] = sum(by_path.values())
        k["launches_by_path"] = by_path
        k["launches_per_eval_replay"] = {
            label: r["launches_per_replay"].get(k["name"], 0)
            for label, r in rec["graphs"]["eval"].items()
            if "launches_per_replay" in r}
    rec["kernels"] = [k1, *k2, *k3, *k45]
    s = rec["slice"]
    print(f"serve, K2 route: {s['points_per_s']:.0f} points/s "
          f"(S={S_SERVE}, B={B_SERVE}, {REQUESTS} requests; plain versions "
          f"{s['plain_points_per_s']:.0f}) on {card}")
    for label, r in rec["pallas_serving"].items():
        print(f"serve {label}: {r['points_per_s']:.0f} points/s (plain "
              f"versions {r['plain_points_per_s']:.0f}; K2 route "
              f"{s['points_per_s']:.0f}) on {card}")
    print("slice: " + json.dumps(s))
    print("pallas serving: " + json.dumps(rec["pallas_serving"]))
    print("fused checks: " + json.dumps(rec["fused_checks"]))
    print("train: " + json.dumps(rec["train"]))
    print("epilogue_bwd checks: " + json.dumps(rec["epilogue_bwd_checks"]))
    print("harness: " + json.dumps(rec["harness"]))
    print("serve CLI: " + json.dumps(rec["serve_cli"]))
    print("families: " + json.dumps(rec["families"]))
    print("breadth: " + json.dumps(rec["breadth"]))
    print("parallel: " + json.dumps(rec["parallel"]))
    print("flops: " + json.dumps(rec["flops"]))
    print("graphs: " + json.dumps(rec["graphs"]))
    print("gate: " + json.dumps(rec["gate"]))
    print("iw_vs_vi: " + json.dumps(rec["iw_vs_vi"]))
    print("measure: " + json.dumps(rec["measure"]))
    if opts.out:
        os.makedirs(opts.out, exist_ok=True)
        with open(os.path.join(opts.out, "chip_smoke.json"), "w") as f:
            json.dump(rec, f, indent=1)
    print(json.dumps({"kernels": rec["kernels"]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": rec["kind"], "count": rec["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
