#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100), kernels included.

    python3 chip_smoke.py [--out DIR]

Phases, each of which fails the run (non-zero exit) when it fails:

1. device: the card's name and power limit, the TF32 flags (TF32 on for
   f32 matmuls fails the run: it is none of the port's precision classes);
2. build: every csrc/*.cu by its own nvcc, all at once, timed as set-up;
3. kernels: each hand-written kernel against its plain PyTorch version on
   the same inputs on the card, at the serving shapes (LGG, M=128,
   B=8192, S=100; K1 on the served model's own Kuu grams), with the
   tolerance stated per case, plus the K1 jitter ladder on a
   rank-deficient gram;
4. slice: the LGG model of phase 3, built from a seed on bench.py's
   synthetic data, 8 requests of
   B=8192 at S=100 scored through ``serving.Scorer``; the kernel launch
   counts of that run must be positive, one batch must agree with the same
   batch through the plain versions on the card, and a small batch with the
   port's CPU path (the path the CPU tests hold to the JAX reference).

Prints one ``{"kernels": [...]}`` line, then the card's name and power
limit, then ``{"ok": true, "device": {...}}`` as the last line. Exits
non-zero without a result where CUDA is unavailable or the package is not
beside this script. ``--out DIR`` also writes the whole record to
``DIR/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

PEAK_BF16 = 989e12   # dense tensor-core FLOP/s, H100 SXM data sheet
PEAK_F32 = 67e12     # f32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12  # HBM3 bytes/s

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


def bound(bytes_moved: float, bf16_ops: float = 0.0, f32_ops: float = 0.0):
    """(bound_ms, bound_by): the largest of the bytes over the memory rate
    and the operations of each type over that type's peak rate (the
    tensor cores and the CUDA cores run at once, so the two op times do
    not add)."""
    t_bytes = bytes_moved / PEAK_BYTES
    t_ops = max(bf16_ops / PEAK_BF16, f32_ops / PEAK_F32)
    if t_ops > t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


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


def chol_phase(torch, hopper, linalg, gen, Kuu, jitter, tries) -> dict:
    """K1 against its plain version on the served model's stacked Kuu
    grams (G=2 GP layers, M=128) over its jitter ladder, which is what
    the serving path factors; then on a well-conditioned SPD batch and on
    a rank-deficient gram that has to climb the ladder."""
    chol = hopper.chol
    G = Kuu.shape[0]
    jit = linalg._jitter_ladder(jitter, tries, Kuu.dtype, Kuu.device)
    served = _chol_case(torch, chol, linalg, Kuu, jit)
    A = torch.randn((G, M, M), generator=gen, device="cuda")
    Kspd = A @ A.transpose(-1, -2) + M * torch.eye(M, device="cuda")
    spd = _chol_case(torch, chol, linalg, Kspd, jit)

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

    def library():
        Kj = Kuu[None] + jit.reshape(-1, 1, 1, 1) * torch.eye(M, device="cuda")
        Lc, _ = torch.linalg.cholesky_ex(Kj)
        return torch.linalg.solve_triangular(
            Lc, torch.eye(M, device="cuda").expand_as(Lc), upper=False)

    ms = time_ms(torch, lambda: chol.chol_inv(Kuu, jit), 50)
    spd_ms = time_ms(torch, lambda: chol.chol_inv(Kspd, jit), 50)
    plain_ms = time_ms(torch, lambda: chol.chol_inv_plain(Kuu, jit), 20)
    library_ms = time_ms(torch, library, 20)
    # the function: G factors and their inverses (K in, L and Linv out,
    # the ladder's jitters in); Cholesky M^3/3 + triangular inverse M^3/3
    b_ms, b_by = bound(bytes_moved=4 * (3 * G * M * M + len(jit)),
                       f32_ops=G * (2.0 / 3.0) * M ** 3)
    return {
        "name": "chol_inv", "route": "cuda",
        "source": "dgps_with_iwvi_torch/csrc/chol_inv.cu",
        "replaces": "dgps_with_iwvi_tpu/ops/pallas/chol.py:101",
        "shape": f"served Kuu [{G},{M},{M}] f32 x {len(jit)} jitter levels",
        "max_abs_err": max(served["max_abs_err_L"],
                           served["max_abs_err_Linv"]),
        "max_rel_err": served["max_rel_err"],
        "tol": "m*u*cond(K+jI)*max|plain| at the selected level",
        "served_kuu": served, "spd": dict(spd, ms=spd_ms),
        "rank_deficient_level": int(lvl[0]),
        "rank_deficient_level_plain": int(lvl_p[0]),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": library_ms,
        "library": "torch.linalg.cholesky_ex + solve_triangular",
    }


EPI_CASES = [
    # (label, D, cov, with_mean)
    ("inner layer: root D=8, mean+sumsq", 8, False, True),
    ("final layer: root D=1, mean+sumsq", 1, False, True),
    ("cov D=8, mean+sumsq", 8, True, True),
    ("q-variance only (_qvar_kernel): root D=8", 8, False, False),
    ("q-variance only (_qvar_kernel): cov D=1", 1, True, False),
]


def _epi_inputs(torch, gen, L, D, N, cov):
    A = torch.randn((L, M, N), generator=gen, device="cuda") / math.sqrt(M)
    R = torch.tril(torch.randn((D, M, M), generator=gen, device="cuda"))
    W = 0.1 * R + torch.eye(M, device="cuda")
    if cov:
        W = W @ W.transpose(-1, -2)
    q_mu = torch.randn((M, D), generator=gen, device="cuda")
    return A, W, q_mu


def _epi_call(qvar, A, W, q_mu, cov, with_mean, plain):
    if with_mean:
        f = qvar.epi_plain if plain else qvar.epi_fused
        return f(A, W, q_mu, cov)
    f = qvar.qvar_plain if plain else qvar.qvar_fused
    return (f(A, W, cov),)


def _epi_check(torch, qvar, label, A, W, q_mu, cov, with_mean):
    """Kernel against plain on the same inputs: (errs, rels) by output."""
    got = _epi_call(qvar, A, W, q_mu, cov, with_mean, plain=False)
    ref = _epi_call(qvar, A, W, q_mu, cov, with_mean, plain=True)
    names = ("qv", "ss", "mean")
    # both sides multiply the same bf16-rounded operands into f32; only the
    # order of the f32 sums differs
    rel_tol = {"qv": 1e-4, "ss": 1e-5, "mean": 1e-4}
    errs, rels = {}, {}
    for name, g, r in zip(names, got, ref):
        if g.shape != r.shape or not bool(torch.isfinite(g).all()):
            fail(f"epilogue [{label}]: {name} shape {tuple(g.shape)} vs "
                 f"{tuple(r.shape)} or non-finite")
        err, tol = max_err(g, r), rel_tol[name] * float(r.abs().max())
        if not err <= tol:
            fail(f"epilogue [{label}] {name}: max |err| {err} > {tol} "
                 f"({rel_tol[name]} max|plain|)")
        errs[name], rels[name] = err, err / float(r.abs().max())
    return errs, rels


def epilogue_phase(torch, hopper, gen) -> dict:
    """K2 against its plain version at the serving shape S=100, B=8192,
    M=128 (errors and times on the same inputs), and on a ragged N."""
    qvar = hopper.qvar
    cases = []
    for label, D, cov, with_mean in EPI_CASES:
        A, W, q_mu = _epi_inputs(torch, gen, S_SERVE, D, B_SERVE, cov)
        errs, rels = _epi_check(torch, qvar, label, A, W, q_mu, cov,
                                with_mean)
        ms = time_ms(torch, lambda: _epi_call(qvar, A, W, q_mu, cov,
                                              with_mean, False), 10)
        plain_ms = time_ms(torch, lambda: _epi_call(qvar, A, W, q_mu, cov,
                                                    with_mean, True), 3, 1)
        Lx, N = S_SERVE, B_SERVE
        out_floats = Lx * D * N + (Lx * N + Lx * D * N if with_mean else 0)
        in_floats = Lx * M * N + D * M * M + (M * D if with_mean else 0)
        b_ms, b_by = bound(
            bytes_moved=4 * (in_floats + out_floats),
            bf16_ops=2 * Lx * D * M * M * N
            + (6 * Lx * D * M * N if with_mean else 0),
            f32_ops=2 * Lx * D * M * N + (2 * Lx * M * N if with_mean else 0))
        cases.append({"case": label,
                      "shape": f"A [{Lx},{M},{N}], W [{D},{M},{M}]",
                      "max_abs_err": max(errs.values()),
                      "max_rel_err": max(rels.values()), "errs": errs,
                      "tol": "qv 1e-4, ss 1e-5, mean 1e-4 x max|plain|",
                      "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                      "bound_by": b_by})
        del A, W, q_mu
        torch.cuda.empty_cache()
    A, W, q_mu = _epi_inputs(torch, gen, 2, 8, 1000, False)
    ragged, _ = _epi_check(torch, qvar, "ragged N=1000, root D=8", A, W,
                           q_mu, False, True)
    main = cases[0]
    return {
        "name": "epilogue", "route": "cuda",
        "source": "dgps_with_iwvi_torch/csrc/epilogue.cu",
        "replaces": "dgps_with_iwvi_tpu/ops/pallas/qvar.py:429",
        "also_replaces": "dgps_with_iwvi_tpu/ops/pallas/qvar.py:96",
        "shape": main["shape"],
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "max_rel_err": max(c["max_rel_err"] for c in cases),
        "tol": main["tol"], "ragged_errs": ragged,
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None, "cases": cases,
    }


def synthetic(seed: int = 0):
    """bench.py's serving data: X ~ N(0, 1) [B, 8], Y = sin(X0) + 0.1 e."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((B_SERVE, D_X)).astype(np.float32)
    Y = (np.sin(X[:, :1]) + 0.1 * rng.standard_normal((B_SERVE, 1))
         ).astype(np.float32)
    return X, Y


def profile_serve(torch, scorer, Xs, Ys, requests: int = 2) -> dict:
    """Device time by kernel over `requests` scored batches (torch.profiler)
    and the device's idle share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        scorer.score(Xs[:requests * B_SERVE], Ys[:requests * B_SERVE],
                     seed=7)
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.self_device_time_total / 1e3 / requests, e.count / requests,
             e.key) for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and e.self_device_time_total > 0]
    busy_ms = sum(r[0] for r in rows)
    return {"requests": requests, "wall_ms_per_request": wall_ms / requests,
            "device_ms_per_request": busy_ms,
            "idle_share": 1.0 - busy_ms * requests / wall_ms,
            "kernels_ms_per_request": [
                {"kernel": k[:200], "ms": ms, "calls": c}
                for ms, c, k in sorted(rows, reverse=True)]}


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
    gen = torch.Generator(device="cuda").manual_seed(1)
    for i, scale in ((1, 0.3), (2, 0.5)):
        lp = params["layers"][i]
        lp["q_mu"] = 0.5 * torch.randn(lp["q_mu"].shape, generator=gen,
                                       device="cuda")
        lp["q_sqrt"] = (0.02 * torch.tril(torch.randn(
            lp["q_sqrt"].shape, generator=gen, device="cuda"))
            + scale * torch.eye(M, device="cuda"))
    torch.cuda.synchronize()
    return X, Y, config, params, time.perf_counter() - t0


def served_kuu(torch, config, params):
    """The stacked Kuu grams that prefactor_gp_layers factors in one K1
    launch, [G, M, M]."""
    from dgps_with_iwvi_torch.models.layers import GPLayerConfig, layer_Kuu

    return torch.stack([layer_Kuu(params["layers"][i], cfg)
                        for i, cfg in enumerate(config.layers)
                        if isinstance(cfg, GPLayerConfig)])


def slice_phase(torch, model, rec: dict, profile: bool) -> dict:
    from dgps_with_iwvi_torch.models import predict_y_and_log_density
    from dgps_with_iwvi_torch.ops.hopper import build
    from dgps_with_iwvi_torch.params import params_to_device
    from dgps_with_iwvi_torch.serving import NormalizationStats, Scorer

    X, Y, config, params, build_s = model
    rng = np.random.default_rng(1)
    n = REQUESTS * B_SERVE
    Xs = rng.standard_normal((n, D_X)).astype(np.float32)
    Ys = (np.sin(Xs[:, :1]) + 0.1 * rng.standard_normal((n, 1))
          ).astype(np.float32)
    stats = NormalizationStats(X.mean(0, keepdims=True),
                               X.std(0, keepdims=True),
                               Y.mean(0, keepdims=True),
                               Y.std(0, keepdims=True))
    scorer = Scorer(params, config, S_SERVE, stats, device="cuda")
    scorer.score(Xs[:B_SERVE], Ys[:B_SERVE], seed=0)          # warm-up

    build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = scorer.score(Xs, Ys, seed=100, max_batch=B_SERVE)
    serve_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = build.launches()
    for name in build.KERNELS:
        if counts[name] <= 0:
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
    # same rounding classes on both paths; the f32 sums run in another
    # order and the difference passes through the inner layer's sample
    agree = {}
    for k, tol in (("mean", 1e-3), ("var", 1e-3), ("log_density", 1e-3)):
        a, b = out[k][:2 * B_SERVE], plain[k]
        err = float(np.max(np.abs(a - b) / (1.0 + np.abs(b))))
        if not err <= tol:
            fail(f"serving {k}: kernels vs plain versions differ by {err} "
                 f"(tol {tol}, |a-b|/(1+|b|))")
        agree[k] = err

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
        rec["profile"] = profile_serve(torch, scorer, Xs, Ys)
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the record to DIR/"
                    "chip_smoke.json")
    ap.add_argument("--profile", action="store_true",
                    help="also trace two served requests with torch.profiler"
                    " and print device time by kernel and the idle share")
    opts = ap.parse_args()

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
    k1 = chol_phase(torch, hopper, linalg, gen,
                    served_kuu(torch, config, model[3]), config.jitter,
                    config.jitter_tries)
    k2 = epilogue_phase(torch, hopper, gen)
    rec["slice"] = slice_phase(torch, model, rec, opts.profile)
    if opts.profile:
        # the profiler slows the host; against the unprofiled serve time
        wall = rec["slice"]["serve_s"] * 1e3 / REQUESTS
        rec["profile"]["idle_share_vs_unprofiled_wall"] = (
            1.0 - rec["profile"]["device_ms_per_request"] / wall)
        print("profile: " + json.dumps(rec["profile"]))
    for k in (k1, k2):
        k["launches"] = rec["slice"]["launches"][k["name"]]
    rec["kernels"] = [k1, k2]
    s = rec["slice"]
    print(f"serve: {s['points_per_s']:.0f} points/s (S={S_SERVE}, "
          f"B={B_SERVE}, {REQUESTS} requests; plain versions "
          f"{s['plain_points_per_s']:.0f}) on {card}")
    print("slice: " + json.dumps(s))
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
