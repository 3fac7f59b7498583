#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100), kernels included.

    python3 chip_smoke.py [--out DIR]

Phases, each of which fails the run (non-zero exit) when it fails:

1. device: the card's name and power limit, the TF32 flags (TF32 on for
   f32 matmuls fails the run: it is none of the port's precision classes);
2. build: every csrc/*.cu by its own nvcc, all at once, timed as set-up;
3. kernels: each hand-written kernel, in every variant, against its plain
   PyTorch version on the same inputs on the card, with the tolerance
   stated per case: K1 on the served model's own Kuu grams, plus its
   jitter ladder on a rank-deficient gram; K2 (epilogue with mean, without
   mean, q-variance only) at the serving shape (M=128, B=8192, S=100); K3
   (its backward, in the same three forms) at the training shapes A
   [20,128,512] and [20,128,8192], at M=100, and two launches bitwise
   equal;
4. serving: the LGG model of phase 3, built from a seed on bench.py's
   synthetic data, 8 requests of
   B=8192 at S=100 scored through ``serving.Scorer``; the kernel launch
   counts of that run must be positive, one batch must agree with the same
   batch through the plain versions on the card, and a small batch with the
   port's CPU path (the path the CPU tests hold to the JAX reference);
5. training: the flagship step (LGG, IW K=20, M=128, B=512, natgrad on
   the final layer) on synthetic data of kin8nm's shape; one step's loss
   and gradients through the kernels against the plain versions on the
   card, 200 timed steps whose K1, K2 and K3 launch counts rise by 2 each
   per step, and 20 steps at B=8192.

Prints one ``{"kernels": [...]}`` line (launches counted on the serving
and the training runs), then the card's name and power limit, then
``{"ok": true, "device": {...}}`` as the last line. Exits
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
    # (label, D, cov, form): form "epi" (mean + sumsq), "ps" (sumsq, no
    # mean) or "qvar" (q-variance only)
    ("inner layer: root D=8, mean+sumsq", 8, False, "epi"),
    ("final layer: root D=1, mean+sumsq", 1, False, "epi"),
    ("cov D=8, mean+sumsq", 8, True, "epi"),
    ("_ps_kernel: root D=8, sumsq", 8, False, "ps"),
    ("_ps_kernel: cov D=1, sumsq", 1, True, "ps"),
    ("q-variance only (_qvar_kernel): root D=8", 8, False, "qvar"),
    ("q-variance only (_qvar_kernel): cov D=1", 1, True, "qvar"),
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


def epilogue_phase(torch, hopper, gen) -> list:
    """K2 against its plain version at the serving shape S=100, B=8192,
    M=128 (errors and times on the same inputs), and on a ragged N; one
    kernels-line row per variant."""
    qvar = hopper.qvar
    cases = {"epi": [], "ps": [], "qvar": []}
    for label, D, cov, form in EPI_CASES:
        A, W, q_mu = _epi_inputs(torch, gen, S_SERVE, D, B_SERVE, cov)
        errs, rels = _epi_check(torch, qvar, label, A, W, q_mu, cov, form)
        ms = time_ms(torch, lambda: _epi_call(qvar, A, W, q_mu, cov, form,
                                              False), 10)
        plain_ms = time_ms(torch, lambda: _epi_call(qvar, A, W, q_mu, cov,
                                                    form, True), 3, 1)
        Lx, N = S_SERVE, B_SERVE
        mean, ssq = form == "epi", form != "qvar"
        out_floats = Lx * D * N * (2 if mean else 1) + (Lx * N if ssq else 0)
        in_floats = Lx * M * N + D * M * M + (M * D if mean else 0)
        b_ms, b_by = bound(
            bytes_moved=4 * (in_floats + out_floats),
            bf16_ops=2 * Lx * D * M * M * N + (6 * Lx * D * M * N if mean
                                               else 0),
            f32_ops=2 * Lx * D * M * N + (2 * Lx * M * N if ssq else 0))
        cases[form].append({"case": label,
                            "shape": f"A [{Lx},{M},{N}], W [{D},{M},{M}]",
                            "max_abs_err": max(errs.values()),
                            "max_rel_err": max(rels.values()), "errs": errs,
                            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                            "bound_by": b_by})
        del A, W, q_mu
        torch.cuda.empty_cache()
    A, W, q_mu = _epi_inputs(torch, gen, 2, 8, 1000, False)
    ragged, _ = _epi_check(torch, qvar, "ragged N=1000, root D=8", A, W,
                           q_mu, False, "epi")
    rows = [_entry(f"epilogue:{form}", "dgps_with_iwvi_torch/csrc/epilogue.cu",
                   K2_REPLACES[form], cases[form],
                   "qv 1e-4, ss 1e-5, mean 1e-4 x max|plain|")
            for form in ("epi", "ps", "qvar")]
    rows[0]["ragged_errs"] = ragged
    return rows


BWD_FORMS = [
    # (label, form, D, cov)
    ("epi, root D=8 (inner layer)", "epi", 8, False),
    ("epi, cov D=1 (natgrad final layer)", "epi", 1, True),
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


def _bwd_bound(form, L, m, n, d):
    """K3's least time: A, the cotangents, W and q_mu in, dA, dW, dq_mu
    out; 6 L D M^2 N bf16 FLOP of the three products per d, plus the two
    bf16x3 mean products (3 passes each), and the f32 prior term."""
    mean, ssq = form == "epi", form != "qvar"
    in_floats = (L * m * n + L * d * n + (L * n if ssq else 0) + d * m * m
                 + ((L * d * n + m * d) if mean else 0))
    out_floats = L * m * n + d * m * m + (m * d if mean else 0)
    return bound(bytes_moved=4 * (in_floats + out_floats),
                 bf16_ops=6 * L * d * m * m * n
                 + (12 * L * m * n * d if mean else 0),
                 f32_ops=(3 * L * m * n if ssq else 0))


def epilogue_bwd_phase(torch, hopper, gen) -> tuple:
    """K3 against its plain version in every form at the training shapes
    A [20,128,512] and [20,128,8192], at M=100, and its determinism."""
    qvar = hopper.qvar
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
            b_ms, b_by = _bwd_bound(form, L_TRAIN, M, n, d)
            cases[form].append({
                "case": label, "shape": f"A [{L_TRAIN},{M},{n}], W "
                f"[{d},{M},{M}]", "max_abs_err": max(errs.values()),
                "max_rel_err": max(rels.values()), "errs": errs, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by})
            del args, got, ref
            torch.cuda.empty_cache()
    # M=100: one chunk padded with zeros in the kernel
    args = _bwd_inputs(torch, gen, L_TRAIN, 100, B_TRAIN, 8, False)
    m100, _ = _compare(torch, "epilogue_bwd [M=100, epi root D=8]",
                       _bwd_call(qvar, "epi", *args, False, plain=False),
                       _bwd_call(qvar, "epi", *args, False, plain=True),
                       names["epi"], tol)
    # no float atomics: two launches give bitwise-equal sums over the grid
    determinism = {}
    for cov in (False, True):
        args = _bwd_inputs(torch, gen, L_TRAIN, M, B_BIG, 8, cov)
        a = qvar.epi_bwd_fused(*args, cov)
        b = qvar.epi_bwd_fused(*args, cov)
        for name, x, y in zip(names["epi"], a, b):
            if not torch.equal(x, y):
                fail(f"epilogue_bwd is not deterministic: {name} differs "
                     f"between two launches (cov={cov})")
        determinism["cov" if cov else "root"] = "bitwise equal"
    rows = [_entry(f"epilogue_bwd:{form}",
                   "dgps_with_iwvi_torch/csrc/epilogue_bwd.cu",
                   K3_REPLACES[form], cases[form],
                   "dA 1e-4, dW and dq_mu 1e-3 x max|plain|")
            for form in cases]
    return rows, {"m100_errs": m100, "determinism": determinism}


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


N_KIN8NM, D_KIN8NM = 7372, 8
TRAIN_STEPS, BIG_STEPS = 200, 20


def _path_counts(build) -> dict:
    """Launches since the last reset, by kernel variant."""
    counts = build.variant_launches()
    counts["chol_inv"] = build.launches()["chol_inv"]
    return counts


def _grad_agreement(torch, train, config, tc, state, X, Y, idx, eps):
    """One step's loss and every gradient through the kernels and through
    the plain versions on the card, same state, rows and noise."""
    from dgps_with_iwvi_torch.ops.hopper import build

    def tensors(tree, path):
        if isinstance(tree, dict):
            return [x for k, v in tree.items()
                    for x in tensors(v, f"{path}.{k}")]
        if isinstance(tree, (list, tuple)):
            return [x for i, v in enumerate(tree)
                    for x in tensors(v, f"{path}[{i}]")]
        return [] if tree is None else [(path, tree)]

    def run():
        loss, g_nat, g_rest = train.loss_and_grads(config, tc, state, X, Y,
                                                   idx=idx, eps=eps)
        return loss, tensors(g_nat, "natvars") + tensors(g_rest, "rest")

    loss_k, g_k = run()
    with build.plain_versions():
        loss_p, g_p = run()
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    by_leaf = {name: max_err(a, b) / max(float(b.abs().max()), 1e-30)
               for (name, a), (_, b) in zip(g_k, g_p)}
    grad_rel = max(by_leaf.values())
    # same rounding classes on both paths; the f32 sums run in another
    # order, and a bf16 rounding boundary crossed by dt or ga moves one
    # product term by a bf16 unit: the bf16 class of the reference's
    # tolerance (tests/test_pallas_epilogue.py:115-117)
    if not (loss_rel <= 1e-4 and grad_rel <= 2e-2):
        fail(f"train step: kernels vs plain versions differ: loss {loss_rel} "
             f"(tol 1e-4 rel), gradients {grad_rel} (tol 2e-2 of max|g|): "
             + json.dumps(by_leaf))
    return {"loss": float(loss_k), "loss_rel_err": loss_rel,
            "max_grad_err_over_max_grad": grad_rel, "by_leaf": by_leaf,
            "tol": "loss 1e-4 rel; each gradient 2e-2 x max|plain|"}


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


def profile_train(torch, step, state, X, Y, gen, steps: int = 5) -> dict:
    """Device time by kernel over `steps` training steps (torch.profiler)
    and the device's idle share of their wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = step(state, X, Y, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    rows = [(e.self_device_time_total / 1e3 / steps, e.count / steps, e.key)
            for e in events if str(e.device_type).endswith("CUDA")
            and e.self_device_time_total > 0]
    busy_ms = sum(r[0] for r in rows)
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC"))
    return {"steps": steps, "wall_ms_per_step": wall_ms / steps,
            "device_ms_per_step": busy_ms,
            "idle_share": 1.0 - busy_ms * steps / wall_ms,
            "kernel_launches_per_step": launches / steps,
            "kernels_ms_per_step": [
                {"kernel": k[:200], "ms": ms, "calls": c}
                for ms, c, k in sorted(rows, reverse=True)[:40]]}


def train_phase(torch, card: str, profile: bool) -> dict:
    """The flagship training step: LGG, IW K=20, M=128, natgrad on the
    final layer, Adam on the rest, on synthetic data of kin8nm's shape.
    One step through the kernels against the same step through the plain
    versions; then TRAIN_STEPS timed steps at B=512 whose K1, K2 and K3
    launch counts must rise by 2 each per step, and BIG_STEPS at B=8192 on
    the data tiled past 8192 rows (as bench.py does)."""
    import dataclasses

    from dgps_with_iwvi_torch import training as train
    from dgps_with_iwvi_torch.models import BuildArgs, build_model
    from dgps_with_iwvi_torch.ops.hopper import build

    rng = np.random.default_rng(2)
    Xn = rng.standard_normal((N_KIN8NM, D_KIN8NM)).astype(np.float32)
    Yn = (np.sin(Xn[:, :1]) + 0.1 * rng.standard_normal((N_KIN8NM, 1))
          ).astype(np.float32)
    args = BuildArgs(configuration="LGG", mode="IW", num_inducing=M,
                     num_iw_samples=L_TRAIN)
    config, params = build_model(0, args, Xn, Yn, device="cuda")
    # a q(u) away from its initialization, as after some training: at
    # q_sqrt = I the whitened prior and q-variance terms cancel exactly,
    # and the hyperparameter gradients are rounding noise in either path
    g0 = torch.Generator(device="cuda").manual_seed(1)
    for i, scale in ((1, 0.3), (2, 0.5)):
        lp = params["layers"][i]
        lp["q_mu"] = 0.5 * torch.randn(lp["q_mu"].shape, generator=g0,
                                       device="cuda")
        lp["q_sqrt"] = (0.02 * torch.tril(torch.randn(
            lp["q_sqrt"].shape, generator=g0, device="cuda"))
            + scale * torch.eye(M, device="cuda"))
    X, Y = torch.from_numpy(Xn).cuda(), torch.from_numpy(Yn).cuda()
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
        rec["profile_b512"] = profile_train(torch, step, state, X, Y, gen)

    reps = (B_BIG + N_KIN8NM - 1) // N_KIN8NM + 1
    Xb, Yb = X.repeat(reps, 1), Y.repeat(reps, 1)
    cfg_big = dataclasses.replace(config, num_data=Xb.shape[0])
    tc_big = dataclasses.replace(tc, minibatch_size=B_BIG)
    init_b, step_b, _, _ = train.make_trainer(cfg_big, tc_big)
    state_b = init_b(params)
    for _ in range(3):                                       # warm-up
        state_b, _ = step_b(state_b, Xb, Yb, gen)
    torch.cuda.reset_peak_memory_stats()
    state_b, rate_big, losses_b = _steps_per_s(torch, step_b, state_b, Xb,
                                               Yb, gen, BIG_STEPS)
    if not bool(torch.isfinite(losses_b).all()):
        fail("train B=8192: a loss is not finite")
    rec.update({"steps_b8192": BIG_STEPS, "steps_per_s_b8192": rate_big,
                "peak_mem_gib_b8192":
                torch.cuda.max_memory_allocated() / 2 ** 30})
    if profile:
        rec["profile_b8192"] = profile_train(torch, step_b, state_b, Xb, Yb,
                                             gen, steps=3)
    print(f"train: {rate:.1f} steps/s at B={B_TRAIN}, {rate_big:.2f} "
          f"steps/s at B={B_BIG} (LGG IW K={L_TRAIN} M={M}, natgrad final) "
          f"on {card}")
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the record to DIR/"
                    "chip_smoke.json")
    ap.add_argument("--profile", action="store_true",
                    help="also trace two served requests and five training "
                    "steps with torch.profiler and print device time by "
                    "kernel and the idle share")
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
    k3, rec["epilogue_bwd_checks"] = epilogue_bwd_phase(torch, hopper, gen)
    rec["slice"] = slice_phase(torch, model, rec, opts.profile)
    rec["train"] = train_phase(torch, card, opts.profile)
    if opts.profile:
        # the profiler slows the host; against the unprofiled serve time
        wall = rec["slice"]["serve_s"] * 1e3 / REQUESTS
        rec["profile"]["idle_share_vs_unprofiled_wall"] = (
            1.0 - rec["profile"]["device_ms_per_request"] / wall)
        print("profile: " + json.dumps(rec["profile"]))
    for k in (k1, *k2, *k3):
        by_path = {"serve": rec["slice"]["launches"].get(k["name"], 0),
                   "train": rec["train"]["launches"].get(k["name"], 0)}
        k["launches"] = sum(by_path.values())
        k["launches_by_path"] = by_path
    rec["kernels"] = [k1, *k2, *k3]
    s = rec["slice"]
    print(f"serve: {s['points_per_s']:.0f} points/s (S={S_SERVE}, "
          f"B={B_SERVE}, {REQUESTS} requests; plain versions "
          f"{s['plain_points_per_s']:.0f}) on {card}")
    print("slice: " + json.dumps(s))
    print("train: " + json.dumps(rec["train"]))
    print("epilogue_bwd checks: " + json.dumps(rec["epilogue_bwd_checks"]))
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
