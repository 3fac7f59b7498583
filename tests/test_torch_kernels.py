"""Parity of the port's kernel modules (``ops/hopper``) with the Pallas
kernels they replace, run in interpret mode on the CPU.

The port's wrappers take their plain PyTorch versions for CPU tensors;
those are what these tests hold to the Pallas kernels, at the tolerances
of ``tests/test_pallas_epilogue.py``: the q-variance to the bf16 rounding
class (atol 2e-2 * max|qv|), the sum of squares near-exactly (rtol 1e-5)
and the mean to f32 (rtol 1e-4). The backwards (K3's plain versions) round
the same operands as the Pallas backward kernels, so they differ by the
order of f32 sums only: measured 4e-7 of the largest value, held at 1e-5.
The hand-written CUDA kernels are held to the plain versions on the card
by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dgps_with_iwvi_tpu.ops import conditionals as jcond
from dgps_with_iwvi_tpu.ops.pallas.chol import chol_inv_pallas
from dgps_with_iwvi_tpu.ops.pallas.qvar import (epi_bwd_fused, epi_fused,
                                                ps_bwd_fused, ps_fused,
                                                qvar_bwd_fused, qvar_fused)
from dgps_with_iwvi_torch.ops import conditionals as tcond
from dgps_with_iwvi_torch.ops import linalg as tlinalg
from dgps_with_iwvi_torch.ops.hopper import build
from dgps_with_iwvi_torch.ops.hopper import chol as tchol
from dgps_with_iwvi_torch.ops.hopper import qvar as tqvar


def _data(seed=0, S=3, M=16, N=256, D=4):
    rng = np.random.RandomState(seed)
    A = rng.randn(S, M, N).astype(np.float32)
    L = (np.tril(rng.randn(D, M, M)) + 2.0 * np.eye(M)).astype(np.float32)
    qmu = rng.randn(M, D).astype(np.float32)
    return A, L, qmu


def _w(L, cov):
    return L @ np.swapaxes(L, -1, -2) if cov else L


def _check_qv(qv, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(qv.numpy(), ref, rtol=0,
                               atol=2e-2 * float(np.max(np.abs(ref))))


@pytest.mark.parametrize("cov", [False, True])
def test_plain_epilogue_matches_pallas(cov):
    A, L, qmu = _data()
    W = _w(L, cov)
    qv_r, ss_r, mn_r = epi_fused(jnp.asarray(A), jnp.asarray(W),
                                 jnp.asarray(qmu), cov, True)
    qv, ss, mn = tqvar.epi_plain(torch.from_numpy(A), torch.from_numpy(W),
                                 torch.from_numpy(qmu), cov)
    assert qv.shape == (3, 4, 256) and ss.shape == (3, 256)
    _check_qv(qv, qv_r)
    np.testing.assert_allclose(ss.numpy(), np.asarray(ss_r), rtol=1e-5,
                               atol=1e-4)
    mn_r = np.asarray(mn_r)
    np.testing.assert_allclose(mn.numpy(), mn_r, rtol=1e-4,
                               atol=1e-4 * float(np.max(np.abs(mn_r))))


@pytest.mark.parametrize("cov", [False, True])
def test_plain_qvar_matches_pallas(cov):
    A, L, _ = _data(seed=1)
    W = _w(L, cov)
    ref = qvar_fused(jnp.asarray(A), jnp.asarray(W), cov, True)
    out = tqvar.qvar_plain(torch.from_numpy(A), torch.from_numpy(W), cov)
    _check_qv(out, ref)


@pytest.mark.parametrize("cov", [False, True])
def test_plain_ps_matches_pallas(cov):
    A, L, _ = _data(seed=6)
    W = _w(L, cov)
    qv_r, ss_r = ps_fused(jnp.asarray(A), jnp.asarray(W), cov, True)
    qv, ss = tqvar.ps_plain(torch.from_numpy(A), torch.from_numpy(W), cov)
    _check_qv(qv, qv_r)
    np.testing.assert_allclose(ss.numpy(), np.asarray(ss_r), rtol=1e-5,
                               atol=1e-4)


def _bwd_data(seed, cov):
    A, L, qmu = _data(seed=seed)
    rng = np.random.RandomState(seed + 100)
    g_qv, g_mn = (rng.randn(3, 4, 256).astype(np.float32) for _ in range(2))
    g_ss = rng.randn(3, 256).astype(np.float32)
    return A, _w(L, cov).astype(np.float32), qmu, g_qv, g_ss, g_mn


@pytest.mark.parametrize("cov", [False, True])
@pytest.mark.parametrize("form", ["epi", "ps", "qvar"])
def test_plain_backward_matches_pallas(form, cov):
    A, W, qmu, g_qv, g_ss, g_mn = _bwd_data(7, cov)
    j = [jnp.asarray(a) for a in (A, W, qmu, g_qv, g_ss, g_mn)]
    t = [torch.from_numpy(a) for a in (A, W, qmu, g_qv, g_ss, g_mn)]
    if form == "epi":
        ref = epi_bwd_fused(*j, cov, True)
        out = tqvar.epi_bwd_plain(*t, cov)
    elif form == "ps":
        ref = ps_bwd_fused(j[0], j[1], j[3], j[4], cov, True)
        out = tqvar.ps_bwd_plain(t[0], t[1], t[3], t[4], cov)
    else:
        ref = qvar_bwd_fused(j[0], j[1], j[3], cov, True)
        out = tqvar.qvar_bwd_plain(t[0], t[1], t[3], cov)
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        r = np.asarray(r)
        assert o.shape == r.shape
        np.testing.assert_allclose(o.numpy(), r, rtol=0,
                                   atol=1e-5 * float(np.max(np.abs(r))))


@pytest.mark.parametrize("cov", [False, True])
def test_training_function_backward_is_the_epilogue_gradient(cov):
    """In float64 the rounding passes through, so EpiFusedTrain's backward
    (the plain K3 on the CPU) equals autograd of the plain forward."""
    A, W, qmu, g_qv, g_ss, g_mn = (a.astype(np.float64)
                                   for a in _bwd_data(8, cov))
    At, Wt, qt = (torch.from_numpy(a).requires_grad_() for a in (A, W, qmu))
    gs = [torch.from_numpy(a) for a in (g_qv, g_ss, g_mn)]

    def grads(outs, inputs):
        outs = outs if isinstance(outs, tuple) else (outs,)
        return torch.autograd.grad(
            sum(torch.sum(o * g) for o, g in zip(outs, gs)), inputs)

    for fused, plain, inputs in (
            (tqvar.EpiFusedTrain.apply(At, Wt, qt, cov),
             tqvar.epi_plain(At, Wt, qt, cov), (At, Wt, qt)),
            (tqvar.PsFusedTrain.apply(At, Wt, cov),
             tqvar.ps_plain(At, Wt, cov), (At, Wt)),
            (tqvar.QvarFusedTrain.apply(At, Wt, cov),
             tqvar.qvar_plain(At, Wt, cov), (At, Wt))):
        for a, b in zip(grads(fused, inputs), grads(plain, inputs)):
            torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("cov", [False, True])
def test_cpu_wrappers_take_the_plain_version(cov):
    A, L, qmu = _data(seed=2, N=40)
    At, Wt, qt = (torch.from_numpy(a) for a in (A, _w(L, cov), qmu))
    build.reset_launches()
    for a, b in zip(tqvar.epi_fused(At, Wt, qt, cov),
                    tqvar.epi_plain(At, Wt, qt, cov)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(tqvar.qvar_fused(At, Wt, cov),
                               tqvar.qvar_plain(At, Wt, cov), rtol=0, atol=0)
    assert build.launches() == dict.fromkeys(build.KERNELS, 0)


def test_epilogue_dispatch_on_inference_calls():
    """The fused epilogue of base_conditional_whitened equals the
    reference's inference branch with its kernel forced on (interpreted),
    in f32: both round the q-variance operands to bf16 and run the mean at
    bf16x3, so they agree to f32 rounding, far inside the bf16 class."""
    rng = np.random.RandomState(3)
    m, n, d = 16, 256, 3
    K = rng.randn(m, m).astype(np.float32)
    Lm = np.linalg.cholesky(K @ K.T + m * np.eye(m)).astype(np.float32)
    Linv = np.linalg.inv(Lm).astype(np.float32)
    Kuf = (0.3 * rng.randn(2, m, n)).astype(np.float32)
    Kff = np.full((2, n), 1.3, np.float32)
    q_mu = rng.randn(m, d).astype(np.float32)
    q_sqrt = (np.tril(0.3 * rng.randn(d, m, m)) + np.eye(m)).astype(np.float32)
    saved = jcond.QVAR_PALLAS
    jcond.QVAR_PALLAS = "on"
    try:
        with jcond.qvar_inference_mode():
            ref = jcond.base_conditional_whitened(
                *(jnp.asarray(a) for a in (Kuf, Lm, Kff, q_mu, q_sqrt)),
                var_precision="default", Linv=jnp.asarray(Linv),
                solve_precision="high")
    finally:
        jcond.QVAR_PALLAS = saved
    out = tcond.base_conditional_whitened(
        *(torch.from_numpy(a) for a in (Kuf, Lm, Kff, q_mu, q_sqrt)),
        var_precision="default", Linv=torch.from_numpy(Linv),
        solve_precision="high")
    for o, r in ((out.mean, ref.mean), (out.var, ref.var)):
        r = np.asarray(r)
        np.testing.assert_allclose(o.numpy(), r, rtol=1e-4,
                                   atol=1e-5 * float(np.max(np.abs(r))))


@pytest.mark.parametrize("m", [16, 20])
def test_plain_chol_inv_matches_pallas(m):
    """M=20 is padded to 128 by the Pallas kernel (identity block)."""
    rng = np.random.RandomState(4)
    A = rng.randn(2, m, m).astype(np.float32)
    K = A @ np.swapaxes(A, -1, -2) + m * np.eye(m, dtype=np.float32)
    L_r, Linv_r = chol_inv_pallas(jnp.asarray(K), interpret=True)
    jit = torch.zeros(1, dtype=torch.float32)
    L, Linv = tchol.chol_inv_plain(torch.from_numpy(K), jit)
    assert L.shape == (1, 2, m, m)
    np.testing.assert_allclose(L[0].numpy(), np.asarray(L_r), atol=1e-4)
    np.testing.assert_allclose(Linv[0].numpy(), np.asarray(Linv_r),
                               atol=1e-4)
    assert float(torch.max(torch.abs(torch.triu(L, 1)))) == 0.0


def test_plain_chol_inv_ladder_levels():
    """One call factors every level; an indefinite level is all NaN and
    the selection picks the first usable one per matrix."""
    rng = np.random.RandomState(5)
    v = rng.randn(16, 2).astype(np.float64)
    bad = v @ v.T - 5e-5 * np.eye(16)
    good = v @ v.T + 16 * np.eye(16)
    K = torch.from_numpy(np.stack([bad, good]))
    jitters = tlinalg._jitter_ladder(1e-6, 4, K.dtype, K.device)
    L_all, Linv_all = tchol.chol_inv_plain(K, jitters)
    assert L_all.shape == (4, 2, 16, 16)
    ok = tlinalg._chol_ok(L_all)
    assert ok.tolist() == [[False, True], [False, True], [True, True],
                           [True, True]]
    assert tlinalg._first_ok_level(L_all).tolist() == [2, 0]
    assert bool(torch.all(torch.isnan(L_all[0, 0])))


def test_kernel_wrappers_reject_other_devices():
    A = torch.zeros(1, 32, 8, device="meta")
    with pytest.raises(ValueError, match="cuda"):
        tqvar.epi_fused(A, torch.zeros(1, 32, 32, device="meta"),
                        torch.zeros(32, 1, device="meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        tchol.chol_inv(torch.zeros(1, 4, 4, device="meta"),
                       torch.zeros(1, device="meta"))
