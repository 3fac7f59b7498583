"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is False; this file imports no JAX, so it
also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: both sides multiply the same bf16-rounded operands into f32
(K2, K3) or run plain f32 (K1), so they differ by the order of f32 sums
only: 1e-4 of the largest plain value for the q-variance, the mean and
every gradient of K3, 1e-5 for the sum of squares; the Cholesky bounds of
tests/test_pallas_chol.py.
"""

import math

import numpy as np
import pytest
import torch

from dgps_with_iwvi_torch.models import (BuildArgs, build_model,
                                         predict_y_and_log_density)
from dgps_with_iwvi_torch.ops import linalg
from dgps_with_iwvi_torch.ops.hopper import build, chol, qvar

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _spd(gen, g, m):
    A = torch.randn((g, m, m), generator=gen, device="cuda")
    return A @ A.transpose(-1, -2) + m * torch.eye(m, device="cuda")


# 200 and 264 work in device memory (past 168 the working set leaves
# shared memory)
@pytest.mark.parametrize("m", [128, 100, 20, 1, 200, 264])
def test_chol_inv_kernel_matches_plain(gen, m):
    K = _spd(gen, 3, m)
    jit = linalg._jitter_ladder(1e-6, 4, K.dtype, K.device)
    L, Li = chol.chol_inv(K, jit)
    Lp, Lip = chol.chol_inv_plain(K, jit)
    torch.testing.assert_close(L, Lp, rtol=0,
                               atol=2e-5 * float(Lp.abs().max()))
    torch.testing.assert_close(Li, Lip, rtol=0, atol=2e-4)
    assert float(torch.triu(L, 1).abs().max()) == 0.0
    assert float(torch.triu(Li, 1).abs().max()) == 0.0


def test_chol_inv_kernel_rejects_failed_pivots_per_matrix(gen):
    K = _spd(gen, 3, 128)
    d = torch.ones(128, device="cuda")
    d[64:] = -1.0
    K[1] = torch.diag(d)
    jit = torch.zeros(1, device="cuda")
    L, _ = chol.chol_inv(K, jit)
    assert linalg._chol_ok(L[0]).tolist() == [True, False, True]
    Lok, _ = chol.chol_inv(K[[0, 2]], jit)
    torch.testing.assert_close(L[0, [0, 2]], Lok[0], rtol=0, atol=0)


def test_rank_deficient_gram_climbs_the_ladder(gen):
    v = torch.randn((128, 2), generator=gen, device="cuda")
    L, Linv = linalg.chol_and_inverse((v @ v.T)[None], 1e-6, 6)
    d = torch.diagonal(L, dim1=-2, dim2=-1)
    assert bool(torch.isfinite(L).all()) and bool((d > 0).all())
    assert bool(torch.isfinite(Linv).all())


# M is worked through in chunks of 128 rows, padded with zeros in the kernel
@pytest.mark.parametrize("m", [128, 100, 20, 264])
@pytest.mark.parametrize("d,cov,with_mean", [(8, False, True),
                                             (1, False, True),
                                             (8, True, True),
                                             (3, False, False),
                                             (1, True, False)])
def test_epilogue_kernel_matches_plain(gen, m, d, cov, with_mean):
    n = 1000  # ragged: 7 full column tiles and one of 104
    A = torch.randn((2, m, n), generator=gen, device="cuda") / math.sqrt(m)
    W = 0.1 * torch.tril(torch.randn((d, m, m), generator=gen,
                                     device="cuda")) + torch.eye(m,
                                                                 device="cuda")
    if cov:
        W = W @ W.transpose(-1, -2)
    q_mu = torch.randn((m, d), generator=gen, device="cuda")
    if with_mean:
        got = qvar.epi_fused(A, W, q_mu, cov)
        ref = qvar.epi_plain(A, W, q_mu, cov)
    else:
        got = (qvar.qvar_fused(A, W, cov),)
        ref = (qvar.qvar_plain(A, W, cov),)
    for g, r, rel in zip(got, ref, (1e-4, 1e-5, 1e-4)):
        assert g.shape == r.shape
        torch.testing.assert_close(g, r, rtol=0,
                                   atol=rel * float(r.abs().max()))


def test_epilogue_kernel_rejects_unsupported_shapes(gen):
    A = torch.randn((1, 48, 16), generator=gen, device="cuda")
    with pytest.raises(ValueError, match=r"W \[D, M, M\]"):
        qvar.qvar_fused(A, torch.eye(32, device="cuda")[None])
    with pytest.raises(TypeError, match="float32"):
        qvar.qvar_fused(A.double()[:, :32], torch.eye(32, device="cuda",
                                                      dtype=torch.float64)[None])


@pytest.mark.parametrize("m", [128, 100])
def test_serving_path_runs_the_kernels(gen, m):
    rng = np.random.default_rng(0)
    X = rng.standard_normal((512, 8)).astype(np.float32)
    Y = np.sin(X[:, :1]).astype(np.float32)
    config, params = build_model(0, BuildArgs(configuration="LGG", mode="IW",
                                              num_inducing=m), X, Y)
    Xt, Yt = torch.from_numpy(X).cuda(), torch.from_numpy(Y).cuda()

    def run():
        g = torch.Generator(device="cuda").manual_seed(5)
        return predict_y_and_log_density(params, config, Xt, Yt, g, 4)

    build.reset_launches()
    (m, v), ld = run()
    assert build.launches() == {"chol_inv": 1, "epilogue": 2,
                                "epilogue_bwd": 0}
    with build.plain_versions():
        (mp, vp), ldp = run()
    assert build.launches() == {"chol_inv": 1, "epilogue": 2,
                                "epilogue_bwd": 0}
    for a, b in ((m, mp), (v, vp), (ld, ldp)):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3)


def _bwd_inputs(gen, L, m, n, d, cov):
    A = torch.randn((L, m, n), generator=gen, device="cuda") / math.sqrt(m)
    W = 0.1 * torch.tril(torch.randn((d, m, m), generator=gen,
                                     device="cuda")) + torch.eye(m,
                                                                 device="cuda")
    if cov:
        W = W @ W.transpose(-1, -2)
    q_mu = torch.randn((m, d), generator=gen, device="cuda")
    g_qv, g_mn = (torch.randn((L, d, n), generator=gen, device="cuda")
                  for _ in range(2))
    g_ss = torch.randn((L, n), generator=gen, device="cuda")
    return A, W, q_mu, g_qv, g_ss, g_mn


def _bwd_call(form, A, W, q_mu, g_qv, g_ss, g_mn, cov, plain):
    if form == "epi":
        f = qvar.epi_bwd_plain if plain else qvar.epi_bwd_fused
        return f(A, W, q_mu, g_qv, g_ss, g_mn, cov)
    if form == "ps":
        f = qvar.ps_bwd_plain if plain else qvar.ps_bwd_fused
        return f(A, W, g_qv, g_ss, cov)
    f = qvar.qvar_bwd_plain if plain else qvar.qvar_bwd_fused
    return f(A, W, g_qv, cov)


# M is worked through in chunks of 128 rows; N=1000 leaves a ragged tile
@pytest.mark.parametrize("m", [128, 100, 20, 200])
@pytest.mark.parametrize("form,d,cov", [("epi", 8, False), ("epi", 1, True),
                                        ("ps", 8, False), ("ps", 3, True),
                                        ("qvar", 8, False),
                                        ("qvar", 1, True)])
def test_epilogue_bwd_kernel_matches_plain(gen, m, form, d, cov):
    args = _bwd_inputs(gen, 3, m, 1000, d, cov)
    got = _bwd_call(form, *args, cov, plain=False)
    ref = _bwd_call(form, *args, cov, plain=True)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        torch.testing.assert_close(g, r, rtol=0,
                                   atol=1e-4 * float(r.abs().max()))


@pytest.mark.parametrize("cov", [False, True])
def test_epilogue_bwd_kernel_is_deterministic(gen, cov):
    """dW and dq_mu sum over the whole grid without atomics: two launches
    on the same inputs are bitwise equal."""
    args = _bwd_inputs(gen, 20, 128, 512, 8, cov)
    a = qvar.epi_bwd_fused(*args, cov)
    b = qvar.epi_bwd_fused(*args, cov)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_training_functions_launch_k2_and_k3(gen):
    A, W, q_mu, g_qv, g_ss, g_mn = _bwd_inputs(gen, 2, 128, 256, 8, False)
    A.requires_grad_()
    W.requires_grad_()
    build.reset_launches()
    qv, ss, mn = qvar.EpiFusedTrain.apply(A, W, q_mu, False)
    torch.autograd.grad((qv * g_qv).sum() + (ss * g_ss).sum()
                        + (mn * g_mn).sum(), (A, W))
    assert build.launches() == {"chol_inv": 0, "epilogue": 1,
                                "epilogue_bwd": 1}
    assert build.variant_launches() == {"epilogue:epi": 1,
                                        "epilogue_bwd:epi": 1}
