"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is False; this file imports no JAX, so it
also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: both sides multiply the same bf16-rounded operands into f32
(K2, K3, K4) or run plain f32 (K1, K5), so they differ by the order of f32
sums only: 1e-4 of the largest plain value for the q-variance, the mean and
every gradient of K3, 1e-5 for the sum of squares; the Cholesky bounds of
tests/test_pallas_chol.py; 1e-5 for every output of K5. K4 computes A
itself, in another order of sums than its plain version: an element of A
moved across a bf16 rounding boundary moves bf16(A) by one bf16 unit, the
q-variance by up to 2^-8 of one of its terms and the sample through its
sd; 1e-4 on the mean, 2e-3 on the variance and the sample (a little
over twice the largest reading of chip_smoke.py on an H100, 8.7e-4 on the
variance at the serving shape).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from dgps_with_iwvi_torch.models import (BuildArgs, build_model,
                                         predict_y_and_log_density)
from dgps_with_iwvi_torch.ops import linalg
from dgps_with_iwvi_torch.ops.hopper import (build, chol, conditional, qvar,
                                             serve_cond)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _spd(gen, g, m):
    A = torch.randn((g, m, m), generator=gen, device="cuda")
    return A @ A.transpose(-1, -2) + m * torch.eye(m, device="cuda")


# the blocked kernel pads M to a multiple of its panel width (17, 127, 129
# are not); 200 and 264 work in device memory (past 160 the working set
# leaves shared memory); T=2 is natgrad's ladder
@pytest.mark.parametrize("m,tries", [(128, 4), (100, 4), (20, 4), (1, 4),
                                     (200, 4), (264, 4), (17, 4), (127, 4),
                                     (129, 4), (160, 4), (161, 4), (128, 2)])
def test_chol_inv_kernel_matches_plain(gen, m, tries):
    K = _spd(gen, 3, m)
    jit = linalg._jitter_ladder(1e-6, tries, K.dtype, K.device)
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


@pytest.mark.parametrize("m", [128, 45])
def test_chol_inv_failed_pivot_stays_in_its_level(gen, m):
    """A pivot that fails in one panel of one (matrix, level) leaves every
    other matrix and level of the launch bitwise as it is alone."""
    K = _spd(gen, 3, m)
    K[1] -= 3.0 * m * torch.eye(m, device="cuda")  # indefinite at low jitter
    jit = torch.tensor([0.0, 1e-3, 10.0 * m], device="cuda")
    L, Li = chol.chol_inv(K, jit)
    ok = linalg._chol_ok(L)
    assert ok[:, 0].all() and ok[:, 2].all()
    assert ok[:2, 1].tolist() == [False, False] and bool(ok[2, 1])
    for g in (0, 2):
        Lg, Lig = chol.chol_inv(K[g:g + 1], jit)
        assert torch.equal(L[:, g], Lg[:, 0]) and torch.equal(Li[:, g],
                                                              Lig[:, 0])
    L2, Li2 = chol.chol_inv(K[1:2], jit[2:])
    assert torch.equal(L[2, 1], L2[0, 0]) and torch.equal(Li[2, 1], Li2[0, 0])


def test_rank_deficient_gram_climbs_the_ladder(gen):
    v = torch.randn((128, 2), generator=gen, device="cuda")
    L, Linv = linalg.chol_and_inverse((v @ v.T)[None], 1e-6, 6)
    d = torch.diagonal(L, dim1=-2, dim2=-1)
    assert bool(torch.isfinite(L).all()) and bool((d > 0).all())
    assert bool(torch.isfinite(Linv).all())


def _epi_inputs(gen, L, m, n, d, cov):
    A = torch.randn((L, m, n), generator=gen, device="cuda") / math.sqrt(m)
    W = 0.1 * torch.tril(torch.randn((d, m, m), generator=gen,
                                     device="cuda")) + torch.eye(m,
                                                                 device="cuda")
    if cov:
        W = W @ W.transpose(-1, -2)
    return A, W, torch.randn((m, d), generator=gen, device="cuda")


# M is worked through in chunks of 128 rows, padded with zeros in the
# kernel; N = 1000 is ragged (7 full column tiles and one of 104); then one
# column, 64 + 1 columns, 16 outputs (two groups of 8), a single L, and the
# covariance form with the mean at M = 264
EPI_KERNEL_CASES = [
    (2, m, 1000, d, cov, with_mean) for m in (128, 100, 20, 264)
    for d, cov, with_mean in ((8, False, True), (1, False, True),
                              (8, True, True), (3, False, False),
                              (1, True, False), (1, False, False))
] + [(2, 128, 1, 8, False, True), (2, 128, 65, 8, False, True),
     (2, 128, 65, 1, True, True), (2, 128, 1, 1, True, False),
     (2, 128, 1000, 16, False, True), (1, 128, 1000, 8, False, True),
     (1, 128, 1000, 1, True, True), (2, 264, 1000, 1, True, True)]


@pytest.mark.parametrize("L,m,n,d,cov,with_mean", EPI_KERNEL_CASES)
def test_epilogue_kernel_matches_plain(gen, L, m, n, d, cov, with_mean):
    A, W, q_mu = _epi_inputs(gen, L, m, n, d, cov)
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


@pytest.mark.parametrize("L,n,d,cov", [(20, 512, 8, False),
                                       (20, 512, 1, True),
                                       (3, 1000, 16, False)])
def test_epilogue_kernel_is_deterministic(gen, L, n, d, cov):
    """Fixed-order sums and no atomics: two launches are bitwise equal."""
    A, W, q_mu = _epi_inputs(gen, L, 128, n, d, cov)
    first = qvar.epi_fused(A, W, q_mu, cov)
    second = qvar.epi_fused(A, W, q_mu, cov)
    for x, y in zip(first, second):
        assert torch.equal(x, y)


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
    assert config.serve_pallas == "auto"

    def run(cfg):
        g = torch.Generator(device="cuda").manual_seed(5)
        return predict_y_and_log_density(params, cfg, Xt, Yt, g, 4)

    # "auto": K4 takes both layers in inference on the card; False: K2
    routes = ((config, {"chol_inv": 1, "epilogue": 0, "epilogue_bwd": 0,
                        "serve_cond": 2, "conditional": 0}),
              (dataclasses.replace(config, serve_pallas=False),
               {"chol_inv": 1, "epilogue": 2, "epilogue_bwd": 0,
                "serve_cond": 0, "conditional": 0}))
    for cfg, want in routes:
        build.reset_launches()
        (m, v), ld = run(cfg)
        assert build.launches() == want
        with build.plain_versions():
            (mp, vp), ldp = run(cfg)
        assert build.launches() == want
        for a, b in ((m, mp), (v, vp), (ld, ldp)):
            torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if not isinstance(tree, (list, tuple)):
        return []
    return [t for sub in tree for t in _leaves(sub)]


def test_serve_pallas_auto_leaves_gradients_to_the_default_route(gen):
    """Where a gradient is needed, "auto" takes the default route (K2 and
    its backward K3) and does not raise; under no_grad it takes K4."""
    rng = np.random.default_rng(1)
    X = rng.standard_normal((256, 8)).astype(np.float32)
    Y = np.sin(X[:, :1]).astype(np.float32)
    config, params = build_model(0, BuildArgs(configuration="LGG", mode="IW",
                                              num_inducing=64), X, Y)
    leaves = [t.requires_grad_() for t in _leaves(params)]
    Xt, Yt = torch.from_numpy(X).cuda(), torch.from_numpy(Y).cuda()
    g = torch.Generator(device="cuda").manual_seed(5)
    build.reset_launches()
    (m, v), ld = predict_y_and_log_density(params, config, Xt, Yt, g, 4)
    torch.autograd.grad(ld.sum(), leaves, allow_unused=True)
    counts = build.launches()
    assert counts["serve_cond"] == 0 and counts["epilogue"] == 2
    assert counts["epilogue_bwd"] == 2
    build.reset_launches()
    with torch.no_grad():
        predict_y_and_log_density(params, config, Xt, Yt, g, 4)
    assert build.launches()["serve_cond"] == 2


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


def _pad_n(t, n):
    """t with its last axis zero-padded to n (the column axis)."""
    return torch.nn.functional.pad(t, (0, n - t.shape[-1]))


# N=999 is odd and not a multiple of 4: the kernel's scalar load paths. For
# an odd leading dimension cuBLAS takes another kernel, whose order of sums
# moves some of T's elements across a bf16 rounding boundary against the
# kernel's; the reference is the plain version of the inputs zero-padded to
# a multiple of 8 columns (zero columns add nothing to any sum)
@pytest.mark.parametrize("n", [1000, 999])
@pytest.mark.parametrize("form,d,cov", [("epi", 8, False), ("epi", 1, True),
                                        ("ps", 8, False), ("qvar", 1, True)])
def test_epilogue_bwd_kernel_ragged_n(gen, n, form, d, cov):
    args = _bwd_inputs(gen, 2, 128, n, d, cov)
    got = _bwd_call(form, *args, cov, plain=False)
    n8 = (n + 7) // 8 * 8
    A, W, q_mu, g_qv, g_ss, g_mn = args
    ref = _bwd_call(form, _pad_n(A, n8), W, q_mu, _pad_n(g_qv, n8),
                    _pad_n(g_ss, n8), _pad_n(g_mn, n8), cov, plain=True)
    ref = (ref[0][..., :n],) + tuple(ref[1:])
    for g, r in zip(got, ref):
        assert g.shape == r.shape and bool(torch.isfinite(g).all())
        torch.testing.assert_close(g, r, rtol=0,
                                   atol=1e-4 * float(r.abs().max()))


@pytest.mark.parametrize("n", [512, 8192])
@pytest.mark.parametrize("cov", [False, True])
def test_epilogue_bwd_kernel_is_deterministic(gen, cov, n):
    """dW and dq_mu sum over the whole grid without float atomics: two
    launches on the same inputs are bitwise equal."""
    args = _bwd_inputs(gen, 20, 128, n, 8, cov)
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
                                "epilogue_bwd": 1, "serve_cond": 0,
                                "conditional": 0}
    assert build.variant_launches() == {"epilogue:epi": 1,
                                        "epilogue_bwd:epi": 1}


def test_non_whitened_step_runs_the_qvar_variants(gen):
    """A non-whitened LGG training step (natgrad on the final layer) on
    the card: both GP layers' q-variance goes through K2 'qvar' forward
    and K3 'qvar' backward, once each, with one K1 for the shared Kuu
    factor; loss and every gradient equal the same step through the plain
    versions, the loss at 1e-4 and each gradient at 2e-2 of its largest
    plain value (chip_smoke.py's step gates)."""
    from dgps_with_iwvi_torch import training as train

    rng = np.random.default_rng(0)
    X = rng.standard_normal((2000, 4)).astype(np.float32)
    Y = (np.sin(X[:, :1]) + 0.1 * rng.standard_normal((2000, 1))).astype(
        np.float32)
    config, params = build_model(0, BuildArgs(
        configuration="LGG", mode="IW", num_inducing=64, num_iw_samples=8,
        white=False), X, Y, device="cuda")
    Xc, Yc = torch.from_numpy(X).cuda(), torch.from_numpy(Y).cuda()
    tc = train.TrainConfig(natgrad="final", minibatch_size=256)
    state = train.make_trainer(config, tc)[0](params)
    idx = torch.randint(0, 2000, (256,), generator=gen, device="cuda")

    def step():
        g = torch.Generator(device="cuda").manual_seed(1)
        loss, g_nat, g_rest = train.loss_and_grads(config, tc, state, Xc, Yc,
                                                   g, idx=idx)
        leaves = [t for nv in g_nat for t in nv.values()]
        stack = [g_rest]
        while stack:
            t = stack.pop()
            if isinstance(t, dict):
                stack.extend(t.values())
            elif isinstance(t, (list, tuple)):
                stack.extend(t)
            elif t is not None:
                leaves.append(t)
        return loss, leaves

    build.reset_launches()
    loss_k, g_k = step()
    assert build.variant_launches() == {"epilogue:qvar": 2,
                                        "epilogue_bwd:qvar": 2}
    assert build.launches()["chol_inv"] == 1
    with build.plain_versions():
        loss_p, g_p = step()
    assert abs(float(loss_k) - float(loss_p)) <= 1e-4 * abs(float(loss_p))
    for a, b in zip(g_k, g_p):
        _rel_close(a, b, 2e-2)


def _cond_inputs(gen, n, m, d_in, d, dense_lq=False):
    # past 20 inputs the scale falls as d_in^-1/2, so that |x - z|^2 stays
    # near 4: at 0.5 year's 91 inputs would give Kxz ~ e^-22, A ~ 0 and a
    # variance of var alone, which no fault in the chain would move
    scale = 0.5 if d_in <= 20 else (2.0 / d_in) ** 0.5
    xs = scale * torch.randn((n, d_in), generator=gen, device="cuda")
    zs = scale * torch.randn((m, d_in), generator=gen, device="cuda")
    var = torch.tensor(1.7, device="cuda")
    R = torch.randn((m, m), generator=gen, device="cuda", dtype=torch.float64)
    Lk = torch.linalg.cholesky(R @ R.T + m * torch.eye(m, device="cuda",
                                                       dtype=torch.float64))
    linv = (3.0 * torch.linalg.inv(Lk)).float()
    q_mu = torch.randn((m, d), generator=gen, device="cuda")
    lq = 0.3 * torch.randn((d, m, m), generator=gen, device="cuda")
    return xs, zs, var, linv, q_mu, lq if dense_lq else torch.tril(lq)


def _rel_close(got, ref, rel):
    assert got.shape == ref.shape and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, ref, rtol=0,
                               atol=rel * float(ref.abs().max()))


# any M: 20 and 100 pad inside the kernels; past 128 K4 takes its wide
# kernel and K5 its 32-row tiles, 200 and 264 with two and three column
# chunks. K4 also at year's scoring layers, (91, 30), (30, 30), (30, 1),
# and the widest chain, (128, 32): d_in 91 and 128 at M <= 128 take the
# chain without zs in shared memory
@pytest.mark.parametrize("m", [20, 100, 128, 200, 264])
@pytest.mark.parametrize("d_in,d", [(9, 8), (8, 1), (91, 30), (30, 30),
                                    (128, 32)])
@pytest.mark.parametrize("with_eps", [False, True])
def test_serve_cond_kernel_matches_plain(gen, m, d_in, d, with_eps):
    n = 1000  # ragged: not a multiple of a block's rows
    args = _cond_inputs(gen, n, m, d_in, d)
    eps = (torch.randn((n, d), generator=gen, device="cuda") if with_eps
           else None)
    got = serve_cond.fused_conditional_infer(*args, eps)
    with build.plain_versions():
        ref = serve_cond.fused_conditional_infer(*args, eps)
    tols = ((2e-3,) if with_eps else ()) + (1e-4, 2e-3)   # (sample,) mean, var
    for g, r, tol in zip(got, ref, tols):
        _rel_close(g, r, tol)


@pytest.mark.parametrize("m", [20, 100, 128, 200, 264])
@pytest.mark.parametrize("d_in,d", [(9, 8), (8, 1)])
@pytest.mark.parametrize("seeded", [False, True])
def test_conditional_kernel_matches_plain(gen, m, d_in, d, seeded):
    """Both variants, the residuals Kxz and A, and the sample element by
    element against the plain Philox stream."""
    n = 1000
    args = _cond_inputs(gen, n, m, d_in, d)
    seed = (torch.tensor(2 ** 40 + 3, dtype=torch.int64, device="cuda")
            if seeded else None)
    got = conditional.fused_forward(*args, seed, residuals=True)
    with build.plain_versions():
        ref = conditional.fused_forward(*args, seed, residuals=True)
    for g, r in zip(got, ref):
        assert (g is None) == (r is None)
        if g is not None:
            _rel_close(g, r, 1e-5)


# the edges of K4's and K5's tiling: N = 1, 63, 65 (one ragged tile of 128
# rows); N = 10,240 (K5 splits the q-variance's d over 3 groups of blocks);
# d_in = 20 (two k16 steps of the gram); M = 264; and a dense Lq, which
# both kernels must read as tril(Lq), as the plain versions do: the tile
# skip never reads above the diagonal
COND_EDGES = [(1, 9, 128, 8, False), (63, 9, 128, 8, False),
              (65, 9, 128, 8, False), (10240, 9, 128, 8, False),
              (1000, 20, 128, 8, False), (1000, 20, 264, 1, False),
              (1000, 9, 128, 8, True), (1000, 9, 100, 1, True),
              (1000, 9, 200, 8, True)]
# K4 alone, with a dense Lq at N = 65 and 1000: year's first and second
# scoring layers, the widest chain and year's first at M = 100 (the chain
# without zs in shared memory, but for (30, 30))
SERVE_COND_EDGES = COND_EDGES + [
    (n, d_in, m, d, True) for n in (65, 1000)
    for d_in, m, d in ((91, 128, 30), (30, 128, 30), (128, 128, 32),
                       (91, 100, 30))]


@pytest.mark.parametrize("n,d_in,m,d,dense_lq", SERVE_COND_EDGES)
def test_serve_cond_kernel_edges(gen, n, d_in, m, d, dense_lq):
    """K4 with and without eps against its plain version, and bitwise
    equal across two launches."""
    args = _cond_inputs(gen, n, m, d_in, d, dense_lq)
    eps = torch.randn((n, d), generator=gen, device="cuda")
    got = serve_cond.fused_conditional_infer(*args, eps)
    bare = serve_cond.fused_conditional_infer(*args)
    with build.plain_versions():
        ref = serve_cond.fused_conditional_infer(*args, eps)
        ref_bare = serve_cond.fused_conditional_infer(*args)
    for g, r, tol in zip(got + bare, ref + ref_bare,
                         (2e-3, 1e-4, 2e-3, 1e-4, 2e-3)):
        _rel_close(g, r, tol)
    again = serve_cond.fused_conditional_infer(*args, eps)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_serve_cond_counts_each_launch_under_its_plan(gen):
    """K4's launch takes the chain with zs in shared memory where it fits
    (kin8nm's inner layer), the chain that reads zs from L2 where it does
    not (year's first layer) and the wide kernel past M = 128; each launch
    is counted once under its plan, the kernel's and variant's counts as
    without one."""
    cases = [((91, 128, 30), "chain_l2zs"), ((9, 128, 8), "chain"),
             ((9, 200, 8), "wide")]
    build.reset_launches()
    for (d_in, m, d), plan in cases:
        assert serve_cond.plan(d_in, m, d) == plan
        args = _cond_inputs(gen, 300, m, d_in, d)
        eps = torch.randn((300, d), generator=gen, device="cuda")
        serve_cond.fused_conditional_infer(*args, eps)
    torch.cuda.synchronize()
    assert build.plan_launches() == {f"serve_cond:plan={p}": 1
                                     for _, p in cases}
    assert build.launches()["serve_cond"] == 3
    assert build.variant_launches() == {"serve_cond:sample": 3}
    # year's other two scoring layers and kin8nm's final one keep the chain
    assert [serve_cond.plan(*s) for s in ((30, 128, 30), (30, 128, 1),
                                          (8, 128, 1))] == ["chain"] * 3
    build.reset_launches()


@pytest.mark.parametrize("n,d_in,m,d,dense_lq", COND_EDGES)
def test_conditional_kernel_edges(gen, n, d_in, m, d, dense_lq):
    """K5 'sample' with the residuals against its plain version, and
    bitwise equal across two launches (at N = 10,240 on the d-split)."""
    args = _cond_inputs(gen, n, m, d_in, d, dense_lq)
    seed = torch.tensor(2 ** 33 + 5, dtype=torch.int64, device="cuda")
    got = conditional.fused_forward(*args, seed, residuals=True)
    with build.plain_versions():
        ref = conditional.fused_forward(*args, seed, residuals=True)
    for g, r in zip(got, ref):
        _rel_close(g, r, 1e-5)
    again = conditional.fused_forward(*args, seed, residuals=True)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_conditional_sample_is_deterministic_and_seeded(gen):
    args = _cond_inputs(gen, 4096, 128, 9, 8)
    seed = torch.tensor(7, dtype=torch.int64, device="cuda")
    a = conditional.fused_forward(*args, seed, residuals=False)[2]
    b = conditional.fused_forward(*args, seed, residuals=False)[2]
    c = conditional.fused_forward(*args, seed + 1, residuals=False)[2]
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_conditional_functions_launch_k5(gen):
    args = [t.requires_grad_() for t in _cond_inputs(gen, 512, 128, 9, 8)]
    build.reset_launches()
    mean, v = conditional.fused_conditional(*args)
    torch.autograd.grad(mean.sum() + v.sum(), args)
    seed = torch.tensor(1, dtype=torch.int64, device="cuda")
    s, mean, v = conditional.fused_conditional_sample(*args, seed)
    torch.autograd.grad(s.sum(), args)
    assert build.variant_launches() == {"conditional:fused": 1,
                                        "conditional:sample": 1}


def _artifact_model():
    """A small LGG (d_x=3, M=16) on the card with a random q(u)."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((256, 3)).astype(np.float32)
    Y = np.sin(X[:, :1]).astype(np.float32)
    config, params = build_model(0, BuildArgs(configuration="LGG",
                                              mode="IW", num_inducing=16),
                                 X, Y, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    for lp in params["layers"][1:]:
        lp["q_mu"] = 0.5 * torch.randn(lp["q_mu"].shape, generator=g,
                                       device="cuda")
        lp["q_sqrt"] = (0.1 * torch.tril(torch.randn(
            lp["q_sqrt"].shape, generator=g, device="cuda"))
            + 0.5 * torch.eye(16, device="cuda"))
    return config, params, X, Y


def test_cuda_artifact_equals_the_plain_live_path(gen, tmp_path):
    """A 'cuda' artifact, saved and loaded, equals make_scorer_fn on the
    plain versions with serve_pallas off, fed the artifact's noise, and
    launches no hand kernel."""
    from dgps_with_iwvi_torch import serving

    config, params, X, Y = _artifact_model()
    S, B = 10, 128
    prog = serving.export_scorer(params, config, batch_size=B, d_in=3,
                                 d_out=1, num_samples=S,
                                 platforms=("cuda",))
    path = str(tmp_path / "scorer.pt2")
    assert serving.save_scorer(path, prog, num_samples=S,
                               has_stats=False)["platforms"] == ["cuda"]
    art = serving.load_scorer(path, device="cuda")
    build.reset_launches()
    out = art.score(X, Y, seed=4, max_batch=B)
    assert sum(build.launches().values()) == 0
    fn = serving.make_scorer_fn(params, dataclasses.replace(
        config, serve_pallas=False), S, device="cuda")
    xs, ys = torch.from_numpy(X).cuda(), torch.from_numpy(Y).cuda()
    with torch.no_grad(), build.plain_versions():
        for i, start in enumerate(range(0, X.shape[0], B)):
            eps = serving.artifact_noise(4 + i, config, S, B, "cuda")
            m, v, ld = fn(xs[start:start + B], ys[start:start + B], 4 + i,
                          eps=eps)
            for got, want in ((out["mean"], m), (out["var"], v),
                              (out["log_density"], ld)):
                want = want.cpu().numpy()
                np.testing.assert_allclose(
                    got[start:start + B], want, rtol=0,
                    atol=1e-5 * np.abs(want).max())


def test_cuda_and_cpu_programs_of_one_artifact_agree(gen, tmp_path):
    """A ("cuda", "cpu") artifact holds one program per device in one
    file; the two score a table alike, to the gate chip_smoke.py holds
    every served route to against its plain versions: |a - b| <= 1e-3
    (1 + |b|). The two devices round the same classes but sum in other
    orders (cuBLAS against the CPU's f32 products of bf16-rounded
    operands, two Cholesky factorizations), and an f32 value that lands
    on the other side of a bf16 rounding boundary moves by one bf16 unit
    (2^-8) and carries through the inner layer's sample; the first
    reading on an H100 was 1.6e-5 of max|mean|."""
    from dgps_with_iwvi_torch import serving

    config, params, X, Y = _artifact_model()
    progs = serving.export_scorer(params, config, batch_size="b", d_in=3,
                                  d_out=1, num_samples=10,
                                  platforms=("cuda", "cpu"))
    path = str(tmp_path / "scorer.pt2")
    meta = serving.save_scorer(path, progs, num_samples=10, has_stats=False)
    assert meta["platforms"] == ["cuda", "cpu"]
    assert meta["polymorphic_batch"] and meta["batch_size"] == 0
    on_card = serving.load_scorer(path, device="cuda")
    on_cpu = serving.load_scorer(path, device="cpu")
    assert on_card.device.type == "cuda" and on_cpu.device.type == "cpu"
    a = on_card.score(X[:97], Y[:97], seed=2, max_batch=32)
    b = on_cpu.score(X[:97], Y[:97], seed=2, max_batch=32)
    for k in ("mean", "var", "log_density"):
        assert np.max(np.abs(a[k] - b[k]) / (1.0 + np.abs(b[k]))) <= 1e-3


# ---- CUDA graphs (utils/graphs.py): each replay against the eager call.
# A replay runs the captured kernels in the eager order on the same values,
# and every kernel on these paths is deterministic, so the gates are
# bitwise; the launch counts of a replayed run equal the eager run's.

def _counts():
    counts = {k: v for k, v in build.launches().items() if v}
    counts.update(build.variant_launches())
    return counts


def _flagship(**fields):
    """The flagship model (LGG, IW K=20, M=128, natgrad final) on data of
    kin8nm's shape, [7372, 8], on the card; a TrainConfig at B=512."""
    from dgps_with_iwvi_torch import training as train

    rng = np.random.default_rng(2)
    X = rng.standard_normal((7372, 8)).astype(np.float32)
    Y = (np.sin(X[:, :1]) + 0.1 * rng.standard_normal((7372, 1))).astype(
        np.float32)
    config, params = build_model(0, BuildArgs(
        configuration="LGG", mode="IW", num_inducing=128,
        num_iw_samples=20), X, Y, device="cuda")
    config = dataclasses.replace(config, **fields)
    tc = train.TrainConfig(natgrad="final", minibatch_size=512,
                           steps_per_call=10)
    return config, params, tc, torch.from_numpy(X).cuda(), \
        torch.from_numpy(Y).cuda()


def _state_leaves(state) -> list:
    from dgps_with_iwvi_torch.training import train

    opt = state.opt_state.state_dict()["state"]
    return (train._leaves(state.rest) + train._leaves(state.natvars)
            + [t for s in opt.values() for t in s.values()])


@pytest.mark.parametrize("case", ["flagship", "use_pallas", "gamma_warmup"])
def test_replayed_steps_equal_eager_steps(gen, case):
    """Two chunks of ten steps from one state and generator state: the
    graphed chunk (one real step, the capture, then replays) against
    make_trainer's eager chunk: losses, every state leaf, Adam's moments
    and the generator bitwise, the launch counts of each chunk equal."""
    from dgps_with_iwvi_torch.training import train

    config, params, tc, X, Y = _flagship(use_pallas=case == "use_pallas")
    if case == "gamma_warmup":
        tc = dataclasses.replace(tc, gamma=5e-2, gamma_warmup=15)
    init, step, chunk, _ = train.make_trainer(config, tc)
    s_e = init(params)
    s_g = init(params)
    assert s_g.opt_state.param_groups[0]["capturable"]
    g_e = torch.Generator(device="cuda").manual_seed(3)
    g_g = torch.Generator(device="cuda").manual_seed(3)
    graphed = train.graphed_chunk_fn(step, tc, s_g, X, Y, g_g)
    for _ in range(2):
        build.reset_launches()
        s_e, l_e = chunk(s_e, X, Y, g_e)
        eager = _counts()
        build.reset_launches()
        s_g, l_g = graphed(s_g, X, Y, g_g)
        assert _counts() == eager
        assert torch.equal(l_e, l_g)
    for a, b in zip(_state_leaves(s_e), _state_leaves(s_g), strict=True):
        assert torch.equal(a, b)
    assert torch.equal(g_e.get_state(), g_g.get_state())


# (build flags, TrainConfig fields): every single-device policy of fit
POLICIES = {
    "alternating": ({}, {"schedule": "alternating"}),
    "full_batch": ({}, {"minibatch_size": 2000}),
    "natgrad_all": ({}, {"natgrad": "all"}),
    "adam_only": ({}, {"natgrad": "none"}),
    "adam_only_use_pallas": ({"use_pallas": True}, {"natgrad": "none"}),
    "multiscale_priors": ({"feature": "multiscale", "priors": (
        ("kernel_variance", "gamma", 2.0, 3.0),
        ("noise_variance", "lognormal", -2.0, 1.0))}, {}),
    "no_white": ({"white": False}, {}),
    "q_diag": ({"q_diag": True}, {}),
    "multiclass_matern": ({"likelihood": "multiclass", "num_classes": 3,
                           "kernel_kind": "matern52+linear"}, {}),
    "student_t": ({"likelihood": "student_t"}, {}),
}


@pytest.mark.parametrize("policy", list(POLICIES))
def test_every_policy_replays_its_eager_steps(gen, policy):
    """A small LGG (d_x=4, M=64, K=8, B=256) under each policy: two
    chunks of five steps, the graphed chunk against the eager one from one
    state and generator state, the launch counts equal, losses, every
    state leaf and the generator bitwise. The graphed step reads its
    natvars in the layout the eager step reads them (``write_step``): in
    the initial natvars' layout natgrad's [1,64,64] x [1,64,1] products
    took another cuBLAS kernel and rounded otherwise."""
    from dgps_with_iwvi_torch.training import train

    flags, fields = POLICIES[policy]
    rng = np.random.default_rng(0)
    X = rng.standard_normal((2000, 4)).astype(np.float32)
    if flags.get("likelihood") == "multiclass":
        Y = ((X[:, :1] > 0).astype(np.float32) + (X[:, 1:2] > 0.5))
    else:
        Y = (np.sin(X[:, :1]) + 0.1 * rng.standard_normal((2000, 1))
             ).astype(np.float32)
    config, params = build_model(0, BuildArgs(
        configuration="LGG", mode="IW", num_inducing=64, num_iw_samples=8,
        **flags), X, Y, device="cuda")
    tc = train.TrainConfig(**{"natgrad": "final", "minibatch_size": 256,
                              "steps_per_call": 5, **fields})
    Xc, Yc = torch.from_numpy(X).cuda(), torch.from_numpy(Y).cuda()
    init, step, chunk, _ = train.make_trainer(config, tc)
    s_e, s_g = init(params), init(params)
    g_e = torch.Generator(device="cuda").manual_seed(3)
    g_g = torch.Generator(device="cuda").manual_seed(3)
    graphed = train.graphed_chunk_fn(step, tc, s_g, Xc, Yc, g_g)
    for _ in range(2):
        build.reset_launches()
        s_e, l_e = chunk(s_e, Xc, Yc, g_e)
        eager = _counts()
        build.reset_launches()
        s_g, l_g = graphed(s_g, Xc, Yc, g_g)
        assert _counts() == eager
        assert torch.equal(l_e, l_g)
    for a, b in zip(_state_leaves(s_e), _state_leaves(s_g), strict=True):
        assert torch.equal(a, b)
    assert torch.equal(g_e.get_state(), g_g.get_state())


def test_capture_survives_dead_graphs_in_cycles(gen):
    """A dead graph left in a reference cycle and freed by the collector
    inside a capture invalidates the capture (its teardown is "not
    permitted when stream is capturing"; seen in the quality gate's
    seventh run). Here the collector stays off until the captured call
    turns it on at every allocation: ``_capture``'s collection beforehand
    has left it no graph to free, and the capture replays."""
    import gc

    from dgps_with_iwvi_torch.utils import graphs

    x = torch.randn((256, 256), generator=gen, device="cuda")
    threshold, was_enabled = gc.get_threshold(), gc.isenabled()

    def fn():
        if torch.cuda.is_current_stream_capturing():
            gc.set_threshold(1)
            gc.enable()
            junk = [[i] for i in range(100)]  # collections at once
            del junk
        return x @ x + 1.0

    gc.disable()
    try:
        dead = [graphs.Graph(lambda: x @ x, device="cuda")]
        dead.append(dead)           # freed only by the cyclic collector
        del dead
        g = graphs.Graph(fn, device="cuda")
        first = g.first.clone()
        assert torch.equal(g.replay(), first)
    finally:
        gc.set_threshold(*threshold)
        (gc.enable if was_enabled else gc.disable)()


def test_capture_makes_no_host_sync(gen):
    """The warm-up step, the capture and the replays of the flagship step,
    and of a request on each serving route, under
    ``torch.cuda.set_sync_debug_mode("error")``: no operation waits for
    the card."""
    from dgps_with_iwvi_torch import serving
    from dgps_with_iwvi_torch.ops.precision import f32_reductions
    from dgps_with_iwvi_torch.training import train

    config, params, tc, X, Y = _flagship()
    init, step, _, _ = train.make_trainer(config, tc)
    state = init(params)
    g = torch.Generator(device="cuda").manual_seed(0)
    graphed = train.graphed_chunk_fn(step, tc, state, X, Y, g)
    fns = [serving.GraphedScore(serving.make_scorer_fn(
        params, dataclasses.replace(config, **fields), 100,
        device="cuda"), 8, 1, "cuda") for fields in (
        {"serve_pallas": False}, {}, {"use_pallas": True})]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, losses = graphed(state, X, Y, g)
        with torch.no_grad(), f32_reductions():
            for fn in fns:
                for seed in range(3):
                    fn(X[:1024], Y[:1024], seed)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(losses).all())


@pytest.mark.parametrize("route", ["k2", "default", "use_pallas"])
def test_replayed_request_equals_eager_request(gen, route):
    """Scorer.score (one graph per batch shape, replayed, a ragged last
    batch padded) against the same batches through make_scorer_fn's eager
    calls, seed + i per batch: every output bitwise, the launch counts
    equal."""
    from dgps_with_iwvi_torch import serving

    fields = {"k2": {"serve_pallas": False}, "default": {},
              "use_pallas": {"use_pallas": True}}[route]
    config, params, _, X, Y = _flagship(**fields)
    Xn, Yn = X[:3000].cpu().numpy(), Y[:3000].cpu().numpy()
    scorer = serving.Scorer(params, config, 100, device="cuda")
    eager = serving.make_scorer_fn(params, config, 100, device="cuda")
    for seed in (0, 11):
        build.reset_launches()
        got = scorer.score(Xn, Yn, seed=seed, max_batch=1024)
        graphed = _counts()
        build.reset_launches()
        want = serving.score_table(
            lambda i, xb, yb: eager(xb, yb, seed + i), Xn, Yn, 8, 1,
            serving.fixed_batches(3000, 1024), torch.device("cuda"))
        assert _counts() == graphed
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_resumed_graphed_fit_equals_straight_run(gen, tmp_path):
    """fit on the card (graphed) for 40 steps, checkpointed at step 20;
    a fit resumed from that checkpoint (its first step real, then its own
    capture) ends bitwise where the straight run ends."""
    from dgps_with_iwvi_torch.training import checkpoint, train

    config, params, tc, X, Y = _flagship()
    tc = dataclasses.replace(tc, iterations=40)
    gen_s = torch.Generator(device="cuda").manual_seed(7)

    def save(step, loss, state):
        if step == 20:
            checkpoint.save_checkpoint(str(tmp_path), step, state, gen_s)

    _, straight = train.fit(gen_s, config, params, X, Y, tc, callback=save)
    init = train.make_trainer(config, tc)[0]
    back = checkpoint.restore_checkpoint(
        str(tmp_path), 20, {"state": init(params),
                            "generator": torch.Generator(device="cuda")})
    assert back["state"].opt_state.param_groups[0]["capturable"]
    _, resumed = train.fit(back["generator"], config, params, X, Y, tc,
                           state=back["state"])
    assert resumed.step == straight.step == 40
    for a, b in zip(_state_leaves(straight), _state_leaves(resumed),
                    strict=True):
        assert torch.equal(a, b)
    assert torch.equal(gen_s.get_state(), back["generator"].get_state())


# ---- evaluation.evaluate: one graph replay per chunk (GraphedEval)

def _fresh_eval_cache(monkeypatch):
    from collections import OrderedDict

    from dgps_with_iwvi_torch.evaluation import metrics

    monkeypatch.setattr(metrics, "_programs", OrderedDict())
    return metrics


@pytest.mark.parametrize("route", ["default", "k2"])
def test_replayed_evaluation_equals_eager_evaluation(gen, monkeypatch,
                                                     route):
    """The flagship's test set of 7372 rows at S=100 in 4096-row chunks
    (one full chunk, then a ragged tail of 3276 rows): the warm-up chunk,
    the capture and the replay run under
    ``torch.cuda.set_sync_debug_mode("error")``, then every point's
    log-density and mean equal the eager chunks' bitwise, launches
    equal."""
    metrics = _fresh_eval_cache(monkeypatch)
    fields = {"default": {}, "k2": {"serve_pallas": False}}[route]
    config, params, _, X, Y = _flagship(**fields)
    bs, n = 4096, X.shape[0]
    build.reset_launches()
    want = metrics._points(params, config, X, Y, 5, 100, bs, None, False)
    eager = _counts()
    build.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            program = metrics.graphed_eval(params, config, 100, X, Y, bs)
            outs = []
            for start in range(0, n, bs):
                ld, mean = program(X[start:start + bs], Y[start:start + bs],
                                   5, start)
                keep = min(bs, n - start)
                outs.append(torch.cat([ld[:keep, None], mean[:keep]], 1))
            out = torch.cat(outs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert _counts() == eager
    out = out.cpu().numpy()
    np.testing.assert_array_equal(out[:, 0], want[0])
    np.testing.assert_array_equal(out[:, 1:], want[1])
    assert len(program.graphs.graphs()) == 1


def test_second_evaluation_with_new_params_replays(gen, monkeypatch):
    """evaluate twice with the same configuration and other parameter
    tensors (the suite's next run): the second call replays the graph of
    the first, makes no new one, and equals eager evaluation of the
    second parameters bitwise, metrics and points."""
    metrics = _fresh_eval_cache(monkeypatch)
    config, params, _, X, Y = _flagship()
    other = {"layers": [dict(lp) for lp in params["layers"]],
             "likelihood": dict(params["likelihood"])}
    other["layers"][2]["q_mu"] = params["layers"][2]["q_mu"] + 0.3
    kw = dict(y_std=np.array([2.0]), num_samples=100)
    first = metrics.evaluate(params, config, X, Y, 9, **kw)
    (program,) = metrics.eval_programs()
    (graph,) = program.graphs.graphs()
    build.reset_launches()
    got = metrics.evaluate(other, config, X, Y, 9, **kw)
    replayed = _counts()
    assert metrics.eval_programs() == [program]
    assert program.graphs.graphs() == [graph]
    assert replayed == {k: 2 * v for k, v in graph.launches.items()}
    want_points = metrics._points(other, config, X, Y, 9, 100, 4096, None,
                                  False)
    got_points = metrics._points(other, config, X, Y, 9, 100, 4096, None,
                                 True)
    for a, b in zip(got_points, want_points, strict=True):
        np.testing.assert_array_equal(a, b)
    want = metrics._metrics(*want_points, Y.cpu().numpy(), kw["y_std"],
                            "gaussian")
    assert got == want and got != first
