"""The kernel and likelihood families of the port against the JAX
reference, on the CPU in float64, and the models and harness built on
them.

Inputs come from numpy seeds. Kernels: ``K`` (on one set and across two)
and ``Kdiag`` of every leaf kind, two combinators, active-dim slices,
coregion and white, and their gradients with respect to every parameter
and both inputs, at rtol 1e-10: float64 runs every precision class
exactly on both sides, so only the order of sums differs. Likelihoods:
the three functions of every family and their gradients at rtol 1e-9
(the quadrature families sum 20 nodes and the QMC family 256 draws).
The gram's precision switches run in float32 against the exact gram, at
the bf16x3 and bf16 class limits of ``tests/test_torch_ops.py`` and
``tests/test_torch_kernels.py``. Models: ten trainer steps against the
reference's trainer with its draws injected, loss and every state leaf at
rtol 1e-8 (the limits of ``tests/test_torch_parity_configs.py``), and
``evaluate`` against the reference's for each likelihood of the CLI at
rtol 1e-9. The harness: ``dgp-train-torch --device cpu`` with the new
flags, and the serve CLI on a multiclass checkpoint.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgps_with_iwvi_tpu.evaluation import evaluate as jevaluate
from dgps_with_iwvi_tpu.models import BuildArgs as JBuildArgs
from dgps_with_iwvi_tpu.models import build_model as jbuild_model
from dgps_with_iwvi_tpu.models import layers as jlayers
from dgps_with_iwvi_tpu.ops import kernels as jkern
from dgps_with_iwvi_tpu.ops import likelihoods as jlik
from dgps_with_iwvi_tpu.training import TrainConfig as JTrainConfig
from dgps_with_iwvi_tpu.training import make_trainer as jmake_trainer
from dgps_with_iwvi_torch import params as tparams
from dgps_with_iwvi_torch.evaluation import Database, evaluate
from dgps_with_iwvi_torch.evaluation import metrics as tmetrics
from dgps_with_iwvi_torch.experiments import main, serve
from dgps_with_iwvi_torch.models import (BuildArgs, build_config,
                                         predict_y_and_log_density)
from dgps_with_iwvi_torch.ops import kernels as tkern
from dgps_with_iwvi_torch.ops import likelihoods as tlik
from dgps_with_iwvi_torch.training import TrainConfig, make_trainer

KERNEL_RTOL, LIK_RTOL = 1e-10, 1e-9


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, ref, rtol, atol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol,
                               atol=atol, err_msg=what)


def _leaves(tree):
    """The array leaves of a params tree, in the reference's order."""
    return jax.tree.leaves(tree)


# ---- kernels --------------------------------------------------------------

N, M, D = 7, 5, 4
KINDS = (list(jkern.LEAF_KINDS)
         + ["exponential", "rbf+linear", "rbf[0:2]*periodic[2:4]",
            "matern32[0,2]", "linear[1:4]+rq[0]",
            "coregion3x1", "rbf[0:3]*coregion3x1[3]"])


def _kernel_inputs(kind, seed=0):
    """X [N, D], X2 [M, D]; a coregion kind reads integer tasks in the
    last column (the whole input where the kind has no slice), with one
    value off the integers, which the index rounds."""
    rng = np.random.default_rng(seed)
    X, X2 = rng.standard_normal((N, D)), rng.standard_normal((M, D))
    if "coregion" in kind:
        X[:, -1] = rng.integers(0, 3, N)
        X2[:, -1] = rng.integers(0, 3, M)
        X[0, -1] = 1.3
        if "[" not in kind:
            X, X2 = X[:, -1:], X2[:, -1:]
    return X, X2


def _kernel_params(kind, d_in, seed=1):
    """The reference's initial parameters, each raw value moved off its
    default (the polynomial's degree stays the integer 3)."""
    rng = np.random.default_rng(seed)
    p = jax.device_get(jkern.kernel_params(kind, d_in, dtype=jnp.float64))

    def move(path, a):
        name = jax.tree_util.keystr(path)
        if "degree" in name:
            return np.asarray(a)
        return np.asarray(a) + 0.3 * rng.standard_normal(np.shape(a))

    return jax.tree_util.tree_map_with_path(move, p)


def _grams(kmod, params, X, X2, kind, same, G, Gd, *, torch_side):
    """(K, Kdiag, d<G, K> + <Gd, Kdiag> with respect to params, X, X2).

    The reference runs eagerly: its squared distances then round as the
    port's do, op for op. On one set the diagonal d2 is rounding noise,
    and Matern 1/2 is exp(-sqrt(d2)) there, whose value moves by the
    square root of the noise where a fused program rounds d2
    otherwise."""
    if torch_side:
        p = tparams.params_from_numpy(params, "cpu")
        leaves = [t for t in tkern.param_leaves(p) if t.is_floating_point()]
        for t in leaves:
            t.requires_grad_(True)
        x, x2 = _t(X).requires_grad_(True), _t(X2).requires_grad_(True)
        Kv = tkern.K(p, x, None if same else x2, kind=kind)
        Kd = tkern.Kdiag(p, x, kind=kind)
        loss = torch.sum(Kv * _t(G)) + torch.sum(Kd * _t(Gd))
        grads = torch.autograd.grad(loss, leaves + [x, x2],
                                    allow_unused=True)
        grads = [np.zeros(t.shape) if g is None else g.numpy()
                 for t, g in zip(leaves + [x, x2], grads)]
        return Kv.detach().numpy(), Kd.detach().numpy(), grads

    def f(params, x, x2):
        Kv = jkern.K(params, x, None if same else x2, kind=kind)
        Kd = jkern.Kdiag(params, x, kind=kind)
        return jnp.sum(Kv * G) + jnp.sum(Kd * Gd), (Kv, Kd)

    jp = jax.tree.map(jnp.asarray, params)
    (_, (Kv, Kd)), (gp, gx, gx2) = jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True)(jp, jnp.asarray(X),
                                            jnp.asarray(X2))
    return (np.asarray(Kv), np.asarray(Kd),
            [np.asarray(g) for g in _leaves(gp)] + [np.asarray(gx),
                                                     np.asarray(gx2)])


@pytest.mark.parametrize("same", [True, False], ids=["same_set", "cross"])
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_matches_reference(kind, same):
    X, X2 = _kernel_inputs(kind)
    params = _kernel_params(kind, X.shape[1])
    rng = np.random.default_rng(2)
    G = rng.standard_normal((N, N if same else M))
    Gd = rng.standard_normal(N)
    ref = _grams(jkern, params, X, X2, kind, same, G, Gd, torch_side=False)
    got = _grams(tkern, params, X, X2, kind, same, G, Gd, torch_side=True)
    scale = float(np.max(np.abs(ref[0])))
    _close(got[0], ref[0], KERNEL_RTOL, 1e-14 * scale, f"{kind} K")
    _close(got[1], ref[1], KERNEL_RTOL, 1e-14 * scale, f"{kind} Kdiag")
    assert len(got[2]) == len(ref[2])
    for i, (g, r) in enumerate(zip(got[2], ref[2])):
        _close(g, r, KERNEL_RTOL,
               1e-12 * max(float(np.max(np.abs(r), initial=0.0)), 1.0),
               f"{kind} gradient {i}")


def test_white_is_the_identity_on_one_set_only():
    """K(p, Z, Z) and K(p, Z) are var I; a copy of Z is another set unless
    same_set says otherwise, as in the reference."""
    X, _ = _kernel_inputs("white")
    params = _kernel_params("white", D)
    p = tparams.params_from_numpy(params, "cpu")
    jp = jax.tree.map(jnp.asarray, params)
    x, xj = _t(X), jnp.asarray(X)
    var = float(tkern.kernel_variance(p))
    assert torch.equal(tkern.K(p, x, x, kind="white"),
                       var * torch.eye(N, dtype=torch.float64))
    copy = x.clone()
    assert not torch.any(tkern.K(p, x, copy, kind="white"))
    _close(tkern.K(p, x, copy, kind="white", same_set=True),
           jkern.K(jp, xj, xj + 0.0, kind="white", same_set=True), 0)
    _close(tkern.K(p, x, copy, kind="white"),
           jkern.K(jp, xj, xj + 0.0, kind="white"), 0)


def test_kernels_broadcast_over_leading_axes():
    """A composite gram on X [2, N, D] against Z [M, D], as a layer's
    sample axes meet its inducing points."""
    kind = "matern52+linear"
    rng = np.random.default_rng(5)
    X, Z = rng.standard_normal((2, N, D)), rng.standard_normal((M, D))
    params = _kernel_params(kind, D)
    ref = jkern.K(jax.tree.map(jnp.asarray, params), jnp.asarray(Z),
                  jnp.asarray(X), kind=kind)
    got = tkern.K(tparams.params_from_numpy(params, "cpu"), _t(Z), _t(X),
                  kind=kind)
    assert got.shape == (2, M, N)
    _close(got, ref, KERNEL_RTOL)


def test_composite_params_carry_across():
    """params_from_numpy keeps the reference's {"terms": ((leaf, ...),
    ...)} tree, tuples included; kernel_params builds the same tree."""
    kind = "rbf[0:2]*periodic[2:4]+linear"
    ref = jax.device_get(jkern.kernel_params(kind, D, dtype=jnp.float64))
    got = tparams.params_from_numpy(ref, "cpu")
    built = tkern.kernel_params(kind, D, dtype=torch.float64, device="cpu")
    for tree in (got, built):
        assert isinstance(tree["terms"], tuple)
        assert all(isinstance(t, tuple) for t in tree["terms"])
        assert (jax.tree.structure(jax.tree.map(np.asarray, tree))
                == jax.tree.structure(ref))
        for a, b in zip(_leaves(jax.tree.map(np.asarray, tree)),
                        _leaves(ref)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["rbf", "matern52+linear", "polynomial",
                                  "coregion3x2", "arccosine2"])
def test_kernel_params_equal_the_reference(kind):
    ref = jax.device_get(jkern.kernel_params(kind, 1 if "coregion" in kind
                                             else D, dtype=jnp.float64))
    got = tkern.kernel_params(kind, 1 if "coregion" in kind else D,
                              dtype=torch.float64, device="cpu")
    for a, b in zip(_leaves(jax.tree.map(np.asarray, got)), _leaves(ref)):
        _close(a, b, 1e-12)


def test_parse_kind_and_split_token():
    assert tkern.parse_kind("rbf*periodic[3]+linear[0,2,5]") == (
        ("rbf", "periodic[3]"), ("linear[0,2,5]",))
    assert tkern.split_token("rbf[0:3]") == ("rbf", (0, 1, 2))
    assert tkern.split_token("linear[0,2,5]") == ("linear", (0, 2, 5))
    assert tkern.split_token("exponential") == ("matern12", None)
    assert tkern.split_token("coregion4x2[3]") == ("coregion4x2", (3,))
    assert tkern.coregion_shape("coregion4x2") == (4, 2)
    for kind in ("rbf", "rbf[0:2]*periodic[2]", "coregion3x1[0]+linear"):
        assert tkern.parse_kind(kind) == jkern.parse_kind(kind)


@pytest.mark.parametrize("kind", ["matern99", "rbf+laplace", "rbf[0:2",
                                  "rbf[2,2]", "linear[a:b]"])
def test_unknown_or_malformed_kind_raises(kind):
    with pytest.raises(ValueError):
        tkern.parse_kind(kind)
    with pytest.raises(ValueError):
        tkern.kernel_params(kind, D, device="cpu")


@pytest.mark.parametrize("kind", ["linear", "polynomial", "constant"])
def test_rank_deficient_gram_climbs_the_reference_ladder(kind):
    """A float32 Kuu of rank < M (linear: rank 2, polynomial of degree 3
    in 2 dims: rank 10, constant: rank 1, at M=64) factors at the jitter
    level the reference's cholesky_with_jitter picks, and the factors
    agree at float32's limit for the conditioning of that level. The
    rounding of the linear and polynomial grams' entries outweighs the
    first level's jitter, so they climb; the constant gram's equal
    entries round alike and factor at the first."""
    from dgps_with_iwvi_tpu.ops import linalg as jlinalg
    from dgps_with_iwvi_torch.ops import linalg as tlinalg

    Z = 3.0 * np.random.default_rng(8).standard_normal((64, 2))
    Z = Z.astype(np.float32)
    p = tkern.kernel_params(kind, 2, device="cpu")
    Kt = tkern.K(p, torch.from_numpy(Z), kind=kind).detach()
    Kj = jnp.asarray(Kt.numpy())
    Lt = tlinalg.cholesky_with_jitter(Kt, 1e-6, 6)
    Lj = np.asarray(jlinalg.cholesky_with_jitter(Kj, 1e-6, 6))

    def level(L):
        L = np.asarray(L, np.float64)
        jit = np.mean(np.diag(L @ L.T) - np.asarray(Kt, np.float64).diagonal())
        return int(np.round(np.log10(jit / 1e-6)))

    assert np.all(np.isfinite(Lt.numpy())) and np.all(np.isfinite(Lj))
    assert level(Lt) == level(Lj)
    assert (level(Lt) > 0) == (kind != "constant")
    _close(Lt, Lj, 0, 1e-2 * float(np.max(np.abs(Lj))))


# ---- the gram's precision switches ----------------------------------------

def _f32_gram(kind, monkeypatch, fwd="highest", relax=False):
    """(K, gradient wrt X) in float32 under the switches."""
    monkeypatch.setattr(tkern, "GRAM_FWD_PRECISION", fwd)
    monkeypatch.setattr(tkern, "GRAM_BWD_RELAX", relax)
    rng = np.random.default_rng(7)
    X = rng.standard_normal((64, 8)).astype(np.float32)
    Z = rng.standard_normal((16, 8)).astype(np.float32)
    G = rng.standard_normal((16, 64)).astype(np.float32)
    p = tkern.kernel_params(kind, 8, device="cpu")
    x = torch.from_numpy(X).requires_grad_(True)
    Kv = tkern.K(p, torch.from_numpy(Z), x, kind=kind)
    (gx,) = torch.autograd.grad(torch.sum(Kv * torch.from_numpy(G)), x)
    return Kv.detach().double().numpy(), gx.double().numpy()


@pytest.mark.parametrize("kind", ["rbf", "matern52+linear"])
def test_gram_fwd_precision_high_is_the_bf16x3_class(kind, monkeypatch):
    K_hi, _ = _f32_gram(kind, monkeypatch, "highest")
    K_h3, _ = _f32_gram(kind, monkeypatch, "high")
    scale = float(np.max(np.abs(K_hi)))
    err = float(np.max(np.abs(K_h3 - K_hi)))
    # the dropped lo*lo term shows, within the bf16x3 class
    assert 0 < err < 1e-4 * scale


def test_gram_bwd_relax_is_the_bf16_class(monkeypatch):
    K0, g0 = _f32_gram("matern52+linear", monkeypatch)
    K1, g1 = _f32_gram("matern52+linear", monkeypatch, relax=True)
    np.testing.assert_array_equal(K1, K0)       # the forward is untouched
    err = float(np.max(np.abs(g1 - g0)))
    assert 0 < err < 2e-2 * float(np.max(np.abs(g0)))


def test_gram_fwd_precision_default_raises(monkeypatch):
    monkeypatch.setattr(tkern, "GRAM_FWD_PRECISION", "default")
    with pytest.raises(ValueError, match="GRAM_FWD_PRECISION"):
        tkern.K(tkern.rbf_params(2, device="cpu"), torch.zeros(3, 2))


@pytest.fixture(params=[True, False, "auto"], ids=["on", "off", "auto"])
def kuf_residual(request, monkeypatch):
    """GRAM_KUF_RESIDUAL set to the same value on both sides for the test
    (monkeypatch puts both modules' own values back)."""
    monkeypatch.setattr(jkern, "GRAM_KUF_RESIDUAL", request.param)
    monkeypatch.setattr(tkern, "GRAM_KUF_RESIDUAL", request.param)
    return request.param


# (Z, F) shapes and dtype: a 4 MB-plus float32 gram (the flagship's
# 20 x 512 x 128), a small one, and the large one in float64
KRES_SHAPES = {"large": ((128, 4), (20, 512, 4), "float32"),
               "small": ((128, 4), (20, 64, 4), "float32"),
               "large_f64": ((128, 4), (20, 512, 4), "float64")}


@pytest.mark.parametrize("case", list(KRES_SHAPES))
def test_gram_kuf_residual_decides_as_the_reference(kuf_residual, case):
    zs, fs, dtype = KRES_SHAPES[case]
    got = tkern._use_kuf_residual(
        torch.empty(zs, dtype=getattr(torch, dtype), device="meta"),
        torch.empty(fs, dtype=getattr(torch, dtype), device="meta"))
    want = jkern._use_kuf_residual(jax.ShapeDtypeStruct(zs, dtype),
                                   jax.ShapeDtypeStruct(fs, dtype))
    assert got is bool(want)
    if kuf_residual != "auto":
        assert got is kuf_residual


@pytest.mark.parametrize("same", [True, False], ids=["same_set", "cross"])
def test_rbf_gram_under_the_kuf_residual_switch_matches_reference(
        kuf_residual, same):
    """Values and gradients of the RBF gram in float64 with the switch set
    on both sides (True: every RBF gram through the output residual)."""
    X, X2 = _kernel_inputs("rbf")
    X2[0] = X[1]                    # a clamped distance: K == var there
    params = _kernel_params("rbf", X.shape[1])
    rng = np.random.default_rng(3)
    G = rng.standard_normal((N, N if same else M))
    Gd = rng.standard_normal(N)
    ref = _grams(jkern, params, X, X2, "rbf", same, G, Gd, torch_side=False)
    got = _grams(tkern, params, X, X2, "rbf", same, G, Gd, torch_side=True)
    scale = float(np.max(np.abs(ref[0])))
    _close(got[0], ref[0], KERNEL_RTOL, 1e-14 * scale, "K")
    assert len(got[2]) == len(ref[2])
    for i, (g, r) in enumerate(zip(got[2], ref[2])):
        _close(g, r, KERNEL_RTOL,
               1e-12 * max(float(np.max(np.abs(r), initial=0.0)), 1.0),
               f"gradient {i}")


def test_gram_kuf_residual_refuses_a_string_the_reference_reads_as_on(
        monkeypatch):
    """The reference reads any value but "auto" by its truth: its string
    "off" turns the residual on, even for a small gram. The port takes
    True, False and "auto" only."""
    monkeypatch.setattr(jkern, "GRAM_KUF_RESIDUAL", "off")
    monkeypatch.setattr(tkern, "GRAM_KUF_RESIDUAL", "off")
    zs, fs, dtype = KRES_SHAPES["small"]
    assert jkern._use_kuf_residual(jax.ShapeDtypeStruct(zs, dtype),
                                   jax.ShapeDtypeStruct(fs, dtype)) is True
    with pytest.raises(ValueError, match="GRAM_KUF_RESIDUAL"):
        tkern.K(tkern.rbf_params(2, device="cpu"), torch.zeros(3, 2),
                torch.zeros(4, 2))


# ---- likelihoods ----------------------------------------------------------

S_LIK, N_LIK = 3, 6

LIK_CASES = {
    # kind: (init kwargs, output width D, y maker)
    "gaussian": ({}, 2, lambda r: r.standard_normal((N_LIK, 2))),
    "switched_gaussian": ({"num_tasks": 3}, 2, lambda r: np.concatenate(
        [r.standard_normal((N_LIK, 2)),
         r.integers(0, 3, (N_LIK, 1)).astype(float)], 1)),
    "bernoulli": ({}, 1, lambda r: r.integers(0, 2, (N_LIK, 1)).astype(
        float)),
    "student_t": ({"scale": 0.7, "df": 4.0}, 2,
                  lambda r: r.standard_normal((N_LIK, 2))),
    "poisson": ({}, 1, lambda r: r.poisson(2.0, (N_LIK, 1)).astype(float)),
    "exponential": ({}, 1, lambda r: r.exponential(1.5, (N_LIK, 1))),
    "gamma": ({"shape": 1.7}, 1, lambda r: r.gamma(2.0, 1.0, (N_LIK, 1))),
    "beta": ({"scale": 2.5}, 1, lambda r: r.uniform(0.05, 0.95, (N_LIK, 1))),
    "ordinal": ({"num_classes": 4}, 1,
                lambda r: r.integers(0, 4, (N_LIK, 1)).astype(float)),
    "multiclass": ({}, 3, lambda r: r.integers(0, 3, (N_LIK, 1)).astype(
        float)),
    "softmax": ({}, 3, lambda r: r.integers(0, 3, (N_LIK, 1)).astype(
        float)),
}


def _lik_inputs(kind):
    kw, d, make_y = LIK_CASES[kind]
    rng = np.random.default_rng(sorted(LIK_CASES).index(kind))
    mean = rng.standard_normal((S_LIK, N_LIK, d))
    var = rng.uniform(0.05, 1.5, (S_LIK, N_LIK, d))
    var[0, 0, 0] = 0.0  # a final-layer variance can be exactly 0
    y = make_y(rng)
    params = jax.device_get(jlik.init_params(kind, 0.1, dtype=jnp.float64,
                                             **kw))
    params = {k: (np.asarray(v) + 0.2 * rng.standard_normal(np.shape(v))
                  if k.startswith("raw_") else np.asarray(v))
              for k, v in params.items()}
    return params, mean, var, y


def _lik_values(params, mean, var, y, kind, *, torch_side):
    """Each function's values, and the gradients of a random weighting of
    all of them with respect to the parameters, mean and var."""
    def fns(lik, p, m, v, yy):
        ve = lik.dispatch_variational_expectations(p, m, v, yy, kind=kind)
        pm, pv = lik.dispatch_predict_mean_and_var(p, m, v, kind=kind, y=yy)
        pd = lik.dispatch_predict_density(p, m, v, yy, kind=kind)
        return ve, pm, pv, pd

    rng = np.random.default_rng(11)
    if torch_side:
        p = {k: _t(v).requires_grad_(k.startswith("raw_"))
             for k, v in params.items()}
        m, v = _t(mean).requires_grad_(True), _t(var).requires_grad_(True)
        outs = fns(tlik, p, m, v, _t(y))
        loss = sum(torch.sum(o * _t(rng.standard_normal(o.shape)))
                   for o in outs)
        wrt = [p[k] for k in sorted(p) if k.startswith("raw_")] + [m, v]
        grads = [g.numpy() for g in torch.autograd.grad(loss, wrt)]
        return [o.detach().numpy() for o in outs], grads

    def f(p, m, v):
        outs = fns(jlik, p, m, v, jnp.asarray(y))
        return sum(jnp.sum(o * rng.standard_normal(o.shape))
                   for o in outs), outs

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    (_, outs), (gp, gm, gv) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True))(jp, jnp.asarray(mean),
                                             jnp.asarray(var))
    grads = [np.asarray(gp[k]) for k in sorted(gp)
             if k.startswith("raw_")] + [np.asarray(gm), np.asarray(gv)]
    return [np.asarray(o) for o in outs], grads


@pytest.mark.parametrize("kind", sorted(LIK_CASES))
def test_likelihood_matches_reference(kind):
    params, mean, var, y = _lik_inputs(kind)
    ref_out, ref_g = _lik_values(params, mean, var, y, kind,
                                 torch_side=False)
    got_out, got_g = _lik_values(params, mean, var, y, kind,
                                 torch_side=True)
    names = ("variational_expectations", "predict_mean", "predict_var",
             "predict_density")
    for name, g, r in zip(names, got_out, ref_out):
        assert g.shape == r.shape, name
        _close(g, r, LIK_RTOL, 1e-12, f"{kind} {name}")
    for i, (g, r) in enumerate(zip(got_g, ref_g)):
        _close(g, r, LIK_RTOL, 1e-12 * max(float(np.max(np.abs(r))), 1.0),
               f"{kind} gradient {i}")


def test_likelihood_kinds_and_init_equal_the_reference():
    assert tlik.LIKELIHOOD_KINDS == jlik.LIKELIHOOD_KINDS
    for kind, (kw, _, _) in LIK_CASES.items():
        ref = jax.device_get(jlik.init_params(kind, 0.07, dtype=jnp.float64,
                                              **kw))
        got = tlik.init_params(kind, 0.07, dtype=torch.float64,
                               device="cpu", **kw)
        assert set(got) == set(ref), kind
        for k in ref:
            _close(got[k], ref[k], 1e-12, 0, f"{kind} {k}")


def test_unknown_likelihood_raises():
    with pytest.raises(ValueError, match="unknown likelihood"):
        tlik.init_params("laplace", device="cpu")
    p = tlik.gaussian_params(device="cpu")
    with pytest.raises(ValueError, match="unknown likelihood"):
        tlik.dispatch_predict_density(p, torch.zeros(2, 1),
                                      torch.ones(2, 1), torch.zeros(2, 1),
                                      kind="laplace")
    with pytest.raises(ValueError, match="task-tagged"):
        tlik.dispatch_predict_mean_and_var(
            tlik.init_params("switched_gaussian", num_tasks=2,
                             device="cpu"),
            torch.zeros(2, 1), torch.ones(2, 1), kind="switched_gaussian")


# ---- models: ten trainer steps --------------------------------------------

N_TR, B_TR, D_X, M_TR, K_TR = 64, 32, 3, 12, 4
STEPS, STEP_RTOL, STEP_ATOL = 10, 1e-8, 1e-12

TRAIN_CASES = [
    # (id, build arguments, Y maker)
    ("matern52-G", dict(configuration="G", kernel_kind="matern52"),
     "regression"),
    ("rbf+linear-LGG", dict(configuration="LGG", kernel_kind="rbf+linear"),
     "regression"),
    ("coregion-switched_gaussian-G",
     dict(configuration="G", kernel_kind="rbf[0:2]*coregion2x1[2]",
          likelihood="switched_gaussian"), "tasks"),
    ("bernoulli-LGG", dict(configuration="LGG", likelihood="bernoulli"),
     "binary"),
    ("multiclass-LGG", dict(configuration="LGG", likelihood="multiclass",
                            num_classes=3), "classes"),
    ("softmax-GG", dict(configuration="GG", likelihood="softmax",
                        num_classes=3), "classes"),
    ("ordinal-LGG", dict(configuration="LGG", likelihood="ordinal",
                         num_classes=3), "classes"),
    ("student_t-LGG", dict(configuration="LGG", likelihood="student_t"),
     "regression"),
]


def _train_data(labels, n=N_TR, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, D_X))
    f = np.sin(X[:, :1]) + 0.5 * X[:, 1:2]
    if labels == "regression":
        Y = f + 0.1 * rng.standard_normal((n, 1))
    elif labels == "binary":
        Y = (f > 0).astype(float)
    elif labels == "classes":
        Y = np.digitize(f, np.quantile(f, [1 / 3, 2 / 3])).astype(float)
    else:  # tasks: the task index in X's last column and Y's
        X[:, 2] = rng.integers(0, 2, n)
        Y = np.concatenate([f + 0.3 * X[:, 2:3], X[:, 2:3]], 1)
    return X, Y, rng


def _randomize_q(params, rng):
    """A random q(u) on every GP layer: at the builder's q(u) the whitened
    terms cancel."""
    for lp in params["layers"]:
        if "q_mu" not in lp:
            continue
        lp["q_mu"] = 0.5 * rng.standard_normal(lp["q_mu"].shape)
        lp["q_sqrt"] = (np.tril(0.2 * rng.standard_normal(
            lp["q_sqrt"].shape)) + 0.5 * np.eye(lp["q_sqrt"].shape[-1]))


def _draws(key, jconfig, batch):
    """(idx, eps) of the reference's joint step_fn for one key: the
    minibatch rows and, per layer, the noise of a latent layer [K, B,
    d_w] or an inner GP layer [K, B, d_out]; none for the final layer."""
    kb, _, ke, _ = jax.random.split(key, 4)
    idx = np.asarray(jax.random.randint(kb, (batch,), 0, N_TR))
    eps = []
    for i, cfg in enumerate(jconfig.layers):
        if isinstance(cfg, jlayers.GPLayerConfig) and cfg.final:
            eps.append(None)
            continue
        width = (cfg.d_w if isinstance(cfg, jlayers.LVLayerConfig)
                 else cfg.d_out)
        e = jax.random.normal(jax.random.fold_in(ke, i), (K_TR, batch, width),
                              jnp.float64)
        eps.append(_t(np.array(e)))
    return _t(idx), eps


@pytest.mark.parametrize("build_kw,labels", [c[1:] for c in TRAIN_CASES],
                         ids=[c[0] for c in TRAIN_CASES])
def test_ten_steps_track_reference(build_kw, labels):
    X, Y, rng = _train_data(labels)
    args = dict(mode="IW", num_inducing=M_TR, num_iw_samples=K_TR,
                **build_kw)
    jconfig, jparams = jbuild_model(jax.random.PRNGKey(0),
                                    JBuildArgs(**args), jnp.asarray(X),
                                    jnp.asarray(Y))
    jparams = jax.device_get(jparams)
    _randomize_q(jparams, rng)
    tc_kw = dict(lr=5e-3, gamma=1e-2, natgrad="final", minibatch_size=B_TR)
    jinit, jstep, _, _ = jmake_trainer(jconfig, JTrainConfig(**tc_kw))
    jstep = jax.jit(jstep)
    jstate = jinit(jax.tree.map(jnp.asarray, jparams))
    config = build_config(BuildArgs(**args), D_X, Y.shape[1], N_TR)
    assert config.layers[-1].d_out == jconfig.layers[-1].d_out
    init, step, _, _ = make_trainer(config, TrainConfig(**tc_kw))
    state = init(tparams.params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a, np.float64), jparams), "cpu"))
    Xj, Yj, Xt, Yt = jnp.asarray(X), jnp.asarray(Y), _t(X), _t(Y)
    for s in range(STEPS):
        key = jax.random.fold_in(jax.random.PRNGKey(11), s)
        jstate, jloss = jstep(jstate, Xj, Yj, key)
        idx, eps = _draws(key, jconfig, B_TR)
        state, loss = step(state, Xt, Yt, idx=idx, eps=eps)
    _close(loss.detach().numpy(), jloss, STEP_RTOL)
    ours = tparams.state_to_numpy(state)
    ref = jax.device_get({"rest": jstate.rest, "natvars": jstate.natvars})
    assert jax.tree.structure(ours) == jax.tree.structure(ref)
    for a, b in zip(_leaves(ours), _leaves(ref)):
        _close(a, b, STEP_RTOL, STEP_ATOL)


# ---- evaluation -----------------------------------------------------------

N_EV, N_TEST, S_EV, BS_EV = 48, 37, 4, 16
CLI_LIKELIHOODS = ["gaussian", "bernoulli", "student_t", "multiclass",
                   "softmax", "ordinal"]
_LABELS = {"gaussian": "regression", "student_t": "regression",
           "bernoulli": "binary", "multiclass": "classes",
           "softmax": "classes", "ordinal": "classes"}


@pytest.mark.parametrize("likelihood", CLI_LIKELIHOODS)
def test_evaluate_matches_reference(likelihood, monkeypatch):
    """``evaluate`` against the reference's with its draws injected chunk
    by chunk (``fold_in(key, start)``, then ``fold_in(k, i)`` for layer
    i), on an LGG model with a random q(u)."""
    X, Y, rng = _train_data(_LABELS[likelihood], N_EV + N_TEST, seed=3)
    args = dict(configuration="LGG", mode="IW", num_inducing=M_TR,
                num_iw_samples=K_TR, likelihood=likelihood)
    jconfig, jparams = jbuild_model(jax.random.PRNGKey(0),
                                    JBuildArgs(**args),
                                    jnp.asarray(X[:N_EV]),
                                    jnp.asarray(Y[:N_EV]))
    jparams = jax.device_get(jparams)
    _randomize_q(jparams, rng)
    key, y_std = jax.random.PRNGKey(5), np.array([1.7])
    Xt, Yt = X[N_EV:], Y[N_EV:]
    ref = jevaluate(jparams, jconfig, jnp.asarray(Xt), jnp.asarray(Yt), key,
                    y_std=y_std, num_samples=S_EV, batch_size=BS_EV,
                    likelihood=likelihood)
    config = build_config(BuildArgs(**args), D_X, 1, N_EV)

    def injected(params, config, xb, yb, seed, start, num_samples):
        k = jax.random.fold_in(key, start)
        eps = [None if (isinstance(c, jlayers.GPLayerConfig) and c.final)
               else _t(np.array(jax.random.normal(
                   jax.random.fold_in(k, i),
                   (S_EV, BS_EV, c.d_w if isinstance(c, jlayers.LVLayerConfig)
                    else c.d_out), jnp.float64)))
               for i, c in enumerate(jconfig.layers)]
        (mean, _), ld = predict_y_and_log_density(params, config, xb, yb,
                                                  None, num_samples, eps=eps)
        return ld, mean

    monkeypatch.setattr(tmetrics, "_batch_eval", injected)
    got = evaluate(tparams.params_from_numpy(jparams, "cpu"), config, Xt, Yt,
                   0, y_std=y_std, num_samples=S_EV, batch_size=BS_EV,
                   likelihood=likelihood, device="cpu")
    assert set(got) == set(ref)
    for k in ref:
        _close(got[k], ref[k], LIK_RTOL, 0, k)


def test_evaluate_reports_each_task_of_a_switched_gaussian():
    """Per-task log-likelihoods and target-width errors, no
    un-normalization, as the reference's evaluate."""
    X, Y, rng = _train_data("tasks", N_EV + N_TEST, seed=4)
    args = dict(configuration="G", mode="VI", num_inducing=M_TR,
                kernel_kind="rbf[0:2]*coregion2x1[2]",
                likelihood="switched_gaussian")
    config = build_config(BuildArgs(**args), D_X, 2, N_EV)
    _, jparams = jbuild_model(jax.random.PRNGKey(0), JBuildArgs(**args),
                              jnp.asarray(X[:N_EV]), jnp.asarray(Y[:N_EV]))
    params = tparams.params_from_numpy(jax.device_get(jparams), "cpu")
    got = evaluate(params, config, X[N_EV:], Y[N_EV:], 0, y_std=np.ones(2),
                   num_samples=S_EV, likelihood="switched_gaussian",
                   device="cpu")
    assert {"test_loglik_task_0", "test_loglik_task_1"} <= set(got)
    assert got["test_loglik"] == got["test_loglik_normalized"]
    tasks = Y[N_EV:, 1]
    pooled = (got["test_loglik_task_0"] * np.sum(tasks == 0)
              + got["test_loglik_task_1"] * np.sum(tasks == 1)) / N_TEST
    _close(pooled, got["test_loglik"], 1e-12)


@pytest.mark.parametrize("kind", ["matern52+linear", "linear",
                                  "rq[0:2]*periodic[2]"])
def test_hyperparameter_scalars_of_any_kernel_equal_the_reference(kind):
    """The monitor reads a composite kernel's first leaf and a leaf's own
    keys, as the reference's does (a linear leaf has no lengthscales)."""
    from dgps_with_iwvi_tpu.training.monitor import \
        hyperparameter_scalars as jscalars
    from dgps_with_iwvi_torch.training.monitor import hyperparameter_scalars

    X, Y, rng = _train_data("regression")
    args = dict(configuration="LGG", mode="IW", num_inducing=8,
                kernel_kind=kind)
    jconfig, jparams = jbuild_model(jax.random.PRNGKey(0),
                                    JBuildArgs(**args), jnp.asarray(X),
                                    jnp.asarray(Y))
    jparams = jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(np.shape(a)),
        jax.device_get(jparams))
    ref = jscalars(jparams, jconfig, JTrainConfig(natgrad="final"), 3)
    got = hyperparameter_scalars(
        tparams.params_from_numpy(jparams, "cpu"),
        build_config(BuildArgs(**args), D_X, 1, N_TR),
        TrainConfig(natgrad="final"), 3)
    assert set(got) == set(ref)
    for k in ref:
        _close(got[k], ref[k], 1e-12, 0, k)


# ---- the harness ----------------------------------------------------------

SMALL = ["--dataset", "energy", "--max_n", "300", "--configuration", "LGG",
         "--mode", "IW", "--M", "16", "--K", "5", "--steps_per_call", "20",
         "--iterations", "40", "--device", "cpu", "--print_every", "0",
         "--num_predict_samples", "10"]


@pytest.mark.parametrize("flags,accuracy", [
    (["--likelihood", "bernoulli"], True),
    (["--likelihood", "multiclass", "--num_classes", "3"], True),
    (["--kernel", "matern32"], False),
], ids=["bernoulli", "multiclass", "matern32"])
def test_cli_runs_the_families(tmp_path, flags, accuracy):
    """dgp-train-torch --device cpu with the new flags: a finite row,
    written to the database as returned, with accuracy for the labels."""
    args = main.parse_args(SMALL + flags + ["--results_db",
                                            str(tmp_path / "r.db")])
    row = main.run(args)
    assert np.isfinite(row["test_loglik"]) and np.isfinite(row["elbo"])
    assert ("test_accuracy" in row) == accuracy
    if accuracy:
        assert 0.0 <= row["test_accuracy"] <= 1.0
    (got,) = Database(str(tmp_path / "r.db")).read("energy")
    for k in Database._COLS:
        if k in row and k != "synthetic_data":
            v = row[k]
            assert (got[k] == v or (isinstance(v, float) and np.isnan(v)
                                    and got[k] is None)), k
    assert tkern.GRAM_FWD_PRECISION == "highest"


def test_cli_sets_the_gram_switches_for_the_run(tmp_path, monkeypatch):
    seen = []
    real = main.fit

    def fit(*a, **kw):
        seen.append((tkern.GRAM_FWD_PRECISION, tkern.GRAM_BWD_RELAX))
        return real(*a, **kw)

    monkeypatch.setattr(main, "fit", fit)
    main.run(main.parse_args(SMALL + [
        "--iterations", "20", "--gram_fwd_precision", "high",
        "--gram_bwd_relax", "--results_db", str(tmp_path / "r.db")]))
    assert seen == [("high", True)]
    assert (tkern.GRAM_FWD_PRECISION, tkern.GRAM_BWD_RELAX) == ("highest",
                                                                False)


def test_build_args_round_trip_the_family_fields(tmp_path):
    from dgps_with_iwvi_torch.models import load_build_args, save_build_args

    build = BuildArgs(configuration="LGG",
                      kernel_kind="rbf[0:2]*coregion4x1[2]",
                      likelihood="switched_gaussian", num_classes=5,
                      num_tasks=4)
    save_build_args(str(tmp_path), build, natgrad="final")
    assert load_build_args(str(tmp_path)) == build


def test_multiclass_scorer_and_artifact(tmp_path):
    """A multiclass model reads one label column and returns [n, 3] class
    probabilities: the live ``Scorer`` and a saved, reloaded artifact (the
    quadrature's constants traced into the program) equal the live
    function fed the artifact's draws, at f32 rounding."""
    import dataclasses

    from dgps_with_iwvi_torch.models import build_model
    from dgps_with_iwvi_torch.ops.hopper import build as hbuild
    from dgps_with_iwvi_torch.serving import (Scorer, artifact_noise,
                                              export_scorer, load_scorer,
                                              make_scorer_fn, save_scorer)

    X, Y, _ = _train_data("classes")
    X, Y = X.astype(np.float32), Y.astype(np.float32)
    config, params = build_model(0, BuildArgs(
        configuration="LGG", mode="IW", num_inducing=8, num_iw_samples=3,
        likelihood="multiclass", num_classes=3), X, Y, device="cpu")
    S, B = 5, 16
    live = Scorer(params, config, S, device="cpu").score(X[:20], Y[:20])
    assert live["mean"].shape == (20, 3) and live["log_density"].shape == (
        20,)
    np.testing.assert_allclose(live["mean"].sum(1), 1.0, atol=1e-3)
    path = str(tmp_path / "scorer.pt2")
    meta = save_scorer(path, export_scorer(params, config, batch_size=B,
                                           d_in=D_X, d_out=1, num_samples=S),
                       num_samples=S, has_stats=False)
    assert (meta["d_out"], meta["d_mean"]) == (1, 3)
    art = load_scorer(path, device="cpu")
    got = art.score(X[:B], Y[:B], seed=4)
    fn = make_scorer_fn(params, dataclasses.replace(config,
                                                    serve_pallas=False),
                        S, device="cpu")
    with torch.no_grad(), hbuild.plain_versions():
        want = fn(torch.from_numpy(X[:B]), torch.from_numpy(Y[:B]), 4,
                  eps=artifact_noise(4, config, S, B, "cpu"))
    for k, w in zip(("mean", "var", "log_density"), want):
        w = w.numpy()
        assert got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k], w, rtol=1e-6,
                                   atol=1e-6 * np.abs(w).max(), err_msg=k)


def test_serve_cli_restores_a_multiclass_checkpoint(tmp_path):
    """The serve CLI rebuilds a multiclass model from build_args.json,
    reads the labels through the class loader and writes [n, 3] class
    probabilities; the test split's mean log-density is the harness's
    test loglik (the same chunk, seed and float32 model)."""
    ck = str(tmp_path / "ck")
    whole = SMALL[:1] + ["yacht"] + SMALL[4:]   # no --max_n: serve reads all
    row = main.run(main.parse_args(
        whole + ["--likelihood", "multiclass", "--num_classes", "3",
                 "--ckpt_dir", ck, "--ckpt_every", "40", "--results_db",
                 str(tmp_path / "r.db")]))
    out = str(tmp_path / "pred.npz")
    res = serve.run(serve.parse_args(
        ["--dataset", "yacht", "--ckpt_dir", ck, "--output", out,
         "--device", "cpu", "--num_predict_samples", "10",
         "--batch_size", "4096"]))
    with np.load(out) as z:
        mean, var, ld = z["mean"], z["var"], z["log_density"]
    n = res["n"]
    assert mean.shape == (n, 3) and var.shape == (n, 3) and ld.shape == (n,)
    np.testing.assert_allclose(mean.sum(1), 1.0, atol=1e-3)
    assert abs(float(np.mean(ld.astype(np.float64)))
               - row["test_loglik"]) <= 1e-6 * max(1.0,
                                                   abs(row["test_loglik"]))
