"""The second half of the port's breadth against the JAX reference, on the
CPU: multiscale features, the non-whitened and full-covariance
conditionals and KLs, hyperparameter priors, the sampling predictives and
the observation draws, and the models, trainer and CLIs built on them.

Inputs come from numpy seeds; float64 runs every precision class exactly
on both sides, so only the order of sums differs. Features at rtol 1e-10
(values and gradients), KLs, conditionals and predictives at 1e-9 with
gradients, priors at 1e-12, ten trainer steps at 1e-8 (the limits of
``tests/test_torch_parity_configs.py``). The reference's draws are
injected: the predictives take its normals per layer, its final draw and,
where its observation draw is a normal or a uniform, that draw. The other
observation families draw from a ``torch.Generator``; their sample mean
and variance over 2e5 draws are held within 5 standard errors of the
family's analytic moments.
"""

import dataclasses
import json
import math

import numpy as np
import pytest
import scipy.stats
import torch

import jax
import jax.numpy as jnp

from dgps_with_iwvi_tpu.models import BuildArgs as JBuildArgs
from dgps_with_iwvi_tpu.models import build_model as jbuild_model
from dgps_with_iwvi_tpu.models import dgp as jdgp
from dgps_with_iwvi_tpu.models import layers as jlayers
from dgps_with_iwvi_tpu.models.builder import \
    parse_prior_flag as jparse_prior_flag
from dgps_with_iwvi_tpu.ops import conditionals as jcond
from dgps_with_iwvi_tpu.ops import features as jfeat
from dgps_with_iwvi_tpu.ops import kernels as jkern
from dgps_with_iwvi_tpu.ops import kl as jkl
from dgps_with_iwvi_tpu.ops import likelihoods as jlik
from dgps_with_iwvi_tpu.ops import priors as jpriors
from dgps_with_iwvi_tpu.training import TrainConfig as JTrainConfig
from dgps_with_iwvi_tpu.training import make_trainer as jmake_trainer
from dgps_with_iwvi_torch import params as tparams
from dgps_with_iwvi_torch.experiments import main, serve
from dgps_with_iwvi_torch.models import (BuildArgs, LatentVarMode,
                                         build_config, build_model,
                                         load_build_args, parse_prior_flag,
                                         predict_f, predict_f_full_cov,
                                         predict_f_samples, predict_y_samples,
                                         save_build_args)
from dgps_with_iwvi_torch.models import dgp as tdgp
from dgps_with_iwvi_torch.ops import conditionals as tcond
from dgps_with_iwvi_torch.ops import features as tfeat
from dgps_with_iwvi_torch.ops import kernels as tkern
from dgps_with_iwvi_torch.ops import kl as tkl
from dgps_with_iwvi_torch.ops import likelihoods as tlik
from dgps_with_iwvi_torch.ops import priors as tpriors
from dgps_with_iwvi_torch.training import TrainConfig, make_trainer

FEAT_RTOL, RTOL, PRIOR_RTOL = 1e-10, 1e-9, 1e-12
STEPS, STEP_RTOL, STEP_ATOL = 10, 1e-8, 1e-12


def _t(a, requires_grad=False):
    return torch.tensor(np.asarray(a, np.float64),
                        requires_grad=requires_grad)


def _close(got, ref, rtol, atol=0.0, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol,
                               atol=atol, err_msg=what)


def _grads_match(t_fn, j_fn, inputs, rtol, seed=0):
    """Values and the gradients of <out, G> with respect to every input,
    G a numpy-seeded cotangent per output, port against reference."""
    j_out = jax.jit(j_fn)(*[jnp.asarray(x) for x in inputs])
    j_out = j_out if isinstance(j_out, tuple) else (j_out,)
    rng = np.random.default_rng(seed)
    Gs = [rng.standard_normal(np.shape(o)) for o in j_out]

    def j_loss(*xs):
        out = j_fn(*xs)
        out = out if isinstance(out, tuple) else (out,)
        return sum(jnp.sum(o * G) for o, G in zip(out, Gs))

    j_grads = jax.jit(jax.grad(j_loss, argnums=tuple(range(len(inputs)))))(
        *[jnp.asarray(x) for x in inputs])
    xs = [_t(x, True) for x in inputs]
    t_out = t_fn(*xs)
    t_out = t_out if isinstance(t_out, tuple) else (t_out,)
    for k, (a, b) in enumerate(zip(t_out, j_out)):
        _close(a, b, rtol, what=f"output {k}")
    loss = sum(torch.sum(o * _t(G)) for o, G in zip(t_out, Gs))
    t_grads = torch.autograd.grad(loss, xs, allow_unused=True)
    for k, (a, b) in enumerate(zip(t_grads, j_grads)):
        scale = float(np.max(np.abs(np.asarray(b))))
        _close(a if a is not None else np.zeros(np.shape(b)), b, rtol,
               atol=1e-14 * max(scale, 1.0), what=f"gradient {k}")


# ---- multiscale features --------------------------------------------------

M_F, N_F, D_F = 6, 9, 3


def _feature_inputs(lead=()):
    rng = np.random.default_rng(3)
    return (rng.normal(0.2, 0.3, D_F),            # raw lengthscales
            np.asarray(rng.normal(0.1, 0.2)),     # raw variance
            rng.standard_normal((M_F, D_F)),      # Z
            rng.normal(-1.0, 0.5, (M_F, D_F)),    # raw scales
            rng.standard_normal(lead + (N_F, D_F)))


def _kp(mod, raw_ls, raw_var):
    return {"raw_lengthscales": raw_ls, "raw_variance": raw_var}


@pytest.mark.parametrize("lead", [(), (2,)], ids=["X_2d", "X_batched"])
def test_multiscale_matches_reference(lead):
    """Kuu and Kuf, and their gradients with respect to the kernel, Z,
    the scales and X, in float64."""
    inputs = _feature_inputs(lead)
    _grads_match(
        lambda ls, v, Z, s, X: tfeat.multiscale_Kuu(_kp(tfeat, ls, v), Z, s),
        lambda ls, v, Z, s, X: jfeat.multiscale_Kuu(_kp(jfeat, ls, v), Z, s),
        inputs, FEAT_RTOL)
    _grads_match(
        lambda ls, v, Z, s, X: tfeat.multiscale_Kuf(_kp(tfeat, ls, v), Z, s,
                                                    X),
        lambda ls, v, Z, s, X: jfeat.multiscale_Kuf(_kp(jfeat, ls, v), Z, s,
                                                    X),
        inputs, FEAT_RTOL)


def test_multiscale_init_and_kinds_equal_the_reference():
    assert tfeat.FEATURE_KINDS == jfeat.FEATURE_KINDS
    _close(tfeat.multiscale_scales_init(M_F, D_F, 0.3, dtype=torch.float64,
                                        device="cpu"),
           jfeat.multiscale_scales_init(M_F, D_F, 0.3, dtype=jnp.float64),
           1e-15)


def _f32_multiscale(monkeypatch, fwd, relax):
    """(Kuf, gradient wrt X, exact Kuf, exact gradient) in float32 under
    the gram switches; exact = the same function in float64."""
    ls, v, Z, s, X = _feature_inputs()
    X = np.random.default_rng(5).standard_normal((64, D_F))
    G = np.random.default_rng(6).standard_normal((M_F, 64))
    out = []
    for dtype, f, r in ((torch.float32, fwd, relax),
                        (torch.float64, "highest", False)):
        monkeypatch.setattr(tkern, "GRAM_FWD_PRECISION", f)
        monkeypatch.setattr(tkern, "GRAM_BWD_RELAX", r)
        x = torch.tensor(X, dtype=dtype, requires_grad=True)
        K = tfeat.multiscale_Kuf(
            _kp(tfeat, torch.tensor(ls, dtype=dtype),
                torch.tensor(v, dtype=dtype)), torch.tensor(Z, dtype=dtype),
            torch.tensor(s, dtype=dtype), x)
        (g,) = torch.autograd.grad(torch.sum(K * torch.tensor(G, dtype=dtype)),
                                   x)
        out += [K.detach().double().numpy(), g.double().numpy()]
    return out


@pytest.mark.parametrize("fwd,relax,k_tol,g_tol", [
    ("highest", False, 1e-6, 1e-5),
    ("high", False, 1e-4, 1e-3),
    ("highest", True, 1e-6, 2e-2),
], ids=["highest", "high", "highest-bwd_relax"])
def test_multiscale_in_float32_under_the_gram_switches(monkeypatch, fwd,
                                                       relax, k_tol, g_tol):
    """In float32 the two products take the gram's classes: f32 within f32
    rounding of the exact Kuf, 'high' within the bf16x3 class, and
    GRAM_BWD_RELAX moves the gradient only, within the bf16 class."""
    K, g, K64, g64 = _f32_multiscale(monkeypatch, fwd, relax)
    k_err = float(np.max(np.abs(K - K64)))
    g_err = float(np.max(np.abs(g - g64)))
    assert k_err < k_tol * float(np.max(np.abs(K64)))
    assert g_err < g_tol * float(np.max(np.abs(g64)))
    if relax:   # the bf16 backward shows; the forward does not
        assert g_err > 1e-5 * float(np.max(np.abs(g64)))


def test_multiscale_refuses_another_kernel():
    kp = tkern.kernel_params("matern32", 2, device="cpu")
    with pytest.raises(ValueError, match="RBF kernel only"):
        tcond.conditional(torch.zeros(3, 2), torch.zeros(4, 2), kp,
                          torch.zeros(4, 1), torch.eye(4)[None],
                          kernel_kind="matern32",
                          feature_raw_scales=torch.zeros(4, 2))
    from dgps_with_iwvi_torch.models import layers as tlayers
    cfg = tlayers.GPLayerConfig(2, 1, 4, kernel_kind="matern32",
                                feature="multiscale")
    with pytest.raises(ValueError, match="RBF kernel only"):
        tlayers.gp_layer_init(torch.Generator(), cfg, device="cpu")


# ---- KLs ------------------------------------------------------------------

M_K = 5


def _spd(rng, m, d=None, scale=0.3):
    R = scale * rng.standard_normal(((d,) if d else ()) + (m, m))
    return R @ np.swapaxes(R, -1, -2) + np.eye(m)


@pytest.mark.parametrize("D", [1, 3])
def test_gauss_kl_matches_reference(D):
    rng = np.random.default_rng(D)
    q_mu = rng.standard_normal((M_K, D))
    q_sqrt = np.tril(0.3 * rng.standard_normal((D, M_K, M_K))) + np.eye(M_K)
    Lm = np.linalg.cholesky(_spd(rng, M_K))
    _grads_match(tkl.gauss_kl, jkl.gauss_kl, (q_mu, q_sqrt, Lm), RTOL)


@pytest.mark.parametrize("D", [1, 3])
def test_gauss_kl_cov_matches_reference(D):
    """The covariance form with the carried log-determinant and inverse:
    its value, and the gradients to q_mu, S (through the carried inverse)
    and Lm; it equals the root form at S = L L^T."""
    rng = np.random.default_rng(10 + D)
    q_mu = rng.standard_normal((M_K, D))
    L = np.tril(0.3 * rng.standard_normal((D, M_K, M_K))) + np.eye(M_K)
    S = L @ np.swapaxes(L, -1, -2)
    logdet = np.linalg.slogdet(S)[1]
    Sinv = np.linalg.inv(S)
    Lm = np.linalg.cholesky(_spd(rng, M_K))

    def t_fn(m, s, lm):
        return tkl.gauss_kl_cov(m, s, _t(logdet), _t(Sinv), lm)

    def j_fn(m, s, lm):
        return jkl.gauss_kl_cov(m, s, jnp.asarray(logdet), jnp.asarray(Sinv),
                                lm)

    _grads_match(t_fn, j_fn, (q_mu, S, Lm), RTOL)
    _close(t_fn(_t(q_mu), _t(S), _t(Lm)),
           jkl.gauss_kl(jnp.asarray(q_mu), jnp.asarray(L), jnp.asarray(Lm)),
           RTOL)


# ---- conditionals ---------------------------------------------------------

M_C, N_C, D_OUT = 6, 8, 2
Q_FORMS = ["root", "q_diag", "cov", "cov_diag"]


def _cond_inputs(seed=0, lead=()):
    rng = np.random.default_rng(seed)
    Z = rng.standard_normal((M_C, 2))
    X = rng.standard_normal(lead + (N_C, 2))
    kp = jkern.rbf_params(2, lengthscales=0.8, dtype=jnp.float64)
    Kuu = np.asarray(jkern.K(kp, jnp.asarray(Z), jnp.asarray(Z)))
    Kuf = np.asarray(jkern.K(kp, jnp.asarray(Z), jnp.asarray(X)))
    Kff = np.asarray(jkern.K(kp, jnp.asarray(X), jnp.asarray(X)))
    Lm = np.linalg.cholesky(Kuu + 1e-6 * np.eye(M_C))
    q_mu = rng.standard_normal((M_C, D_OUT))
    root = np.tril(0.3 * rng.standard_normal((D_OUT, M_C, M_C))) \
        + 0.5 * np.eye(M_C)
    scales = 0.5 + 0.2 * rng.random((M_C, D_OUT))
    return dict(Kuf=Kuf, Lm=Lm, Kff=Kff, Kff_diag=np.diagonal(Kff, 0, -2, -1)
                .copy(), q_mu=q_mu, root=root, scales=scales)


def _q_args(form, root, scales):
    """(q_sqrt, q_S) of a q form: root [D, M, M], q_diag scales [M, D],
    covariance [D, M, M] or diagonal variances [M, D]."""
    if form == "root":
        return root, None
    if form == "q_diag":
        return scales, None
    if form == "cov":
        return None, root @ np.swapaxes(root, -1, -2)
    return None, np.square(scales)


@pytest.mark.parametrize("form", Q_FORMS)
@pytest.mark.parametrize("white", [True, False], ids=["white", "non_white"])
def test_base_conditional_matches_reference(white, form):
    """The marginal conditional, whitened or not, in each q form: mean,
    variance and their gradients to Kuf, Lm, Kff_diag, q_mu and q."""
    c = _cond_inputs(1, lead=(3,))
    q_sqrt, q_S = _q_args(form, c["root"], c["scales"])
    q = q_sqrt if q_S is None else q_S

    def call(mod, Kuf, Lm, Kd, q_mu, qq):
        # a root is lower-triangular where the layers pass it (their tril)
        if form == "root":
            qq = qq.tril() if isinstance(qq, torch.Tensor) else jnp.tril(qq)
        qs, qS = (qq, None) if q_S is None else (None, qq)
        return tuple(mod.base_conditional(
            Kuf, Lm, Kd, q_mu, qs, white=white, var_precision="default",
            q_S=qS, solve_precision="high"))

    inputs = (c["Kuf"], c["Lm"], c["Kff_diag"], c["q_mu"], q)
    _grads_match(lambda *a: call(tcond, *a), lambda *a: call(jcond, *a),
                 inputs, RTOL)


@pytest.mark.parametrize("form", ["root", "q_diag"])
@pytest.mark.parametrize("white", [True, False], ids=["white", "non_white"])
def test_fullcov_conditional_matches_reference(white, form):
    """The full-covariance conditional: mean [N, D] and cov [D, N, N] and
    their gradients; its diagonal is the marginal conditional's variance."""
    c = _cond_inputs(2)
    q = c["root"] if form == "root" else c["scales"]

    def call(mod, Kuf, Lm, Kff, q_mu, qq):
        return tuple(mod.base_conditional_whitened_fullcov(
            Kuf, Lm, Kff, q_mu, qq, white=white))

    inputs = (c["Kuf"], c["Lm"], c["Kff"], c["q_mu"], q)
    _grads_match(lambda *a: call(tcond, *a), lambda *a: call(jcond, *a),
                 inputs, RTOL)
    mean, cov = call(tcond, *[_t(x) for x in inputs])
    marg = tcond.base_conditional(
        *[_t(c[k]) for k in ("Kuf", "Lm", "Kff_diag", "q_mu")], _t(q),
        white=white)
    _close(mean, marg.mean.numpy(), 1e-12)
    _close(torch.diagonal(cov, dim1=-2, dim2=-1).T, marg.var.numpy(), 1e-10)


def test_fullcov_conditional_broadcasts_over_samples():
    """Kuf [S, M, N] and Kff [S, N, N] give S full covariances at once,
    each the unbatched one (the reference maps over S)."""
    c = _cond_inputs(3, lead=(2,))
    args = [_t(c[k]) for k in ("Kuf", "Lm", "Kff", "q_mu", "root")]
    mean, cov = tcond.base_conditional_whitened_fullcov(*args, white=False)
    assert cov.shape == (2, D_OUT, N_C, N_C)
    for s in range(2):
        m1, c1 = tcond.base_conditional_whitened_fullcov(
            args[0][s], args[1], args[2][s], args[3], args[4], white=False)
        _close(mean[s], m1.numpy(), 1e-13)
        _close(cov[s], c1.numpy(), 1e-13)


@pytest.mark.parametrize("white", [True, False], ids=["white", "non_white"])
def test_conditional_with_multiscale_features_matches_reference(white):
    """conditional(feature_raw_scales=): the window-integral Kuu and Kuf,
    the plain Kff, factored here (no Lm given)."""
    ls, v, Z, s, X = _feature_inputs((2,))
    rng = np.random.default_rng(8)
    q_mu = rng.standard_normal((M_F, D_OUT))
    root = np.tril(0.3 * rng.standard_normal((D_OUT, M_F, M_F))) \
        + 0.5 * np.eye(M_F)

    def call(mod, ls, v, Z, s, X, q_mu, root):
        root = root.tril() if mod is tcond else jnp.tril(root)
        return tuple(mod.conditional(
            X, Z, _kp(mod, ls, v), q_mu, root, white=white,
            var_precision="default", solve_precision="high",
            feature_raw_scales=s))

    _grads_match(lambda *a: call(tcond, *a), lambda *a: call(jcond, *a),
                 (ls, v, Z, s, X, q_mu, root), RTOL)


# ---- priors ---------------------------------------------------------------

@pytest.mark.parametrize("kind,a,b", [("gaussian", 0.3, 1.5),
                                      ("gamma", 2.0, 3.0),
                                      ("lognormal", -2.0, 1.0)])
def test_log_density_matches_reference(kind, a, b):
    raw = np.random.default_rng(4).normal(0.0, 1.0, 5)
    _grads_match(lambda r: tpriors._log_density(r, kind, a, b),
                 lambda r: jpriors._log_density(r, kind, a, b), (raw,),
                 PRIOR_RTOL)


def _composite_model():
    """(reference params, port params) of an LGG model with a composite
    kernel and a student-t likelihood."""
    X, Y, _ = _train_data()
    jconfig, jparams = jbuild_model(
        jax.random.PRNGKey(0), JBuildArgs(configuration="LGG", mode="IW",
                                          num_inducing=6, num_iw_samples=2,
                                          kernel_kind="rbf+linear",
                                          likelihood="student_t",
                                          feature="points"),
        jnp.asarray(X), jnp.asarray(Y))
    jparams = jax.device_get(jparams)
    return jparams, tparams.params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a, np.float64), jparams), "cpu")


def test_prior_paths_equal_the_reference():
    """The '/'-joined paths of a composite kernel's terms and the
    likelihood's leaves, in the reference's order."""
    jparams, params = _composite_model()
    ref = [jpriors._path_str(p) for p, _ in
           jax.tree_util.tree_flatten_with_path(jparams)[0]]
    ours = [tpriors._path_str(p) for p, _ in
            tpriors._flatten_with_path(params)]
    assert ours == ref
    assert "layers/1/kernel/terms/0/0/raw_variance" in ours
    assert "likelihood/raw_scale" in ours


@pytest.mark.parametrize("priors", [
    (("kernel/terms/0/0/raw_lengthscales", "gamma", 2.0, 1.0),),
    (("raw_variance", "lognormal", 0.0, 1.0), ("raw_scale", "gamma", 2.0,
                                               3.0)),
    (("layers/3/kernel/terms/1/0/raw_variance", "gaussian", 0.5, 2.0),
     ("df", "gaussian", 3.0, 1.0)),
], ids=["one_term", "every_variance_and_the_scale", "deep_path_and_df"])
def test_log_prior_matches_reference(priors):
    jparams, params = _composite_model()
    leaves = [t for _, t in tpriors._flatten_with_path(params)]
    for t in leaves:
        t.requires_grad_(True)
    lp = tpriors.log_prior(params, priors)
    jlp, jg = jax.value_and_grad(jpriors.log_prior)(
        jax.tree.map(jnp.asarray, jparams), priors)
    _close(lp, jlp, PRIOR_RTOL)
    grads = torch.autograd.grad(lp, leaves, allow_unused=True)
    for g, r in zip(grads, jax.tree.leaves(jg)):
        _close(np.zeros(np.shape(r)) if g is None else g, r, PRIOR_RTOL,
               atol=1e-300)


def test_unmatched_prior_and_unknown_kind_raise():
    _, params = _composite_model()
    with pytest.raises(ValueError, match="no parameter path matched"):
        tpriors.log_prior(params, (("kernel/raw_period", "gamma", 1.0,
                                    1.0),))
    with pytest.raises(ValueError, match="unknown prior kind"):
        tpriors.log_prior(params, (("raw_scale", "cauchy", 0.0, 1.0),))
    assert tpriors.log_prior(params, ()) == 0.0


@pytest.mark.parametrize("spec", [
    "kernel_variance=gamma(2,3)", "lengthscales = lognormal(0, 0.5)",
    "noise_variance=lognormal(-2,1)", "layers/2/Z=gaussian(0,1)"])
def test_parse_prior_flag_matches_reference(spec):
    assert parse_prior_flag(spec) == jparse_prior_flag(spec)


# ---- models ---------------------------------------------------------------

N_TR, B_TR, D_X, M_TR, K_TR = 64, 32, 3, 8, 4


def _train_data(labels="regression", n=N_TR, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, D_X))
    f = np.sin(X[:, :1]) + 0.5 * X[:, 1:2]
    if labels == "binary":
        Y = (f > 0).astype(float)
    elif labels == "classes":
        Y = np.digitize(f, np.quantile(f, [1 / 3, 2 / 3])).astype(float)
    else:
        Y = f + 0.1 * rng.standard_normal((n, 1))
    return X, Y, rng


def _randomize(params, rng):
    """A random q(u) on every GP layer, and multiscale windows away from
    their initial width."""
    for lp in params["layers"]:
        if "q_mu" not in lp:
            continue
        lp["q_mu"] = 0.5 * rng.standard_normal(lp["q_mu"].shape)
        q = lp["q_sqrt"]
        if q.ndim == 3:
            lp["q_sqrt"] = (np.tril(0.2 * rng.standard_normal(q.shape))
                            + 0.5 * np.eye(q.shape[-1]))
        else:
            lp["q_sqrt"] = 0.5 + 0.1 * rng.standard_normal(q.shape)
        if "raw_Z_scales" in lp:
            lp["raw_Z_scales"] = lp["raw_Z_scales"] + 0.3 * \
                rng.standard_normal(lp["raw_Z_scales"].shape)


def _model(labels="regression", **build_kw):
    """(jconfig, jparams as numpy, config, params) of one model built by
    the reference's builder, with a random q(u)."""
    X, Y, rng = _train_data(labels)
    args = dict(mode="IW", num_inducing=M_TR, num_iw_samples=K_TR,
                **build_kw)
    jconfig, jparams = jbuild_model(jax.random.PRNGKey(0),
                                    JBuildArgs(**args), jnp.asarray(X),
                                    jnp.asarray(Y))
    jparams = jax.device_get(jparams)
    _randomize(jparams, rng)
    config = build_config(BuildArgs(**args), D_X, Y.shape[1], N_TR)
    params = tparams.params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a, np.float64), jparams), "cpu")
    return jconfig, jparams, config, params, X, Y


def _layer_noise(key, jconfig, S, B):
    """The reference's per-layer normals of a propagate keyed by `key`:
    a latent layer's [S, B, d_w], an inner GP layer's [S, B, d_out]."""
    eps = []
    for i, cfg in enumerate(jconfig.layers):
        if isinstance(cfg, jlayers.GPLayerConfig) and cfg.final:
            eps.append(None)
            continue
        width = (cfg.d_w if isinstance(cfg, jlayers.LVLayerConfig)
                 else cfg.d_out)
        eps.append(_t(jax.random.normal(jax.random.fold_in(key, i),
                                        (S, B, width), jnp.float64)))
    return eps


S_P, B_P = 3, 10


@pytest.mark.parametrize("build_kw,mode", [
    (dict(configuration="LGG"), "posterior"),
    (dict(configuration="LGG", amortized=False), "posterior_rows"),
    (dict(configuration="LGG", feature="multiscale", white=False), "prior"),
], ids=["amortized_posterior", "non_amortized_posterior",
        "multiscale_non_white_prior"])
def test_predict_f_matches_reference(build_kw, mode):
    """predict_f with Y (an amortized encoder) or data_idx (per-point
    latents) in POSTERIOR mode, and a multiscale non-whitened model."""
    jconfig, jparams, config, params, X, Y = _model(**build_kw)
    key = jax.random.PRNGKey(5)
    rows = np.arange(3, 3 + B_P)
    kw = {} if mode == "prior" else {"lv_mode": LatentVarMode.POSTERIOR}
    jkw = dict(kw, Y=jnp.asarray(Y[rows]))
    tkw = dict(kw, Y=_t(Y[rows]))
    if mode == "posterior_rows":
        jkw["data_idx"] = jnp.asarray(rows)
        tkw["data_idx"] = torch.from_numpy(rows)
    jm, jv = jdgp.predict_f(jax.tree.map(jnp.asarray, jparams), jconfig,
                            jnp.asarray(X[rows]), key, S_P, **jkw)
    m, v = predict_f(params, config, _t(X[rows]), None, S_P,
                     eps=_layer_noise(key, jconfig, S_P, B_P), **tkw)
    _close(m, jm, RTOL)
    _close(v, jv, RTOL)


@pytest.mark.parametrize("build_kw", [
    dict(configuration="LGG"),
    dict(configuration="LGG", feature="multiscale", white=False),
    dict(configuration="GG", q_diag=True, mean_function="linear"),
], ids=["LGG", "LGG_multiscale_non_white", "GG_q_diag_linear_mean"])
def test_predict_f_full_cov_matches_reference(build_kw):
    """The final layer's full covariance over S paths, and its diagonal
    equal to predict_f's variance on the same noise."""
    jconfig, jparams, config, params, X, Y = _model(**build_kw)
    key = jax.random.PRNGKey(6)
    jm, jc = jdgp.predict_f_full_cov(jax.tree.map(jnp.asarray, jparams),
                                     jconfig, jnp.asarray(X[:B_P]), key, S_P)
    eps = _layer_noise(key, jconfig, S_P, B_P)
    m, c = predict_f_full_cov(params, config, _t(X[:B_P]), None, S_P,
                              eps=eps)
    assert c.shape == (S_P, config.layers[-1].d_out, B_P, B_P)
    _close(m, jm, RTOL)
    _close(c, jc, RTOL, atol=1e-14)
    _, v = predict_f(params, config, _t(X[:B_P]), None, S_P, eps=eps)
    _close(torch.diagonal(c, dim1=-2, dim2=-1).transpose(-1, -2), v.numpy(),
           1e-9)


def test_predict_f_samples_matches_reference():
    jconfig, jparams, config, params, X, Y = _model(configuration="LGG",
                                                    feature="multiscale")
    key = jax.random.PRNGKey(7)
    kp, ke = jax.random.split(key)
    jf = jdgp.predict_f_samples(jax.tree.map(jnp.asarray, jparams), jconfig,
                                jnp.asarray(X[:B_P]), key, S_P)
    f = predict_f_samples(
        params, config, _t(X[:B_P]), None, S_P,
        eps=_layer_noise(kp, jconfig, S_P, B_P),
        sample_eps=_t(jax.random.normal(ke, (S_P, B_P, 1), jnp.float64)))
    _close(f, jf, RTOL)


def _obs_noise(kind, key, shape):
    """The reference's observation draw of `kind` under `key`, for the
    families whose draw is a normal or a uniform."""
    if kind in ("gaussian", "ordinal"):
        return _t(jax.random.normal(key, shape, jnp.float64))
    if kind == "bernoulli":
        return _t(jax.random.uniform(key, shape, jnp.float64))
    kr, ku, _ = jax.random.split(key, 3)
    C = shape[-1]
    return (_t(jax.random.uniform(kr, shape[:-1], jnp.float64)),
            torch.from_numpy(np.array(jax.random.randint(
                ku, shape[:-1], 1, C))))


@pytest.mark.parametrize("kind,labels,extra", [
    ("gaussian", "regression", {}),
    ("bernoulli", "binary", {}),
    ("ordinal", "classes", {"num_classes": 3}),
    ("multiclass", "classes", {"num_classes": 3}),
])
def test_predict_y_samples_matches_reference(kind, labels, extra):
    jconfig, jparams, config, params, X, Y = _model(
        labels, configuration="LGG", likelihood=kind, white=False, **extra)
    key = jax.random.PRNGKey(8)
    kf, ky = jax.random.split(key)
    kp, ke = jax.random.split(kf)
    jy = jdgp.predict_y_samples(jax.tree.map(jnp.asarray, jparams), jconfig,
                                jnp.asarray(X[:B_P]), key, S_P)
    d = config.layers[-1].d_out
    y = predict_y_samples(
        params, config, _t(X[:B_P]), None, S_P,
        eps=_layer_noise(kp, jconfig, S_P, B_P),
        sample_eps=_t(jax.random.normal(ke, (S_P, B_P, d), jnp.float64)),
        obs_noise=_obs_noise(kind, ky, (S_P, B_P, d)))
    _close(y, jy, RTOL)


# ---- observation draws ----------------------------------------------------

F_OBS = 0.3
F_CLASSES = (0.2, -0.5, 1.0)


@pytest.mark.parametrize("kind", ["gaussian", "bernoulli", "ordinal",
                                  "multiclass"])
def test_sample_observations_take_the_reference_draws(kind):
    """With the reference's normal or uniform injected, the draws equal
    its dispatch_sample_observations bit for bit."""
    rng = np.random.default_rng(9)
    d = 3 if kind == "multiclass" else 1
    fs = rng.standard_normal((4, 50, d))
    jp = jax.device_get(jlik.init_params(kind, 0.2, dtype=jnp.float64))
    key = jax.random.PRNGKey(2)
    ref = jlik.dispatch_sample_observations(jax.tree.map(jnp.asarray, jp),
                                            key, jnp.asarray(fs), kind=kind)
    got = tlik.dispatch_sample_observations(
        tparams.params_from_numpy(jp, "cpu"), _t(fs), kind=kind,
        noise=_obs_noise(kind, key, fs.shape))
    _close(got, ref, 0.0)


def _analytic_moments(kind, p):
    """(mean, variance) of one observation at f = F_OBS (F_CLASSES for the
    class families), from the family's parameters p (numpy)."""
    f = F_OBS
    sp = lambda r: 1e-6 + np.logaddexp(r, 0.0)   # noqa: E731, the positive map
    if kind == "gaussian":
        return f, sp(p["raw_noise_variance"])
    if kind == "bernoulli":
        q = scipy.stats.norm.cdf(f)
        return q, q * (1 - q)
    if kind == "student_t":
        s, df = sp(p["raw_scale"]), p["df"]
        return f, s * s * df / (df - 2.0)
    if kind == "poisson":
        return math.exp(f), math.exp(f)
    if kind == "exponential":
        return math.exp(f), math.exp(2 * f)
    if kind == "gamma":
        k = sp(p["raw_shape"])
        return k * math.exp(f), k * math.exp(2 * f)
    if kind == "beta":
        s, mu = sp(p["raw_scale"]), 1.0 / (1.0 + math.exp(-f))
        return mu, mu * (1 - mu) / (s + 1.0)
    if kind == "ordinal":
        cdf = scipy.stats.norm.cdf(np.asarray(p["bin_edges"]) - f)
        probs = np.diff(np.concatenate([[0.0], cdf, [1.0]]))
    else:
        C = len(F_CLASSES)
        if kind == "softmax":
            probs = np.exp(F_CLASSES) / np.sum(np.exp(F_CLASSES))
        else:
            probs = np.full(C, tlik.ROBUSTMAX_EPS / (C - 1))
            probs[int(np.argmax(F_CLASSES))] = 1 - tlik.ROBUSTMAX_EPS
    k = np.arange(len(probs))
    mean = float(np.sum(k * probs))
    return mean, float(np.sum(np.square(k - mean) * probs))


SAMPLE_KINDS = ["gaussian", "bernoulli", "student_t", "poisson",
                "exponential", "gamma", "beta", "ordinal", "multiclass",
                "softmax"]


def moments_within(draws: np.ndarray, mean: float, var: float,
                   z: float = 5.0) -> tuple:
    """(mean's and variance's distances from the analytic values in
    standard errors of the sample: sqrt(var / n) and sqrt((m4 - s^4) / n)
    with the sample's fourth central moment m4)."""
    x = draws.astype(np.float64).ravel()
    n = x.size
    c = x - x.mean()
    s2 = float(np.mean(c * c))
    m4 = float(np.mean(c ** 4))
    z_mean = abs(x.mean() - mean) / math.sqrt(var / n)
    z_var = abs(s2 - var) / math.sqrt(max(m4 - s2 * s2, 1e-300) / n)
    return z_mean, z_var


@pytest.mark.parametrize("kind", SAMPLE_KINDS)
def test_sample_observations_have_the_family_moments(kind):
    """Draws from a generator: mean and variance over 2e5 draws within 5
    standard errors of the family's analytic moments. student_t runs at
    df=10, where its fourth moment (and so the variance's standard error)
    is finite; at the default df=3 it is not."""
    extra = {"df": 10.0} if kind == "student_t" else {}
    if kind == "ordinal":
        extra = {"num_classes": 4}
    p = tlik.init_params(kind, 0.2, dtype=torch.float64, device="cpu",
                         **extra)
    n = 200_000
    if kind in ("multiclass", "softmax"):
        fs = torch.tensor(F_CLASSES, dtype=torch.float64).expand(n, 3)
    else:
        fs = torch.full((n, 1), F_OBS, dtype=torch.float64)
    g = torch.Generator().manual_seed(13)
    y = tlik.dispatch_sample_observations(p, fs, g, kind=kind).numpy()
    assert y.shape == (n, 1) and np.all(np.isfinite(y))
    mean, var = _analytic_moments(kind, tparams.params_to_numpy(p))
    z_mean, z_var = moments_within(y, mean, var)
    assert z_mean < 5.0 and z_var < 5.0, (z_mean, z_var)


def test_sample_observations_refusals():
    fs = torch.zeros(4, 1, dtype=torch.float64)
    p = tlik.init_params("switched_gaussian", num_tasks=2,
                         dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="per-point task"):
        tlik.dispatch_sample_observations(p, fs, torch.Generator(),
                                          kind="switched_gaussian")
    with pytest.raises(ValueError, match="unknown likelihood"):
        tlik.dispatch_sample_observations(p, fs, torch.Generator(),
                                          kind="laplace")
    with pytest.raises(ValueError, match="not injected noise"):
        tlik.dispatch_sample_observations(
            tlik.init_params("poisson", device="cpu"), fs,
            torch.Generator(), kind="poisson", noise=fs)
    with pytest.raises(ValueError, match="torch.Generator"):
        tlik.dispatch_sample_observations(
            tlik.init_params("gaussian", device="cpu"), fs, kind="gaussian")


@pytest.mark.parametrize("kind", [k for k in tlik.LIKELIHOOD_KINDS
                                  if k != "switched_gaussian"])
def test_sample_observations_need_a_generator(kind):
    """Without injected noise, every family refuses a missing generator
    rather than draw from the global RNG."""
    kw = ({"num_classes": 4} if kind == "ordinal" else {})
    p = tlik.init_params(kind, dtype=torch.float64, device="cpu", **kw)
    fs = torch.zeros(4, 3 if kind in ("multiclass", "softmax") else 1,
                     dtype=torch.float64)
    state = torch.random.get_rng_state()
    with pytest.raises(ValueError, match="torch.Generator"):
        tlik.dispatch_sample_observations(p, fs, kind=kind)
    assert torch.equal(torch.random.get_rng_state(), state)


# ---- ten trainer steps ----------------------------------------------------

PRIORS = (("kernel/raw_variance", "gamma", 2.0, 3.0),
          ("raw_noise_variance", "lognormal", -2.0, 1.0))
TRAIN_CASES = [
    # (id, build arguments, natgrad)
    ("LGG-multiscale", dict(configuration="LGG", feature="multiscale"),
     "final"),
    ("LGG-no_white-natgrad-final", dict(configuration="LGG", white=False),
     "final"),
    ("LGG-priors", dict(configuration="LGG", priors=PRIORS), "final"),
    ("GG-multiscale-no_white-adam",
     dict(configuration="GG", feature="multiscale", white=False), "none"),
]


def _draws(key, jconfig, batch):
    """(idx, eps) of the reference's joint step_fn for one key."""
    kb, _, ke, _ = jax.random.split(key, 4)
    idx = np.array(jax.random.randint(kb, (batch,), 0, N_TR))
    return torch.from_numpy(idx), _layer_noise(ke, jconfig, K_TR, batch)


@pytest.mark.parametrize("build_kw,natgrad", [c[1:] for c in TRAIN_CASES],
                         ids=[c[0] for c in TRAIN_CASES])
def test_ten_steps_track_reference(build_kw, natgrad):
    jconfig, jparams, config, params, X, Y = _model(**build_kw)
    assert config.priors == jconfig.priors
    tc_kw = dict(lr=5e-3, gamma=1e-2, natgrad=natgrad, minibatch_size=B_TR)
    jinit, jstep, _, _ = jmake_trainer(jconfig, JTrainConfig(**tc_kw))
    jstep = jax.jit(jstep)
    jstate = jinit(jax.tree.map(jnp.asarray, jparams))
    init, step, _, _ = make_trainer(config, TrainConfig(**tc_kw))
    state = init(params)
    Xj, Yj, Xt, Yt = jnp.asarray(X), jnp.asarray(Y), _t(X), _t(Y)
    for s in range(STEPS):
        key = jax.random.fold_in(jax.random.PRNGKey(11), s)
        jstate, jloss = jstep(jstate, Xj, Yj, key)
        idx, eps = _draws(key, jconfig, B_TR)
        state, loss = step(state, Xt, Yt, idx=idx, eps=eps)
    _close(loss, jloss, STEP_RTOL)
    ours = tparams.state_to_numpy(state)
    ref = jax.device_get({"rest": jstate.rest, "natvars": jstate.natvars})
    assert jax.tree.structure(ours) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(ref)):
        _close(a, b, STEP_RTOL, STEP_ATOL)


def test_non_whitened_kls_share_the_steps_factor():
    """gp_kls with the step's factors equals gp_kls factoring each Kuu
    itself, and the reference's."""
    jconfig, jparams, config, params, X, Y = _model(configuration="LGG",
                                                    white=False,
                                                    feature="multiscale")
    factors = tdgp.prefactor_gp_layers(params, config)
    shared = tdgp.gp_kls(params, config, factors)
    _close(shared, tdgp.gp_kls(params, config).numpy(), 1e-12)
    jf = jdgp.prefactor_gp_layers(jax.tree.map(jnp.asarray, jparams),
                                  jconfig)
    _close(shared, jdgp.gp_kls(jax.tree.map(jnp.asarray, jparams), jconfig,
                               jf), RTOL)


# ---- the builder and the CLIs ---------------------------------------------

def test_build_args_round_trip_the_breadth_fields(tmp_path):
    build = BuildArgs(configuration="LGG", white=False, feature="multiscale",
                      feature_init_scale=0.2, priors=PRIORS)
    save_build_args(str(tmp_path), build, natgrad="final")
    assert load_build_args(str(tmp_path)) == build
    cfg = build_config(build, 3, 1, 10)
    assert cfg.priors == PRIORS
    assert all(c.feature == "multiscale" and not c.white
               and c.feature_init_scale == 0.2
               for c in cfg.layers if hasattr(c, "white"))


def test_build_args_written_before_the_breadth_fields_load(tmp_path):
    """A build_args.json without priors, feature or feature_init_scale
    (as the port wrote before they existed) loads with their defaults."""
    d = dataclasses.asdict(BuildArgs(configuration="LGG"))
    for k in ("priors", "feature", "feature_init_scale"):
        del d[k]
    (tmp_path / "build_args.json").write_text(json.dumps(d))
    assert load_build_args(str(tmp_path)) == BuildArgs(configuration="LGG")


def test_multiscale_layer_init_equals_the_reference():
    """build_model of a multiscale model carries raw_Z_scales at the
    reference's initial value, and the builder passes white, the feature
    and the priors into the config."""
    X, Y, _ = _train_data()
    args = dict(configuration="LGG", num_inducing=M_TR, white=False,
                feature="multiscale", feature_init_scale=0.25, priors=PRIORS)
    config, params = build_model(0, BuildArgs(**args), X, Y, device="cpu",
                                 dtype=torch.float64)
    jconfig, jparams = jbuild_model(jax.random.PRNGKey(0), JBuildArgs(**args),
                                    jnp.asarray(X), jnp.asarray(Y))
    for lp, jlp in zip(params["layers"], jparams["layers"]):
        if "Z" in lp:
            _close(lp["raw_Z_scales"], jlp["raw_Z_scales"], 1e-15)
    assert ([dataclasses.asdict(c) for c in config.layers]
            == [dataclasses.asdict(c) for c in jconfig.layers])
    assert config.priors == jconfig.priors


SMALL = ["--dataset", "energy", "--max_n", "300", "--configuration", "LGG",
         "--mode", "IW", "--M", "16", "--K", "5", "--steps_per_call", "20",
         "--iterations", "40", "--device", "cpu", "--print_every", "0",
         "--num_predict_samples", "10"]
BREADTH_FLAGS = ["--feature", "multiscale", "--no_white", "--prior",
                 "kernel_variance=gamma(2,3)", "--prior",
                 "noise_variance=lognormal(-2,1)"]


@pytest.fixture(scope="module")
def breadth_run(tmp_path_factory):
    """dgp-train-torch --device cpu with the breadth flags, its checkpoint
    kept: (row, checkpoint directory, tmp)."""
    tmp = tmp_path_factory.mktemp("breadth")
    ck = str(tmp / "ck")
    row = main.run(main.parse_args(
        SMALL[:1] + ["yacht"] + SMALL[4:] + BREADTH_FLAGS
        + ["--ckpt_dir", ck, "--ckpt_every", "40", "--results_db",
           str(tmp / "r.db")]))
    return row, ck, tmp


def test_cli_trains_with_the_breadth_flags(breadth_run):
    row, ck, _ = breadth_run
    assert np.isfinite(row["test_loglik"]) and np.isfinite(row["elbo"])
    build = load_build_args(ck)
    assert (build.feature, build.white) == ("multiscale", False)
    assert build.priors == (("kernel/raw_variance", "gamma", 2.0, 3.0),
                            ("raw_noise_variance", "lognormal", -2.0, 1.0))


def test_serve_cli_scores_the_breadth_checkpoint(breadth_run):
    """dgp-serve-torch rebuilds the multiscale non-whitened model from its
    build_args.json: the test split's mean log-density is the run's test
    loglik (the same chunk, seed and model)."""
    row, ck, tmp = breadth_run
    out = str(tmp / "pred.npz")
    res = serve.run(serve.parse_args(
        ["--dataset", "yacht", "--ckpt_dir", ck, "--output", out,
         "--device", "cpu", "--num_predict_samples", "10",
         "--batch_size", "4096"]))
    with np.load(out) as z:
        ld = z["log_density"]
    assert ld.shape == (res["n"],)
    assert abs(float(np.mean(ld.astype(np.float64)))
               - row["test_loglik"]) <= 1e-6 * max(1.0,
                                                   abs(row["test_loglik"]))


@pytest.mark.parametrize("batch", ["fixed", "polymorphic"])
def test_breadth_artifact_equals_the_live_scorer(breadth_run, batch):
    """An exported artifact of the multiscale non-whitened checkpoint
    (stock ops: triangular solves and the window-integral grams) equals
    the live scorer fed the artifact's noise; the polymorphic one also
    scores a batch past its example's size, so no bound on the batch is
    baked in."""
    from dgps_with_iwvi_torch.ops.hopper import build as hbuild
    from dgps_with_iwvi_torch.serving import (artifact_noise, export_scorer,
                                              load_scorer, make_scorer_fn,
                                              save_scorer)
    from dgps_with_iwvi_torch.training import checkpoint

    _, ck, tmp = breadth_run
    build, meta = load_build_args(ck, with_meta=True)
    data = main.load_data("gaussian", "yacht", 0)
    X, Y = data.X_train[:80], data.Y_train[:80]
    config, params = build_model(0, build, X, Y, device="cpu")
    tc = TrainConfig(natgrad=meta["natgrad"])
    init, _, _, params_fn = make_trainer(config, tc)
    state = checkpoint.restore_checkpoint(
        ck, checkpoint.latest_step(ck), {"state": init(params)})["state"]
    params = params_fn(state)
    S, B = 4, 16
    path = str(tmp / f"scorer_{batch}.pt2")
    save_scorer(path, export_scorer(
        params, config, batch_size=B if batch == "fixed" else "b",
        d_in=X.shape[1], d_out=1, num_samples=S), num_samples=S,
        has_stats=False)
    art = load_scorer(path, device="cpu")
    n = B if batch == "fixed" else 3 * B
    got = art.score(X[:n], Y[:n], seed=2, max_batch=n)
    fn = make_scorer_fn(params, config, S, device="cpu")
    with torch.no_grad(), hbuild.plain_versions():
        want = fn(torch.from_numpy(X[:n]), torch.from_numpy(Y[:n]), 2,
                  eps=artifact_noise(2, config, S, n, "cpu"))
    for k, w in zip(("mean", "var", "log_density"), want):
        w = w.numpy()
        np.testing.assert_allclose(got[k], w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(), err_msg=k)
