"""Per-op parity of the PyTorch port against the JAX reference.

Inputs come from numpy seeds and go through both the reference function
and its counterpart in ``dgps_with_iwvi_torch`` on the CPU. In float64
every precision class passes through exactly on both sides, so the
tolerance is rtol 1e-9 (the two LAPACKs agree to ~1e-15; the margin
covers the condition number of the small jittered grams).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgps_with_iwvi_tpu.models import encoders as jenc
from dgps_with_iwvi_tpu.ops import conditionals as jcond
from dgps_with_iwvi_tpu.ops import kernels as jkern
from dgps_with_iwvi_tpu.ops import likelihoods as jlik
from dgps_with_iwvi_tpu.ops import linalg as jlinalg
from dgps_with_iwvi_tpu.ops import mean_functions as jmf
from dgps_with_iwvi_tpu.ops import transforms as jtr
from dgps_with_iwvi_tpu.ops.pallas.qvar import _dot3
from dgps_with_iwvi_torch import params as tparams
from dgps_with_iwvi_torch.models import encoders as tenc
from dgps_with_iwvi_torch.models import kmeans_centers
from dgps_with_iwvi_torch.ops import conditionals as tcond
from dgps_with_iwvi_torch.ops import kernels as tkern
from dgps_with_iwvi_torch.ops import likelihoods as tlik
from dgps_with_iwvi_torch.ops import linalg as tlinalg
from dgps_with_iwvi_torch.ops import mean_functions as tmf
from dgps_with_iwvi_torch.ops import precision as tprec
from dgps_with_iwvi_torch.ops import transforms as ttr

RTOL = 1e-9


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(port, ref, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=rtol, atol=atol)


def _kparams(rng, d):
    return {"raw_variance": np.asarray(rng.uniform(0.2, 1.5)),
            "raw_lengthscales": rng.uniform(0.3, 1.2, size=d)}


def _spd(rng, m):
    Z = rng.standard_normal((m, 3))
    K = np.asarray(jkern.K(jax.tree.map(jnp.asarray, _kparams(rng, 3)),
                           jnp.asarray(Z), jnp.asarray(Z)))
    return K


@pytest.mark.parametrize("value", [1e-7, 0.05, 1.0, 30.0])
def test_positive_transforms(value):
    v = np.asarray(value, np.float64)
    raw_j = jtr.positive_inverse(jnp.asarray(v))
    raw_t = ttr.positive_inverse(_t(v))
    _close(raw_t, raw_j, rtol=1e-12)
    _close(ttr.positive(raw_t), jtr.positive(raw_j), rtol=1e-12)


def test_rbf_gram_and_diag():
    rng = np.random.default_rng(0)
    kp = _kparams(rng, 4)
    Z = rng.standard_normal((16, 4))
    X = rng.standard_normal((3, 32, 4))
    jp = jax.tree.map(jnp.asarray, kp)
    tp = tparams.params_from_numpy(kp, device="cpu")
    Kj = jkern.K(jp, jnp.asarray(Z), jnp.asarray(X))
    Kt = tkern.K(tp, _t(Z), _t(X))
    assert tuple(Kt.shape) == (3, 16, 32)
    _close(Kt, Kj)
    _close(tkern.Kdiag(tp, _t(X)), jkern.Kdiag(jp, jnp.asarray(X)))


def test_other_kernel_kinds_raise():
    """Every kind of the reference is ported (tests/test_torch_families.py);
    a kind the reference does not know raises ValueError, as there."""
    with pytest.raises(ValueError, match="unknown kernel kind"):
        tkern.K({}, torch.zeros(2, 1), kind="matern99")


@pytest.mark.parametrize("cls", ["default", "high", "highest"])
def test_precision_f64_passes_through(cls):
    rng = np.random.default_rng(1)
    x, y = rng.standard_normal((2, 5, 7)), rng.standard_normal((7, 3))
    out = tprec.matmul(_t(x), _t(y), cls)
    np.testing.assert_array_equal(out.numpy(), _t(x).matmul(_t(y)).numpy())


def test_precision_high_is_the_bf16x3_split():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((8, 64)).astype(np.float32)
    y = rng.standard_normal((64, 40)).astype(np.float32)
    ref = _dot3(jnp.asarray(x), jnp.asarray(y))
    out = tprec.matmul(_t(x), _t(y), "high")
    _close(out, ref, rtol=1e-5, atol=1e-5)
    # and it is not plain f32: the dropped lo*lo term shows at ~2^-16
    exact = x.astype(np.float64) @ y.astype(np.float64)
    err = np.max(np.abs(out.numpy() - exact))
    assert 0 < err < 1e-3


def test_precision_default_is_bf16_operands_f32_accumulation():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 16, 32)).astype(np.float32)
    y = rng.standard_normal((32, 24)).astype(np.float32)
    ref = jnp.matmul(jnp.asarray(x).astype(jnp.bfloat16),
                     jnp.asarray(y).astype(jnp.bfloat16),
                     preferred_element_type=jnp.float32)
    out = tprec.matmul(_t(x), _t(y), "default")
    assert out.dtype == torch.float32
    _close(out, ref, rtol=1e-5, atol=1e-5)


def test_precision_rejects_unknown_class():
    with pytest.raises(ValueError, match="unknown precision"):
        tprec.matmul(torch.ones(2, 2), torch.ones(2, 2), "bf16")


@pytest.mark.parametrize("shift,level", [(0.0, 0), (-5e-6, 1), (-5e-5, 2)])
def test_cholesky_with_jitter_ladder(shift, level):
    """shift < 0 makes K + 1e-6 I indefinite, so the ladder climbs to the
    first level whose jitter outweighs it; values equal the reference's."""
    rng = np.random.default_rng(4)
    v = rng.standard_normal((16, 2))
    K = v @ v.T + shift * np.eye(16)
    Lj = jlinalg.cholesky_with_jitter(jnp.asarray(K), 1e-6, 4)
    Lt = tlinalg.cholesky_with_jitter(_t(K), 1e-6, 4)
    # cond(K + jitter I) ~ 1e7: entries near 0 agree to rtol * max|L|
    _close(Lt, Lj, atol=RTOL * float(np.max(np.abs(Lj))))
    sel = tlinalg._select_jitter(_t(K)[None], 1e-6, 4)
    _close(sel, jlinalg._select_jitter(jnp.asarray(K)[None], 1e-6, 4))
    assert float(sel[0]) == pytest.approx(1e-6 * 10.0 ** level)


def test_cholesky_rank_deficient_f32_is_finite():
    """The verify flow: a rank-deficient f32 gram gives a finite factor
    with a positive diagonal through the ladder."""
    rng = np.random.default_rng(5)
    v = rng.standard_normal((16, 2)).astype(np.float32)
    L = tlinalg.cholesky_with_jitter(_t(v @ v.T), 1e-6, 6)
    d = torch.diagonal(L)
    assert bool(torch.all(torch.isfinite(L))) and bool(torch.all(d > 0))


def test_chol_and_inverse_batched():
    rng = np.random.default_rng(6)
    K = np.stack([_spd(rng, 16), _spd(rng, 16)])
    Lj, Ij = jlinalg.chol_and_inverse(jnp.asarray(K), 1e-6, 4)
    Lt, It = tlinalg.chol_and_inverse(_t(K), 1e-6, 4)
    _close(Lt, Lj)
    _close(It, Ij, atol=1e-12 * float(np.max(np.abs(Ij))))
    assert float(torch.max(torch.abs(torch.triu(Lt, 1)))) == 0.0


@pytest.mark.parametrize("trans", [False, True])
def test_solve_triangular_wide(trans):
    rng = np.random.default_rng(7)
    L = np.tril(rng.standard_normal((16, 16))) + 4 * np.eye(16)
    B = rng.standard_normal((3, 16, 20))
    ref = jlinalg.solve_triangular(jnp.asarray(L), jnp.asarray(B), lower=True,
                                   trans=trans)
    out = tlinalg.solve_triangular(_t(L), _t(B), lower=True, trans=trans)
    _close(out, ref)


def _conditional_inputs(rng, form, m=16, n=32, d=3):
    Kuu = _spd(rng, m)
    Lm = np.linalg.cholesky(Kuu + 1e-6 * np.eye(m))
    Kuf = rng.standard_normal((4, m, n)) * 0.3
    Kff = np.full((4, n), 1.3)
    q_mu = rng.standard_normal((m, d))
    if form == "diag":
        return Kuf, Lm, Kff, q_mu, rng.uniform(0.1, 1, (m, d)), None
    root = np.tril(rng.standard_normal((d, m, m))) * 0.3 + 0.5 * np.eye(m)
    if form == "cov":
        return Kuf, Lm, Kff, q_mu, None, root @ np.swapaxes(root, -1, -2)
    return Kuf, Lm, Kff, q_mu, root, None


@pytest.mark.parametrize("form", ["root", "cov", "diag"])
@pytest.mark.parametrize("with_linv", [False, True])
def test_base_conditional_whitened(form, with_linv):
    rng = np.random.default_rng(8)
    Kuf, Lm, Kff, q_mu, q_sqrt, q_S = _conditional_inputs(rng, form)
    Linv = np.linalg.inv(Lm) if with_linv else None
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    t = lambda a: None if a is None else _t(a)  # noqa: E731
    ref = jcond.base_conditional_whitened(
        j(Kuf), j(Lm), j(Kff), j(q_mu), j(q_sqrt), var_precision="default",
        Linv=j(Linv), q_S=j(q_S), solve_precision="high")
    out = tcond.base_conditional_whitened(
        t(Kuf), t(Lm), t(Kff), t(q_mu), t(q_sqrt), var_precision="default",
        Linv=t(Linv), q_S=t(q_S), solve_precision="high")
    _close(out.mean, ref.mean, atol=1e-12)
    _close(out.var, ref.var)


def test_conditional_non_white_matches_reference():
    """The end-to-end non-whitened conditional (grams, chol(Kuu), two
    triangular solves, moments) against the reference's in float64."""
    rng = np.random.default_rng(11)
    X, Z = rng.standard_normal((4, 32, 3)), rng.standard_normal((16, 3))
    kp = _kparams(rng, 3)
    q_mu = rng.standard_normal((16, 2))
    q_sqrt = np.tril(rng.standard_normal((2, 16, 16))) * 0.3 \
        + 0.5 * np.eye(16)
    ref = jcond.conditional(
        jnp.asarray(X), jnp.asarray(Z), jax.tree.map(jnp.asarray, kp),
        jnp.asarray(q_mu), jnp.asarray(q_sqrt), white=False,
        var_precision="default", solve_precision="high")
    out = tcond.conditional(
        _t(X), _t(Z), tparams.params_from_numpy(kp, "cpu"), _t(q_mu),
        _t(q_sqrt), white=False, var_precision="default",
        solve_precision="high")
    _close(out.mean, ref.mean, atol=1e-12)
    _close(out.var, ref.var)


def test_safe_sqrt_floors():
    v = torch.tensor([-1.0, 0.0, 4.0], dtype=torch.float64)
    out = tcond.safe_sqrt(v)
    _close(out, jcond.safe_sqrt(jnp.asarray(v.numpy())), rtol=0)


def test_gaussian_likelihood():
    rng = np.random.default_rng(9)
    m, v = rng.standard_normal((4, 8, 1)), rng.uniform(0.1, 2, (4, 8, 1))
    y = rng.standard_normal((8, 1))
    jp = jlik.gaussian_params(0.07, dtype=jnp.float64)
    tp = tlik.gaussian_params(0.07, dtype=torch.float64, device="cpu")
    _close(tp["raw_noise_variance"], jp["raw_noise_variance"], rtol=1e-12)
    _close(tlik.predict_density(tp, _t(m), _t(v), _t(y)),
           jlik.predict_density(jp, jnp.asarray(m), jnp.asarray(v),
                                jnp.asarray(y)))
    _, vt = tlik.predict_mean_and_var(tp, _t(m), _t(v))
    _, vj = jlik.predict_mean_and_var(jp, jnp.asarray(m), jnp.asarray(v))
    _close(vt, vj)
    # the other families are ported (tests/test_torch_families.py): the
    # dispatch reaches them, here the probit density of the same inputs
    _close(tlik.dispatch_predict_density(tp, _t(m), _t(v), _t(y),
                                         kind="bernoulli"),
           jlik.dispatch_predict_density(jp, jnp.asarray(m), jnp.asarray(v),
                                         jnp.asarray(y), kind="bernoulli"))


@pytest.mark.parametrize("d_in,d_out", [(4, 4), (4, 3), (3, 5)])
def test_skip_mean_function(d_in, d_out):
    X = np.random.default_rng(10).standard_normal((2, 5, d_in))
    Wj = jmf.skip_projection(d_in, d_out, jnp.float64)
    Wt = tmf.skip_projection(d_in, d_out, dtype=torch.float64, device="cpu")
    assert (Wj is None) == (Wt is None)
    ref = jmf.apply_mean_function(jnp.asarray(X), Wj)
    _close(tmf.apply_mean_function(_t(X), Wt), ref, rtol=0)


def test_encoder_matches_reference():
    """The reference's encoder tree carries over whole and encodes alike
    (heads randomized: at init they are zero)."""
    rng = np.random.default_rng(13)
    tree = jax.device_get(jenc.encoder_init(jax.random.PRNGKey(0), 5, 2,
                                            (6, 4), dtype=jnp.float64))
    for head in ("mu_head", "logvar_head"):
        tree[head]["W"] = rng.standard_normal(tree[head]["W"].shape)
    ported = tenc.encoder_init(torch.Generator().manual_seed(0), 5, 2, (6, 4),
                               dtype=torch.float64, device="cpu")
    assert jax.tree.structure(tparams.params_to_numpy(ported)) == \
        jax.tree.structure(tree)
    s = rng.standard_normal((3, 7, 5))
    for port, ref in zip(tenc.encode(tparams.params_from_numpy(tree, "cpu"),
                                     _t(s)),
                         jenc.encode(jax.tree.map(jnp.asarray, tree),
                                     jnp.asarray(s))):
        _close(port, ref)


def test_params_round_trip_is_exact():
    rng = np.random.default_rng(11)
    tree = {"layers": [{"Z": rng.standard_normal((4, 2)),
                        "kernel": {"raw_variance": np.asarray(0.3)}},
                       {"encoder": {"trunk": [{"W": rng.standard_normal(
                           (3, 2)).astype(np.float32)}]}}],
            "likelihood": {"raw_noise_variance": np.asarray(-2.0)}}
    back = tparams.params_to_numpy(tparams.params_from_numpy(tree, "cpu"))
    flat_a = jax.tree.leaves(tree)
    flat_b = jax.tree.leaves(back)
    assert jax.tree.structure(tree) == jax.tree.structure(back)
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_kmeans_centers_deterministic():
    rng = np.random.default_rng(12)
    X = _t(np.concatenate([rng.normal(-3, 0.1, (40, 2)),
                           rng.normal(3, 0.1, (40, 2))]))
    c1 = kmeans_centers(X, 2, torch.Generator().manual_seed(0))
    c2 = kmeans_centers(X, 2, torch.Generator().manual_seed(0))
    torch.testing.assert_close(c1, c2, rtol=0, atol=0)
    got = sorted(float(c[0]) for c in c1)
    assert got[0] == pytest.approx(-3, abs=0.1)
    assert got[1] == pytest.approx(3, abs=0.1)
