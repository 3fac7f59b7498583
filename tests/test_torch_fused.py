"""The fused-conditional paths of the port against the JAX reference, on
the CPU: K5 (``ops/hopper/conditional.py``, the reference's
``ops/pallas/conditional.py``) and K4 (``ops/hopper/serve_cond.py``, the
reference's ``ops/pallas/serve_cond.py``), op by op and through whole
models. The reference's Pallas kernels run in interpret mode, as its own
tests run them; inputs come from numpy seeds.

Tolerances, with what sets them:
- K4's plain version against ``fused_conditional_infer(interpret=True)``:
  both round the same bf16 splits into f32 products; only the order of
  the f32 sums differs. The mean agrees to 2.7e-6 of max|ref| (bound
  1e-5). Where that order moves an element of A across a bf16 rounding
  boundary, bf16(A) moves by one bf16 unit and the q-variance by up to
  2^-8 of one of its M terms: measured 1.5e-4 of max|ref| on var (bound
  1e-3) and 2.5e-5 on the sample (bound 1e-4).
- K5's plain version against ``fused_conditional(interpret=True)``: both
  are true f32. Forward measured at most 5.7e-7 of max|ref|, gradients
  4.2e-6 of each one's largest value; bound 1e-5.
- Whole models with ``use_pallas``: the reference runs inner layers
  through its XLA route off the TPU (``conditionals.py:954-957``), in
  f64 here, while the port runs K5's plain version, which computes in f32
  as the kernel does. In float32, with the reference's bf16 q-variance
  policy of that route off: measured 7.6e-8 relative on the ELBO and
  4.0e-6 of a leaf's largest gradient; bounds 1e-6 and 1e-4. One flagship
  trainer step in float64: 2.5e-8 on the loss, 1.6e-5 on the state.
- Serving with ``serve_pallas`` (float32, M=128, S*B = 1024) against the
  reference with ``SERVE_PALLAS = "on"``: the same rounding classes on
  both sides, and the bf16 moves of A above, passed on through the inner
  layer's sample. Measured |a-b|/(1+|b|): 2.6e-5 on the mean, 7.9e-5 on
  the variance, 1.5e-4 on the log-density; bound 1e-3 (the chip check's
  measure). The default route differs from the reference's by the bf16
  class, some 1e-2 on the log-density here.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgps_with_iwvi_tpu.models import BuildArgs as JBuildArgs
from dgps_with_iwvi_tpu.models import build_model as jbuild_model
from dgps_with_iwvi_tpu.models import dgp as jdgp
from dgps_with_iwvi_tpu.ops import conditionals as jcond
from dgps_with_iwvi_tpu.ops.pallas import conditional as jpc
from dgps_with_iwvi_tpu.ops.pallas import serve_cond as jserve
from dgps_with_iwvi_tpu.training import TrainConfig as JTrainConfig
from dgps_with_iwvi_tpu.training import make_trainer as jmake_trainer
from dgps_with_iwvi_torch import params as tparams
from dgps_with_iwvi_torch.models import (BuildArgs, build_config, elbo,
                                         predict_y_and_log_density)
from dgps_with_iwvi_torch.ops import conditionals as tcond
from dgps_with_iwvi_torch.ops.hopper import conditional as tpc
from dgps_with_iwvi_torch.ops.hopper import serve_cond as tserve
from dgps_with_iwvi_torch.training import TrainConfig, make_trainer

from test_torch_training import _jax_draws, _state_close


def _t(a, requires_grad=False):
    return torch.from_numpy(np.array(a, copy=True)).requires_grad_(
        requires_grad)


def _inputs(seed, n, m, d_in, d_out):
    """xs, zs, var, Linv, q_mu, Lq as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    xs = (0.5 * rng.standard_normal((n, d_in))).astype(np.float32)
    zs = (0.5 * rng.standard_normal((m, d_in))).astype(np.float32)
    var = np.asarray(1.7, np.float32)
    R = rng.standard_normal((m, m))
    linv = np.linalg.inv(np.linalg.cholesky(R @ R.T + m * np.eye(m)))
    q_mu = rng.standard_normal((m, d_out)).astype(np.float32)
    lq = 0.3 * np.tril(rng.standard_normal((d_out, m, m)))
    return (xs, zs, var, (3.0 * linv).astype(np.float32), q_mu,
            lq.astype(np.float32))


def _close(port, ref, rel):
    ref = np.asarray(ref)
    np.testing.assert_allclose(port.detach().numpy(), ref, rtol=0,
                               atol=rel * float(np.max(np.abs(ref))))


# ------------------------------------------------------ Philox stream


# Philox4x32-10 known-answer vectors (Salmon, Moraes, Dror and Shaw,
# "Parallel random numbers: as easy as 1, 2, 3", SC'11; Random123's
# kat_vectors): (counter, key, output)
_M32 = 0xFFFFFFFF
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((_M32, _M32, _M32, _M32), (_M32, _M32),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("counter,key,want", PHILOX_KAT)
def test_philox_known_answers(counter, key, want):
    words = [torch.tensor(w, dtype=torch.int64) for w in counter + key]
    assert [int(w) for w in tpc.philox4x32(*words)] == list(want)


def test_philox_normal_is_standard_normal_and_keyed_by_seed():
    """4e5 draws: mean, variance and the share beyond +-3 within 5
    standard errors; one seed gives one stream, another seed another."""
    seed = torch.tensor(123456789012345, dtype=torch.int64)
    eps = tpc.philox_normal(seed, 50000, 8).double()
    n = eps.numel()
    assert abs(float(eps.mean())) < 5 / n ** 0.5
    assert abs(float(eps.var()) - 1.0) < 5 * (2.0 / n) ** 0.5
    p3 = 2.6997961e-3
    tail = float((eps.abs() > 3).double().mean())
    assert abs(tail - p3) < 5 * (p3 * (1 - p3) / n) ** 0.5
    assert torch.equal(tpc.philox_normal(seed, 50000, 8).double(), eps)
    assert not torch.equal(tpc.philox_normal(seed + 1, 50000, 8).double(),
                           eps)
    # the counter is (row, column): a row's draws do not depend on N
    torch.testing.assert_close(tpc.philox_normal(seed, 7, 8).double(),
                               eps[:7], rtol=0, atol=0)


# --------------------------------------------- K4: the inference kernel


@pytest.mark.parametrize("n,sample", [(1280, False), (1280, True),
                                      (1000, True)])
def test_infer_plain_matches_reference(n, sample):
    xs, zs, var, linv, q_mu, lq = _inputs(0, n, 128, 6, 3)
    eps = np.random.default_rng(9).standard_normal((n, 3)).astype(
        np.float32)
    ref = jserve.fused_conditional_infer(
        *(jnp.asarray(a) for a in (xs, zs, var, linv, q_mu, lq)),
        jnp.asarray(eps) if sample else None, sample=sample, interpret=True)
    got = tserve.fused_conditional_infer(
        *(_t(a) for a in (xs, zs, var, linv, q_mu, lq)),
        _t(eps) if sample else None)
    assert len(got) == len(ref)
    tols = ((1e-4,) if sample else ()) + (1e-5, 1e-3)   # (sample,) mean, var
    for p, r, tol in zip(got, ref, tols):
        assert p.dtype == torch.float32 and p.shape == r.shape
        _close(p, r, tol)


def test_infer_raises_where_a_gradient_is_needed():
    args = [_t(a) for a in _inputs(1, 64, 16, 3, 2)]
    args[3].requires_grad_()
    with pytest.raises(RuntimeError, match="not differentiable"):
        tserve.fused_conditional_infer(*args)
    with torch.no_grad():
        mean, v = tserve.fused_conditional_infer(*args)
    assert mean.shape == v.shape == (64, 2)


# ---------------------------------------- K5: the whole f32 conditional


@pytest.mark.parametrize("n,m,d_in,d_out", [(300, 64, 5, 3), (37, 8, 2, 1)])
def test_fused_plain_matches_reference_forward(n, m, d_in, d_out):
    """Outputs and the residuals Kxz and A; (37, 8, 2, 1) is the
    reference's padding case (ragged N, small d_in)."""
    args = _inputs(2, n, m, d_in, d_out)
    ref = jpc._fused_forward(*(jnp.asarray(a) for a in args), interpret=True)
    got = tpc.fused_forward(*(_t(a) for a in args), residuals=True)
    for p, r in zip((got[0], got[1], got[3], got[4]), ref):
        assert p.shape == r.shape
        _close(p, r, 1e-5)
    assert got[2] is None
    mean, v = tpc.fused_conditional(*(_t(a) for a in args))
    _close(mean, ref[0], 1e-5)
    _close(v, ref[1], 1e-5)


def _vjp_pair(args, n, d_out, seed=4):
    rng = np.random.default_rng(seed)
    g_mean = rng.standard_normal((n, d_out)).astype(np.float32)
    g_var = rng.standard_normal((n, d_out)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jpc.fused_conditional(*a, True),
                     *(jnp.asarray(a) for a in args))
    ref = vjp((jnp.asarray(g_mean), jnp.asarray(g_var)))
    targs = [_t(a, True) for a in args]
    mean, v = tpc.fused_conditional(*targs)
    got = torch.autograd.grad(
        torch.sum(mean * _t(g_mean)) + torch.sum(v * _t(g_var)), targs)
    return got, ref


@pytest.mark.parametrize("n,m,d_in,d_out", [(300, 64, 5, 3), (37, 8, 2, 1)])
def test_fused_gradients_match_reference(n, m, d_in, d_out):
    """The vjp with respect to all six inputs (xs, zs, var, Linv, q_mu,
    Lq) against the reference's ``_bwd``, the same cotangents."""
    got, ref = _vjp_pair(_inputs(3, n, m, d_in, d_out), n, d_out)
    for p, r in zip(got, ref):
        assert p.shape == r.shape and p.dtype == torch.float32
        _close(p, r, 1e-5)
    assert float(torch.triu(got[5], 1).abs().max()) == 0.0


def test_sample_variant_deterministic_parts():
    """``_sample_kernel`` cannot run off the TPU (its prng_seed has no CPU
    lowering). Its deterministic parts: (mean, var, Kxz, A) equal
    ``_fused_forward``'s, and sample = mean + sqrt(max(var, 0)) eps for
    the port's stream."""
    args = _inputs(5, 300, 64, 5, 3)
    seed = torch.tensor(2 ** 40 + 17, dtype=torch.int64)
    ref = jpc._fused_forward(*(jnp.asarray(a) for a in args), interpret=True)
    mean, v, samp, kxz, a = tpc.fused_forward(*(_t(x) for x in args), seed)
    for p, r in zip((mean, v, kxz, a), ref):
        _close(p, r, 1e-5)
    eps = tpc.philox_normal(seed, 300, 3)
    torch.testing.assert_close(
        samp, mean + torch.sqrt(torch.clamp(v, min=0.0)) * eps, rtol=0,
        atol=0)
    s2, m2, v2 = tpc.fused_conditional_sample(*(_t(x) for x in args), seed)
    for x, y in ((s2, samp), (m2, mean), (v2, v)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_sample_backward_matches_reference():
    """The port's backward against the reference's ``_sample_bwd`` called
    on the same residuals and the port's sample."""
    n, d_out = 300, 3
    args = _inputs(6, n, 64, 5, d_out)
    seed = torch.tensor(99, dtype=torch.int64)
    jargs = [jnp.asarray(a) for a in args]
    mean, v, kxz, a = jpc._fused_forward(*jargs, interpret=True)
    eps = tpc.philox_normal(seed, n, d_out).numpy()
    samp = mean + jnp.sqrt(jnp.maximum(v, 0.0)) * eps
    rng = np.random.default_rng(7)
    cots = [rng.standard_normal((n, d_out)).astype(np.float32)
            for _ in range(3)]
    ref = jpc._sample_bwd(True, (*jargs, kxz, a, mean, v, samp),
                          tuple(jnp.asarray(c) for c in cots))
    assert ref[-1] is None
    targs = [_t(x, True) for x in args]
    outs = tpc.fused_conditional_sample(*targs, seed)
    got = torch.autograd.grad(
        sum(torch.sum(o * _t(c)) for o, c in zip(outs, cots)), targs)
    for p, r in zip(got, ref[:6]):
        _close(p, r, 1e-5)


# -------------------------------------------------------- whole models

N, B, D_X, M, K = 64, 32, 3, 16, 4
ARGS = dict(configuration="LGG", mode="IW", num_inducing=M, num_iw_samples=K)


@pytest.fixture(scope="module")
def reference():
    """(X, Y, JAX config with use_pallas, JAX params as numpy) in f64."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N, D_X))
    Y = np.sin(X[:, :1]) + 0.1 * rng.standard_normal((N, 1))
    config, params = jbuild_model(jax.random.PRNGKey(0), JBuildArgs(**ARGS),
                                  jnp.asarray(X), jnp.asarray(Y))
    params = jax.device_get(params)
    for i in (1, 2):
        lp = params["layers"][i]
        lp["q_mu"] = 0.5 * rng.standard_normal(lp["q_mu"].shape)
        lp["q_sqrt"] = (np.tril(0.2 * rng.standard_normal(lp["q_sqrt"].shape))
                        + 0.5 * np.eye(M))
    return X, Y, dataclasses.replace(config, use_pallas=True), params


def _port(jparams, dtype, **kw):
    config = build_config(BuildArgs(**ARGS, **kw), D_X, 1, N)
    return config, tparams.params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a, dtype), jparams), "cpu")


@pytest.fixture
def f32_xla_inner_layers():
    """The reference's inner layers take its XLA route off the TPU; in f32
    that route rounds the q-variance through bf16 by default
    (QVAR_BF16_RESIDUAL, ~1e-3 relative), a policy of that route and not
    of the kernels compared here. Off for the test, as the reference's own
    tests/test_pallas_conditional.py turns it off."""
    saved = jcond.QVAR_BF16_RESIDUAL
    jcond.QVAR_BF16_RESIDUAL = False
    yield
    jcond.QVAR_BF16_RESIDUAL = saved


def test_elbo_and_gradients_with_use_pallas_match_reference(
        reference, f32_xla_inner_layers):
    """float32 (the reference's fused custom_vjp returns f32 cotangents,
    so it differentiates only f32 inputs)."""
    X, Y, jconfig, jparams = reference
    X, Y = X[:B].astype(np.float32), Y[:B].astype(np.float32)
    key = jax.random.PRNGKey(5)
    jval, jgrad = jax.jit(jax.value_and_grad(
        lambda p: jdgp.elbo(p, jconfig, jnp.asarray(X), jnp.asarray(Y),
                            key)))(
        jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), jparams))
    config, params = _port(jparams, np.float32, use_pallas=True)
    assert config.use_pallas is True
    w = jax.random.normal(jax.random.fold_in(key, 0), (K, B, 1), jnp.float32)
    e = jax.random.normal(jax.random.fold_in(key, 1), (K, B, 3), jnp.float32)
    leaves = [t.requires_grad_() for t in jax.tree.leaves(params)]
    val = elbo(params, config, _t(X), _t(Y), eps=[_t(w), _t(e), None])
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-6)
    grads = torch.autograd.grad(val, leaves, allow_unused=True)
    for g, r in zip(grads, jax.tree.leaves(jgrad)):
        r = np.asarray(r)
        g = torch.zeros(r.shape) if g is None else g
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=1e-4 * float(np.max(np.abs(r)))
                                   + 1e-30)


def test_one_trainer_step_with_use_pallas_matches_reference(reference):
    """The flagship step (natgrad on the final layer, whose q_cov keeps it
    on the default route) with the inner layer on K5, float64 (the port's
    K5 computes in f32). Measured: 2.5e-8 relative on the loss, 1.6e-5
    relative on the updated state; bounds 1e-6 and 1e-4."""
    X, Y, jconfig, jparams = reference
    tc_kw = dict(lr=5e-3, gamma=1e-2, natgrad="final", minibatch_size=B)
    jinit, jstep, _, _ = jmake_trainer(jconfig, JTrainConfig(**tc_kw))
    jstate, jloss = jax.jit(jstep)(jinit(jax.tree.map(jnp.asarray, jparams)),
                                   jnp.asarray(X), jnp.asarray(Y),
                                   jax.random.PRNGKey(11))
    config, params = _port(jparams, np.float64, use_pallas=True)
    init, step, _, _ = make_trainer(config, TrainConfig(**tc_kw))
    (idx, eps), _ = _jax_draws(jax.random.PRNGKey(11), N, B, K, 3)
    state, loss = step(init(params), _t(X), _t(Y), idx=idx, eps=eps)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    _state_close(state, jstate, rtol=1e-4, atol=1e-7)


S_SERVE, B_SERVE, M_SERVE = 8, 128, 128


def test_serving_with_serve_pallas_matches_reference():
    """predict_y_and_log_density through K4's plain version against the
    reference with SERVE_PALLAS = "on" (its _infer_kernel in interpret
    mode), float32, injected noise."""
    rng = np.random.default_rng(1)
    X = rng.standard_normal((B_SERVE, D_X)).astype(np.float32)
    Y = (np.sin(X[:, :1]) + 0.1 * rng.standard_normal((B_SERVE, 1))
         ).astype(np.float32)
    args = dict(ARGS, num_inducing=M_SERVE)
    jconfig, jp = jbuild_model(jax.random.PRNGKey(0), JBuildArgs(**args),
                               jnp.asarray(X), jnp.asarray(Y))
    jp = jax.device_get(jp)
    for i in (1, 2):
        lp = jp["layers"][i]
        # spread-out Z: k-means of 128 rows into 128 centres leaves Kuu
        # near-singular, and its inverse then differs by far more than the
        # kernels' rounding between any two f32 factorizations
        lp["Z"] = (2.0 * rng.standard_normal(lp["Z"].shape)).astype(
            np.float32)
        lp["q_mu"] = (0.5 * rng.standard_normal(lp["q_mu"].shape)
                      ).astype(np.float32)
        lp["q_sqrt"] = (np.tril(0.02 * rng.standard_normal(
            lp["q_sqrt"].shape)) + 0.4 * np.eye(M_SERVE)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    saved = jcond.SERVE_PALLAS
    try:
        jcond.SERVE_PALLAS = "on"
        (jm, jv), jld = jdgp.predict_y_and_log_density(
            jp, jconfig, jnp.asarray(X), jnp.asarray(Y), key, S_SERVE)
    finally:
        jcond.SERVE_PALLAS = saved
    config = build_config(BuildArgs(**args, serve_pallas=True), D_X, 1,
                          B_SERVE)
    params = tparams.params_from_numpy(jp, "cpu")
    w = jax.random.normal(jax.random.fold_in(key, 0), (S_SERVE, B_SERVE, 1),
                          jnp.float32)
    e = jax.random.normal(jax.random.fold_in(key, 1), (S_SERVE, B_SERVE, 3),
                          jnp.float32)
    calls = []
    infer = tserve.fused_conditional_infer

    def spy(*a):
        calls.append(a[0].shape)
        return infer(*a)

    tserve.fused_conditional_infer = spy
    try:
        (m, v), ld = predict_y_and_log_density(
            params, config, _t(X), _t(Y), None, S_SERVE,
            eps=[_t(w), _t(e), None])
    finally:
        tserve.fused_conditional_infer = infer
    assert calls == [(S_SERVE * B_SERVE, D_X + 1), (S_SERVE * B_SERVE, 3)]
    for p, r in ((m, jm), (v, jv), (ld, jld)):
        r = np.asarray(r)
        assert float(np.max(np.abs(p.numpy() - r) / (1.0 + np.abs(r)))) \
            <= 1e-3


# ------------------------------------------------------------- routes


def _spy(monkeypatch):
    """Record which whole-conditional entry each layer took."""
    seen = []
    for mod, name in ((tpc, "fused_conditional"),
                      (tpc, "fused_conditional_sample"),
                      (tserve, "fused_conditional_infer")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name: (
            seen.append((_n, a[1].shape[0])), _f(*a))[1])
    return seen


def test_routes(reference, monkeypatch):
    """use_pallas: the inner layer draws in K5 'sample' with a generator
    and takes K5 'fused' with injected noise, the final layer K5 'fused';
    q_cov (natgrad) keeps the final layer on the default route; 'auto'
    is the default route, bit for bit."""
    X, Y, _, jparams = reference
    seen = _spy(monkeypatch)
    Xb, Yb = _t(X[:B]), _t(Y[:B])
    cfg, params = _port(jparams, np.float32, use_pallas=True)
    gen = torch.Generator().manual_seed(0)
    v1 = elbo(params, cfg, Xb.float(), Yb.float(), gen)
    assert seen == [("fused_conditional_sample", M), ("fused_conditional", M)]
    assert bool(torch.isfinite(v1))
    seen.clear()
    eps =[torch.randn(K, B, 1), torch.randn(K, B, 3), None]
    elbo(params, cfg, Xb.float(), Yb.float(), eps=eps)
    assert seen == [("fused_conditional", M), ("fused_conditional", M)]
    seen.clear()
    init, step, _, _ = make_trainer(cfg, TrainConfig(natgrad="final",
                                                     minibatch_size=B))
    step(init(params), _t(X).float(), _t(Y).float(),
         torch.Generator().manual_seed(1))
    assert seen == [("fused_conditional_sample", M)]
    seen.clear()
    cfg_auto, _ = _port(jparams, np.float32)
    assert cfg_auto.use_pallas == "auto"
    cfg_off = dataclasses.replace(cfg_auto, use_pallas=False)
    a = elbo(params, cfg_auto, Xb.float(), Yb.float(), eps=eps)
    b = elbo(params, cfg_off, Xb.float(), Yb.float(), eps=eps)
    assert seen == [] and torch.equal(a, b)


def test_serve_pallas_raises_under_autograd(reference):
    X, Y, _, jparams = reference
    cfg, params = _port(jparams, np.float32, serve_pallas=True)
    leaves = [t.requires_grad_() for t in jax.tree.leaves(params)]
    assert leaves
    eps = [torch.randn(K, B, 1), torch.randn(K, B, 3), None]
    with pytest.raises(RuntimeError, match="not differentiable"):
        elbo(params, cfg, _t(X[:B]).float(), _t(Y[:B]).float(), eps=eps)
    with torch.no_grad():
        (m, v), ld = predict_y_and_log_density(
            params, cfg, _t(X[:B]).float(), _t(Y[:B]).float(), None, K,
            eps=eps)
    assert bool(torch.isfinite(ld).all()) and bool((v > 0).all())


def test_sample_conditional_adds_safe_sqrt_noise():
    rng = np.random.default_rng(8)
    Xs = _t(rng.standard_normal((2, 20, 3)).astype(np.float32))
    Z = _t(rng.standard_normal((8, 3)).astype(np.float32))
    kp = tparams.params_from_numpy(
        {"raw_variance": np.asarray(0.4, np.float32),
         "raw_lengthscales": np.full(3, 0.8, np.float32)}, "cpu")
    q_mu = _t(rng.standard_normal((8, 2)).astype(np.float32))
    q_sqrt = torch.tril(_t(rng.standard_normal((2, 8, 8)).astype(
        np.float32)))
    eps = torch.randn(2, 20, 2)
    s, out = tcond.sample_conditional(Xs, Z, kp, q_mu, q_sqrt, eps=eps)
    torch.testing.assert_close(s, out.mean + tcond.safe_sqrt(out.var) * eps,
                               rtol=0, atol=0)
    s2, out2 = tcond.sample_conditional_fused(Xs, Z, kp, q_mu, q_sqrt,
                                              eps=eps)
    torch.testing.assert_close(out2.mean, out.mean, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s2, s, rtol=1e-5, atol=1e-5)
