"""The training slice of the port against the JAX reference, on the CPU.

Inputs come from numpy seeds. Per op and for the whole slice, float64 runs
every precision class exactly on both sides, so values and gradients agree
at rtol 1e-9 (the step-tracking test at rtol 1e-8: fifty steps of Adam and
natural gradients compound the last digits). The reference's own draws
are injected: the minibatch rows ``randint(kb1, (B,), 0, N)`` and the
noise ``normal(fold_in(ke1, i), ...)`` of layer i, with
``kb1, kb2, ke1, ke2 = split(key, 4)`` as its ``step_fn`` splits them.

In float32 the port rounds what the TPU rounds (the q-variance operands
and its backward to bf16, the solve path at bf16x3), while the
reference's CPU run does those dots in full f32, so one step agrees at
the bf16 class only; the bound is stated where it is checked.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgps_with_iwvi_tpu.models import BuildArgs as JBuildArgs
from dgps_with_iwvi_tpu.models import build_model as jbuild_model
from dgps_with_iwvi_tpu.models import dgp as jdgp
from dgps_with_iwvi_tpu.models import layers as jlayers
from dgps_with_iwvi_tpu.ops import conditionals as jcond
from dgps_with_iwvi_tpu.ops import kernels as jkern
from dgps_with_iwvi_tpu.ops import kl as jkl
from dgps_with_iwvi_tpu.ops import likelihoods as jlik
from dgps_with_iwvi_tpu.ops import linalg as jlinalg
from dgps_with_iwvi_tpu.training import TrainConfig as JTrainConfig
from dgps_with_iwvi_tpu.training import make_trainer as jmake_trainer
from dgps_with_iwvi_tpu.training import natgrad as jng
from dgps_with_iwvi_torch import params as tparams
from dgps_with_iwvi_torch.models import (BuildArgs, build_config, elbo,
                                         init_dgp, propagate)
from dgps_with_iwvi_torch.models import layers as tlayers
from dgps_with_iwvi_torch.ops import kernels as tkern
from dgps_with_iwvi_torch.ops import kl as tkl
from dgps_with_iwvi_torch.ops import likelihoods as tlik
from dgps_with_iwvi_torch.ops import linalg as tlinalg
from dgps_with_iwvi_torch.ops import precision as tprec
from dgps_with_iwvi_torch.training import (TrainConfig, fit, loss_and_grads,
                                           make_trainer)
from dgps_with_iwvi_torch.training import natgrad as tng

RTOL = 1e-9
N, B, D_X, M, K = 64, 32, 3, 16, 4
ARGS = dict(configuration="LGG", mode="IW", num_inducing=M, num_iw_samples=K)


def _t(a, requires_grad=False):
    return torch.from_numpy(np.array(a, copy=True)).requires_grad_(
        requires_grad)


def _close(port, ref, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=rtol, atol=atol)


def _vjp_both(jfn, tfn, args, cot, rtol=RTOL):
    """Values and vjps of the reference and the port on the same inputs
    (float64 numpy arrays) and cotangent(s)."""
    jout, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in args))
    targs = [_t(a, True) for a in args]
    tout = tfn(*targs)
    jouts = jout if isinstance(jout, tuple) else (jout,)
    touts = tout if isinstance(tout, tuple) else (tout,)
    cots = cot if isinstance(cot, tuple) else (cot,)
    for p, r in zip(touts, jouts):
        _close(p, r, rtol)
    jgrads = vjp(tuple(jnp.asarray(c) for c in cots)
                 if isinstance(jout, tuple) else jnp.asarray(cots[0]))
    tgrads = torch.autograd.grad(
        sum(torch.sum(o * _t(c)) for o, c in zip(touts, cots)), targs,
        allow_unused=True)
    for p, r in zip(tgrads, jgrads):
        r = np.asarray(r)
        _close(p if p is not None else torch.zeros(r.shape), r, rtol,
               atol=1e-13 * float(np.max(np.abs(r)) + 1e-300))


# ---------------------------------------------------------------- per op


def test_rbf_gram_kres_values_and_vjp():
    rng = np.random.default_rng(0)
    Xs = rng.standard_normal((M, D_X))
    X2s = rng.standard_normal((K, B, D_X))
    X2s[0, 0] = Xs[0]              # a clamped distance: K == var there
    var = np.asarray(1.3)
    g = rng.standard_normal((K, M, B))
    _vjp_both(jkern._rbf_gram_kres, tkern.RbfGramKres.apply,
              (Xs, X2s, var), g)


def test_gram_residual_size_rule():
    """The reference's rule: f32 and >= 4 MB take the residual path, whose
    values equal the plain path's."""
    kp = tparams.params_from_numpy(
        {"raw_variance": np.asarray(0.4, np.float32),
         "raw_lengthscales": np.full(3, 0.8, np.float32)}, "cpu")
    Z = torch.randn(128, 3, generator=torch.Generator().manual_seed(0))
    F = torch.randn(20, 512, 3, generator=torch.Generator().manual_seed(1))
    assert tkern._use_kuf_residual(Z, F)
    assert not tkern._use_kuf_residual(Z, F[:2])
    assert not tkern._use_kuf_residual(Z.double(), F.double())
    ls = tkern.kernel_lengthscales(kp)
    torch.testing.assert_close(
        tkern.K(kp, Z, F), tkern.kernel_variance(kp) * torch.exp(
            -0.5 * tkern.scaled_squared_distance(Z, F, ls)), rtol=0, atol=0)


def test_chol_and_inverse_vjp():
    rng = np.random.default_rng(1)
    A = rng.standard_normal((2, M, M))
    Kmat = A @ np.swapaxes(A, -1, -2) + M * np.eye(M)
    cot = (rng.standard_normal((2, M, M)), rng.standard_normal((2, M, M)))
    _vjp_both(lambda k: jlinalg.chol_and_inverse(k, 1e-6, 4),
              lambda k: tlinalg.chol_and_inverse(k, 1e-6, 4), (Kmat,), cot)


def test_cho_solve_and_log_det():
    rng = np.random.default_rng(2)
    L = np.tril(rng.standard_normal((3, M, M))) + 4 * np.eye(M)
    Bm = rng.standard_normal((3, M, 5))
    _close(tlinalg.cho_solve(_t(L), _t(Bm)),
           jlinalg.cho_solve(jnp.asarray(L), jnp.asarray(Bm)))
    _close(tlinalg.log_det_from_chol(_t(L)),
           jlinalg.log_det_from_chol(jnp.asarray(L)))


@pytest.mark.parametrize("xs,ys", [((M, M), (K, M, B)), ((K, B, M), (M, 3))])
@pytest.mark.parametrize("fwd,bwd", [("high", "default"), ("default", None)])
def test_classed_matmul_vjp(xs, ys, fwd, bwd):
    """f64 passes through every class: the split-precision matmul's value
    and both broadcast-reduced cotangents equal the reference's."""
    rng = np.random.default_rng(3)
    x, y = rng.standard_normal(xs), rng.standard_normal(ys)
    out_shape = np.broadcast_shapes(xs[:-2], ys[:-2]) + (xs[-2], ys[-1])
    g = rng.standard_normal(out_shape)
    jp = jcond._var_prec
    _vjp_both(lambda a, b: jcond.matmul_split_precision(
        a, b, jp(fwd), jp(bwd if bwd else fwd)),
        lambda a, b: tprec.matmul(a, b, fwd, bwd), (x, y), g)


def test_classed_matmul_backward_class_in_f32():
    """In f32 the cotangent dots run at the backward class: 'default'
    rounds both operands to bf16."""
    rng = np.random.default_rng(4)
    x = _t(rng.standard_normal((8, 64)).astype(np.float32), True)
    y = _t(rng.standard_normal((64, 16)).astype(np.float32))
    g = _t(rng.standard_normal((8, 16)).astype(np.float32))
    (dx,) = torch.autograd.grad(
        torch.sum(tprec.matmul(x, y, "high", "default") * g), (x,))
    ref = tprec.round_bf16(g) @ tprec.round_bf16(y).T
    torch.testing.assert_close(dx, ref, rtol=1e-6, atol=1e-6)


def test_kls_and_carried_logdet():
    rng = np.random.default_rng(5)
    q_mu = rng.standard_normal((M, 2))
    L = np.tril(0.3 * rng.standard_normal((2, M, M))) + np.eye(M)
    S = L @ np.swapaxes(L, -1, -2)
    _vjp_both(jkl.gauss_kl_white, tkl.gauss_kl_white, (q_mu, L),
              np.asarray(1.7))
    logdet = np.linalg.slogdet(S)[1]
    Sinv = np.linalg.inv(S)
    jout, vjp = jax.vjp(lambda m, s: jkl.gauss_kl_white_cov(
        m, s, jnp.asarray(logdet), jnp.asarray(Sinv)), jnp.asarray(q_mu),
        jnp.asarray(S))
    tm, tS = _t(q_mu, True), _t(S, True)
    tout = tkl.gauss_kl_white_cov(tm, tS, _t(logdet), _t(Sinv))
    _close(tout, jout)
    for p, r in zip(torch.autograd.grad(1.7 * tout, (tm, tS)),
                    vjp(jnp.asarray(1.7))):
        _close(p, r)
    # the carried value equals the root-form KL of the same q
    _close(tout, jkl.gauss_kl_white(jnp.asarray(q_mu), jnp.asarray(L)))
    s = rng.uniform(0.2, 1.5, (M, 2))
    _vjp_both(jkl.gauss_kl_white_diag, tkl.gauss_kl_white_diag, (q_mu, s),
              np.asarray(0.9))
    _vjp_both(jkl.gauss_kl_white_diagvar, tkl.gauss_kl_white_diagvar,
              (q_mu, s * s), np.asarray(0.9))
    mu, lv = rng.standard_normal((K, B, 2)), rng.standard_normal((K, B, 2))
    x = rng.standard_normal((K, B, 2))
    _vjp_both(jkl.gauss_kl_diag_white, tkl.gauss_kl_diag_white, (mu, lv),
              rng.standard_normal((K, B)))
    _vjp_both(jkl.diag_gaussian_logpdf, tkl.diag_gaussian_logpdf,
              (x, mu, lv), rng.standard_normal((K, B)))
    _vjp_both(jkl.std_gaussian_logpdf, tkl.std_gaussian_logpdf, (x,),
              rng.standard_normal((K, B)))


def test_gaussian_variational_expectations_and_log_prob():
    rng = np.random.default_rng(6)
    m, v = rng.standard_normal((K, B, 1)), rng.uniform(0.1, 2, (K, B, 1))
    y, raw = rng.standard_normal((B, 1)), np.asarray(-1.3)
    _vjp_both(lambda r, a, b: jlik.variational_expectations(
        {"raw_noise_variance": r}, a, b, jnp.asarray(y)),
        lambda r, a, b: tlik.dispatch_variational_expectations(
            {"raw_noise_variance": r}, a, b, _t(y)),
        (raw, m, v), rng.standard_normal((K, B)))
    _vjp_both(lambda r, a: jlik.log_prob({"raw_noise_variance": r}, a,
                                         jnp.asarray(y)),
              lambda r, a: tlik.log_prob({"raw_noise_variance": r}, a, _t(y)),
              (raw, m), rng.standard_normal((K, B)))


@pytest.mark.parametrize("amortized", [True, False])
def test_lv_posterior_propagate(amortized):
    rng = np.random.default_rng(7)
    cfg_kw = dict(d_w=2, d_in=D_X, d_y=1, encoder_hidden=(6, 5),
                  amortized=amortized, num_data=N)
    jcfg = jlayers.LVLayerConfig(**cfg_kw)
    tcfg = tlayers.LVLayerConfig(**cfg_kw)
    p = jax.device_get(jlayers.lv_layer_init(jax.random.PRNGKey(0), jcfg,
                                             jnp.float64))
    p = jax.tree.map(lambda a: a + 0.3 * rng.standard_normal(a.shape), p)
    leaves, tree = jax.tree.flatten(p)
    X0, Y = rng.standard_normal((B, D_X)), rng.standard_normal((B, 1))
    F = rng.standard_normal((K, B, D_X))
    idx = rng.integers(0, N, B)
    key = jax.random.PRNGKey(3)
    eps = np.asarray(jax.random.normal(key, (K, B, 2), jnp.float64))

    def jfn(*ls):
        return jlayers.lv_layer_propagate(
            jax.tree.unflatten(tree, ls), jcfg, jnp.asarray(F), key,
            mode="posterior", X0=jnp.asarray(X0), Y=jnp.asarray(Y),
            data_idx=jnp.asarray(idx))

    def tfn(*ls):
        tp = jax.tree.unflatten(tree, list(ls))
        return tlayers.lv_layer_propagate(
            tp, tcfg, _t(F), mode="posterior", X0=_t(X0), Y=_t(Y),
            data_idx=torch.from_numpy(idx), eps=_t(eps))

    cot = (rng.standard_normal((K, B, D_X + 2)),
           rng.standard_normal((K, B)), rng.standard_normal(B))
    _vjp_both(jfn, tfn, leaves, cot)


# ---------------------------------------------------------- whole slice


@pytest.fixture(scope="module")
def reference():
    """(X, Y, JAX config, JAX params as numpy) in float64, q(u) random."""
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
    return X, Y, config, params


def _cast(tree, dtype):
    return jax.tree.map(lambda a: np.asarray(a, dtype), tree)


def _noise(key, lead, dtype, d_inner):
    """The reference's per-layer draws of one objective call."""
    w = jax.random.normal(jax.random.fold_in(key, 0), (lead, B, 1), dtype)
    e = jax.random.normal(jax.random.fold_in(key, 1), (lead, B, d_inner),
                          dtype)
    return [torch.from_numpy(np.array(w)), torch.from_numpy(np.array(e)),
            None]


def _port(jparams, dtype, objective="iw", n=N, **kw):
    args = dict(ARGS, mode="IW" if objective == "iw" else "VI", **kw)
    config = build_config(BuildArgs(**args), D_X, 1, n)
    return config, tparams.params_from_numpy(_cast(jparams, dtype), "cpu")


def _jconfig(jconfig, objective, **kw):
    import dataclasses
    return dataclasses.replace(jconfig, objective=objective, **kw)


def _leaf_pairs(tree_t, tree_j):
    lt, lj = jax.tree.leaves(tree_t), jax.tree.leaves(tree_j)
    assert jax.tree.structure(tparams.params_to_numpy(tree_t)) == \
        jax.tree.structure(jax.device_get(tree_j))
    return list(zip(lt, lj))


@pytest.mark.parametrize("objective", ["iw", "vi"])
def test_elbo_and_gradient_match_reference(reference, objective):
    X, Y, jconfig, jparams = reference
    jcfg = _jconfig(jconfig, objective, num_samples=K)
    config, params = _port(jparams, np.float64, objective, num_samples=K)
    key = jax.random.PRNGKey(5)
    jp = jax.tree.map(jnp.asarray, jparams)
    jval, jgrad = jax.jit(jax.value_and_grad(
        lambda p: jdgp.elbo(p, jcfg, jnp.asarray(X[:B]), jnp.asarray(Y[:B]),
                            key)))(jp)
    leaves = [t.requires_grad_() for t in jax.tree.leaves(params)]
    val = elbo(params, config, _t(X[:B]), _t(Y[:B]),
               eps=_noise(key, K, jnp.float64, 3))
    _close(val, jval)
    grads = torch.autograd.grad(val, leaves, allow_unused=True)
    for g, r in zip(grads, jax.tree.leaves(jgrad)):
        r = np.asarray(r)
        _close(torch.zeros(r.shape) if g is None else g, r,
               atol=1e-12 * float(np.max(np.abs(r)) + 1e-300))


def test_iw_with_one_sample_equals_vi(reference):
    """Under the same draws, IW(K=1) - VI(S=1) = (N/B) sum_n (log_w_n +
    local_kl_n): the sampled and the analytic latent KL. Without latent
    layers both are zero and the bounds are equal, as the reference pins
    it (tests/test_models.py)."""
    X, Y, _, jparams = reference
    cfg_iw, params = _port(jparams, np.float64, "iw", num_iw_samples=1)
    cfg_vi, _ = _port(jparams, np.float64, "vi", num_samples=1)
    eps = _noise(jax.random.PRNGKey(6), 1, jnp.float64, 3)
    Xb, Yb = _t(X[:B]), _t(Y[:B])
    iw = elbo(params, cfg_iw, Xb, Yb, eps=eps)
    vi = elbo(params, cfg_vi, Xb, Yb, eps=eps)
    _, _, log_w, local_kl = propagate(params, cfg_iw, Xb, (1,),
                                      lv_mode="posterior", Y=Yb, eps=eps)
    torch.testing.assert_close(
        iw - vi, N / B * torch.sum(log_w[0] + local_kl), rtol=1e-10, atol=0)
    cfgs = [build_config(BuildArgs(configuration="GG", mode=mode,
                                   num_inducing=M, num_iw_samples=1,
                                   num_samples=1), D_X, 1, N)
            for mode in ("IW", "VI")]
    pg = init_dgp(torch.Generator().manual_seed(0), cfgs[0],
                  dtype=torch.float64, device="cpu")
    e = [eps[1], None]
    a, b = (elbo(pg, c, Xb, Yb, eps=e) for c in cfgs)
    torch.testing.assert_close(a, b, rtol=1e-12, atol=0)


def _jax_draws(key, n_rows, batch, lead, d_inner, dtype=jnp.float64):
    """idx and eps of the reference's step_fn for one key (joint schedule
    takes kb1/ke1, the alternating one also kb2/ke2)."""
    kb1, kb2, ke1, ke2 = jax.random.split(key, 4)
    out = []
    for kb, ke in ((kb1, ke1), (kb2, ke2)):
        idx = (np.arange(n_rows) if batch >= n_rows else
               np.asarray(jax.random.randint(kb, (batch,), 0, n_rows)))
        b = min(batch, n_rows)
        w = jax.random.normal(jax.random.fold_in(ke, 0), (lead, b, 1), dtype)
        e = jax.random.normal(jax.random.fold_in(ke, 1), (lead, b, d_inner),
                              dtype)
        out.append((torch.from_numpy(np.array(idx)),
                    [torch.from_numpy(np.array(w)),
                     torch.from_numpy(np.array(e)), None]))
    return out


def _state_close(state, jstate, rtol, atol):
    ours = tparams.state_to_numpy(state)
    ref = jax.device_get({"rest": jstate.rest, "natvars": jstate.natvars})
    assert jax.tree.structure(ours) == jax.tree.structure(ref)
    for t, j in zip(jax.tree.leaves(ours), jax.tree.leaves(ref)):
        np.testing.assert_allclose(t, j, rtol=rtol, atol=atol)


def _run_both(reference, tc_kw, steps, schedule="joint", batch=B):
    X, Y, jconfig, jparams = reference
    jtc = JTrainConfig(**tc_kw, schedule=schedule, minibatch_size=batch)
    tc = TrainConfig(**tc_kw, schedule=schedule, minibatch_size=batch)
    jinit, jstep, _, _ = jmake_trainer(jconfig, jtc)
    jstep = jax.jit(jstep)
    jstate = jinit(jax.tree.map(jnp.asarray, jparams))
    config, params = _port(jparams, np.float64)
    init, step, _, _ = make_trainer(config, tc)
    state = init(params)
    Xj, Yj, Xt, Yt = jnp.asarray(X), jnp.asarray(Y), _t(X), _t(Y)
    for s in range(steps):
        key = jax.random.fold_in(jax.random.PRNGKey(11), s)
        jstate, jloss = jstep(jstate, Xj, Yj, key)
        (i1, e1), (i2, e2) = _jax_draws(key, N, batch, K, 3)
        if schedule == "alternating":
            state, loss = step(state, Xt, Yt, idx=(i1, i2), eps=(e1, e2))
        else:
            state, loss = step(state, Xt, Yt, idx=i1, eps=e1)
    return state, jstate, loss, jloss


def test_fifty_joint_steps_track_reference(reference):
    state, jstate, loss, jloss = _run_both(
        reference, dict(lr=5e-3, gamma=1e-2, natgrad="final"), 50)
    assert state.step == 50
    _close(loss, jloss, rtol=1e-8)
    _state_close(state, jstate, rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("schedule,batch", [("alternating", B),
                                            ("joint", N)])
def test_alternating_and_full_batch_steps(reference, schedule, batch):
    """One alternating step (natgrad on batch 1, Adam on batch 2) and one
    full-batch step (B >= N: the whole set, escalated to the exact class)
    equal the reference's."""
    state, jstate, loss, jloss = _run_both(
        reference, dict(lr=5e-3, gamma=1e-2, natgrad="final"), 1, schedule,
        batch)
    _close(loss, jloss)
    _state_close(state, jstate, rtol=RTOL, atol=1e-13)


def test_one_step_in_f32_at_the_bf16_class(reference):
    """float32: the port's loss and gradients at the initial state against
    the reference's (which does the q-variance and solve dots in full f32
    on the CPU). Measured: 8.7e-5 relative on the loss and at most 8.8e-3
    of each leaf's largest gradient; bounds 1e-3 and 2e-2 (the latter the
    reference's own bf16-class tolerance,
    tests/test_pallas_epilogue.py:115-117)."""
    X, Y, jconfig, jparams = reference
    X32, Y32 = X.astype(np.float32), Y.astype(np.float32)
    jp32 = jax.tree.map(jnp.asarray, _cast(jparams, np.float32))
    jtc = JTrainConfig(natgrad="final", minibatch_size=B)
    jinit, _, _, _ = jmake_trainer(jconfig, jtc)
    jstate = jinit(jp32)
    key = jax.random.PRNGKey(12)
    (idx, eps), _ = _jax_draws(key, N, B, K, 3, jnp.float32)
    kb1, _, ke1, _ = jax.random.split(key, 4)
    layer_ids = jng.natgrad_layer_ids(jconfig, "final")

    def jloss(nv, rest):
        p = jng.insert_natvars(rest, nv, layer_ids)
        return -jdgp.elbo(p, jconfig, jnp.asarray(X32)[idx.numpy()],
                          jnp.asarray(Y32)[idx.numpy()], ke1,
                          data_idx=jnp.asarray(idx.numpy()))

    jl, (jg_nat, jg_rest) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1)))(jstate.natvars, jstate.rest)
    config, params = _port(jparams, np.float32)
    tc = TrainConfig(natgrad="final", minibatch_size=B)
    state = make_trainer(config, tc)[0](params)
    loss, g_nat, g_rest = loss_and_grads(
        config, tc, state, _t(X32), _t(Y32), idx=idx,
        eps=eps)
    assert loss.dtype == torch.float32
    _close(loss, jl, rtol=1e-3)
    for t, j in (_leaf_pairs(g_rest, jg_rest)
                 + [(g_nat[0][k], jg_nat[0][k]) for k in ("q_mu", "q_S")]):
        j = np.asarray(j)
        _close(t, j, rtol=0, atol=2e-2 * float(np.max(np.abs(j))) + 1e-30)


def test_natgrad_indefinite_block_skip_matches_reference():
    """A gamma large enough to make P indefinite in one output block keeps
    that block's (m, S, Sinv, logdet); the other block updates. Both as
    the reference does."""
    rng = np.random.default_rng(8)
    L = np.tril(0.2 * rng.standard_normal((2, M, M))) + np.eye(M)
    params = {"layers": [{"q_mu": rng.standard_normal((M, 2)),
                          "q_sqrt": L}]}
    jnv = jng.extract_natvars(jax.tree.map(jnp.asarray, params), (0,))
    tnv = tng.extract_natvars(tparams.params_from_numpy(params, "cpu"), (0,))
    for k in jnv[0]:
        _close(tnv[0][k], jnv[0][k])
    G = rng.standard_normal((2, M, M))
    G[0] = -G[0] @ G[0].T - 5.0 * np.eye(M)      # block 0: indefinite P
    G[1] = 0.01 * G[1] @ G[1].T                  # block 1: P stays SPD
    grads = {"q_mu": rng.standard_normal((M, 2)), "q_S": G}
    gamma = 50.0
    jnew = jng.natgrad_update(jnv, [jax.tree.map(jnp.asarray, grads)], gamma)
    tnew = tng.natgrad_update(tnv, [tparams.params_from_numpy(grads, "cpu")],
                              gamma)
    for k in jnew[0]:
        _close(tnew[0][k], jnew[0][k], atol=1e-12)
    torch.testing.assert_close(tnew[0]["q_S"][0], tnv[0]["q_S"][0], rtol=0,
                               atol=0)
    assert not torch.equal(tnew[0]["q_S"][1], tnv[0]["q_S"][1])
    back = tng.natvars_to_canonical(tnew, {"layers": [{}]}, (0,))
    jback = jng.natvars_to_canonical(jnew, {"layers": [{}]}, (0,))
    _close(back["layers"][0]["q_sqrt"], jback["layers"][0]["q_sqrt"],
           atol=1e-12)


def test_state_numpy_round_trip(reference):
    _, _, _, jparams = reference
    config, params = _port(jparams, np.float64)
    init = make_trainer(config, TrainConfig(natgrad="final"))[0]
    a, b = init(params), init(params)
    arrays = tparams.state_to_numpy(a)
    arrays["natvars"][0]["q_mu"] = arrays["natvars"][0]["q_mu"] + 1.0
    tparams.state_from_numpy(b, arrays)
    back = tparams.state_to_numpy(b)
    for x, y in zip(jax.tree.leaves(arrays), jax.tree.leaves(back)):
        np.testing.assert_array_equal(x, y)


def test_fit_callback_cadence_and_mesh(reference, tmp_path):
    """fit's callback after every chunk, unsharded and under a mesh (here
    a gloo world of one rank, made and destroyed in this test)."""
    X, Y, _, jparams = reference
    config, params = _port(jparams, np.float32)
    tc = TrainConfig(natgrad="final", minibatch_size=B, iterations=6,
                     steps_per_call=3)
    X32, Y32 = _t(X.astype(np.float32)), _t(Y.astype(np.float32))
    seen = []
    out, state = fit(torch.Generator().manual_seed(0), config, params,
                     X32, Y32, tc,
                     callback=lambda s, loss, st: seen.append((s, loss)))
    assert [s for s, _ in seen] == [3, 6] and state.step == 6
    assert all(np.isfinite(loss) for _, loss in seen)
    assert out["layers"][2]["q_sqrt"].shape == (1, M, M)

    import torch.distributed as dist

    from dgps_with_iwvi_torch.parallel import make_mesh

    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        seen.clear()
        out, state = fit(torch.Generator().manual_seed(0), config, params,
                         X32, Y32, tc, mesh=make_mesh(device="cpu"),
                         callback=lambda s, loss, st: seen.append((s, loss)))
    finally:
        dist.destroy_process_group()
    assert [s for s, _ in seen] == [3, 6] and state.step == 6
    assert all(np.isfinite(loss) for _, loss in seen)
    assert out["layers"][2]["q_sqrt"].shape == (1, M, M)


def test_training_imports_no_jax():
    code = ("import sys, dgps_with_iwvi_torch.training;"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'dgps_with_iwvi_tpu'))];"
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr



@pytest.mark.parametrize("gamma,gamma_start,warmup", [
    (1e-2, 1e-4, 5), (0.5, 1e-4, 500), (0.05, 1e-3, 7)])
def test_gamma_schedule_matches_reference_at_float32_rounding(
        gamma, gamma_start, warmup):
    """The reference computes the warm-up fraction of its int32 step in
    float32 (dgps_with_iwvi_tpu/training/train.py:167) and returns a
    float32 step size; the port computes in float64. They agree within
    three float32 roundings (the fraction, the product, the sum; measured
    at most 1.24 units), at every step of the warm-up and after it."""
    from dgps_with_iwvi_tpu.training.train import gamma_schedule as jgamma

    from dgps_with_iwvi_torch.training import gamma_schedule

    kw = dict(gamma=gamma, gamma_start=gamma_start, gamma_warmup=warmup)
    for step in list(range(12)) + [warmup - 1, warmup, 2 * warmup]:
        ref = float(jgamma(JTrainConfig(**kw), jnp.int32(step)))
        ours = gamma_schedule(TrainConfig(**kw), step)
        assert abs(ours - ref) <= 3 * 2.0 ** -24 * ref, (step, ours, ref)


def test_ten_steps_with_gamma_warmup_track_reference(reference):
    """Ten f64 LGG steps with gamma_warmup=5 against the reference's
    trainer on its draws. The reference's float32 warm-up fraction (test
    above) gives steps 1-4 a step size up to 7.4e-8 relative off the
    exact one, which moves the natgrad block by up to 5.6e-6 of an
    element (2.6e-8 absolute, in q_Sinv) over the ten steps: each state
    leaf is held within 1e-6 of its largest value (measured 8.3e-9), the
    loss at rtol 1e-8 (measured 4.3e-10)."""
    state, jstate, loss, jloss = _run_both(
        reference, dict(lr=5e-3, gamma=1e-2, natgrad="final",
                        gamma_warmup=5), 10)
    assert state.step == 10
    _close(loss, jloss, rtol=1e-8)
    ours = tparams.state_to_numpy(state)
    ref = jax.device_get({"rest": jstate.rest, "natvars": jstate.natvars})
    assert jax.tree.structure(ours) == jax.tree.structure(ref)
    for t, j in zip(jax.tree.leaves(ours), jax.tree.leaves(ref)):
        j = np.asarray(j)
        np.testing.assert_allclose(
            t, j, rtol=0, atol=1e-6 * float(np.max(np.abs(j)) + 1e-300))
