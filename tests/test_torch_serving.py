"""The whole serving slice of the port against the JAX reference.

The reference builds LGG (d_x=3, M=16); its weights carry over to the port
with ``params_from_numpy`` and its own noise draws — w from
``normal(fold_in(key, 0), (S, B, d_w))`` and the inner layer's sample
noise from ``normal(fold_in(key, 1), mean.shape)`` — are injected as
``eps``. q(u) is randomized so every term of the variance matters.

float64: every precision class is exact on both sides, so mix_mean,
mix_var and the log-density agree at rtol 1e-9.
float32: the port rounds what the TPU rounds (q-variance operands to
bf16, the solve path and the mean at bf16x3), while the reference on the
CPU runs those dots in full f32. Measured gaps: ~7e-4 absolute on the
mean and the log-density, ~2e-3 relative on the variance; the
tolerances below (5e-3 absolute, 1e-2 relative) sit a few times above
them and far below any modelling difference.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgps_with_iwvi_tpu import serving as jserving
from dgps_with_iwvi_tpu.models import BuildArgs as JBuildArgs
from dgps_with_iwvi_tpu.models import build_model as jbuild_model
from dgps_with_iwvi_tpu.models import \
    predict_y_and_log_density as jpredict
from dgps_with_iwvi_torch import params as tparams
from dgps_with_iwvi_torch import serving as tserving
from dgps_with_iwvi_torch.models import (BuildArgs, LatentVarMode,
                                         build_config, build_model,
                                         predict_f, predict_log_density,
                                         predict_y, predict_y_and_log_density)

B, D_X, M, S = 32, 3, 16, 4
ARGS = dict(configuration="LGG", mode="IW", num_inducing=M,
            num_iw_samples=20)


@pytest.fixture(scope="module")
def reference():
    """(X, Y, JAX config, JAX params as numpy) in float64."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((B, D_X))
    Y = np.sin(X[:, :1]) + 0.1 * rng.standard_normal((B, 1))
    config, params = jbuild_model(jax.random.PRNGKey(0), JBuildArgs(**ARGS),
                                  jnp.asarray(X), jnp.asarray(Y))
    params = jax.device_get(params)
    for i in (1, 2):
        lp = params["layers"][i]
        lp["q_mu"] = 0.5 * rng.standard_normal(lp["q_mu"].shape)
        lp["q_sqrt"] = (np.tril(0.3 * rng.standard_normal(lp["q_sqrt"].shape))
                        + 0.5 * np.eye(M))
    return X, Y, config, params


def _cast(tree, dtype):
    return jax.tree.map(lambda a: np.asarray(a, dtype), tree)


def _jax_noise(key, dtype, d_inner):
    w = jax.random.normal(jax.random.fold_in(key, 0), (S, B, 1), dtype)
    e = jax.random.normal(jax.random.fold_in(key, 1), (S, B, d_inner), dtype)
    return [torch.from_numpy(np.array(w)), torch.from_numpy(np.array(e)), None]


def _port(params_np, dtype):
    config = build_config(BuildArgs(**ARGS), D_X, 1, B)
    return config, tparams.params_from_numpy(_cast(params_np, dtype), "cpu")


TOLS = {np.float64: dict(rtol=1e-9, atol=0.0),
        np.float32: dict(rtol=1e-2, atol=5e-3)}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_predict_y_and_log_density_matches_reference(reference, dtype):
    X, Y, jconfig, jparams = reference
    X, Y, jp = X.astype(dtype), Y.astype(dtype), _cast(jparams, dtype)
    key = jax.random.PRNGKey(7)
    f = jax.jit(lambda p, x, y, k: jpredict(p, jconfig, x, y, k, S))
    (jm, jv), jld = f(jp, jnp.asarray(X), jnp.asarray(Y), key)
    config, params = _port(jparams, dtype)
    eps = _jax_noise(key, dtype, config.layers[1].d_out)
    (m, v), ld = predict_y_and_log_density(
        params, config, torch.from_numpy(X), torch.from_numpy(Y), None, S,
        eps=eps)
    for port, ref in ((m, jm), (v, jv), (ld, jld)):
        assert port.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
        np.testing.assert_allclose(port.numpy(), np.asarray(ref),
                                   **TOLS[dtype])


def test_predict_y_and_log_density_equals_the_separate_calls(reference):
    X, Y, _, jparams = reference
    config, params = _port(jparams, np.float64)
    eps = _jax_noise(jax.random.PRNGKey(3), np.float64, 3)
    Xt, Yt = torch.from_numpy(X), torch.from_numpy(Y)
    (m, v), ld = predict_y_and_log_density(params, config, Xt, Yt, None, S,
                                           eps=eps)
    m2, v2 = predict_y(params, config, Xt, None, S, eps=eps)
    ld2 = predict_log_density(params, config, Xt, Yt, None, S, eps=eps)
    for a, b in ((m, m2), (v, v2), (ld, ld2)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_given_latents_equal_prior_draws_of_the_same_noise(reference):
    """GIVEN mode with w fixed to the noise a PRIOR draw would use gives
    the same moments: the two modes differ only in where w comes from."""
    X, _, _, jparams = reference
    config, params = _port(jparams, np.float64)
    eps = _jax_noise(jax.random.PRNGKey(4), np.float64, 3)
    Xt = torch.from_numpy(X)
    prior = predict_f(params, config, Xt, None, S, eps=eps)
    given = predict_f(params, config, Xt, None, S,
                      lv_mode=LatentVarMode.GIVEN, ws_given=[eps[0]],
                      eps=[None] + eps[1:])
    for a, b in zip(prior, given):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _stats(X, Y):
    return dict(x_mean=(X.mean(0, keepdims=True) + 1.5).astype(np.float32),
                x_std=(2.0 * X.std(0, keepdims=True)).astype(np.float32),
                y_mean=np.full((1, 1), -0.7, np.float32),
                y_std=np.full((1, 1), 3.0, np.float32))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_scorer_fn_with_stats_matches_reference(reference, dtype):
    X, Y, jconfig, jparams = reference
    st = _stats(X, Y)
    raw_X = (X * st["x_std"] + st["x_mean"]).astype(dtype)
    raw_Y = (Y * st["y_std"] + st["y_mean"]).astype(dtype)
    jscore = jserving.make_scorer_fn(_cast(jparams, dtype), jconfig, S,
                                     jserving.NormalizationStats(**st))
    jm, jv, jld = jax.jit(jscore)(jnp.asarray(raw_X), jnp.asarray(raw_Y), 5)
    config, params = _port(jparams, dtype)
    score = tserving.make_scorer_fn(params, config, S,
                                    tserving.NormalizationStats(**st),
                                    device="cpu")
    eps = _jax_noise(jax.random.PRNGKey(5), dtype, 3)
    m, v, ld = score(torch.from_numpy(raw_X), torch.from_numpy(raw_Y), 5,
                     eps=eps)
    tol = dict(TOLS[dtype])
    if dtype == np.float32:
        tol["atol"] *= 9.0  # var scales by y_std^2 = 9
    for port, ref in ((m, jm), (v, jv), (ld, jld)):
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), **tol)


def test_scorer_batches_pad_and_seed_per_batch(reference):
    X, Y, _, jparams = reference
    config, params = _port(jparams, np.float32)
    st = tserving.NormalizationStats(**_stats(X, Y))
    scorer = tserving.Scorer(params, config, S, st, device="cpu")
    X32, Y32 = X.astype(np.float32), Y.astype(np.float32)
    out = scorer.score(X32[:20], Y32[:20], seed=9, max_batch=12)
    assert out["mean"].shape == (20, 1) and out["log_density"].shape == (20,)
    assert all(np.all(np.isfinite(a)) for a in out.values())
    # batch i scores rows [12 i, 12 i + 12) padded to 12 with seed 9 + i
    score = tserving.make_scorer_fn(params, config, S, st, device="cpu")
    xb = np.concatenate([X32[12:20], np.zeros((4, D_X), np.float32)])
    yb = np.concatenate([Y32[12:20], np.zeros((4, 1), np.float32)])
    m, v, ld = score(torch.from_numpy(xb), torch.from_numpy(yb), 10)
    np.testing.assert_array_equal(out["mean"][12:], m[:8].numpy())
    np.testing.assert_array_equal(out["log_density"][12:], ld[:8].numpy())
    no_y = scorer.score(X32[:5], seed=9, max_batch=12)
    assert set(no_y) == {"mean", "var"}
    with pytest.raises(ValueError, match="X must be"):
        scorer.score(X32[:, :2])


def test_port_builds_and_scores_lgg_on_cpu():
    rng = np.random.default_rng(1)
    X = rng.standard_normal((64, D_X)).astype(np.float32)
    Y = np.sin(X[:, :1]).astype(np.float32)
    config, params = build_model(0, BuildArgs(**ARGS), X, Y, device="cpu")
    assert [type(c).__name__ for c in config.layers] == [
        "LVLayerConfig", "GPLayerConfig", "GPLayerConfig"]
    assert params["layers"][1]["q_sqrt"].shape == (3, M, M)
    assert params["layers"][1]["mean_W"].shape == (4, 3)
    gen = torch.Generator().manual_seed(0)
    (m, v), ld = predict_y_and_log_density(
        params, config, torch.from_numpy(X), torch.from_numpy(Y), gen, S)
    assert m.shape == (64, 1) and v.shape == (64, 1) and ld.shape == (64,)
    assert bool(torch.all(torch.isfinite(ld))) and bool(torch.all(v > 0))


def test_port_imports_no_jax():
    """Every module of the package, found by walking it, imports no JAX
    and nothing of the reference package."""
    code = ("import importlib, pkgutil, sys, dgps_with_iwvi_torch as p;"
            "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
            "p.__name__ + '.')];"
            "[importlib.import_module(m) for m in mods];"
            "assert len(mods) > 20, mods;"
            "assert {'dgps_with_iwvi_torch.serving', "
            "'dgps_with_iwvi_torch.experiments.serve', "
            "'dgps_with_iwvi_torch.ops.features', "
            "'dgps_with_iwvi_torch.ops.priors', "
            "'dgps_with_iwvi_torch.parallel.sharding', "
            "'dgps_with_iwvi_torch.utils.flops', "
            "'dgps_with_iwvi_torch.experiments.quality_gate', "
            "'dgps_with_iwvi_torch.demos.toy_1d', "
            "'dgps_with_iwvi_torch.demos.multitask_icm'} <= set(mods), mods;"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'dgps_with_iwvi_tpu'))];"
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_entry_points_default_to_cuda(reference, monkeypatch):
    """Without device=, an entry point asks for CUDA and raises where
    there is none: no silent CPU path."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, Y, _, jparams = reference
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(0, BuildArgs(**ARGS), X, Y)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tparams.params_from_numpy(jparams)
    config, params = _port(jparams, np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserving.Scorer(params, config, S)
