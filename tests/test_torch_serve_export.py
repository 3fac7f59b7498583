"""The port's exported scorer (``serving.export_scorer`` / ``save_scorer``
/ ``load_scorer`` / ``ServingArtifact``) on the CPU, mirroring the
reference's tests/test_export.py on a tiny LGG (d_x=3, M=8, S=5, B=16,
random q(u), float32).

The artifact is ``make_scorer_fn`` traced with its noise drawn inside the
program (``artifact_noise``: the port's Philox stream under the seed), so
it is held to the live function fed the same draws as ``eps``. Both run
the same ops on the same device; export keeps them, so the outputs agree
to f32 rounding (1e-6 relative; bitwise where torch runs the ops alike).
Batches of another size round the same rows differently (another
blocking of the same products): 1e-5 of max|value| between a polymorphic
and a fixed-batch artifact. The narrow transports are held to one unit of
their format, as in the reference. One float64 case ties the function the
artifact closes over to the reference's scorer, its draws injected.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgps_with_iwvi_tpu import serving as jserving
from dgps_with_iwvi_tpu.models import BuildArgs as JBuildArgs
from dgps_with_iwvi_tpu.models import build_model as jbuild_model
from dgps_with_iwvi_torch import params as tparams
from dgps_with_iwvi_torch.models import BuildArgs, build_config, build_model
from dgps_with_iwvi_torch.models.dgp import prefactor_gp_layers
from dgps_with_iwvi_torch.ops.hopper import build as hbuild
from dgps_with_iwvi_torch.serving import (NormalizationStats, ServingArtifact,
                                          artifact_noise, export_scorer,
                                          load_scorer, make_scorer_fn,
                                          save_scorer)

D_X, M, S, B = 3, 8, 5, 16
ARGS = dict(configuration="LGG", mode="IW", num_inducing=M,
            num_iw_samples=3)
STATS = NormalizationStats(
    x_mean=np.asarray([[0.3, -1.2, 2.0]], np.float32),
    x_std=np.asarray([[0.7, 1.5, 1.1]], np.float32),
    y_mean=np.asarray([[2.5]], np.float32),
    y_std=np.asarray([[3.0]], np.float32))


def _random_q(params, rng):
    for lp in params["layers"][1:]:
        lp["q_mu"] = torch.from_numpy(
            0.5 * rng.standard_normal(tuple(lp["q_mu"].shape))).float()
        lp["q_sqrt"] = torch.from_numpy(
            np.tril(0.3 * rng.standard_normal(tuple(lp["q_sqrt"].shape)))
            + 0.5 * np.eye(M)).float()


@pytest.fixture(scope="module")
def model():
    """(config, params, X, Y, {name: exported program}): three exports,
    shared by the tests (each costs a few seconds)."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((64, D_X)).astype(np.float32)
    Y = (np.sin(X.sum(-1, keepdims=True))
         + 0.1 * rng.standard_normal((64, 1))).astype(np.float32)
    config, params = build_model(0, BuildArgs(**ARGS), X, Y, device="cpu")
    _random_q(params, rng)
    kw = dict(d_in=D_X, d_out=1, num_samples=S)
    programs = {
        "fixed": export_scorer(params, config, batch_size=B, **kw),
        "poly": export_scorer(params, config, batch_size="b", **kw),
        "stats": export_scorer(params, config, batch_size=B, stats=STATS,
                               platforms=("cpu",), **kw),
    }
    return config, params, X, Y, programs


def _meta(batch_size=B, raw_units=False, poly=False):
    return {"batch_size": batch_size, "d_in": D_X, "d_out": 1,
            "num_samples": S, "raw_units": raw_units, "format_version": 1,
            "polymorphic_batch": poly}


def _live(config, params, X, Y, seed, stats=None):
    """make_scorer_fn on the plain path, fed the artifact's draws."""
    fn = make_scorer_fn(params, dataclasses.replace(config,
                                                    serve_pallas=False),
                        S, stats, device="cpu")
    eps = artifact_noise(seed, config, S, X.shape[0], "cpu")
    with torch.no_grad(), hbuild.plain_versions():
        return [t.numpy() for t in fn(torch.from_numpy(X),
                                      torch.from_numpy(Y), seed, eps=eps)]


def _call(program, X, Y, seed):
    with torch.no_grad():
        return [t.numpy() for t in program.module()(
            torch.from_numpy(X), torch.from_numpy(Y), torch.tensor(seed))]


def _close(got, want, rtol):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def test_exported_scorer_matches_live_scorer_fed_its_noise(model):
    config, params, X, Y, programs = model
    got = _call(programs["fixed"], X[:B], Y[:B], 7)
    want = _live(config, params, X[:B], Y[:B], 7)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        _close(g, w, 1e-6)
    assert np.abs(want[0]).max() > 0.1  # the random q(u) reaches the mean


def test_artifact_noise_is_row_local_and_keyed_by_seed_and_layer(model):
    config = model[0]
    n16 = artifact_noise(3, config, S, 16)
    n5 = artifact_noise(3, config, S, 5)
    assert n16[2] is None and n5[2] is None  # the final GP layer
    assert n16[0].shape == (S, 16, 1) and n16[1].shape == (S, 16, 3)
    for a, b in zip(n16[:2], n5[:2]):
        assert torch.equal(a[:, :5], b)
    other = artifact_noise(4, config, S, 16)
    assert not torch.equal(other[0], n16[0])
    assert not torch.equal(n16[0][..., 0], n16[1][..., 0])
    draws = torch.cat([e.reshape(-1) for e in
                       artifact_noise(5, config, 400, 16)[:2]])
    assert abs(float(draws.mean())) < 0.05
    assert abs(float(draws.std()) - 1.0) < 0.05


def test_save_load_file_round_trip(model, tmp_path):
    _, _, X, Y, programs = model
    path = str(tmp_path / "scorer.artifact")
    meta = save_scorer(path, programs["fixed"], num_samples=S,
                       has_stats=False, extra_meta={"checkpoint_step": 123})
    assert sorted(p.name for p in tmp_path.iterdir()) == ["scorer.artifact"]
    assert meta["batch_size"] == B and meta["d_in"] == D_X
    assert meta["d_out"] == 1 and meta["platforms"] == ["cpu"]
    assert meta["polymorphic_batch"] is False and meta["raw_units"] is False
    art = load_scorer(path, device="cpu")
    assert art.meta == meta and art.meta["checkpoint_step"] == 123
    for a, b in zip(_call(art.exported, X[:B], Y[:B], 3),
                    _call(programs["fixed"], X[:B], Y[:B], 3)):
        np.testing.assert_array_equal(a, b)


def test_version_and_device_guards(model, tmp_path, monkeypatch):
    programs = model[4]
    path = str(tmp_path / "scorer.pt2")
    save_scorer(path, programs["fixed"], num_samples=S, has_stats=False,
                extra_meta={"format_version": 999})
    with pytest.raises(ValueError, match="version"):
        load_scorer(path, device="cpu")
    save_scorer(path, programs["fixed"], num_samples=S, has_stats=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match=r"holds programs for \['cpu'\]"):
        load_scorer(path, device="cuda")


def test_fixed_batch_pads_the_tail_and_seeds_per_batch(model, tmp_path):
    _, _, X, Y, programs = model
    art = ServingArtifact(programs["fixed"], _meta())
    n = 40  # two full batches and a tail of 8
    out = art.score(X[:n], Y[:n], seed=11, depth=2)
    assert out["mean"].shape == (n, 1) and out["var"].shape == (n, 1)
    assert out["log_density"].shape == (n,)
    for i, start in enumerate(range(0, n, B)):
        take = min(B, n - start)
        xb = np.zeros((B, D_X), np.float32)
        yb = np.zeros((B, 1), np.float32)
        xb[:take], yb[:take] = X[start:start + take], Y[start:start + take]
        m, v, ld = _call(programs["fixed"], xb, yb, 11 + i)
        np.testing.assert_array_equal(out["mean"][start:start + take],
                                      m[:take])
        np.testing.assert_array_equal(out["var"][start:start + take],
                                      v[:take])
        np.testing.assert_array_equal(
            out["log_density"][start:start + take], ld[:take])


def test_polymorphic_batch_scores_any_n_like_the_fixed_artifact(model,
                                                                 tmp_path):
    _, _, X, Y, programs = model
    path = str(tmp_path / "poly.pt2")
    meta = save_scorer(path, programs["poly"], num_samples=S,
                       has_stats=False)
    assert meta["polymorphic_batch"] is True and meta["batch_size"] == 0
    poly = load_scorer(path, device="cpu")
    fixed = ServingArtifact(programs["fixed"], _meta())
    for n in (1, 7, 33, 64):  # 33 = two chunks of 16 and a 1-row tail
        op = poly.score(X[:n], Y[:n], seed=3, max_batch=B)
        of = fixed.score(X[:n], Y[:n], seed=3)
        for k in ("mean", "var", "log_density"):
            assert op[k].shape == of[k].shape
            assert np.all(np.isfinite(op[k]))
            _close(op[k], of[k], 1e-5)
    assert np.all(op["var"] > 0)


@pytest.mark.parametrize("transport", ["bfloat16", "float16"])
def test_narrow_transport_is_rounding_only(model, transport):
    art = ServingArtifact(model[4]["fixed"], _meta())
    X, Y = model[2][:40], model[3][:40]
    ref = art.score(X, Y, seed=11, depth=2)
    out = art.score(X, Y, seed=11, depth=2, transport=transport)
    eps = 2.0 ** (-8 if transport == "bfloat16" else -11)
    for k in ("mean", "var", "log_density"):
        assert out[k].dtype == np.float32 and out[k].shape == ref[k].shape
        np.testing.assert_allclose(out[k], ref[k], rtol=eps,
                                   atol=eps * np.abs(ref[k]).max())
    assert not np.array_equal(out["log_density"], ref["log_density"])


def test_transport_in_is_input_rounding_only(model):
    art = ServingArtifact(model[4]["fixed"], _meta())
    X, Y = model[2][:40], model[3][:40]
    ref = art.score(X, Y, seed=7, depth=2)
    out = art.score(X, Y, seed=7, depth=2, transport_in="bfloat16")
    Xr = torch.from_numpy(X).bfloat16().float().numpy()
    Yr = torch.from_numpy(Y).bfloat16().float().numpy()
    rounded = art.score(Xr, Yr, seed=7, depth=2)
    for k in ("mean", "var", "log_density"):
        assert out[k].dtype == np.float32
        np.testing.assert_array_equal(out[k], rounded[k])
        _close(out[k], ref[k], 0.05)
    assert not np.array_equal(out["var"], ref["var"])


def test_score_without_targets_omits_log_density(model):
    art = ServingArtifact(model[4]["fixed"], _meta())
    out = art.score(model[2][:10])
    assert set(out) == {"mean", "var"} and out["mean"].shape == (10, 1)


def test_input_shape_guards(model):
    art = ServingArtifact(model[4]["fixed"], _meta())
    X, Y = model[2], model[3]
    with pytest.raises(ValueError, match="X must be"):
        art.score(X[:10, :2])
    with pytest.raises(ValueError, match="Y must be"):
        art.score(X[:10], Y[:9])


def test_raw_unit_scoring_matches_manual_unnormalization(model):
    config, params, X, Y, programs = model
    X_raw = (X[:B] * STATS.x_std + STATS.x_mean).astype(np.float32)
    Y_raw = (Y[:B] * STATS.y_std + STATS.y_mean).astype(np.float32)
    m_raw, v_raw, ld_raw = _call(programs["stats"], X_raw, Y_raw, 5)
    m, v, ld = _live(config, params,
                     ((X_raw - STATS.x_mean) / STATS.x_std).astype(np.float32),
                     ((Y_raw - STATS.y_mean) / STATS.y_std).astype(np.float32),
                     5)
    log_sigma = float(np.log(3.0))
    _close(m_raw, m * 3.0 + 2.5, 2e-5)
    _close(v_raw, v * 9.0, 2e-5)
    _close(ld_raw, ld - log_sigma, 1e-5)


def test_cpu_artifact_scores_where_there_is_no_card(model, tmp_path,
                                                     monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = str(tmp_path / "cpu.pt2")
    meta = save_scorer(path, model[4]["stats"], num_samples=S,
                       has_stats=True)
    assert meta["platforms"] == ["cpu"] and meta["raw_units"] is True
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_scorer(path)  # the card by default
    out = load_scorer(path, device="cpu").score(model[2][:20] * 2.0 + 1.0,
                                                seed=1)
    assert np.all(np.isfinite(out["mean"])) and np.all(out["var"] > 0)


def _jax_noise(key, n, d_inner):
    """The reference scorer's draws: w from fold_in(key, 0), the inner
    layer's sample noise from fold_in(key, 1), float64."""
    w = jax.random.normal(jax.random.fold_in(key, 0), (S, n, 1), jnp.float64)
    e = jax.random.normal(jax.random.fold_in(key, 1), (S, n, d_inner),
                          jnp.float64)
    return [torch.from_numpy(np.array(w)), torch.from_numpy(np.array(e)),
            None]


def test_artifact_function_matches_the_reference_scorer_in_float64():
    """The function export_scorer traces (make_scorer_fn with the stats,
    Kuu prefactored once, the K2 route's plain versions) against the
    reference's make_scorer_fn(stats), with the reference's draws
    injected, in float64: agreement to 1e-9."""
    rng = np.random.default_rng(2)
    X = rng.standard_normal((B, D_X))
    Y = np.sin(X[:, :1]) + 0.1 * rng.standard_normal((B, 1))
    jconfig, jparams = jbuild_model(jax.random.PRNGKey(0),
                                    JBuildArgs(**ARGS), jnp.asarray(X),
                                    jnp.asarray(Y))
    jparams = jax.device_get(jparams)
    for lp in jparams["layers"][1:]:
        lp["q_mu"] = 0.5 * rng.standard_normal(lp["q_mu"].shape)
        lp["q_sqrt"] = (np.tril(0.3 * rng.standard_normal(lp["q_sqrt"]
                                                          .shape))
                        + 0.5 * np.eye(M))
    jparams = jax.tree.map(lambda a: np.asarray(a, np.float64), jparams)
    X_raw = X * STATS.x_std + STATS.x_mean
    Y_raw = Y * STATS.y_std + STATS.y_mean
    jscore = jserving.make_scorer_fn(jparams, jconfig, S,
                                     jserving.NormalizationStats(
                                         **dataclasses.asdict(STATS)))
    want = jax.jit(jscore)(jnp.asarray(X_raw), jnp.asarray(Y_raw), 5)

    config = dataclasses.replace(build_config(BuildArgs(**ARGS), D_X, 1, B),
                                 serve_pallas=False, use_pallas=False)
    params = tparams.params_from_numpy(jparams, "cpu")
    with torch.no_grad(), hbuild.plain_versions():
        fn = make_scorer_fn(params, config, S, STATS, device="cpu",
                            factors=prefactor_gp_layers(params, config))
        got = fn(torch.from_numpy(X_raw), torch.from_numpy(Y_raw), 5,
                 eps=_jax_noise(jax.random.PRNGKey(5), B,
                                config.layers[1].d_out))
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9,
                                   atol=1e-12)


def test_polymorphic_artifact_has_no_bound_from_a_size_rule(model):
    """The gram's residual rule (float32 and >= 4 MB of output) must not
    decide on a symbolic batch: here S * n * M * 4 bytes passes 4 MB at
    n = 26215 rows, and a chunk beyond that scores like the fixed
    artifact (it used to fail the program's guard on the batch size)."""
    _, _, X, Y, programs = model
    poly = ServingArtifact(programs["poly"], _meta(0, poly=True))
    n = 26300
    Xb, Yb = np.tile(X, (n // 64 + 1, 1))[:n], np.tile(Y, (n // 64 + 1, 1))[:n]
    out = poly.score(Xb, Yb, seed=3, max_batch=n)
    assert out["mean"].shape == (n, 1)
    fixed = ServingArtifact(programs["fixed"], _meta())
    ref = fixed.score(Xb[:B], Yb[:B], seed=3)
    for k in ("mean", "var", "log_density"):
        _close(out[k][:B], ref[k], 1e-5)
