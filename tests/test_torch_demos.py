"""The demos (``dgps_with_iwvi_torch/demos``) on the CPU: each compute half
runs for a few steps, each plot writes a PNG (where matplotlib is
installed), and on the reference's parameters, carried across in float64
with a random q(u) on the final layer, each prediction half equals the
reference's at rtol 1e-9: toy_1d's GIVEN draws and traversal (the
reference's ``vmap`` of single-sample ``predict_f`` calls, as
``demos/toy_1d.py`` does it), and multitask's per-task ``predict_f``
moments, ``coregion_B`` and noise variances. The reference side is built
from ``dgps_with_iwvi_tpu`` calls here, not by importing ``demos/*.py``.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from dgps_with_iwvi_tpu.models import BuildArgs as JBuildArgs
from dgps_with_iwvi_tpu.models import build_model as jbuild_model
from dgps_with_iwvi_tpu.models import predict_f as jpredict_f
from dgps_with_iwvi_tpu.models.layers import LatentVarMode as JLatentVarMode
from dgps_with_iwvi_tpu.ops.kernels import coregion_B as jcoregion_B
from dgps_with_iwvi_tpu.ops.transforms import positive as jpositive
from dgps_with_iwvi_torch import params as tparams
from dgps_with_iwvi_torch.demos import multitask_icm, toy_1d
from dgps_with_iwvi_torch.models import build_config

RTOL = 1e-9
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def toy_run():
    return toy_1d.compute(iterations=20, K=4, device="cpu")


@pytest.fixture(scope="module")
def multitask_run():
    return multitask_icm.compute(iterations=20, device="cpu")


def test_toy_1d_compute_runs(toy_run):
    r = toy_run
    assert r["draws"].shape == (toy_1d.N_DRAWS, 200)
    assert r["traversal"].shape == (len(toy_1d.W_GRID), 200)
    assert r["losses"].shape == (1,) and np.isfinite(r["losses"]).all()
    assert np.isfinite(r["draws"]).all() and np.isfinite(r["traversal"]).all()
    assert r["noise_variance"] > 0


def test_multitask_compute_runs(multitask_run):
    r = multitask_run
    assert r["mean"].shape == r["var"].shape == (3, 200)
    assert r["B"].shape == (3, 3) and r["noise_variance"].shape == (3,)
    assert np.isfinite(r["mean"]).all() and (r["var"] > -1e-6).all()
    assert np.isfinite(r["losses"]).all()


def test_plots_write_png(toy_run, multitask_run, tmp_path):
    pytest.importorskip("matplotlib")
    for mod, run in ((toy_1d, toy_run), (multitask_icm, multitask_run)):
        out = str(tmp_path / f"{mod.__name__.rsplit('.', 1)[1]}.png")
        assert mod.plot(run, out) == out
        with open(out, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_default_out_is_no_committed_file():
    committed = {os.path.realpath(os.path.join(REPO, "demos", f))
                 for f in os.listdir(os.path.join(REPO, "demos"))}
    for mod in (toy_1d, multitask_icm):
        out = mod.parse_args([]).out
        assert os.path.dirname(out) == "" and out.endswith("_torch.png")
        assert os.path.realpath(os.path.join(REPO, "demos", out)) \
            not in committed
        assert mod.parse_args([]).device == "cuda"


def _reference(build_args, X, Y, rng):
    """The reference's parameters of the demo's model on (X, Y) in
    float64, with a random q(u) on the final layer (at its initial q(u)
    the prediction is the prior's)."""
    jconfig, jparams = jbuild_model(jax.random.PRNGKey(0), build_args,
                                    jnp.asarray(X, jnp.float64),
                                    jnp.asarray(Y, jnp.float64))
    jparams = jax.device_get(jparams)
    lp = jparams["layers"][-1]
    lp["q_mu"] = 0.5 * rng.standard_normal(lp["q_mu"].shape)
    lp["q_sqrt"] = (np.tril(0.2 * rng.standard_normal(lp["q_sqrt"].shape))
                    + 0.5 * np.eye(lp["q_sqrt"].shape[-1]))
    params = tparams.params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a, np.float64), jparams), "cpu")
    return jconfig, jparams, params


def test_toy_1d_prediction_matches_reference():
    X, Y = toy_1d.make_data()
    jb = toy_1d.build(K=4)
    jconfig, jparams, params = _reference(
        JBuildArgs(configuration=jb.configuration, mode=jb.mode,
                   num_inducing=jb.num_inducing,
                   num_iw_samples=jb.num_iw_samples,
                   encoder_init_logvar=jb.encoder_init_logvar),
        X, Y, np.random.default_rng(0))
    config = build_config(jb, 1, 1, X.shape[0])
    ws = np.random.default_rng(1).standard_normal(toy_1d.N_DRAWS)
    got = toy_1d.predict(params, config, ws, "cpu")
    np.testing.assert_allclose(got["xg"], np.linspace(-2.5, 2.5, 200),
                               rtol=0, atol=1e-15)
    xg = jnp.asarray(got["xg"])[:, None]
    jp = jax.tree.map(jnp.asarray, jparams)

    @jax.jit
    def draw(w):
        wfix = jnp.full((200, 1), w, jnp.float64)
        fm, _ = jpredict_f(jp, jconfig, xg, jax.random.PRNGKey(2), 1,
                           lv_mode=JLatentVarMode.GIVEN, ws_given=[wfix])
        return fm[0, :, 0]

    np.testing.assert_allclose(got["draws"], jax.vmap(draw)(jnp.asarray(ws)),
                               rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(
        got["traversal"], jax.vmap(draw)(jnp.asarray(toy_1d.W_GRID)),
        rtol=RTOL, atol=1e-12)
    assert np.ptp(got["traversal"]) > 0.1


def test_multitask_prediction_matches_reference():
    X, Y = multitask_icm.make_data()
    b = multitask_icm.build()
    jconfig, jparams, params = _reference(
        JBuildArgs(configuration=b.configuration, mode=b.mode,
                   num_inducing=b.num_inducing, kernel_kind=b.kernel_kind,
                   likelihood=b.likelihood),
        X, Y, np.random.default_rng(2))
    # move B and the noise off their initial values
    kp = jparams["layers"][-1]["kernel"]["terms"][0][1]
    kp["W"] = kp["W"] + 0.3 * np.random.default_rng(3).standard_normal(
        kp["W"].shape)
    jparams["likelihood"]["raw_noise_variance"] = np.asarray(
        [-3.0, -1.5, -0.5])
    params = tparams.params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a, np.float64), jparams), "cpu")
    config = build_config(b, 2, 2, X.shape[0])
    got = multitask_icm.predict(params, config, "cpu")
    jp = jax.tree.map(jnp.asarray, jparams)
    xg = np.linspace(-3.2, 3.2, 200)[:, None]
    for t in range(3):
        Xt = jnp.asarray(np.concatenate([xg, np.full_like(xg, float(t))], 1))
        fm_s, fv_s = jpredict_f(jp, jconfig, Xt, jax.random.PRNGKey(1),
                                multitask_icm.N_SAMPLES)
        fm = jnp.mean(fm_s, 0)
        fv = jnp.mean(fv_s + jnp.square(fm_s), 0) - jnp.square(fm)
        np.testing.assert_allclose(got["mean"][t], fm[:, 0], rtol=RTOL,
                                   atol=1e-12)
        np.testing.assert_allclose(got["var"][t], fv[:, 0], rtol=RTOL,
                                   atol=1e-12)
    np.testing.assert_allclose(got["B"], jcoregion_B(kp), rtol=RTOL)
    np.testing.assert_allclose(
        got["noise_variance"],
        jpositive(jp["likelihood"]["raw_noise_variance"]), rtol=RTOL)
    assert np.ptp(got["mean"]) > 0.1
