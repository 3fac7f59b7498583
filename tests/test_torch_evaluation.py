"""The port's evaluation against the reference's: ``evaluate`` on the same
carried LGG parameters, with the reference's noise draws injected chunk by
chunk (``fold_in(key, start)``, then ``fold_in(k, 0)`` for w and
``fold_in(k, 1)`` for the inner layer's sample noise), on a test set that
is not a multiple of the chunk size, so padding and masking are exercised.
float64: every precision class is exact on both sides, so the metrics
agree at rtol 1e-9. And the results database: the same table, and a row
that round-trips.
"""

import contextlib
import json
import sqlite3

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgps_with_iwvi_tpu.evaluation import Database as JDatabase
from dgps_with_iwvi_tpu.evaluation import evaluate as jevaluate
from dgps_with_iwvi_tpu.models import BuildArgs as JBuildArgs
from dgps_with_iwvi_tpu.models import build_model as jbuild_model
from dgps_with_iwvi_torch import params as tparams
from dgps_with_iwvi_torch.evaluation import Database, evaluate
from dgps_with_iwvi_torch.evaluation import metrics as tmetrics
from dgps_with_iwvi_torch.models import (BuildArgs, build_config,
                                         predict_y_and_log_density)

N_TRAIN, N_TEST, D_X, M, S, BS = 48, 37, 3, 16, 4, 16
ARGS = dict(configuration="LGG", mode="IW", num_inducing=M,
            num_iw_samples=20)
Y_STD = np.array([2.5])


@pytest.fixture(scope="module")
def model():
    """(X_test, Y_test, JAX config, JAX params as numpy) in float64, with a
    random q(u) so that every term of the variance matters."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N_TRAIN + N_TEST, D_X))
    Y = np.sin(X[:, :1]) + 0.1 * rng.standard_normal((N_TRAIN + N_TEST, 1))
    config, params = jbuild_model(jax.random.PRNGKey(0), JBuildArgs(**ARGS),
                                  jnp.asarray(X[:N_TRAIN]),
                                  jnp.asarray(Y[:N_TRAIN]))
    params = jax.device_get(params)
    for i in (1, 2):
        lp = params["layers"][i]
        lp["q_mu"] = 0.5 * rng.standard_normal(lp["q_mu"].shape)
        lp["q_sqrt"] = (np.tril(0.3 * rng.standard_normal(lp["q_sqrt"].shape))
                        + 0.5 * np.eye(M))
    return X[N_TRAIN:], Y[N_TRAIN:], config, params


def _port(params):
    config = build_config(BuildArgs(**ARGS), D_X, 1, N_TRAIN)
    return config, tparams.params_from_numpy(params, "cpu")


def test_evaluate_matches_reference_with_injected_draws(model, monkeypatch):
    X, Y, jconfig, jparams = model
    key = jax.random.PRNGKey(11)
    ref = jevaluate(jparams, jconfig, jnp.asarray(X), jnp.asarray(Y), key,
                    y_std=Y_STD, num_samples=S, batch_size=BS)
    config, params = _port(jparams)
    d_inner = config.layers[1].d_out
    starts = []

    def injected(params, config, xb, yb, seed, start, num_samples):
        assert seed == 123 and xb.shape[0] == BS
        starts.append(start)
        k = jax.random.fold_in(key, start)
        w = jax.random.normal(jax.random.fold_in(k, 0), (S, BS, 1),
                              jnp.float64)
        e = jax.random.normal(jax.random.fold_in(k, 1), (S, BS, d_inner),
                              jnp.float64)
        eps = [torch.from_numpy(np.array(w)), torch.from_numpy(np.array(e)),
               None]
        (mean, _), ld = predict_y_and_log_density(params, config, xb, yb,
                                                  None, num_samples, eps=eps)
        return ld, mean

    monkeypatch.setattr(tmetrics, "_batch_eval", injected)
    got = evaluate(params, config, X, Y, 123, y_std=Y_STD, num_samples=S,
                   batch_size=BS, device="cpu")
    assert starts == [0, 16, 32]
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-9, atol=0.0,
                                   err_msg=k)


def test_evaluate_unnormalizes_and_masks_the_padding(model):
    """Original units: loglik - sum log y_std, rmse * y_std. Chunk c's
    noise depends on the seed and its first row only: the same seed
    repeats, another seed moves the metrics."""
    X, Y, _, jparams = model
    config, params = _port(jparams)
    kw = dict(y_std=Y_STD, num_samples=S, batch_size=BS, device="cpu")
    m = evaluate(params, config, X, Y, 0, **kw)
    np.testing.assert_allclose(m["test_loglik"],
                               m["test_loglik_normalized"] - np.log(2.5),
                               rtol=1e-12)
    np.testing.assert_allclose(m["test_rmse"],
                               m["test_rmse_normalized"] * 2.5, rtol=1e-12)
    assert evaluate(params, config, X, Y, 0, **kw) == m
    assert evaluate(params, config, X, Y, 1, **kw) != m
    # the CPU generator keeps 32 bits of its seed
    assert (tmetrics.chunk_seed(1, 0) - tmetrics.chunk_seed(0, 0)) % 2 ** 32


def _columns(path):
    with contextlib.closing(sqlite3.connect(path)) as conn:
        return conn.execute("PRAGMA table_info(regression)").fetchall()


def test_database_schema_equals_the_reference(tmp_path):
    Database(str(tmp_path / "port.db"))
    JDatabase(str(tmp_path / "ref.db"))
    assert _columns(tmp_path / "port.db") == _columns(tmp_path / "ref.db")
    assert Database._COLS == JDatabase._COLS


def test_database_row_round_trips(tmp_path):
    row = {"dataset": "kin8nm", "split": 2, "configuration": "LGG",
           "mode": "IW", "M": 128, "K": 20, "num_samples": 1,
           "minibatch_size": 512, "iterations": 400, "lr": 5e-3,
           "gamma": 1e-2, "test_loglik": -0.25, "test_rmse": 0.4,
           "test_loglik_normalized": 0.1, "test_rmse_normalized": 0.3,
           "elbo": -1234.5, "steps_per_sec": 40.5, "synthetic_data": True,
           "mfu": None, "backend": "cuda"}
    path = str(tmp_path / "r.db")
    Database(path).write_result(row)
    (got,) = Database(path).read("kin8nm")
    for k in Database._COLS:
        assert got[k] == (1 if k == "synthetic_data" else row[k]), k
    assert json.loads(got["extra"]) == {"mfu": None, "backend": "cuda"}
    # the reference reads the port's row from the same file
    assert JDatabase(path).read("kin8nm")[0] == got
    assert Database(path).read("energy") == []
