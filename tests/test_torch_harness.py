"""The port's UCI harness end to end on the CPU (``--device cpu --dtype
float64``, a small LGG on the energy surrogate): a run writes one row of
the reference's schema and beats the untrained model; a run of 20 steps
resumed for 20 more equals a straight run of 40 bit for bit; the monitor,
the build-args record and the Z initialization match the reference's."""

import contextlib
import json
import os
import sqlite3

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgps_with_iwvi_tpu.data import native_loader as jnative
from dgps_with_iwvi_tpu.evaluation import Database as JDatabase
from dgps_with_iwvi_tpu.models import BuildArgs as JBuildArgs
from dgps_with_iwvi_tpu.models import build_model as jbuild_model
from dgps_with_iwvi_tpu.training import TrainConfig as JTrainConfig
from dgps_with_iwvi_tpu.training.monitor import \
    hyperparameter_scalars as jhyperparameter_scalars
from dgps_with_iwvi_torch import params as tparams
from dgps_with_iwvi_torch.data import native_loader as tnative
from dgps_with_iwvi_torch.experiments import main, run_suite, serve
from dgps_with_iwvi_torch.models import (BuildArgs, build_config, build_model,
                                         load_build_args, save_build_args)
from dgps_with_iwvi_torch.models.builder import kmeans_centers
from dgps_with_iwvi_torch.training import TrainConfig
from dgps_with_iwvi_torch.training.monitor import (Monitor,
                                                   hyperparameter_scalars)

SMALL = ["--dataset", "energy", "--max_n", "300", "--configuration", "LGG",
         "--mode", "IW", "--M", "16", "--K", "5", "--steps_per_call", "20",
         "--device", "cpu", "--dtype", "float64", "--print_every", "0"]


def _args(tmp_path, *extra, iterations=40):
    return main.parse_args(SMALL + ["--iterations", str(iterations),
                                    "--results_db", str(tmp_path / "r.db")]
                           + list(extra))


def test_run_writes_a_row_and_beats_the_untrained_model(tmp_path):
    args = _args(tmp_path)
    row = main.run(args)
    exp = main.setup(args)
    untrained = main.evaluate_model(args, exp, exp.params)
    assert np.isfinite(row["test_loglik"]) and np.isfinite(row["test_rmse"])
    assert row["test_loglik"] > untrained["test_loglik"]
    assert row["backend"] == "cpu" and row["mfu"] is None
    JDatabase(str(tmp_path / "ref.db"))
    with contextlib.closing(sqlite3.connect(tmp_path / "r.db")) as conn:
        cols = conn.execute("PRAGMA table_info(regression)").fetchall()
    with contextlib.closing(sqlite3.connect(tmp_path / "ref.db")) as conn:
        assert cols == conn.execute(
            "PRAGMA table_info(regression)").fetchall()
    (got,) = JDatabase(str(tmp_path / "r.db")).read("energy")
    assert got["configuration"] == "LGG" and got["iterations"] == 40
    assert got["test_loglik"] == row["test_loglik"]
    assert got["synthetic_data"] == 1 and got["elbo"] == row["elbo"]


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree, key=str)
                for x in _leaves(tree[k], f"{path}.{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _leaves(v, f"{path}[{i}]")]
    return [(path, tree)]


def test_resumed_run_equals_the_straight_run(tmp_path):
    """20 steps, then a resume of 20 more, against 40 straight: every leaf
    of the last checkpoint (parameters, natgrad blocks, Adam's moments and
    step, the generator's state) is equal."""
    straight, resumed = tmp_path / "a", tmp_path / "b"
    main.run(_args(tmp_path, "--ckpt_dir", str(straight), "--ckpt_every",
                   "20"))
    main.run(_args(tmp_path, "--ckpt_dir", str(resumed), "--ckpt_every",
                   "20", iterations=20))
    assert sorted(os.listdir(resumed)) == ["build_args.json", "step_20.pt"]
    main.run(_args(tmp_path, "--ckpt_dir", str(resumed), "--ckpt_every",
                   "20", "--resume"))
    a = torch.load(straight / "step_40.pt", weights_only=True)
    b = torch.load(resumed / "step_40.pt", weights_only=True)
    la, lb = _leaves(a), _leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    names = [p for p, _ in la]
    assert any("exp_avg_sq" in p for p in names)
    assert ".generator" in names and ".state.step" in names
    for (path, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), path
        else:
            assert x == y, path
    assert a["state"]["step"] == 40


def test_monitor_tracks_rate_and_history():
    """As the reference's test_monitor_tracks_rate_and_history."""
    mon = Monitor(print_every=0)
    for step in (10, 20, 30):
        mon(step, -float(step), None)
    assert len(mon.history) == 3
    assert mon.history[-1]["elbo"] == 30.0
    assert mon.history[0]["steps_per_sec"] == 0.0
    assert np.isfinite(mon.mean_steps_per_sec)
    assert mon.median_steps_per_sec > 0
    assert np.isnan(Monitor(print_every=0).median_steps_per_sec)


def test_hyperparameter_scalars_equal_the_reference():
    rng = np.random.default_rng(3)
    X = rng.standard_normal((40, 3))
    Y = np.sin(X[:, :1])
    jconfig, jparams = jbuild_model(
        jax.random.PRNGKey(0), JBuildArgs(configuration="LGG", mode="IW",
                                          num_inducing=8),
        jnp.asarray(X), jnp.asarray(Y))
    jparams = jax.device_get(jparams)
    for i in (1, 2):
        kp = jparams["layers"][i]["kernel"]
        kp["raw_lengthscales"] = rng.standard_normal(
            kp["raw_lengthscales"].shape)
    ref = jhyperparameter_scalars(
        jparams, jconfig, JTrainConfig(natgrad="final", gamma_warmup=10), 4)
    config = build_config(BuildArgs(configuration="LGG", mode="IW",
                                    num_inducing=8), 3, 1, 40)
    got = hyperparameter_scalars(
        tparams.params_from_numpy(jparams, "cpu"), config,
        TrainConfig(natgrad="final", gamma_warmup=10), 4)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-12, err_msg=k)


def test_build_args_round_trip(tmp_path):
    build = BuildArgs(configuration="LGG", mode="IW", num_inducing=64,
                      num_iw_samples=20, q_diag=True, use_pallas=True,
                      encoder_hidden=(10, 30))
    save_build_args(str(tmp_path), build, natgrad="none")
    assert load_build_args(str(tmp_path)) == build
    assert load_build_args(str(tmp_path), with_meta=True) == (
        build, {"natgrad": "none"})
    assert load_build_args(str(tmp_path / "missing")) is None
    with open(tmp_path / "build_args.json") as f:
        assert json.load(f)["_train"] == {"natgrad": "none"}


def test_z_init_is_the_native_kmeans_of_the_reference():
    """With N > M and the library loaded, build_model seeds Z with the
    native kmeans++ that the reference's build_model calls, at the seed of the
    build generator's first draw; LGG's first GP layer pads it with a zero
    column for w."""
    if not tnative.native_available():
        pytest.skip("native library not buildable (no C++ toolchain)")
    rng = np.random.default_rng(4)
    X = rng.standard_normal((200, 3)).astype(np.float32)
    Y = np.sin(X[:, :1])
    _, params = build_model(7, BuildArgs(configuration="LGG", mode="IW",
                                         num_inducing=16), X, Y, device="cpu")
    seed = int(torch.randint(0, 2 ** 31 - 1, (),
                             generator=torch.Generator().manual_seed(7)))
    want = jnative.kmeans(X, 16, seed=seed).astype(np.float32)
    Z = params["layers"][1]["Z"].numpy()
    np.testing.assert_array_equal(Z[:, :3], want)
    np.testing.assert_array_equal(Z[:, 3], 0.0)
    np.testing.assert_array_equal(params["layers"][2]["Z"].numpy(), want)


def test_z_init_falls_back_to_lloyds_when_the_library_cannot_load(
        tmp_path, monkeypatch):
    """A library file that dlopen refuses (a half-written .so) sends
    build_model to Lloyd's from a generator seeded with the build
    generator's first draw, as the reference's build_model falls back to
    its own Lloyd's."""
    bad = tmp_path / "libdgpdata.so"
    bad.write_bytes(b"not a shared object")
    monkeypatch.setattr(tnative, "_LIB_PATH", str(bad))
    tnative.load_library.cache_clear()
    try:
        rng = np.random.default_rng(4)
        X = rng.standard_normal((200, 3)).astype(np.float32)
        _, params = build_model(7, BuildArgs(configuration="G",
                                             num_inducing=16),
                                X, np.sin(X[:, :1]), device="cpu")
    finally:
        tnative.load_library.cache_clear()
    seed = int(torch.randint(0, 2 ** 31 - 1, (),
                             generator=torch.Generator().manual_seed(7)))
    want = kmeans_centers(torch.as_tensor(X), 16,
                          torch.Generator().manual_seed(seed))
    assert torch.equal(params["layers"][0]["Z"], want)


def test_profile_dir_writes_a_trace(tmp_path):
    main.run(_args(tmp_path, "--steps_per_call", "2", "--profile_dir",
                   str(tmp_path / "prof"), iterations=2))
    with open(tmp_path / "prof" / "trace.json") as f:
        assert json.load(f)["traceEvents"]


def test_cli_runs_on_cuda_by_default(tmp_path, monkeypatch):
    """Without --device the run asks for the card and raises where there
    is none, before it writes anything; float64 is refused on the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = main.parse_args(["--dataset", "energy", "--results_db",
                            str(tmp_path / "r.db")])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main.run(args)
    assert not os.path.exists(tmp_path / "r.db")
    with pytest.raises(ValueError, match="float64"):
        main.run(main.parse_args(["--dtype", "float64"]))


def test_serve_cli_runs_on_cuda_by_default(tmp_path, monkeypatch):
    """dgp-serve-torch without --device asks for the card, from a
    checkpoint and from an artifact, and raises where there is none,
    before it writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "pred.npz")
    for source in (["--ckpt_dir", str(tmp_path / "ck")],
                   ["--from_export", str(tmp_path / "scorer.pt2")]):
        args = serve.parse_args(["--dataset", "yacht", "--output", out,
                                 *source])
        assert args.device == "cuda"
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve.run(args)
    assert not os.path.exists(out)


def test_suite_runs_the_grid_and_skips_existing_rows(tmp_path, capsys):
    argv = ["--datasets", "yacht", "--configurations", "G", "--modes",
            "VI", "--splits", "2", "--M", "8", "--iterations", "4",
            "--results_db", str(tmp_path / "s.db"), "--extra",
            "--device cpu --steps_per_call 2 --print_every 0 "
            "--num_predict_samples 4"]
    rows = run_suite.main(argv)
    assert [(r["dataset"], r["split"]) for r in rows] == [("yacht", 0),
                                                         ("yacht", 1)]
    assert run_suite.main(argv) == []
    assert "[skip] ('yacht', 'G', 'VI', 1)" in capsys.readouterr().out
    assert run_suite.parse_args(argv).skip_existing
    assert run_suite.parse_args(argv + ["--skip_existing"]).skip_existing
    assert not run_suite.parse_args(argv + ["--no_skip_existing"]) \
        .skip_existing
    assert run_suite.parse_args(
        argv + ["--no_skip_existing", "--skip_existing"]).skip_existing
