"""The port's serving CLI (``dgp-serve-torch``) end to end on the CPU,
mirroring the single-device serve tests of the reference's
tests/test_checkpoint_e2e.py: ``experiments.main`` trains a tiny model
with checkpoints on the yacht surrogate (``--device cpu``), then
``experiments.serve`` scores from the checkpoint, restores the structure
flags from build_args.json, exports an artifact and scores from it, and
standardizes an external table with the train statistics.

Raw and standardized tables differ by the rounding of x * std + mean and
back, so the --input case agrees with the built-in split at 1e-5, as in
the reference. The CLI's test log-density equals evaluation's where
their batches and seeds coincide (one chunk of the whole split, the same
eval seed): the per-point values are equal, and their means differ by the
order of the float32 sums only (1e-6)."""

import os

import numpy as np
import pytest
import torch

from dgps_with_iwvi_torch.data import get_regression_data
from dgps_with_iwvi_torch.experiments import main, serve
from dgps_with_iwvi_torch.serving import (export_scorer, load_scorer,
                                          save_scorer)

TRAIN = ["--dataset", "yacht", "--configuration", "LG", "--mode", "IW",
         "--K", "3", "--M", "8", "--minibatch_size", "64",
         "--steps_per_call", "50", "--num_predict_samples", "10",
         "--print_every", "0", "--seed", "0", "--device", "cpu"]
SERVE = ["--dataset", "yacht", "--num_predict_samples", "10",
         "--device", "cpu"]


def _train(tmp, *extra, iterations=100):
    ck = str(tmp / "ck")
    row = main.run(main.parse_args(TRAIN + [
        "--iterations", str(iterations), "--results_db", str(tmp / "r.db"),
        "--ckpt_dir", ck, "--ckpt_every", "50", *extra]))
    return ck, row


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(checkpoint dir, the training run's results row)."""
    return _train(tmp_path_factory.mktemp("serve_cli"))


def _serve(*flags):
    return serve.run(serve.parse_args(SERVE + list(flags)))


def _raw_test_split():
    data = get_regression_data("yacht", 0)
    return (data, np.asarray(data.X_test) * data.X_std + data.X_mean,
            np.asarray(data.Y_test) * data.Y_std + data.Y_mean)


def test_serve_scores_from_checkpoint(trained, tmp_path):
    """Finite predictions in original units, [n, 1] and [n], with the
    reference's keys."""
    ck, _ = trained
    out = str(tmp_path / "pred.npz")
    res = _serve("--ckpt_dir", ck, "--output", out, "--batch_size", "16")
    z = np.load(out)
    data, _, Y_raw = _raw_test_split()
    n = data.X_test.shape[0]
    assert set(z.files) == {"mean", "var", "log_density", "num_samples",
                            "checkpoint_step"}
    assert z["mean"].shape == (n, 1) and z["var"].shape == (n, 1)
    assert z["log_density"].shape == (n,)
    assert np.all(np.isfinite(z["mean"])) and np.all(z["var"] > 0)
    assert np.all(np.isfinite(z["log_density"]))
    assert int(z["num_samples"]) == 10 and int(z["checkpoint_step"]) == 100
    # un-normalized: predictions live near the raw-Y scale
    assert abs(float(z["mean"].mean()) - float(Y_raw.mean())) < \
        10 * float(np.asarray(data.Y_std).max())
    assert res["n"] == n and res["points_per_sec"] > 0


def test_serve_log_density_equals_evaluation(trained, tmp_path):
    """One batch of the whole split at the run's eval seed is evaluation's
    chunk: the mean log-density is the run's test_loglik. --shard with
    one device (here none) changes nothing."""
    ck, row = trained
    out = str(tmp_path / "pred.npz")
    _serve("--ckpt_dir", ck, "--output", out, "--batch_size", "4096",
           "--shard")
    ld = np.load(out)["log_density"]
    np.testing.assert_allclose(float(np.mean(ld.astype(np.float64))),
                               row["test_loglik"], rtol=1e-6)


def test_serve_restores_structure_flags_from_build_args(tmp_path):
    """--q_diag --non_amortized --natgrad none come from build_args.json;
    the serve run passes none of them."""
    ck, _ = _train(tmp_path, "--q_diag", "--non_amortized", "--natgrad",
                   "none", iterations=50)
    assert os.path.exists(os.path.join(ck, "build_args.json"))
    out = str(tmp_path / "pred.npz")
    res = _serve("--ckpt_dir", ck, "--output", out, "--batch_size", "16")
    z = np.load(out)
    assert np.all(np.isfinite(z["mean"])) and np.all(z["var"] > 0)
    assert res["n"] == z["mean"].shape[0]


def test_serve_export_and_score_from_artifact(trained, tmp_path):
    """--export writes one self-contained artifact (params and statistics
    baked in); --from_export scores the test split from it alone, equal
    to in-process ServingArtifact.score with the same seed."""
    ck, _ = trained
    art_path = str(tmp_path / "scorer.pt2")
    res = _serve("--ckpt_dir", ck, "--export", art_path, "--batch_size",
                 "16")
    assert res["export"] == art_path and res["raw_units"] is True
    assert res["dataset"] == "yacht" and res["checkpoint_step"] == 100
    assert res["platforms"] == ["cpu"] and res["batch_size"] == 16
    out = str(tmp_path / "pred.npz")
    res2 = _serve("--from_export", art_path, "--output", out, "--seed", "3")
    z = np.load(out)
    data, X_raw, Y_raw = _raw_test_split()
    n = data.X_test.shape[0]
    assert res2["n"] == n and z["mean"].shape == (n, 1)
    assert np.all(np.isfinite(z["log_density"]))
    ref = load_scorer(art_path, device="cpu").score(X_raw, Y_raw, seed=3)
    for k in ("mean", "var", "log_density"):
        np.testing.assert_array_equal(z[k], ref[k])
    assert abs(float(z["mean"].mean()) - float(Y_raw.mean())) < \
        10 * float(np.asarray(data.Y_std).max())
    with pytest.raises(SystemExit, match="cannot re-export"):
        _serve("--from_export", art_path, "--output", out, "--export", out)


def test_serve_external_npz_input_standardizes(trained, tmp_path):
    """Raw X/Y rows through --input are standardized with the train
    split's statistics: the same predictions as the built-in split."""
    ck, _ = trained
    _, X_raw, Y_raw = _raw_test_split()
    np.savez(tmp_path / "in.npz", X=X_raw, Y=Y_raw)
    common = ["--ckpt_dir", ck, "--batch_size", "16"]
    _serve(*common, "--input", str(tmp_path / "in.npz"), "--output",
           str(tmp_path / "a.npz"))
    _serve(*common, "--output", str(tmp_path / "b.npz"))
    a, b = np.load(tmp_path / "a.npz"), np.load(tmp_path / "b.npz")
    np.testing.assert_allclose(a["mean"], b["mean"], rtol=1e-5)
    np.testing.assert_allclose(a["log_density"], b["log_density"],
                               rtol=1e-5)


def test_from_export_refuses_a_caller_unit_artifact(trained, tmp_path):
    """An artifact without statistics (raw_units=false) is refused by the
    CLI, which speaks raw units; so are runs without an output or a
    source."""
    ck, _ = trained
    data = get_regression_data("yacht", 0)
    config, params, _ = serve._restore(
        serve.parse_args(SERVE + ["--ckpt_dir", ck]), data,
        torch.device("cpu"))
    path = str(tmp_path / "caller_units.pt2")
    save_scorer(path, export_scorer(params, config, batch_size=8,
                                    d_in=data.D, d_out=1, num_samples=2),
                num_samples=2, has_stats=False)
    with pytest.raises(SystemExit, match="raw_units"):
        _serve("--from_export", path, "--output", str(tmp_path / "p.npz"))
    for flags, msg in ((["--ckpt_dir", ck], "need --output"),
                       (["--from_export", path, "--export", path],
                        "needs --output"),
                       (["--output", str(tmp_path / "p.npz")],
                        "need --ckpt_dir")):
        with pytest.raises(SystemExit, match=msg):
            _serve(*flags)
