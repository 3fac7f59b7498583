"""Runs of the port over several processes (the counterparts of
tests/test_multiprocess.py): gloo ranks spawned on the CPU
(tests/torch_dist_worker.py), each holding only its own rows, and both
CLIs launched over two ranks as torchrun would launch them; the
launcher's deadline and its backend rule (``parallel/launch.py``).
"""

import os
import sqlite3
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_dist_worker as W
from dgps_with_iwvi_torch import params as tparams
from dgps_with_iwvi_torch.experiments import serve
from dgps_with_iwvi_torch.models import BuildArgs, build_config, init_dgp
from dgps_with_iwvi_torch.training import TrainConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def local_world(tmp_path_factory):
    rng = np.random.default_rng(0)
    X = rng.standard_normal((64, 3))
    Y = np.sin(X[:, :1]) + 0.1 * rng.standard_normal((64, 1))
    config = build_config(BuildArgs(configuration="LG", mode="IW",
                                    num_inducing=8, num_iw_samples=4),
                          3, 1, 64)
    params = tparams.params_to_numpy(init_dgp(
        torch.Generator().manual_seed(0), config, dtype=torch.float64,
        device="cpu"))
    tc = TrainConfig(lr=1e-2, gamma=1e-2, natgrad="final",
                     minibatch_size=32, steps_per_call=5)
    return W.spawn_world("local_chunks", 4,
                         tmp_path_factory.mktemp("local"),
                         {"config": config, "tc": tc, "params": params,
                          "X": X, "Y": Y})


def test_per_rank_chunks_train_as_the_global_arrays(local_world):
    """shard_arrays(local=True) on each rank's own 'dp' chunk gives, on
    every rank, the losses of the same chunk cut from the global arrays
    (bitwise: the same rows, seeds and sums); every rank sees the same
    summed losses."""
    for r in local_world:
        np.testing.assert_array_equal(r["local"], r["global"])
        np.testing.assert_array_equal(r["local"], local_world[0]["local"])
        assert np.isfinite(r["local"]).all()


def test_per_rank_chunks_of_unequal_size_are_refused(local_world):
    for r in local_world:
        assert r["unequal"] is not None
        assert "from 32 to 35 rows" in r["unequal"], r["unequal"]


def test_import_initializes_neither_cuda_nor_a_process_group():
    """Importing the package (the parallel modules included) starts no
    CUDA context and joins no process group: initialize() must be able to
    come first."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import torch, torch.distributed as dist\n"
            "import dgps_with_iwvi_torch\n"
            "from dgps_with_iwvi_torch import parallel\n"
            "from dgps_with_iwvi_torch.experiments import main, serve\n"
            "assert not torch.cuda.is_initialized(), 'CUDA initialized'\n"
            "assert not dist.is_initialized(), 'a process group exists'\n"
            % REPO)
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR")}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


SMALL = ["--dataset", "energy", "--data_dir", "{tmp}/data", "--max_n", "300",
         "--configuration", "LGG", "--mode", "IW", "--M", "16", "--K", "4",
         "--steps_per_call", "10", "--device", "cpu", "--dtype", "float64",
         "--print_every", "0",
         "--num_predict_samples", "4", "--results_db", "{tmp}/r.db",
         "--ckpt_dir", "{tmp}/ck", "--ckpt_every", "10"]


@pytest.fixture(scope="module")
def cli_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")

    def argv(args):
        return [a.format(tmp=tmp) for a in args]

    payload = {
        "train": argv(SMALL + ["--iterations", "20", "--shard", "--n_k",
                               "2"]),
        "resume": argv(SMALL + ["--iterations", "30", "--shard", "--n_k",
                                "2", "--resume"]),
        "serve": argv(["--dataset", "energy", "--data_dir", "{tmp}/data",
                       "--ckpt_dir", "{tmp}/ck", "--device", "cpu",
                       "--num_predict_samples", "4", "--batch_size", "25",
                       "--output", "{tmp}/sharded.npz", "--shard"]),
    }
    return tmp, payload, W.spawn_world("cli", 2, tmp / "world", payload)


def _rows(tmp):
    with sqlite3.connect(tmp / "r.db") as conn:
        return conn.execute("SELECT iterations, test_loglik FROM regression"
                            " ORDER BY id").fetchall()


def test_sharded_cli_writes_one_row_from_rank_0(cli_world):
    """dgp-train-torch --shard --n_k 2 over two ranks (a 1x2 mesh) writes
    one results row, from rank 0, with the metrics every rank computed
    (the resumed run below writes the second); each checkpoint once."""
    tmp, _, ranks = cli_world
    rows = _rows(tmp)
    assert len(rows) == 2 and rows[0][0] == 20, rows
    first = [r["rows"][0] for r in ranks]
    assert first[0]["test_loglik"] == first[1]["test_loglik"]
    assert np.isclose(rows[0][1], first[0]["test_loglik"], rtol=1e-12)
    assert np.isfinite(first[0]["test_loglik"])
    assert sorted(f for f in os.listdir(tmp / "ck") if f.endswith(".pt")) \
        == ["step_10.pt", "step_20.pt", "step_30.pt"]


def test_sharded_cli_resumes_on_every_rank(cli_world):
    """--resume restores the step-20 checkpoint on both ranks and trains
    to step 30: the second row, the same on every rank."""
    tmp, _, ranks = cli_world
    rows = _rows(tmp)
    assert rows[1][0] == 30
    resumed = [r["rows"][1] for r in ranks]
    assert resumed[0]["test_loglik"] == resumed[1]["test_loglik"]
    assert np.isclose(rows[1][1], resumed[0]["test_loglik"], rtol=1e-12)


def test_sharded_serve_equals_unsharded(cli_world):
    """dgp-serve-torch --shard over two ranks splits every batch of 25
    rows 13 + 12 (+ one padding row): rank 0's .npz equals the unsharded
    scoring of the same checkpoint, row for row, with the same noise per
    row. The served model is float32, and a piece of 13 rows sums its
    float32 products in another order than a batch of 25 (measured up to
    3.2e-8 relative), so the rows are held at rtol 1e-6, the reference's
    float32 gate for its sharded evaluation
    (tests/test_parallel.py:362-363)."""
    tmp, payload, ranks = cli_world
    argv = [a for a in payload["serve"] if a != "--shard"]
    argv[argv.index(str(tmp / "sharded.npz"))] = str(tmp / "single.npz")
    single = serve.run(serve.parse_args(argv))
    assert ranks[0]["served"]["n"] == single["n"]
    a, b = np.load(tmp / "sharded.npz"), np.load(tmp / "single.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=0,
                                   err_msg=k)


def test_spawned_ranks_past_their_deadline_are_killed(tmp_path):
    """``parallel.launch.spawn_ranks`` kills every rank that outlasts its
    deadline and raises."""
    from dgps_with_iwvi_torch.parallel import launch

    with pytest.raises(TimeoutError, match="ran past 2 s"):
        launch.spawn_ranks(W.sleeper, 2, 600.0, timeout_s=2.0)


@pytest.mark.parametrize("device,world,cards,want", [
    ("cpu", 2, 0, "gloo"),
    ("cuda", 10, 1, "gloo"),      # ten ranks on one card
    ("cuda", 4, 4, "nccl"),       # a card for each rank
    ("cuda", 4, 2, "gloo"),
])
def test_join_group_picks_the_backend(monkeypatch, tmp_path, device, world,
                                      cards, want):
    from dgps_with_iwvi_torch.parallel import distributed, launch

    seen = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(distributed, "initialize",
                        lambda *a, **kw: seen.append((a, kw)))
    assert launch.join_group(1, world, str(tmp_path), device) == want
    (backend, init, n, rank), kw = seen[0]
    assert (backend, n, rank, kw["device"].type) == (want, world, 1, device)
    assert init == "file://" + str(tmp_path / "store")
