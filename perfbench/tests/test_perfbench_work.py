"""The frozen work formulas give today's values at the cells' shapes:
the training step's FLOPs equal the port's ``step_cost`` (11.405 GFLOP
for LGG-kin8nm at B=512), K3's and K4's work and bounds equal
``ops/hopper/cost.py``'s, and the scoring count per row is the hand
count of its products."""

import json

import pytest

from pb_tiny import BENCH, CELLS, ROOT, driver_of
from perfbench import harness, system, tracing, traffic, work
from perfbench.reference import dgp_ref

CARD = "NVIDIA H100 80GB HBM3"


def _cell(name):
    files = harness.files_of(ROOT, BENCH, name)
    cfg = json.loads(files["config"].read_text())
    mix = json.loads(files["traffic"].read_text())
    ds = cfg["dataset"]
    return cfg, mix, traffic.specs_of(cfg), int(ds["train_share"] * ds["N"])


TRAIN = [c for c in CELLS if driver_of(c).DRIVES == "fit"]
SCORE = [c for c in CELLS if driver_of(c).DRIVES == "score"]
REMAT_MIN_BYTES = 64 * 1024 * 1024


@pytest.mark.parametrize("cell", TRAIN)
def test_train_step_flops_equal_the_ports_count(cell):
    """The frozen count at the rows the step computes is the port's, but
    for the full-batch step's recomputed q-variance forward, which the
    port counts where the float32 residual would pass 64 MiB."""
    from dgps_with_iwvi_torch import training
    from dgps_with_iwvi_torch.utils.flops import step_cost

    cfg, mix, specs, n = _cell(cell)
    m = cfg["model"]
    M, K, mb = m["num_inducing"], m["num_iw_samples"], mix["minibatch_size"]
    rows, full = work.step_rows(cfg["dataset"], mb)
    config = system.port_config(cfg, cfg["dataset"]["D"], 1, n)
    tc = training.TrainConfig(natgrad="final", minibatch_size=mb)
    frozen = work.train_step_flops(specs, m["encoder_hidden"], 1, M, K,
                                   rows, full=full)
    C = K * rows
    remat = sum(2 * D * M * M * C for _, D, _ in work.gp_layers(specs)
                if full and D * C * M * 4 > REMAT_MIN_BYTES)
    assert frozen + remat == step_cost(config, tc, n)["flops"]


@pytest.mark.parametrize("cell", TRAIN)
def test_train_readers_read_as_before(cell):
    """mfu.train and k3_roofline.train on a synthetic trace of a training
    cell: at a minibatch under the training rows they read what the
    minibatch's count gave before the readers counted the step's rows
    (a final width of 1, B the minibatch); on the full-batch step, the
    count at every training row."""
    cfg, mix, specs, n = _cell(cell)
    m, mb = cfg["model"], mix["minibatch_size"]
    assert specs == dgp_ref.layer_specs(m, cfg["dataset"]["D"], 1)
    B, full = (mb, False) if mb < n else (n, True)
    assert work.step_rows(cfg["dataset"], mb) == (B, full)
    assert work.step_rows(cfg["dataset"], n) == (n, True)
    trace = tracing.Trace(
        [("void k3_epilogue_bwd::pass1_kernel", 0, 400_000_000, "kernel"),
         ("elementwise", 400_000_000, 900_000_000, "kernel")], [],
        (0, 1_000_000_000))
    ctx = harness.Context(trace, {"steps": 500}, cfg, mix, specs, CARD,
                          work)
    flops = work.train_step_flops(specs, m["encoder_hidden"], 1,
                                  m["num_inducing"], m["num_iw_samples"],
                                  B, full=full)
    mfu = harness.load_reader(ROOT / "perfbench/metrics/mfu.train.py")
    assert mfu(ctx) == pytest.approx(100 * flops * 500 / 1.0 / 989e12,
                                     rel=1e-12)
    k3 = harness.load_reader(ROOT / "perfbench/metrics/k3_roofline.train.py")
    bound = work.k3_bound_s_per_step(CARD, specs, m["num_inducing"],
                                     m["num_iw_samples"], B)
    assert k3(ctx) == pytest.approx(100 * bound * 500 / 0.4, rel=1e-12)


def test_flagship_step_pinned():
    cfg, mix, specs, _ = _cell("train.lgg-kin8nm.b512")
    assert work.train_step_flops(specs, [20, 20], 1, 128, 20, 512) \
        == 11_404_984_320


@pytest.mark.parametrize("cell", TRAIN)
def test_k3_work_and_bound_equal_cost_py(cell):
    from dgps_with_iwvi_torch.ops.hopper import cost

    cfg, mix, specs, _ = _cell(cell)
    m = cfg["model"]
    K, M = m["num_iw_samples"], m["num_inducing"]
    B, _ = work.step_rows(cfg["dataset"], mix["minibatch_size"])
    total = 0.0
    for _, D, _ in work.gp_layers(specs):
        assert work.k3_work(K, M, B, D) == tuple(
            cost.epilogue_bwd(K, M, B, D, "epi"))
        total += cost.bound(*cost.epilogue_bwd(K, M, B, D, "epi"))[0] / 1e3
    assert work.k3_bound_s_per_step(CARD, specs, M, K, B) \
        == pytest.approx(total, rel=1e-12)


@pytest.mark.parametrize("cell", SCORE)
def test_k4_work_and_bound_equal_cost_py(cell):
    from dgps_with_iwvi_torch.ops.hopper import cost

    cfg, mix, specs, _ = _cell(cell)
    M, S, b = (cfg["model"]["num_inducing"], mix["num_samples"],
               mix["batch_rows"])
    total = 0.0
    for d_in, D, final in work.gp_layers(specs):
        ref = cost.serve_cond(S * b, d_in, M, D, not final)
        assert work.k4_work(S * b, d_in, M, D, not final)[:2] == \
            tuple(ref)[:2]
        total += cost.bound(*ref)[0] / 1e3
    assert work.k4_bound_s_per_batch(CARD, specs, M, S, b) \
        == pytest.approx(total, rel=1e-12)


def test_score_flops_per_row_by_hand():
    # LGG on kin8nm: GP 9 -> 8 (skip 9 -> 8), GP 8 -> 1; M=128, S=100
    layer1 = 2 * 128 * 9 + 2 * 128 ** 2 + 2 * 128 * 8 + 2 * 8 * 128 ** 2 \
        + 2 * 9 * 8
    layer2 = 2 * 128 * 8 + 2 * 128 ** 2 + 2 * 128 + 2 * 128 ** 2
    kuu = 2 * 128 ** 2 * (9 + 8) / 8192
    _, _, specs, _ = _cell("score.lgg-kin8nm.s100")
    assert work.score_flops_per_row(specs, 128, 100, 8192) == \
        pytest.approx(100 * (layer1 + layer2) + kuu, rel=1e-15)


def test_peaks_are_the_data_sheets():
    from dgps_with_iwvi_torch.utils import flops

    p = work.peaks(CARD)
    assert (p["bf16"], p["f32"]) == flops.PEAK_FLOPS[CARD]
    assert p["bytes"] == flops.PEAK_BYTES[CARD]
