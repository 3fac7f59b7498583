"""``correct`` comes out true for a sound run and false for each fault
the cells can have, and for the control: a whole run of each cell,
shrunk and on the CPU with the chip check skipped, with the timed path
broken underneath (a fault planted in the port), or the reference in
bfloat16 put in the program's place. Every cell runs on one chip, so
no exchange between chips can be left out."""

import json
import time

import pytest
import torch

from pb_tiny import (BENCH, CELLS, SEED, driver_of, run_tiny,  # noqa: F401
                     tiny)
from perfbench import calibrate, check, inputs, traffic

# the cells by the port entry point their driver drives
TRAIN = [c for c in CELLS if driver_of(c).DRIVES == "fit"]
SCORE = [c for c in CELLS if driver_of(c).DRIVES == "score"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, tiny):
    files, _, _ = tiny(cell)
    out = run_tiny(files, cell)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] > 0 and out["failed"] == 0


def _half_batch(orig):
    def elbo(params, config, X, Y, generator=None, **kw):
        h = X.shape[0] // 2
        return orig(params, config, X[:h], Y[:h], generator, **kw)
    return elbo


def _scaled_loss(orig):
    def elbo(*a, **kw):
        return orig(*a, **kw) * 1.01
    return elbo


def _natural_step_off_from_step2(orig):
    """The natural-gradient update with its step size half again as large
    from its second call on: a fault in the replayed steps alone (the
    first step runs for real, the later ones replay), in the block alone."""
    calls = []

    def update(natvars, grads, gamma):
        calls.append(1)
        return orig(natvars, grads, gamma * (1.5 if len(calls) > 1 else 1))
    return update


@pytest.mark.parametrize("cell", TRAIN)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "loss_altered", "natural_from_step2"])
def test_training_fault_is_caught(cell, fault, tiny, monkeypatch):
    from dgps_with_iwvi_torch.models import dgp
    from dgps_with_iwvi_torch.training import natgrad

    if fault == "natural_from_step2":
        monkeypatch.setattr(natgrad, "natgrad_update",
                            _natural_step_off_from_step2(
                                natgrad.natgrad_update))
    elif fault == "state_unchanged":
        monkeypatch.setattr(torch.optim.Adam, "step",
                            lambda self, closure=None: None)
        monkeypatch.setattr(natgrad, "natgrad_update",
                            lambda natvars, grads, gamma: natvars)
    elif fault == "half_batch":
        monkeypatch.setattr(dgp, "elbo", _half_batch(dgp.elbo))
    else:
        monkeypatch.setattr(dgp, "elbo", _scaled_loss(dgp.elbo))
    files, _, _ = tiny(cell)
    out = run_tiny(files, cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", SCORE)
def test_altered_answer_is_caught(cell, tiny, monkeypatch):
    from dgps_with_iwvi_torch.models import dgp

    orig = dgp._mixture_moments

    def moments(*a, **kw):
        m, v = orig(*a, **kw)
        m = m.clone()
        m[0] = m[0] + 0.1
        return m, v

    monkeypatch.setattr(dgp, "_mixture_moments", moments)
    files, _, _ = tiny(cell)
    out = run_tiny(files, cell)
    assert not out["correct"], out["checks"]
    assert out["checks"]["mean_gap"]["value"] > \
        out["checks"]["mean_gap"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_bf16_control_is_not_correct(cell, tiny):
    files, cfg, mix = tiny(cell)
    c = traffic.Cell(cell, cfg, mix, inputs.Seeds.of(SEED), 0.0, False,
                     torch.device("cpu"), time.perf_counter())
    numbers = calibrate.control_numbers(c, "bf16")
    limits = json.loads(files["limits"].read_text())
    numbers = {k: numbers[k] for k in limits}
    correct, _ = check.judge(numbers, limits)
    assert not correct, numbers
