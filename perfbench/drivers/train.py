"""Training traffic (mix kind "train"): ``training.fit`` on the card, as
the CLI runs it.

One step object (the port's ``TrainState``) serves every phase. Set-up
drives it from the seed through ``lead_in``, a list of
[steps_per_call, up to step] stages of ``fit``: the first stage runs one
step per chunk, so that the benchmark sees the state after each of the
first ``checked_steps`` steps (the reference follows those); the later
stages take it on in longer chunks, without a callback, up to a step
that the window's ``steps_per_call`` divides (``fit`` resumes only at a
chunk boundary). Each stage's ``fit`` captures the step as a CUDA graph
of its own after running it once for real, so steps 2 on of the checked
ones replay a capture of the step function that the window replays.

Then ``fit`` runs on with ``steps_per_call`` steps per chunk and a
callback after each chunk: its first chunk captures the step's graph.
Set-up ends at the first chunk boundary ``warm_seconds`` after the
lead-in's second stage began (the full load from there on warms); the
window is the chunks after it, up to the first chunk boundary past the
window's seconds. Why ``warm_seconds``: a new process on the card ran
its first 5 to 15 s of full training load 10-13% slower, then held its
rate within 0.1% (5 s blocks over 60 s); the length of that slow phase
varied from run to run, up to 15 s.

A mix whose ``minibatch_size`` is at least the training rows runs the
port's full-batch step (every row, in order; the q-variance and solve
classes as the configuration's ``precision.full_batch_precision`` says,
``auto`` where absent), and the checked steps' draws (``draws``) follow
it.
"""

from __future__ import annotations

import copy
import time

import numpy as np
import torch

from perfbench import check, system, tracing, traffic
from perfbench.reference import dgp_ref

NUMBERS = ("loss_gap", "grad_gap", "change_gap", "nat_change_gap")
# the reference with its products' operands rounded to TF32 and to
# bfloat16, and the fault that leaves half of each batch out (the
# objective's mean over the other half)
CONTROLS = ("tf32", "bf16", "half_batch")
DRIVES = "fit"
REFERENCE = dgp_ref


class WindowClosed(Exception):
    """Raised from fit's callback to end the run at a chunk boundary."""


def stages(tr: dict) -> list:
    """The lead-in's [steps_per_call, up to step] stages, checked."""
    spc, n_check, lead = (tr["steps_per_call"], tr["checked_steps"],
                          tr["lead_in"])
    if lead[0][0] != 1 or lead[0][1] < max(n_check, check.GRAD_STEPS):
        raise ValueError("the lead-in's first stage runs one step per "
                         "chunk over the checked steps")
    done = 0
    for per, until in lead:
        if until <= done or until % per:
            raise ValueError("each lead-in stage ends past the last, on a "
                             "multiple of its steps_per_call")
        done = until
    if done % spc:
        raise ValueError("the lead-in ends on a multiple of steps_per_call")
    return lead


def shrink(cfg: dict, mix: dict) -> tuple:
    """(cfg, mix) at the CPU tests' size: 2,000 rows, K=4, chunks of 3
    steps and no warm phase."""
    cfg, mix = copy.deepcopy(cfg), copy.deepcopy(mix)
    cfg["dataset"].update(N=2000)
    cfg["model"].update(num_iw_samples=4)
    mix.update(steps_per_call=3, lead_in=[[1, 3], [3, 6]], warm_seconds=0)
    return cfg, mix


def draws(cell: traffic.Cell, data) -> list:
    """The draws of the checked steps, from a generator of the run's
    seed, as the port's step draws them: a minibatch smaller than the
    training rows draws its rows, then each layer's noise; the full-batch
    step (a minibatch of at least the training rows) takes every row in
    order and draws only the noise, so the data scale N / B is 1."""
    n, mb = data.X.shape[0], cell.traffic["minibatch_size"]
    K = cell.cfg["model"]["num_iw_samples"]
    gen = torch.Generator(device=cell.device).manual_seed(cell.seeds.run)
    rows = torch.arange(n, device=cell.device)
    return [(rows, dgp_ref.draw_noise(gen, n, K, cell.specs)) if mb >= n
            else dgp_ref.draw_train(gen, n, mb, K, cell.specs)
            for _ in range(cell.traffic["checked_steps"])]


def run(cell: traffic.Cell) -> traffic.Outcome:
    tr, spec = cell.traffic, cell.cfg["train"]
    lead = stages(tr)
    data, weights = traffic.make_inputs(cell)
    specs, device = cell.specs, cell.device
    config = system.port_config(cell.cfg, data.X.shape[1], 1,
                                data.X.shape[0])
    params = system.port_params(weights, specs)
    spc, n_check = tr["steps_per_call"], tr["checked_steps"]
    tc, init = system.trainer(config, dict(
        lr=spec["lr"], gamma=spec["gamma"], natgrad=spec["natgrad"],
        schedule=spec["schedule"], minibatch_size=tr["minibatch_size"],
        full_batch_precision=cell.cfg["precision"].get(
            "full_batch_precision", "auto")))
    state = init(params)
    named = system.leaves(state, specs)
    start = {k: v.detach().clone() for k, v in named.items()}
    gen = torch.Generator(device=device).manual_seed(cell.seeds.run)
    seen: dict = {"losses": [], "moments": [], "states": [],
                  "natvars": [system.natvars(state)]}

    def lead_cb(step, loss, st):
        if step <= n_check:
            seen["losses"].append(loss)
        if step <= check.GRAD_STEPS:
            seen["moments"].append(system.adam_first_moments(st, named))
            seen["natvars"].append(system.natvars(st))
        if step < check.GRAD_STEPS:
            seen["states"].append({k: v.detach().clone() for k, v in
                                   system.leaves(st, specs).items()})
        if step == n_check:
            seen["after"] = {k: v.detach().clone()
                             for k, v in system.leaves(st, specs).items()}

    clock = {"chunks": 0, "failed": 0, "lengths": []}
    for i, (per, until) in enumerate(lead):
        if i == 1:                       # full load from here: warming
            traffic.sync(device)
            clock["warm0"] = time.perf_counter()
        system.fit(gen, config, params, data.X, data.Y,
                   tc(steps_per_call=per, iterations=until),
                   lead_cb if i == 0 else None, state)
    traffic.sync(device)
    cell.log(f"lead-in to step {lead[-1][1]}")

    traced = tracing.Window(cell.trace)

    def cb(step, loss, st):
        now = time.perf_counter()
        if "w0" not in clock:            # set-up: the capture, then warming
            clock.setdefault("warm0", now)
            if now - clock["warm0"] < tr["warm_seconds"]:
                return
            clock["setup_s"] = now - cell.t0
            clock["w0"] = now
            cell.log("window opens after the capture and the warm chunks")
            traced.start()
            traced.enter("train.chunk")
            return
        traced.exit()
        traced.enter("train.callback")
        clock["chunks"] += 1
        clock["lengths"].append(now - clock.get("t1", clock["w0"]))
        clock["t1"] = now
        if not np.isfinite(loss):
            clock["failed"] += spc
        if (clock["chunks"] >= tr["traced_chunks"] if cell.trace
                else now - clock["w0"] >= cell.seconds):
            raise WindowClosed
        traced.exit()
        traced.enter("train.chunk")

    try:
        system.fit(gen, config, params, data.X, data.Y,
                   tc(steps_per_call=spc, iterations=1 << 60), cb, state)
    except WindowClosed:
        pass
    traffic.sync(device)
    trace = traced.stop()
    cell.log("window closed")
    cell.log("chunks per 10 s of the window (n, median ms, p95 ms): "
             + traffic.blocks(clock["lengths"], 10.0))
    steps = clock["chunks"] * spc
    e2e = {"setup_s": clock["setup_s"],
           "train_steps_per_s": steps / (clock["t1"] - clock["w0"])}
    peak = traffic.memory_peak(device)
    prog_grads = check.program_grads(seen["moments"], seen["natvars"],
                                     spec["gamma"])
    del state, params, named
    traffic.free(device)

    steps_drawn = draws(cell, data)
    ref = reference(cell, data, weights, steps_drawn)
    ref_grads = step_grads(cell, data, weights, ref["grads"][0],
                           seen["states"], steps_drawn)
    cell.log("reference done")
    numbers, readings = check.train_numbers(seen["losses"], prog_grads,
                                            ref_grads, start, seen["after"],
                                            ref)
    return traffic.Outcome(e2e["setup_s"], e2e, steps, clock["failed"],
                           {"steps": steps}, trace, peak, numbers, readings)


def reference(cell: traffic.Cell, data, weights, draws, mode="f64") -> dict:
    spec = cell.cfg["train"]
    return dgp_ref.train(weights, cell.specs, data.X, data.Y, draws,
                         data.X.shape[0], spec["lr"], spec["gamma"],
                         dgp_ref.Arith(mode))


def state_weights(weights: dict, leaves: dict, specs: list) -> dict:
    """`weights` with each value taken from `leaves`, a state after some
    steps under the names of ``system.leaves`` (the final layer's q(u) as
    "final.q_mu", "final.q_S"), in float64: a state to follow from."""
    fi = len(specs) - 1
    layers = []
    for i, lw in enumerate(weights["layers"]):
        lp = {k: leaves.get(f"{i}.{k}", v).detach().double()
              for k, v in lw.items()}
        if i == fi:
            lp["q_mu"] = leaves["final.q_mu"].detach().double()
            lp["q_sqrt"] = torch.linalg.cholesky(
                leaves["final.q_S"].detach().double())
        layers.append(lp)
    return {"layers": layers, "likelihood": {
        "raw_noise_variance":
            leaves["likelihood.raw_noise_variance"].detach().double()}}


def step_grads(cell: traffic.Cell, data, weights, first: dict,
               states: list, draws: list, mode="f64") -> list:
    """The reference's gradient of each compared step: the first step's
    (`first`, from `weights`), then step t+1's at the state after step t
    (``states[t - 1]``) on step t+1's draw, so that a later step is held
    to the gradient at the state it started from and not to the
    reference's own trajectory, which parts from it by the rounding of
    the steps before (Adam moves an element whose gradient is near zero
    by its learning rate either way)."""
    return [first] + [
        reference(cell, data, state_weights(weights, s, cell.specs),
                  draws[t:t + 1], mode)["grads"][0]
        for t, s in enumerate(states, 1)]


def control_numbers(cell: traffic.Cell, mode: str) -> dict:
    """The numbers of one control in the program's place (``CONTROLS``),
    held to the float64 reference by the same comparison. The half-batch
    fault takes the first half of each step's rows."""
    data, weights = traffic.make_inputs(cell)
    steps_drawn = draws(cell, data)
    ref = reference(cell, data, weights, steps_drawn)
    got_draws, got_mode = steps_drawn, mode
    if mode == "half_batch":
        got_draws = [(idx[:len(idx) // 2],
                      [None if e is None else e[:, :len(idx) // 2]
                       for e in eps]) for idx, eps in steps_drawn]
        got_mode = "f64"
    got = reference(cell, data, weights, got_draws, got_mode)
    # the control in the program's place: its own states after the
    # steps before each compared one, held to the reference there
    states = [reference(cell, data, weights, got_draws[:t],
                        got_mode)["params"]
              for t in range(1, check.GRAD_STEPS)]
    got_grads = step_grads(cell, data, weights, got["grads"][0], states,
                           got_draws, got_mode)
    ref_grads = step_grads(cell, data, weights, ref["grads"][0], states,
                           steps_drawn)
    numbers, readings = check.train_numbers(
        got["losses"], got_grads, ref_grads, got["start"], got["params"],
        ref)
    return {**numbers, **readings}
