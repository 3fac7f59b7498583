#!/usr/bin/env python
"""Device time by kernel of the flagship training step (port of
benchmarks/profile_step.py).

The reference traces a few jitted chunks of steps on its accelerator
(xprof) and prints the device self time by op (l.30-129). Here
``torch.profiler`` (CUPTI) traces ``--calls`` chunks of ``--steps``
steps on the card: by default replays of the captured step
(``training.graphed_chunk_fn``, the counterpart of the reference's
``jax.jit(chunk_fn)``), with ``--eager`` the eager chunk. It prints the
device self time per step, then the top 30 kernels (ms per step, share
of the step, calls per step, name), the device's idle share of the
window with its idle time split into starved gaps, by the program's span
(``utils.trace``), and the graph's node gaps (``idle_split``), and the
hand kernels' launches per step with their work
(``ops.hopper.build.launch_costs``); ``run`` returns the same as a dict
and ``--out`` writes it as JSON, with the card's name and power limit.

The flagship as the reference builds it (l.43-58): kin8nm split 0 (its
name-seeded surrogate where no UCI file is staged), tiled to a true
B-row minibatch when B > N as bench.py:70-77 does, LGG, IW, M=128, K=20,
``lr=5e-3``, ``gamma=1e-2``, natgrad on the final layer.

    python -m dgps_with_iwvi_torch.experiments.profile_step \\
        [--minibatch 512|8192] [--steps 100] [--calls 3] [--eager] \\
        [--out FILE.json] [--device cpu]

On ``--device cpu`` the step runs eagerly on the host and the profile
holds the host's self time by op (``host_ms_per_step``), not a device
time. ``profile_window``, ``profile_train`` and ``profile_serve`` are
also chip_smoke.py's.
"""

from __future__ import annotations

import argparse
import bisect
import heapq
import json
import time

import torch

from dgps_with_iwvi_torch import training as train
from dgps_with_iwvi_torch.data import get_regression_data
from dgps_with_iwvi_torch.device import backend, resolve_device
from dgps_with_iwvi_torch.models import BuildArgs, build_model
from dgps_with_iwvi_torch.ops.hopper import build
from dgps_with_iwvi_torch.utils import trace

TOP = 30
WINDOW = "profile_step.window"


def flagship(minibatch: int, steps_per_call: int, device):
    """(config, params, X, Y, tc) of the reference's flagship (l.43-58) on
    `device`; X and Y tiled past `minibatch` rows where it exceeds the
    training split."""
    data = get_regression_data("kin8nm", 0)
    X, Y = data.X_train, data.Y_train
    if minibatch > X.shape[0]:
        # a true B-row minibatch rather than the full-batch step
        reps = (minibatch + X.shape[0] - 1) // X.shape[0] + 1
        X, Y = X.repeat(reps, 0), Y.repeat(reps, 0)
    args = BuildArgs(configuration="LGG", mode="IW", num_inducing=128,
                     num_iw_samples=20)
    config, params = build_model(0, args, X, Y, device=device)
    tc = train.TrainConfig(lr=5e-3, gamma=1e-2, natgrad="final",
                           minibatch_size=minibatch,
                           steps_per_call=steps_per_call)
    X = torch.as_tensor(X, device=device)
    Y = torch.as_tensor(Y, device=device)
    return config, params, X, Y, tc


def device_rows(averages, per: int, device_type: str = "CUDA"):
    """(rows, annotation rows) of a profile's ``key_averages()``, each (ms
    per unit, calls per unit, name), for events of `device_type` with
    self time there (device time for "CUDA", host time for "CPU").
    User-annotation spans (record_function ranges such as
    ``Optimizer.step#Adam.step``) cover queued work, not a kernel: they
    are kept apart and out of "device busy"."""
    rows, spans = [], []
    for e in averages:
        if not str(e.device_type).endswith(device_type):
            continue
        us = (e.self_device_time_total if device_type == "CUDA"
              else e.self_cpu_time_total)
        if us > 0:
            row = (us / 1e3 / per, e.count / per, e.key)
            (spans if getattr(e, "is_user_annotation", False)
             else rows).append(row)
    return rows, spans


def _union(intervals) -> list:
    """Sorted, merged [(start, end)] of intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def _innermost(spans) -> list:
    """[(start, end, name)]: the time that `spans` [(start, end, name)]
    cover, cut where the innermost open span (the one opened last)
    changes."""
    cuts = sorted({t for s, e, _ in spans for t in (s, e)})
    order, open_, out, j = sorted(spans), [], [], 0
    for a, b in zip(cuts, cuts[1:]):
        while j < len(order) and order[j][0] <= a:
            s, e, name = order[j]
            heapq.heappush(open_, (-s, e, name))
            j += 1
        while open_ and open_[0][1] <= a:
            heapq.heappop(open_)
        if open_:
            out.append((a, b, open_[0][2]))
    return out


def idle_split(events, window) -> dict:
    """The device's busy and idle time over `window` (start_ns, end_ns)
    of a profile's events (``prof.profiler.kineto_results.events()``),
    with the idle time split in two. Busy is the union of the device's
    operations (kernels, copies, sets), so operations that overlap on
    two streams count once. A gap between them is starved where the
    operation that ends it was launched (its CUDA runtime or driver
    call, joined by correlation id, began) after the gap began, or where
    no operation ends it: the device waited for the host. Otherwise it
    is a node gap: the work was queued, as between the nodes of a
    replayed graph (their launch is the graph's), or its launch is not
    in the profile. Starved time is split across the innermost program
    span (``utils.trace``) open over it, the part outside every program
    span under None. Returns {"window_ns", "busy_ns", "node_gap_ns",
    "starved_ns": {span name or None: ns}}."""
    w0, w1 = window
    ops, launched, spans = [], {}, []
    for ev in events:
        name, s = ev.name(), ev.start_ns()
        e = s + ev.duration_ns()
        if str(ev.device_type()).endswith("CUDA"):
            if not ev.is_user_annotation() and e > w0 and s < w1:
                ops.append((max(s, w0), min(e, w1), ev.correlation_id()))
        elif ev.is_user_annotation():
            if name.startswith(trace.PREFIX) and e > w0 and s < w1:
                spans.append((max(s, w0), min(e, w1), name))
        elif name.startswith("cu") and ev.correlation_id():
            # a CUDA runtime or driver call; a host op's correlation id
            # counts the profiler's ops, not CUPTI's calls
            c = ev.correlation_id()
            launched[c] = min(s, launched.get(c, s))
    first = {}   # an op's start -> the earliest launch of the ops there
    for s, _, c in ops:
        first[s] = min(first.get(s, float("inf")),
                       launched.get(c, float("-inf")))
    busy = _union((s, e) for s, e, _ in ops)
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    pieces = _innermost(spans)
    starts = [p[0] for p in pieces]
    starved, node = {}, 0
    for a, b in gaps:
        if first.get(b, float("inf")) <= a:
            node += b - a
            continue
        left = b - a
        for ps, pe, name in pieces[max(0, bisect.bisect_right(starts, a)
                                       - 1):]:
            if ps >= b:
                break
            part = min(b, pe) - max(a, ps)
            if part > 0:
                starved[name] = starved.get(name, 0) + part
                left -= part
        if left:
            starved[None] = starved.get(None, 0) + left
    return {"window_ns": w1 - w0, "busy_ns": sum(e - s for s, e in busy),
            "node_gap_ns": node, "starved_ns": starved}


def _work_since(before: dict, per: int) -> dict:
    """The hand kernels' launches and work per unit since `before` (a
    ``build.launch_costs()``)."""
    out = {}
    for key, now in build.launch_costs().items():
        was = before.get(key, {})
        diff = {k: (v - was.get(k, 0)) / per for k, v in now.items()}
        if diff["launches"]:
            out[key] = diff
    return out


def profile_window(fn, per: int, unit: str, device, top: int | None = None,
                   **profile_kwargs):
    """(profile, the torch profiler) of one call of ``fn()``, which runs
    `per` units (steps, requests): on the card, the device's self time by
    kernel per unit, the device's idle share of the window (one minus the
    union of its operations over the window, on the profiler's clock; the
    profiler stretches the host's side of it) and that idle time per unit
    split into starved gaps, by program span, and node gaps
    (``idle_split``), the runtime's kernel launches and the hand kernels'
    launches and work per unit; on the CPU, the host's self time by op.
    The annotation rows hold the program's spans (``utils.trace``) and
    the window's own. `top` keeps the largest rows."""
    from torch.profiler import ProfilerActivity, profile, record_function

    on_card = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if on_card else [])
    if on_card:
        torch.cuda.synchronize()
    before = build.launch_costs()
    with profile(activities=activities, **profile_kwargs) as prof:
        with record_function(WINDOW):
            t0 = time.perf_counter()
            fn()
            if on_card:
                torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    rows, spans = device_rows(averages, per, "CUDA" if on_card else "CPU")
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    where, what = ("device", "kernels") if on_card else ("host", "ops")
    out = {f"{unit}s": per, f"wall_ms_per_{unit}": wall_ms / per,
           f"{where}_ms_per_{unit}": busy_ms,
           f"{what}_ms_per_{unit}": [
               {"kernel" if on_card else "op": k[:200], "ms": ms, "calls": c}
               for ms, c, k in rows[:top]],
           f"annotations_ms_per_{unit}": [
               {"span": k[:200], "ms": ms} for ms, _, k in spans]}
    if on_card:
        events = prof.profiler.kineto_results.events()
        (window,) = [(e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in events if e.name() == WINDOW
                     and not str(e.device_type()).endswith("CUDA")]
        split = idle_split(events, window)
        out["idle_share"] = 1.0 - split["busy_ns"] / split["window_ns"]
        out[f"node_gap_ms_per_{unit}"] = split["node_gap_ns"] / 1e6 / per
        out[f"starved_ms_per_{unit}"] = {
            (k or "(no span)"): ns / 1e6 / per
            for k, ns in sorted(split["starved_ns"].items(),
                                key=lambda kv: -kv[1])}
        out[f"kernel_launches_per_{unit}"] = sum(
            e.count for e in averages
            if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC")) / per
        out[f"hand_kernels_per_{unit}"] = _work_since(before, per)
    return out, prof


def profile_train(step, state, X, Y, gen, steps: int = 5) -> dict:
    """Device time by kernel over `steps` eager training steps."""
    def body():
        s = state
        for _ in range(steps):
            s, _ = step(s, X, Y, gen)

    return profile_window(body, steps, "step", X.device, top=40)[0]


def profile_chunk(chunk, state, X, Y, gen, steps: int) -> dict:
    """Device time by kernel over one chunk of `steps` steps (a graphed
    chunk replays one graph per step)."""
    return profile_window(lambda: chunk(state, X, Y, gen), steps, "step",
                          X.device, top=40)[0]


def profile_serve(scorer, Xs, Ys, batch: int, requests: int = 2) -> dict:
    """Device time by kernel over `requests` scored batches of `batch`
    rows through ``serving.Scorer.score``."""
    return profile_window(
        lambda: scorer.score(Xs[:requests * batch], Ys[:requests * batch],
                             seed=7),
        requests, "request", scorer.device)[0]


def run_chunks(config, params, X, Y, tc, calls: int, eager: bool,
               top: int = TOP, **profile_kwargs):
    """(profile, profiler) of `calls` chunks of the trainer's steps after
    two chunks of warm-up (the first graphed one captures the step)."""
    init, step, chunk, _ = train.make_trainer(config, tc)
    state = init(params)
    gen = torch.Generator(device=X.device).manual_seed(0)
    if not eager and X.device.type == "cuda":
        chunk = train.graphed_chunk_fn(step, tc, state, X, Y, gen)
    held = {"state": state}

    def chunks(n):
        for _ in range(n):
            held["state"], losses = chunk(held["state"], X, Y, gen)
        if not bool(torch.isfinite(losses).all()):
            raise RuntimeError("profile_step: a training loss is not finite")

    chunks(2)
    return profile_window(lambda: chunks(calls), calls * tc.steps_per_call,
                          "step", X.device, top=top, **profile_kwargs)


def run(minibatch: int = 512, steps: int = 100, calls: int = 3,
        eager: bool = False, device="cuda", setup=None) -> dict:
    """The profile of the flagship's chunks (see the module docstring);
    `setup`: (config, params, X, Y, tc) in place of ``flagship``'s."""
    device = resolve_device(device)
    if setup is None:
        setup = flagship(minibatch, steps, device)
    config, params, X, Y, tc = setup
    prof, _ = run_chunks(config, params, X, Y, tc, calls, eager)
    graphed = not eager and device.type == "cuda"
    return {"backend": backend(device), "minibatch": tc.minibatch_size,
            "steps_per_call": tc.steps_per_call, "calls": calls,
            "graphed": graphed, **prof}


def report(rec: dict) -> list:
    """The printed lines of a profile record."""
    per = rec["steps"]
    on_card = "device_ms_per_step" in rec
    where = "device" if on_card else "host"
    total = rec[f"{where}_ms_per_step"]
    lines = [f"{rec['backend']}; B={rec['minibatch']}, "
             f"{'graphed' if rec['graphed'] else 'eager'} steps",
             f"{where} self time total: {total * per * 1e3:.0f} us over "
             f"{per} steps = {total * 1e3:.1f} us/step", "",
             f"{'ms/step':>9}  {'%':>5}  {'calls':>6}  "
             f"{'kernel' if on_card else 'op'}"]
    for r in rec["kernels_ms_per_step" if on_card else "ops_ms_per_step"]:
        lines.append(f"{r['ms']:9.4f}  {100 * r['ms'] / total:5.1f}  "
                     f"{r['calls']:6.2f}  "
                     f"{r['kernel' if on_card else 'op'][:110]}")
    if on_card:
        lines += ["", f"idle share of the window: {rec['idle_share']:.3f}; "
                      f"runtime kernel launches per step: "
                      f"{rec['kernel_launches_per_step']:.1f}",
                  f"idle per step: node gaps "
                  f"{rec['node_gap_ms_per_step'] * 1e3:.1f} us; starved "
                  + (", ".join(f"{k} {v * 1e3:.1f} us" for k, v in
                               rec["starved_ms_per_step"].items())
                     or "none"),
                  "hand kernels per step: " + ", ".join(
                      f"{k} {v['launches']:g}" for k, v in
                      sorted(rec["hand_kernels_per_step"].items()))]
    return lines


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--minibatch", type=int, default=512,
                   help="512 = the flagship latency-sensitive config; "
                        "8192 = the compute-bound throughput row")
    p.add_argument("--steps", type=int, default=100,
                   help="steps per chunk")
    p.add_argument("--calls", type=int, default=3,
                   help="chunks profiled")
    p.add_argument("--eager", action="store_true",
                   help="profile eager steps, not graph replays")
    p.add_argument("--out", default=None, help="write the record as JSON")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch "
                        "versions of the kernels on the host")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    a = parse_args(argv)
    rec = run(a.minibatch, a.steps, a.calls, a.eager, a.device)
    print("\n".join(report(rec)), flush=True)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


if __name__ == "__main__":
    main()
