#!/usr/bin/env python
"""Per-op roofline of the flagship training step (port of
benchmarks/roofline.py).

One row per op of the step on the card, with the reference's columns
(l.94-136): the measured device time per step, its share, what bounds
it, the achieved GB/s and GF/s, the attainable time
``max(bytes / memory peak, flops / peak of the operands' type)`` and the
headroom (measured over attainable); the last line is the speed of
light of this op mix, the sum over the rows of the smaller of the
measured and the attainable time (a row with no modelled bytes or flops
counts its measured time, l.121-124). ``--out-md`` writes the table.

Time and attribution. A graph replay carries no ops to attribute a
kernel to, so the rows come from eager steps profiled with
``record_shapes``, ``with_flops`` and ``with_stack`` (with the verbose
experimental config, without which torch 2.11 records no stack and no
dtype on the events): each device kernel
is joined to the op that launched it through the profiler's event tree,
a backward op named by its autograd node (the reference's
``transpose(jvp())``) and placed at its forward op's source line. Beside
the rows' total the table gives the graphed device time per step
(``profile_step``): the same kernels without the host's gaps, so the two
should agree to about 10%; a larger gap is stated.

Bytes and operations. The hand kernels are not aten ops (ctypes
launches): their device rows are joined to their launches by the C++
namespace of their symbols (``ops.hopper.cost.SYMBOLS``) and take their
bytes and operations from ``build.launch_costs()``, that is from
``ops/hopper/cost.py``, and their attainable time as the sum of each
launch's ``cost.bound`` (launches of different shapes run one after
another), bound by what bounds the larger part of it.
A plain op's bytes are its inputs' sizes from the recorded shapes and
dtypes plus its output, which the profiler does not record: a product's
(mm, bmm, addmm, baddbmm) from its operands' shapes, an in-place op's
its first input (a copy or a fill writes it without reading it), a
reduction's none (an undercount of a small output),
any other op's its largest input (exact for an elementwise op). An
input is one argument: a tensor, or a tensor list (the optimizer's
``_foreach_*`` ops, ``cat``) counted from its tensors' shapes and dtype.
The profiler's events name a list's type only ("TensorList", no shape):
its tensors are joined from the profiler's event tree by correlation id
(``with_tensor_lists``). A list with shapes but no known dtype takes
that of the op's first tensor input, or float32; a list left without
shapes counts no bytes, and the table states how many op calls kept
one. Flops
are the profiler's, for the products; their peak is the bf16 tensor
cores' for bf16 operands and the f32 rate for f32 operands (the port
runs no TF32: ``ops/precision.py`` ``check_tf32_off``). Peaks are the
data sheet's (``utils.flops``).

    python -m dgps_with_iwvi_torch.experiments.roofline \\
        [--minibatch 8192] [--steps-per-call 50] [--calls 2] \\
        [--eager-steps 5] [--top 30] [--out-md FILE.md]

It needs the card: on the CPU there is no device time to report.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import re
from collections import defaultdict

import torch
from torch._C._profiler import _ExperimentalConfig

from dgps_with_iwvi_torch.device import backend, resolve_device
from dgps_with_iwvi_torch.experiments import profile_step
from dgps_with_iwvi_torch.ops.hopper import cost
from dgps_with_iwvi_torch.ops.hopper.build import COST_FIELDS

GAP = 0.10  # the eager rows' total against the graphed step's device time
PRODUCTS = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm")
REDUCTIONS = ("sum", "mean", "amax", "amin", "max", "min", "norm",
              "logsumexp", "prod", "all", "any", "argmax", "argmin", "var",
              "std", "trace", "dot")
ITEMSIZE = {"float": 4, "double": 8, "c10::BFloat16": 2, "c10::Half": 2,
            "long int": 8, "int": 4, "short int": 2, "signed char": 1,
            "unsigned char": 1, "bool": 1, "c10::complex<float>": 8}
HALF = ("c10::BFloat16", "c10::Half")
# in-place ops that write their first operand without reading it
WRITE_ONLY = ("copy_", "fill_", "zero_", "normal_", "uniform_")
NODE = "autograd::engine::evaluate_function: "
_FRAME = re.compile(r"(?:.*/)?(dgps_with_iwvi_torch/[^(]+)\((\d+)\)")
# the profiler's names of the dtypes that a tensor list may hold
DTYPE_NAMES = {torch.float32: "float", torch.float64: "double",
               torch.bfloat16: "c10::BFloat16", torch.float16: "c10::Half",
               torch.int64: "long int", torch.int32: "int",
               torch.bool: "bool"}
# a Python function's event (``with_stack``'s tracer), not an op
_PYTHON = re.compile(r"<built-in |.*\.py\(\d+\): ")


def _numel(shape) -> int:
    return math.prod(shape) if shape else 1


def _inputs(e) -> list:
    """(bytes, dtype) of each tensor or tensor-list input of op event `e`,
    a scalar none; a list's dtype is that of the op's first tensor input,
    or float where it has none."""
    shapes = e.input_shapes or []
    dtypes = getattr(e, "input_dtypes", None) or []
    args = list(zip(shapes, dtypes))
    elem = next((d for _, d in args if d in ITEMSIZE), "float")
    out = []
    for shape, dtype in args:
        if shape and isinstance(shape[0], (list, tuple)):  # a tensor list
            d = dtype if dtype in ITEMSIZE else elem
            out.append((sum(_numel(t) for t in shape) * ITEMSIZE[d], d))
        elif dtype in ITEMSIZE:
            out.append((_numel(shape) * ITEMSIZE[dtype], dtype))
    return out


def op_work(e) -> tuple:
    """(bytes, flops, operands in bf16 or f16) of one call of op event `e`
    under the module docstring's rules."""
    ins = _inputs(e)
    if not ins:
        return 0, 0, False
    nbytes = sum(n for n, _ in ins)
    name = e.name
    short = name.split("::")[-1]
    shapes = e.input_shapes
    if name in PRODUCTS:
        a, b = (shapes[1], shapes[2]) if name in ("aten::addmm",
                                                  "aten::baddbmm") \
            else (shapes[0], shapes[1])
        out = _numel(a[:-1]) * b[-1]
        nbytes += out * ITEMSIZE[ins[0][1]]
    elif short in WRITE_ONLY:
        pass  # the first operand's size, counted once, is its write
    elif short.endswith("_"):
        nbytes += ins[0][0]
    elif short.removeprefix("_foreach_").rstrip("_") not in REDUCTIONS:
        nbytes += max(n for n, _ in ins)
    return nbytes, (e.flops or 0), ins[0][1] in HALF


def _source(e) -> str:
    """The innermost frame of the package above op event `e` (a Python
    function's event among its ancestors, or a recorded stack), as
    file:line under the package."""
    while e is not None:
        for frame in [e.name] + list(e.stack or ()):
            m = _FRAME.match(frame)
            if m:
                return f"{m.group(1).split('dgps_with_iwvi_torch/')[-1]}:" \
                       f"{m.group(2)}"
        e = e.cpu_parent
    return ""


def _is_python(e) -> bool:
    return bool(getattr(e, "is_python_function", False)
                or _PYTHON.match(e.name))


def _node(e):
    """The autograd node event above op event `e`, if it runs in a
    backward."""
    p = e.cpu_parent
    while p is not None:
        if p.name.startswith(NODE):
            return p
        p = p.cpu_parent
    return None


def hand_kernel(name: str):
    """The hand kernel (``cost.SYMBOLS``'s key) whose symbol `name` is."""
    return next((k for k, (_, ns) in cost.SYMBOLS.items()
                 if f"{ns}::" in name), None)


def _is_device(e) -> bool:
    return str(e.device_type).endswith("CUDA")


def with_dtypes(profiler):
    """The profile's events, each op given its inputs' dtypes
    (``input_dtypes``) from the profiler's own records where the event
    does not carry them (torch releases before 2.12)."""
    events = profiler.events()
    if any(getattr(e, "input_dtypes", None) for e in events):
        return events
    dtypes = {k.correlation_id(): list(k.dtypes())
              for k in profiler.profiler.kineto_results.events()}
    for e in events:
        e.input_dtypes = dtypes.get(e.id, [])
    return events


def _unresolved(e) -> bool:
    """Whether op event `e` has a tensor-list input with no shapes."""
    return any(d == "TensorList" and not s for s, d in zip(
        e.input_shapes or [], getattr(e, "input_dtypes", None) or []))


def with_tensor_lists(profiler, events):
    """`events`, each tensor-list input given its tensors' shapes (nested)
    and dtype where the event names only its type: joined by correlation
    id from the profiler's event tree, which keeps every input's
    metadata."""
    todo = {e.id: e for e in events if _unresolved(e)}
    if not todo:
        return events
    stack = list(profiler.profiler.kineto_results.experimental_event_tree())
    while stack:
        n = stack.pop()
        stack.extend(n.children)
        e = todo.get(getattr(n, "correlation_id", None))
        inputs = getattr(n.extra_fields, "inputs", None)
        if e is None or not inputs:
            continue
        shapes, dtypes = list(e.input_shapes), list(e.input_dtypes)
        for i, x in enumerate(inputs[:len(dtypes)]):
            if dtypes[i] == "TensorList" and isinstance(x, list):
                ts = [t for t in x if hasattr(t, "sizes")]
                shapes[i] = [list(t.sizes) for t in ts]
                if ts:
                    dtypes[i] = DTYPE_NAMES.get(ts[0].dtype, "TensorList")
        e.input_shapes, e.input_dtypes = shapes, dtypes
    return events


def attribute(events) -> dict:
    """{(op, source): {"us", "bytes", "flops", "half", "calls"}} over the
    events of a profile (``prof.events()``) on the card: each op's own
    kernels (hand kernels left out), then the device time no op launched,
    by kernel name."""
    rows = defaultdict(lambda: {"us": 0.0, "bytes": 0.0, "flops": 0.0,
                                "half": False, "calls": 0})
    fwd_src = {}
    ops = [e for e in events if not _is_device(e) and not e.is_async
           and not getattr(e, "is_user_annotation", False)
           and not _is_python(e)]
    for e in ops:
        if e.sequence_nr >= 0 and _node(e) is None \
                and e.sequence_nr not in fwd_src:
            src = _source(e)
            if src:
                fwd_src[e.sequence_nr] = src
    by_kernel = defaultdict(float)
    for e in ops:
        us = sum(k.duration for k in e.kernels
                 if hand_kernel(k.name) is None)
        for k in e.kernels:
            by_kernel[k.name] -= k.duration
        if us <= 0:
            continue
        node = _node(e)
        if node is None:
            key = (e.name, _source(e))
        else:
            src = fwd_src.get(node.sequence_nr, "")
            key = (f"{node.name[len(NODE):]} > {e.name}",
                   f"{src} (bwd)" if src else "")
        row = rows[key]
        row["us"] += us
        row["calls"] += 1
        nbytes, flops, half = op_work(e)
        row["bytes"] += nbytes
        row["flops"] += flops
        row["half"] |= half
    for e in events:
        if _is_device(e) and hand_kernel(e.name) is None \
                and not getattr(e, "is_user_annotation", False):
            by_kernel[e.name] += e.device_time_total
    for name, us in by_kernel.items():
        if us > 0.5:  # device time no op launched (beyond rounding)
            row = rows[(f"(no op) {name[:60]}", "")]
            row["us"] += us
            row["calls"] += 1
    return dict(rows)


def hand_rows(events, work: dict) -> dict:
    """{(label, source): row} of the hand kernels: device time by symbol
    namespace, work and the sum of the launches' bounds from
    ``build.launch_costs()`` (`work`, keyed "<kernel>[:<variant>]")."""
    us = defaultdict(float)
    for e in events:
        if _is_device(e):
            k = hand_kernel(e.name)
            if k is not None:
                us[k] += e.device_time_total
    rows = {}
    for k in sorted(set(us) | {key.split(":")[0] for key in work}):
        parts = {key: w for key, w in work.items()
                 if key.split(":")[0] == k}
        tot = {f: sum(w[f] for w in parts.values()) for f in COST_FIELDS}
        variants = ", ".join(key.split(":", 1)[1] for key in sorted(parts)
                             if ":" in key)
        label = f"{cost.SYMBOLS[k][0]} {k}" + (f" ({variants})" if variants
                                              else "")
        rows[(label, f"csrc/{k}.cu")] = {
            "us": us.get(k, 0.0), "bytes": tot["bytes"],
            "flops": tot["bf16_ops"] + tot["f32_ops"],
            "bf16_ops": tot["bf16_ops"], "f32_ops": tot["f32_ops"],
            "calls": tot["launches"], "hand": k,
            "attainable_us": 1e3 * tot["bound_ms"],
            "bound_by": ("operations" if 2 * tot["ops_bound_ms"]
                         >= tot["bound_ms"] else "bytes")}
    return rows


def table(rows: dict, per: int) -> tuple:
    """(rows as dicts per step, sorted by time, total us per step,
    speed-of-light us per step): the reference's arithmetic (l.107-130)
    with this card's peaks; a hand row brings its own attainable time and
    what bounds it."""
    peak_bf16, peak_f32, peak_bytes = cost.peaks()
    out = []
    for (op, src), r in rows.items():
        t = r["us"] / per
        if t <= 0:
            continue
        byts, flops = r["bytes"] / per, r["flops"] / per
        peak = peak_bf16 if r.get("half") else peak_f32
        t_bytes, t_ops = byts / peak_bytes * 1e6, flops / peak * 1e6
        att = (r["attainable_us"] / per if "attainable_us" in r
               else max(t_bytes, t_ops))
        if r.get("hand"):
            by = r["bound_by"]
        else:
            by = ("measured" if not (byts or flops) else
                  "bytes" if t_bytes >= t_ops else "operations")
        out.append({"op": op, "source": src, "us": t,
                    "calls": r["calls"] / per, "bytes": byts,
                    "flops": flops, "gbs": byts / t / 1e3,
                    "gfs": flops / t / 1e3, "attainable_us": att,
                    "bound_by": by, "hand": r.get("hand")})
    out.sort(key=lambda d: -d["us"])
    total = sum(d["us"] for d in out)
    sol = 0.0
    for d in out:
        # no modelled bytes or flops: the measured time is the bound
        att_eff = d["attainable_us"] if (d["bytes"] or d["flops"]) \
            else d["us"]
        sol += min(att_eff, d["us"])
        d["headroom"] = (d["us"] / d["attainable_us"]
                         if d["attainable_us"] > 0.005 else float("nan"))
    return out, total, sol


def render(out: list, total: float, sol: float, per: int, top: int,
           head: list = ()) -> list:
    """The markdown lines of the table (the reference's columns and
    formats)."""
    lines = list(head) + [
        f"Measured device self time: {total:.0f} us/step ({per} steps "
        "traced).", "",
        "| us/step | % | bound | GB/s | GF/s | attainable us | headroom "
        "| source | op |", "|---|---|---|---|---|---|---|---|---|"]
    for d in out[:top]:
        lines.append(
            f"| {d['us']:.1f} | {100 * d['us'] / total:.1f} "
            f"| {d['bound_by']} | {d['gbs']:.0f} | {d['gfs']:.0f} "
            f"| {d['attainable_us']:.1f} | {d['headroom']:.2f}x "
            f"| {d['source']} | {d['op'][:70]} |")
    lines += ["", f"Speed-of-light for THIS op mix: {sol:.0f} us/step "
              f"(measured {total:.0f} -> {total / max(sol, 1e-9):.2f}x "
              "headroom if every op hit its own roofline; changing the op "
              "mix — fusing away intermediates — moves the bound itself)."]
    return lines


def run(minibatch: int = 8192, steps_per_call: int = 50, calls: int = 2,
        eager_steps: int = 5, top: int = 30, device="cuda",
        out_md: str | None = None, setup=None, graphed=None) -> dict:
    """The roofline of the flagship step (module docstring). Returns
    {"rows", "total_us", "sol_us", "graphed_device_ms_per_step", "gap",
    "lines", ...}. `setup`: (config, params, X, Y, tc) in place of
    ``profile_step.flagship``'s; `graphed`: a ``profile_step.run`` record
    of the same setup in place of profiling the graphed steps again."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError(f"roofline: no device time to report on "
                           f"{device.type}; it profiles the card")
    if setup is None:
        setup = profile_step.flagship(minibatch, steps_per_call, device)
    config, params, X, Y, tc = setup
    if graphed is None:
        graphed, _ = profile_step.run_chunks(config, params, X, Y, tc,
                                             calls, eager=False)
    prof, profiler = profile_step.run_chunks(
        config, params, X, Y,
        dataclasses.replace(tc, steps_per_call=eager_steps), 1, eager=True,
        record_shapes=True, with_flops=True, with_stack=True,
        experimental_config=_ExperimentalConfig(verbose=True))
    events = with_tensor_lists(profiler, with_dtypes(profiler))
    unresolved = sum(1 for e in events if not _is_device(e)
                     and _unresolved(e))
    rows = attribute(events)
    work = {k: {f: v * eager_steps for f, v in w.items()}
            for k, w in prof["hand_kernels_per_step"].items()}
    rows.update(hand_rows(events, work))
    out, total, sol = table(rows, eager_steps)
    card = backend(device)
    head = [f"# Roofline of the flagship step, B={tc.minibatch_size}", "",
            f"Card: {card}. Eager steps profiled for attribution: "
            f"{eager_steps}; peaks: the data sheet's (utils/flops.py)."]
    if unresolved:
        head.append(f"Op calls with a tensor list the profiler gave no "
                    f"shapes for: {unresolved} (its bytes not counted).")
    rec = {"backend": card, "minibatch": tc.minibatch_size,
           "unresolved_tensor_lists": unresolved,
           "eager_steps": eager_steps, "total_us": total, "sol_us": sol,
           "rows": out, "hand_kernels_per_step": {
               k: {f: v / eager_steps for f, v in w.items()}
               for k, w in work.items()}}
    g_us = graphed["device_ms_per_step"] * 1e3
    rec.update(graphed_device_ms_per_step=graphed["device_ms_per_step"],
               graphed_idle_share=graphed["idle_share"],
               gap=total / g_us - 1.0)
    head += [f"Graphed device self time: {g_us:.0f} us/step "
             f"({graphed['steps']} replayed steps, profile_step); the rows' "
             f"total {total:.0f} us/step, {100 * rec['gap']:+.1f}%"
             + (f": beyond {GAP:.0%}, the eager kernels are not the "
                "replayed ones" if abs(rec["gap"]) > GAP else "") + ".", ""]
    rec["lines"] = render(out, total, sol, eager_steps, top, head)
    print("\n".join(rec["lines"]), flush=True)
    if out_md:
        with open(out_md, "w") as f:
            f.write("\n".join(rec["lines"]) + "\n")
    return rec


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--minibatch", type=int, default=8192)
    p.add_argument("--steps-per-call", type=int, default=50,
                   help="steps per graphed chunk")
    p.add_argument("--calls", type=int, default=2,
                   help="graphed chunks profiled for the step's total")
    p.add_argument("--eager-steps", type=int, default=5,
                   help="eager steps profiled for the rows")
    p.add_argument("--top", type=int, default=30)
    p.add_argument("--out-md", default=None)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    a = parse_args(argv)
    return run(a.minibatch, a.steps_per_call, a.calls, a.eager_steps, a.top,
               a.device, a.out_md)


if __name__ == "__main__":
    main()
