"""The port's measurement tools (``experiments/profile_step.py``,
``roofline.py``, ``peak_probe.py``, ``predict_bench.py``) and the hand
kernels' cost model (``ops/hopper/cost.py``), on the CPU.

The reference's scripts are read, not imported (importing them sets JAX's
configuration and a compile-cache directory): ``render`` of
``benchmarks/roofline.py`` and ``two_point`` of
``benchmarks/peak_probe.py`` are taken from their source with ``ast`` and
run in a namespace of their own, which holds the peaks the test sets
(the module globals ``HBM_PEAK_GBS`` and ``MXU_PEAK_GFS``) and a fake
clock; the header of ``benchmarks/predict_bench.py``'s table likewise.
The profiler's CUDA rows are faked: the CPU has no device events.
"""

import ast
import math
import os
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dgps_with_iwvi_torch.experiments import (peak_probe, predict_bench,
                                              profile_step, roofline)
from dgps_with_iwvi_torch.ops.hopper import build, cost
from dgps_with_iwvi_torch.utils import flops, graphs
from torch_threads import one_thread  # noqa: F401  (autouse)

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks")
PACKAGE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "dgps_with_iwvi_torch")
NEW_MODULES = ("experiments/profile_step.py", "experiments/roofline.py",
               "experiments/peak_probe.py", "experiments/predict_bench.py",
               "ops/hopper/cost.py")


def _reference(script: str, *names) -> dict:
    """The named top-level functions of a reference script, executed in a
    namespace of their own."""
    path = os.path.join(BENCH, script)
    with open(path) as f:
        tree = ast.parse(f.read())
    body = [n for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name in names]
    ns = {"re": re, "np": np}
    exec(compile(ast.Module(body=body, type_ignores=[]), path, "exec"), ns)
    return ns


# (a) PERF.md section 6's bound column: (label, work, printed ms, bound_by)
BOUNDS = [
    ("K2 epi A[100,128,8192] D=8", cost.epilogue(100, 128, 8192, 8, "epi"),
     "0.222", "operations"),
    ("K2 epi A[100,128,8192] D=1", cost.epilogue(100, 128, 8192, 1, "epi"),
     "0.128", "bytes"),
    ("K2 epi A[20,128,512] D=8", cost.epilogue(20, 128, 512, 8, "epi"),
     "0.0028", "operations"),
    ("K2 epi A[20,128,512] D=1", cost.epilogue(20, 128, 512, 1, "epi"),
     "0.0016", "bytes"),
    ("K2 epi A[20,128,8192] D=8", cost.epilogue(20, 128, 8192, 8, "epi"),
     "0.0444", "operations"),
    ("K2 epi A[20,128,8192] D=1", cost.epilogue(20, 128, 8192, 1, "epi"),
     "0.0256", "bytes"),
    ("K2 epi A[20,128,512] D=3", cost.epilogue(20, 128, 512, 3, "epi"),
     "0.0017", "bytes"),
    ("K2 epi A[20,128,8192] D=3", cost.epilogue(20, 128, 8192, 3, "epi"),
     "0.0265", "bytes"),
    ("K2 qvar A[20,128,512] D=8", cost.epilogue(20, 128, 512, 8, "qvar"),
     "0.0027", "operations"),
    ("K2 qvar A[20,128,512] D=1", cost.epilogue(20, 128, 512, 1, "qvar"),
     "0.0016", "bytes"),
    ("K2 qvar A[100,128,820] D=8", cost.epilogue(100, 128, 820, 8, "qvar"),
     "0.0217", "operations"),
    ("K2 qvar A[100,128,820] D=1", cost.epilogue(100, 128, 820, 1, "qvar"),
     "0.0127", "bytes"),
    ("K2 qvar A[100,128,8192] D=8", cost.epilogue(100, 128, 8192, 8,
                                                  "qvar"),
     "0.217", "operations"),
    ("K2 qvar A[100,128,8192] D=1", cost.epilogue(100, 128, 8192, 1,
                                                  "qvar"),
     "0.126", "bytes"),
    ("K2 ps A[100,128,8192] D=8", cost.epilogue(100, 128, 8192, 8, "ps"),
     "0.217", "operations"),
    ("K2 ps A[100,128,8192] D=1", cost.epilogue(100, 128, 8192, 1, "ps"),
     "0.127", "bytes"),
    ("K3 epi A[20,128,8192] D=8", cost.epilogue_bwd(20, 128, 8192, 8, "epi"),
     "0.132", "operations"),
    ("K3 epi A[20,128,8192] D=1", cost.epilogue_bwd(20, 128, 8192, 1, "epi"),
     "0.051", "bytes"),
    ("K3 epi A[20,128,512] D=8", cost.epilogue_bwd(20, 128, 512, 8, "epi"),
     "0.0083", "operations"),
    ("K3 epi A[20,128,512] D=1", cost.epilogue_bwd(20, 128, 512, 1, "epi"),
     "0.0032", "bytes"),
    ("K3 epi A[20,128,512] D=3", cost.epilogue_bwd(20, 128, 512, 3, "epi"),
     "0.0033", "bytes"),
    ("K3 epi A[20,128,8192] D=3", cost.epilogue_bwd(20, 128, 8192, 3, "epi"),
     "0.0516", "bytes"),
    ("K3 ps A[20,128,512] D=8", cost.epilogue_bwd(20, 128, 512, 8, "ps"),
     "0.0081", "operations"),
    ("K3 ps A[20,128,8192] D=8", cost.epilogue_bwd(20, 128, 8192, 8, "ps"),
     "0.130", "operations"),
    ("K3 qvar A[20,128,512] D=8", cost.epilogue_bwd(20, 128, 512, 8, "qvar"),
     "0.0081", "operations"),
    ("K3 qvar A[20,128,512] D=1", cost.epilogue_bwd(20, 128, 512, 1, "qvar"),
     "0.0032", "bytes"),
    ("K4 sample xs[819200,9] D=8", cost.serve_cond(819200, 9, 128, 8, True),
     "0.202", "operations"),
    ("K4 infer xs[819200,8] D=1", cost.serve_cond(819200, 8, 128, 1, False),
     "0.101", "operations"),
    ("K4 infer xs[82000,8] D=3", cost.serve_cond(82000, 8, 128, 3, False),
     "0.0130", "operations"),
    ("K5 sample xs[819200,9] D=8", cost.conditional(819200, 9, 128, 8, True,
                                                    False),
     "2.069", "operations"),
    ("K5 fused xs[819200,8] D=1", cost.conditional(819200, 8, 128, 1, False,
                                                   False),
     "0.631", "operations"),
    ("K5 fused xs[10240,8] D=1 residuals", cost.conditional(
        10240, 8, 128, 1, False, True), "0.0079", "operations"),
    ("K5 sample xs[10240,9] D=8 residuals", cost.conditional(
        10240, 9, 128, 8, True, True), "0.026", "operations"),
    ("K1 Kuu [2,128,128] x 4 levels", cost.chol_inv(2, 128, 4), "0.000117",
     "bytes"),
    ("K1 natgrad P [1,128,128] x 2 levels", cost.chol_inv(1, 128, 2),
     "0.000059", "bytes"),
]


@pytest.mark.parametrize("label,work,printed,by", BOUNDS,
                         ids=[b[0] for b in BOUNDS])
def test_cost_bounds_equal_the_perf_table(label, work, printed, by):
    ms, got_by = cost.bound(*work)
    assert f"{ms:.{len(printed.split('.')[1])}f}" == printed
    assert got_by == by


def test_peaks_are_one_table():
    """cost.py reads the card's peaks from utils.flops, the data sheet."""
    assert cost.peaks() == (*flops.PEAK_FLOPS[flops.CARD],
                            flops.PEAK_BYTES[flops.CARD])
    assert cost.peaks() == (989e12, 67e12, 3.35e12)


# (b) the roofline's arithmetic against the reference's render
SYNTHETIC = [
    # (op, total self time us, GB/s, GF/s): compute- and memory-bound
    # rows, no model (the measured-time rule), an attainable time under
    # 0.005 us (no headroom), a row read faster than its roofline (past
    # the memory peak), a zero row
    ("jvp()/dot_general: a", 12345.6, 1901.3, 859317.7),
    ("jit(cholesky)/cholesky: b", 5000.0, 0.0, 0.0),
    ("transpose(jvp())/mul: c", 800.0, 0.9, 0.3),
    ("transpose(jvp())/dot_general: d", 3000.0, 4100.0, 412345.0),
    ("jvp()/add: e", 7000.0, 3301.0, 1002.0),
    ("while.8: f", 2600.0, 1.7, 80.4),
    ("idle: g", 0.0, 10.0, 10.0),
]
STEPS = 100


def test_roofline_arithmetic_equals_the_reference_render(tmp_path,
                                                         capsys):
    ref = _reference("roofline.py", "render")
    bf16, _, hbm = cost.peaks()
    ref["HBM_PEAK_GBS"] = hbm / 1e9
    ref["MXU_PEAK_GFS"] = bf16 / 1e9
    ref_rows = [{"total_self_time": t, "measured_memory_bw": bw,
                 "model_flop_rate": fr, "bound_by": "x", "tf_op_name": op,
                 "source_info": ""} for op, t, bw, fr in SYNTHETIC]
    out = tmp_path / "ref.md"
    ref["render"](ref_rows, STEPS, 30, str(out))
    want = out.read_text().splitlines()

    rows = {(op, ""): {"us": t, "bytes": bw * t * 1e3,
                       "flops": fr * t * 1e3, "half": True, "calls": STEPS}
            for op, t, bw, fr in SYNTHETIC}
    table, total, sol = roofline.table(rows, STEPS)
    got = roofline.render(table, total, sol, STEPS, 30)
    capsys.readouterr()

    def cells(line):  # every column but the bound's (xprof's own there)
        parts = line.split("|")
        return parts[:3] + parts[4:] if len(parts) > 4 else parts

    assert len(got) == len(want)
    assert [cells(g) for g in got] == [cells(w) for w in want]
    assert got[-1].startswith("Speed-of-light for THIS op mix:")
    by = {d["op"]: d["bound_by"] for d in table}
    assert by["jit(cholesky)/cholesky: b"] == "measured"
    assert by["jvp()/dot_general: a"] == "operations"
    assert by["jvp()/add: e"] == "bytes"
    assert math.isnan(next(d["headroom"] for d in table
                           if d["op"] == "transpose(jvp())/mul: c"))


def _event(name, device="CPU", **kw):
    e = SimpleNamespace(
        name=name, device_type=f"DeviceType.{device}", is_async=False,
        is_user_annotation=False, sequence_nr=-1, cpu_parent=None,
        cpu_children=[], stack=[], kernels=[], input_shapes=[],
        input_dtypes=[], flops=0, self_cpu_time_total=0.0,
        device_time_total=0.0)
    for k, v in kw.items():
        setattr(e, k, v)
    return e


def _kernel(name, us):
    return SimpleNamespace(name=name, device=0, duration=us)


def test_roofline_attributes_device_time_through_the_event_tree():
    """A forward product at its source line, its backward under its node
    at the forward's line, device time no op launched by kernel name, and
    the hand kernels by their symbols' namespace with cost.py's work."""
    frame = _event("dgps_with_iwvi_torch/ops/conditionals.py(94): cond")
    fwd = _event("aten::mm", sequence_nr=5, cpu_parent=frame,
                 kernels=[_kernel("sm90_gemm_f32", 10.0)],
                 input_shapes=[[4, 8], [8, 16]],
                 input_dtypes=["float", "float"], flops=2 * 4 * 8 * 16)
    node = _event("autograd::engine::evaluate_function: MmBackward0",
                  sequence_nr=5)
    bwd = _event("aten::mm", cpu_parent=node,
                 kernels=[_kernel("sm90_gemm_bf16", 20.0)],
                 input_shapes=[[16, 8], [8, 4]],
                 input_dtypes=["c10::BFloat16", "c10::BFloat16"],
                 flops=2 * 16 * 8 * 4)
    hand = "void k2_epilogue::epilogue_kernel<true>(float const*)"
    launcher = _event("autograd::engine::evaluate_function: EpiBackward",
                      kernels=[_kernel(hand, 5.0)])
    events = [frame, fwd, node, bwd, launcher,
              _event("sm90_gemm_f32", "CUDA", device_time_total=10.0),
              _event("sm90_gemm_bf16", "CUDA", device_time_total=20.0),
              _event(hand, "CUDA", device_time_total=5.0),
              _event("void k2_epilogue::prep_kernel()", "CUDA",
                     device_time_total=1.0),
              _event("orphan_kernel", "CUDA", device_time_total=3.0)]
    rows = roofline.attribute(events)
    assert set(rows) == {("aten::mm", "ops/conditionals.py:94"),
                         ("MmBackward0 > aten::mm",
                          "ops/conditionals.py:94 (bwd)"),
                         ("(no op) orphan_kernel", "")}
    f = rows[("aten::mm", "ops/conditionals.py:94")]
    assert f["us"] == 10.0 and f["flops"] == 2 * 4 * 8 * 16
    assert f["bytes"] == 4 * (4 * 8 + 8 * 16 + 4 * 16) and not f["half"]
    b = rows[("MmBackward0 > aten::mm", "ops/conditionals.py:94 (bwd)")]
    assert b["us"] == 20.0 and b["half"]
    assert b["bytes"] == 2 * (16 * 8 + 8 * 4 + 16 * 4)
    assert rows[("(no op) orphan_kernel", "")]["us"] == 3.0

    # one step: the two GP layers' launches, D=8 (bound by operations)
    # and D=1 (by bytes); the bound is the sum of theirs, not the bound
    # of their summed work
    ws = [cost.epilogue(20, 128, 512, 8, "epi"),
          cost.epilogue(20, 128, 512, 1, "epi")]
    bounds = [cost.bound(*w) for w in ws]
    assert [b for _, b in bounds] == ["operations", "bytes"]
    build.reset_launches()
    try:
        for _ in range(2):
            for w in ws:
                build.count_launch("epilogue", "epi", w)
        work = build.launch_costs()
    finally:
        build.reset_launches()
    hrows = roofline.hand_rows(events, work)
    (key, h), = hrows.items()
    assert key == ("K2 epilogue (epi)", "csrc/epilogue.cu")
    assert h["us"] == 6.0 and h["calls"] == 4 and h["hand"] == "epilogue"
    per_launch = 2e3 * (bounds[0][0] + bounds[1][0])
    assert h["attainable_us"] == pytest.approx(per_launch, rel=1e-12)
    assert h["attainable_us"] > 1e3 * cost.bound(
        *(2 * (ws[0][i] + ws[1][i]) for i in range(3)))[0]
    table, total, sol = roofline.table({**rows, **hrows}, 2)
    hand_row = next(d for d in table if d["hand"])
    assert hand_row["bound_by"] == (
        "operations" if bounds[0][0] >= bounds[1][0] else "bytes")
    assert hand_row["attainable_us"] == pytest.approx(per_launch / 2)
    assert total == pytest.approx((10 + 20 + 3 + 6) / 2)


def test_roofline_takes_dtypes_from_the_profilers_records():
    """Where the events carry no dtypes (torch before 2.12), each op takes
    its inputs' dtypes from the profiler's records of the same id."""
    ops = [SimpleNamespace(id=7, name="aten::bmm"),
           SimpleNamespace(id=9, name="aten::add")]
    records = [SimpleNamespace(correlation_id=lambda: 7,
                               dtypes=lambda: ["c10::BFloat16"] * 2),
               SimpleNamespace(correlation_id=lambda: 8,
                               dtypes=lambda: ["float"])]
    profiler = SimpleNamespace(
        events=lambda: ops, profiler=SimpleNamespace(
            kineto_results=SimpleNamespace(events=lambda: records)))
    events = roofline.with_dtypes(profiler)
    assert [e.input_dtypes for e in events] == [["c10::BFloat16"] * 2, []]
    carried = SimpleNamespace(events=lambda: [
        SimpleNamespace(id=1, input_dtypes=["float"])])
    assert roofline.with_dtypes(carried)[0].input_dtypes == ["float"]


@pytest.mark.parametrize("name,shapes,dtypes,extra", [
    ("aten::add", [[4, 8], [8]], ["float", "float"], 4 * 32),
    ("aten::mul_", [[4, 8], []], ["float", "double"], 4 * 32),
    ("aten::sum", [[4, 8], [], []], ["float", "", ""], 0),
    ("aten::baddbmm", [[2, 4, 6], [2, 4, 3], [2, 3, 6]],
     ["float"] * 3, 4 * 2 * 4 * 6),
    ("aten::cat", [[[4, 8], [4, 8]], []], ["TensorList", ""], None),
])
def test_roofline_op_bytes(name, shapes, dtypes, extra):
    """An op's bytes: its tensor inputs, plus the output the rules give
    (a product's from its operands, an in-place op's first input, a
    reduction's none, else the largest input)."""
    e = _event(name, input_shapes=shapes, input_dtypes=dtypes)
    nbytes, fl, half = roofline.op_work(e)
    ins = sum(4 * math.prod(s) if s else (8 if d == "double" else 0)
              for s, d in zip(shapes, dtypes) if d in ("float", "double"))
    if extra is None:  # a tensor list the profiler names only by its type:
        # float32, read, and written once concatenated
        assert nbytes == 2 * 4 * (4 * 8 + 4 * 8) and fl == 0 and not half
    else:
        assert nbytes == ins + extra and fl == 0 and not half


LIST = [[4, 8], [16]]  # a parameter list: 48 elements


@pytest.mark.parametrize("name,shapes,dtypes,want", [
    # self, tensor1, tensor2 read, self written; the scalars nothing
    ("aten::_foreach_addcdiv_", [LIST, LIST, LIST, []],
     ["TensorList"] * 3 + ["Scalar"], 4 * 48 * 4),
    ("aten::_foreach_sqrt", [LIST], ["TensorList"], 4 * 48 * 2),
    ("aten::_foreach_lerp_", [LIST, LIST, []],
     ["TensorList", "TensorList", "Scalar"], 4 * 48 * 3),
    # a list's dtype from the op's tensor input
    ("aten::_foreach_mul_", [LIST, []], ["TensorList", "c10::BFloat16"],
     2 * 48 * 2 + 2),
    ("aten::_foreach_norm", [LIST, []], ["TensorList", "Scalar"], 4 * 48),
])
def test_roofline_counts_tensor_lists(name, shapes, dtypes, want):
    """The optimizer's foreach ops move their lists' bytes (the profiler
    gives a list's nested shapes and names its type, not its dtype)."""
    nbytes, fl, _ = roofline.op_work(
        _event(name, input_shapes=shapes, input_dtypes=dtypes))
    assert nbytes == want and fl == 0


def test_roofline_joins_tensor_lists_from_the_event_tree():
    """A real profile on the CPU: the events name a tensor list's type
    only; the join gives the optimizer's foreach ops their lists' bytes
    (the lists f32, a bf16 list by its own dtype)."""
    from torch.profiler import ProfilerActivity, profile

    a = [torch.ones(4, 8), torch.ones(16)]
    h = [t.bfloat16() for t in a]
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True,
                 experimental_config=roofline._ExperimentalConfig(
                     verbose=True)) as prof:
        torch._foreach_addcdiv_(a, a, a, 0.5)
        torch._foreach_sqrt(h)
        torch.cat(a[:1] * 2)
    events = roofline.with_tensor_lists(prof, roofline.with_dtypes(prof))
    got = {e.name: roofline.op_work(e)[0] for e in events
           if e.name in ("aten::_foreach_addcdiv_", "aten::_foreach_sqrt",
                         "aten::cat")}
    assert got == {"aten::_foreach_addcdiv_": 4 * 48 * 4,
                   "aten::_foreach_sqrt": 2 * 48 * 2,
                   "aten::cat": 4 * 32 * 2 * 2}
    assert not any(roofline._unresolved(e) for e in events)


# (c) the launch-cost tally of a captured graph
def test_launch_costs_add_a_graphs_work_once_per_replay(monkeypatch):
    class CUDAGraph:
        def register_generator_state(self, gen):
            pass

        def replay(self):
            pass

    k1 = cost.chol_inv(2, 16, 4)
    k2 = cost.epilogue(4, 16, 32, 3, "epi")

    def launches():
        build.count_launch("chol_inv", work=k1)
        build.count_launch("epilogue", "epi", k2)
        build.count_launch("epilogue", "epi", k2)
        return torch.ones(1)

    monkeypatch.setattr(graphs, "capture_stream", lambda device: None)
    monkeypatch.setattr(graphs, "_warm_up", lambda fn, stream, device: fn())
    monkeypatch.setattr(graphs, "_capture", lambda graph, fn, stream: fn())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", CUDAGraph)
    build.reset_launches()
    try:
        g = graphs.Graph(launches, device="cpu")
        assert g.launches == {"chol_inv": 1, "epilogue": 2,
                              "epilogue:epi": 2}

        def fields(w, launches):
            ms, by = cost.bound(*w)
            return dict(zip(build.COST_FIELDS, (
                launches, *(launches * v for v in w), launches * ms,
                launches * ms if by == "operations" else 0.0)))

        def want(n):
            return {"chol_inv": fields(k1, n),
                    "epilogue:epi": fields(k2, 2 * n)}

        assert build.launch_costs() == want(1)  # the warm-up, run for real
        for n in range(2, 5):
            g.replay()
            got = build.launch_costs()
            assert got.keys() == want(n).keys()
            for key, w in want(n).items():
                assert got[key] == pytest.approx(w, rel=1e-15)
        # a launch with no work given is counted, its work not tallied
        build.count_launch("serve_cond", "infer")
        assert build.variant_launches()["serve_cond:infer"] == 1
        assert "serve_cond:infer" not in build.launch_costs()
        # a capture inside a capture tallies into the inner one only
        with build.capturing() as outer:
            with build.capturing() as inner:
                build.count_launch("chol_inv", work=k1)
        assert inner.costs == {"chol_inv": list(
            fields(k1, 1).values())} and outer.costs == {}
    finally:
        build.reset_launches()
    assert build.launch_costs() == {}


# (d) the peak probe's two-point fit
class _Clock:
    """A clock that a chain advances by 2 ms an iteration, a 25 ms fixed
    cost and a jitter from a fixed sequence."""

    def __init__(self):
        self.now, self.calls = 0.0, 0

    def perf_counter(self):
        return self.now

    def chain(self, iters):
        def fn(x):
            self.calls += 1
            self.now += 2e-3 * iters + 25e-3 + 1e-4 * ((7 * self.calls) % 5)
            return torch.tensor(x)
        return fn, (1.5,)


def test_two_point_equals_the_reference(monkeypatch):
    ref = _reference("peak_probe.py", "two_point")
    ref_clock, clock = _Clock(), _Clock()
    ref["time"] = ref_clock
    monkeypatch.setattr(peak_probe, "time", clock)
    want = ref["two_point"](ref_clock.chain)
    got = peak_probe.two_point(clock.chain)
    assert got == want
    assert got == pytest.approx(2e-3, rel=0.05)
    assert peak_probe.two_point(clock.chain, rounds=3, n_lo=5, n_hi=25) == \
        ref["two_point"](ref_clock.chain, rounds=3, n_lo=5, n_hi=25)


def test_peak_probe_flags_impossible_readings():
    rec = {"hbm": {"share": 0.9}, "bf16": {"share": 1.06},
           "f32": {"share": 1.05}}
    assert peak_probe.check(rec) == ["bf16: 106.0% of the data sheet"]
    assert peak_probe.summary(
        ["1980 MHz, 1980 MHz, 650.10 W, 700.00 W",
         "1755 MHz, 1980 MHz, [N/A], 700.00 W",
         "1800 MHz, 1980 MHz, 600.00 W, 700.00 W"]) == {
        "samples": 2, "sm_mhz_median": 1890.0,
        "sm_mhz_max_allowed": 1980.0, "power_w_median": 625.05,
        "power_w_max": 650.1, "power_limit_w": 700.0}


# (e) the serving table's header
def _reference_header() -> list:
    with open(os.path.join(BENCH, "predict_bench.py")) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    lines = next(n.value for n in ast.walk(main) if isinstance(n, ast.Assign)
                 and getattr(n.targets[0], "id", None) == "lines")
    return ast.literal_eval(lines)


class _FakeArtifact:
    """``load_scorer``'s artifact, faked: the real one is exported, saved
    and loaded in tests/test_torch_serve_export.py; a CPU export costs
    seconds."""

    def __init__(self):
        self.calls = []

    def score(self, X, Y, seed=0, depth=8):
        self.calls.append((len(X), seed, depth))
        n = len(X)
        return {"mean": np.zeros((n, 1), np.float32),
                "var": np.ones((n, 1), np.float32),
                "log_density": np.zeros(n, np.float32)}


def test_predict_bench_writes_the_reference_header(tmp_path, monkeypatch,
                                                   capsys):
    art = _FakeArtifact()
    exported = []
    monkeypatch.setattr(predict_bench, "export_scorer",
                        lambda *a, **kw: exported.append(kw) or "program")
    monkeypatch.setattr(predict_bench, "save_scorer",
                        lambda path, exp, **kw: open(path, "w").close())
    monkeypatch.setattr(predict_bench, "load_scorer",
                        lambda path, device: art)
    monkeypatch.setattr(predict_bench, "M", 8)
    monkeypatch.setattr(predict_bench, "S", 4)
    rec = predict_bench.main(
        ["--device", "cpu", "--batches", "16,32", "--rounds", "2", "--out",
         str(tmp_path)])
    capsys.readouterr()
    text = (tmp_path / "SERVING_H100.md").read_text().splitlines()
    header = _reference_header()
    assert header == predict_bench.HEADER
    at = text.index(header[0])
    assert text[at + 1] == header[1]
    assert [r.split("|")[1].strip() for r in text[at + 2:at + 4]] == \
        ["16", "32"]
    assert rec["finite"] and rec["backend"] == "cpu"
    assert [r["batch"] for r in rec["rows"]] == [16, 32]
    assert all(len(r["blocking_ms_all"]) == 2 for r in rec["rows"])
    assert exported == [{"batch_size": 8192, "d_in": 8, "d_out": 1,
                         "num_samples": 4}]
    assert art.calls == [(8192, 0, 8)] + [
        (8 * 8192, 300 + 8 * r, 8) for r in range(3)]
    assert "points/s** pipelined at B=8192" in text[-1]


# (f) the profile helpers
def _chip_smoke_rows(averages, per):
    """chip_smoke.py's ``_device_rows`` as it was before the move."""
    rows, spans = [], []
    for e in averages:
        if str(e.device_type).endswith("CUDA") and \
                e.self_device_time_total > 0:
            row = (e.self_device_time_total / 1e3 / per, e.count / per,
                   e.key)
            (spans if getattr(e, "is_user_annotation", False)
             else rows).append(row)
    return rows, spans


def _average(key, device, device_us, cpu_us, count, annotation=False):
    return SimpleNamespace(key=key, device_type=f"DeviceType.{device}",
                           self_device_time_total=device_us,
                           self_cpu_time_total=cpu_us, count=count,
                           is_user_annotation=annotation)


def test_device_rows_aggregate_as_chip_smoke_did():
    averages = [
        _average("void k1_chol_inv::chol_inv_blocked()", "CUDA", 120.0, 0.0,
                 4),
        _average("ampere_sgemm_128x64_nn", "CUDA", 900.5, 0.0, 40),
        _average("Optimizer.step#Adam.step", "CUDA", 300.0, 0.0, 2,
                 annotation=True),
        _average("aten::mm", "CPU", 0.0, 800.0, 40),
        _average("Memset (Device)", "CUDA", 0.0, 0.0, 3),
    ]
    assert profile_step.device_rows(averages, 2) == \
        _chip_smoke_rows(averages, 2)
    rows, spans = profile_step.device_rows(averages, 4, "CPU")
    assert rows == [(0.2, 10.0, "aten::mm")] and spans == []


def test_profile_window_on_the_cpu_reads_the_host():
    a = torch.ones((64, 64))

    def fn():
        for _ in range(3):
            torch.mm(a, a)

    out, _ = profile_step.profile_window(fn, 3, "step", "cpu", top=5)
    assert out["steps"] == 3 and out["host_ms_per_step"] > 0
    assert "idle_share" not in out and "device_ms_per_step" not in out
    assert any(r["op"] == "aten::mm" and r["calls"] == 1.0
               for r in out["ops_ms_per_step"])


def _kineto_event(name, start, end, device="CPU", corr=0,
                  annotation=False):
    """A profiler event as ``kineto_results.events()`` gives it."""
    return SimpleNamespace(
        name=lambda: name, start_ns=lambda: start,
        duration_ns=lambda: end - start,
        device_type=lambda: f"DeviceType.{device}",
        correlation_id=lambda: corr, is_user_annotation=lambda: annotation)


def _device_op(start, end, corr):
    return _kineto_event(f"kernel{corr}", start, end, "CUDA", corr)


def _runtime_call(start, corr, name="cudaLaunchKernel"):
    return _kineto_event(name, start, start + 2, corr=corr)


def _program_span(name, start, end):
    return _kineto_event("dgps." + name, start, end, annotation=True)


def test_idle_split_takes_the_union_of_overlapping_operations():
    """A copy beside a kernel on a second stream counts once, where the
    sum of self times counts the overlap twice: busy 150 of 200, not 180.
    The first gap ends with an operation launched before the window (a
    node gap), the last ends the window with nothing queued (starved);
    a range the profiler draws on the device for a host span is not an
    operation."""
    events = [_runtime_call(-50, 1), _runtime_call(-40, 2),
              _device_op(20, 120, 1), _device_op(90, 170, 2),
              _kineto_event("dgps.graphs.replay", 10, 180, "CUDA",
                            annotation=True)]
    split = profile_step.idle_split(events, (0, 200))
    assert split == {"window_ns": 200, "busy_ns": 150, "node_gap_ns": 20,
                     "starved_ns": {None: 30}}
    assert 1.0 - split["busy_ns"] / split["window_ns"] == 0.25


def test_idle_split_starved_gaps_by_innermost_program_program_span():
    """Op 1 runs 0-100. The gap 100-400 ends with op 2, launched at 350,
    after the gap began: starved, split across the spans the host was in
    (batch 100-150 inside score, score alone 150-200, table 200-300 and
    upload 300-400 inside score). The gap 500-520 ends with op 3,
    launched at 50 (queued): a node gap. The gap 600-650 ends with op 4,
    whose launch is not in the profile: a node gap. The gap 700-800 ends
    the window with nothing queued: starved, outside every span."""
    events = [
        _device_op(0, 100, 1), _runtime_call(-10, 1),
        _device_op(400, 500, 2), _runtime_call(350, 2, "cudaGraphLaunch"),
        _device_op(520, 600, 3), _runtime_call(50, 3),
        _device_op(650, 700, 4),
        _program_span("serving.score", 20, 480),
        _program_span("serving.batch", 30, 150),
        _program_span("serving.table", 200, 300),
        _program_span("serving.upload", 300, 420),
        _kineto_event("aten::mm", 360, 370, corr=2),
    ]
    split = profile_step.idle_split(events, (0, 800))
    assert split["busy_ns"] == 330 and split["node_gap_ns"] == 70
    assert split["starved_ns"] == {
        "dgps.serving.batch": 50, "dgps.serving.score": 50,
        "dgps.serving.table": 100, "dgps.serving.upload": 100, None: 100}
    assert split["node_gap_ns"] + sum(split["starved_ns"].values()) == \
        split["window_ns"] - split["busy_ns"]


def test_idle_split_clips_to_the_window():
    """An operation and a span that cross the window's edges count only
    inside it; the gap at the window's start ends with an operation
    launched after the window began: starved."""
    events = [_device_op(-30, 10, 1), _runtime_call(-40, 1),
              _device_op(60, 130, 2), _runtime_call(40, 2),
              _program_span("fit.chunk", -100, 50)]
    split = profile_step.idle_split(events, (0, 100))
    assert split == {"window_ns": 100, "busy_ns": 50, "node_gap_ns": 0,
                     "starved_ns": {"dgps.fit.chunk": 40, None: 10}}


# the tools on this machine
@pytest.mark.parametrize("tool", ["profile_step", "roofline", "peak_probe",
                                  "predict_bench"])
def test_tools_raise_without_a_card(tool, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = {"profile_step": profile_step, "roofline": roofline,
           "peak_probe": peak_probe, "predict_bench": predict_bench}[tool]
    argv = ["--out", str(tmp_path)] if tool == "predict_bench" else []
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(argv)


@pytest.mark.parametrize("module", NEW_MODULES)
def test_tools_import_no_reference(module):
    with open(os.path.join(PACKAGE, module)) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module or "" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)]
    assert not [m for m in names if m.split(".")[0] in (
        "jax", "dgps_with_iwvi_tpu", "benchmarks")]
