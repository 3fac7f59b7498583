"""The port's CUDA-graph layer (``utils/graphs.py``) and what it captures,
on the CPU.

A graph needs the card, so here the CUDA calls are replaced: the real
``Graph`` with a fake capture (the bookkeeping of launch counts), and the
whole ``Graph`` with ``FakeGraph``, which re-runs the captured call at each
replay. What a replay does on the card, it does here on the same static
tensors: the graphed training chunk and the graphed scorer are then held
to the eager step in float64 and the eager scorer, bit for bit, since the
same operations run on the same values (gamma read from a float64 tensor
rounds as the Python float does). The step body is also run under a
dispatch mode that fails on any operation that would make the host wait
for the card, or copy from host memory, inside a captured step.
"""

import dataclasses
import importlib
import tomllib
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

from dgps_with_iwvi_torch.models import BuildArgs, build_model
from dgps_with_iwvi_torch.ops.hopper import build
from dgps_with_iwvi_torch.serving import (GraphedScore, fixed_batches,
                                          make_scorer_fn, score_table)
from dgps_with_iwvi_torch.training import (TrainConfig, checkpoint,
                                           gamma_schedule, make_trainer)
from dgps_with_iwvi_torch.training import natgrad as ng
from dgps_with_iwvi_torch.training import train
from dgps_with_iwvi_torch.utils import graphs

N, D_X, M, K, B = 64, 3, 8, 4, 16
LGG = dict(configuration="LGG", mode="IW", num_inducing=M, num_iw_samples=K)


class FakeGraph:
    """``utils.graphs.Graph`` on the CPU: the first call runs for real (the
    warm-up); the capture records the call; each replay runs it again on
    the same tensors, its launches tallied as a capture tallies them and
    the tally then counted once, as a replay counts."""

    made: list = []

    def __init__(self, fn, *, device, generators=()):
        self.fn, self.generators, self.replays = fn, generators, 0
        self.first = fn()
        self.launches = None
        FakeGraph.made.append(self)

    def replay(self):
        with build.capturing() as tally:
            out = self.fn()
        if self.launches is None:
            self.launches = tally
        assert tally == self.launches
        build.replayed(self.launches)
        self.replays += 1
        return out


@pytest.fixture
def fake_graphs(monkeypatch):
    FakeGraph.made = []
    monkeypatch.setattr(graphs, "Graph", FakeGraph)
    return FakeGraph.made


def _data(likelihood: str = "gaussian"):
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N, D_X))
    if likelihood == "bernoulli":
        Y = (X[:, :1] > 0).astype(np.float64)
    elif likelihood in ("multiclass", "softmax", "ordinal"):
        Y = (X[:, :1] > 0).astype(np.float64) + (X[:, 1:2] > 0.5)
    else:
        Y = np.sin(X[:, :1]) + 0.1 * rng.standard_normal((N, 1))
    return X, Y


# (build flags beside LGG's, TrainConfig fields): every single-device
# policy that fit runs
CASES = {
    "joint": ({}, {}),
    "alternating": ({}, {"schedule": "alternating"}),
    "full_batch": ({}, {"minibatch_size": N}),
    "gamma_warmup": ({}, {"gamma_warmup": 6, "gamma": 0.05}),
    "natgrad_all": ({}, {"natgrad": "all"}),
    "adam_only": ({}, {"natgrad": "none"}),
    "use_pallas": ({"use_pallas": True}, {}),
    "multiscale_priors": ({"feature": "multiscale", "priors": (
        ("kernel_variance", "gamma", 2.0, 3.0),
        ("noise_variance", "lognormal", -2.0, 1.0))}, {}),
    "no_white": ({"white": False}, {}),
    "q_diag": ({"q_diag": True}, {}),
    "multiclass_matern": ({"likelihood": "multiclass", "num_classes": 3,
                           "kernel_kind": "matern52+linear"}, {}),
    "softmax": ({"likelihood": "softmax", "num_classes": 3}, {}),
    "ordinal": ({"likelihood": "ordinal", "num_classes": 3}, {}),
    "bernoulli": ({"likelihood": "bernoulli"}, {}),
    "student_t": ({"likelihood": "student_t"}, {}),
}


def _model(case: str, dtype=torch.float64):
    flags, fields = CASES[case]
    X, Y = _data(flags.get("likelihood", "gaussian"))
    config, params = build_model(0, BuildArgs(**LGG, **flags), X, Y,
                                 device="cpu", dtype=dtype)
    tc = TrainConfig(**{"natgrad": "final", "minibatch_size": B,
                        "steps_per_call": 5, "gamma": 1e-2, **fields})
    return (config, params, tc, torch.from_numpy(X).to(dtype),
            torch.from_numpy(Y).to(dtype))


def _leaves(state) -> list:
    opt = state.opt_state.state_dict()["state"]
    return (train._leaves(state.rest) + train._leaves(state.natvars)
            + [t for s in opt.values() for t in s.values()])


@pytest.mark.parametrize("case", list(CASES))
def test_graphed_chunk_equals_eager_chunk(fake_graphs, case):
    """Ten steps in two chunks of five: the graphed chunk (the step body
    with its static buffers, one capture, nine replays) against
    make_trainer's eager chunk from the same state and generator: losses,
    every state leaf, Adam's moments and the generator bitwise."""
    config, params, tc, X, Y = _model(case)
    init, step, chunk, _ = make_trainer(config, tc)
    s_e, g_e = init(params), torch.Generator().manual_seed(5)
    s_g, g_g = init(params), torch.Generator().manual_seed(5)
    graphed = train.graphed_chunk_fn(step, tc, s_g, X, Y, g_g)
    natvar_ids = [id(t) for t in train._leaves(s_g.natvars)]
    for _ in range(2):
        s_e, l_e = chunk(s_e, X, Y, g_e)
        s_g, l_g = graphed(s_g, X, Y, g_g)
        assert torch.equal(l_e, l_g)
    assert s_g.step == s_e.step == 10
    # the natvars were written in place: the graph's static tensors
    assert [id(t) for t in train._leaves(s_g.natvars)] == natvar_ids
    for a, b in zip(_leaves(s_e), _leaves(s_g), strict=True):
        assert torch.equal(a, b)
    assert torch.equal(g_e.get_state(), g_g.get_state())
    assert len(fake_graphs) == 1 and fake_graphs[0].replays == 9
    assert fake_graphs[0].generators == (g_g,)


@pytest.mark.parametrize("case", ["joint", "natgrad_all", "alternating",
                                  "q_diag", "no_white"])
def test_graphed_natvars_take_the_eager_layout(fake_graphs, case):
    """After the graph's warm-up step the natvars have the strides an
    eager step gives them (not the initial natvars'), so that the captured
    step's natgrad products read operands in the eager layout: on the card
    cuBLAS picks its kernel by the operands' strides."""
    config, params, tc, X, Y = _model(case)
    init, step, chunk, _ = make_trainer(config, tc)
    s_e, g_e = init(params), torch.Generator().manual_seed(5)
    s_g, g_g = init(params), torch.Generator().manual_seed(5)
    graphed = train.graphed_chunk_fn(step, tc, s_g, X, Y, g_g)
    s_e, _ = chunk(s_e, X, Y, g_e)
    s_g, _ = graphed(s_g, X, Y, g_g)
    eager, graph = train._leaves(s_e.natvars), train._leaves(s_g.natvars)
    assert [t.stride() for t in graph] == [t.stride() for t in eager]
    for a, b in zip(eager, graph, strict=True):
        assert torch.equal(a, b)


def test_graphed_chunk_refuses_another_state(fake_graphs):
    config, params, tc, X, Y = _model("joint")
    init, step, _, _ = make_trainer(config, tc)
    state, gen = init(params), torch.Generator().manual_seed(0)
    graphed = train.graphed_chunk_fn(step, tc, state, X, Y, gen)
    with pytest.raises(ValueError, match="state, data and generator"):
        graphed(init(params), X, Y, gen)
    with pytest.raises(ValueError, match="state, data and generator"):
        graphed(state, X.clone(), Y, gen)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gamma_from_tensor_matches_schedule(dtype):
    """At every step of a warm-up and after it, the natgrad update with
    gamma read from the float64 scalar that the graph reads equals the
    update with gamma_schedule's Python float, bitwise; so does the
    value the scalar holds."""
    _, params, tc, _, _ = _model("gamma_warmup")
    final = {k: params["layers"][2][k].to(dtype) for k in ("q_mu", "q_sqrt")}
    nat = ng.extract_natvars({"layers": [None, None, final]}, (2,))
    rng = np.random.default_rng(1)
    grads = [{k: torch.from_numpy(rng.standard_normal(v.shape)).to(dtype)
              for k, v in nv.items() if k in ("q_mu", "q_S")} for nv in nat]
    g_t = torch.zeros((), dtype=torch.float64)
    values = set()
    for step in range(tc.gamma_warmup + 3):
        g = gamma_schedule(tc, step)
        values.add(g)
        g_t.fill_(g)
        assert float(g_t) == g
        a = ng.natgrad_update(nat, grads, g)
        b = ng.natgrad_update(nat, grads, g_t)
        for k in a[0]:
            assert a[0][k].dtype == b[0][k].dtype == nat[0][k].dtype
            assert torch.equal(a[0][k], b[0][k]), (step, k)
    assert len(values) == tc.gamma_warmup + 1


def test_graph_counts_its_launches_once_per_replay(monkeypatch):
    """The real Graph with the CUDA calls replaced: the warm-up counts as
    an eager call, the capture records into the graph's tally and counts
    nothing, each replay adds the tally once."""
    class CUDAGraph:
        def __init__(self):
            self.registered, self.replays = [], 0

        def register_generator_state(self, gen):
            self.registered.append(gen)

        def replay(self):
            self.replays += 1

    def launches():
        build.count_launch("chol_inv")
        build.count_launch("epilogue", "epi")
        build.count_launch("epilogue_bwd", "epi")
        build.count_launch("epilogue_bwd", "epi")
        return torch.ones(2)

    monkeypatch.setattr(graphs, "capture_stream", lambda device: None)
    monkeypatch.setattr(graphs, "_warm_up", lambda fn, stream, device: fn())
    monkeypatch.setattr(graphs, "_capture", lambda graph, fn, stream: fn())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", CUDAGraph)
    build.reset_launches()
    gen = torch.Generator()
    g = graphs.Graph(launches, device="cpu", generators=(gen,))
    once = {"chol_inv": 1, "epilogue": 1, "epilogue_bwd": 2,
            "epilogue:epi": 1, "epilogue_bwd:epi": 2}
    assert g.launches == once
    assert g._graph.registered == [gen]

    def counted():
        c = {k: v for k, v in build.launches().items() if v}
        c.update(build.variant_launches())
        return c

    assert counted() == once
    for n in range(2, 5):
        assert torch.equal(g.replay(), torch.ones(2))
        assert counted() == {k: n * v for k, v in once.items()}
    assert g._graph.replays == 3
    # a capture inside a capture tallies into the inner one only
    with build.capturing() as outer:
        with build.capturing() as inner:
            build.count_launch("serve_cond", "infer")
        build.count_launch("chol_inv")
    assert inner == {"serve_cond": 1, "serve_cond:infer": 1}
    assert outer == {"chol_inv": 1}
    assert counted() == {k: 4 * v for k, v in once.items()}
    build.reset_launches()


def test_plans_are_counted_apart_once_per_replay(monkeypatch):
    """A launch's plan is counted under "<kernel>:plan=<plan>" in
    ``plan_launches`` and nowhere else: the kernel's and variant's counts
    are those of a launch without one; a capture records it into the
    graph's tally, each replay adds it once."""
    def launches():
        build.count_launch("serve_cond", "sample", plan="chain_l2zs")
        build.count_launch("serve_cond", "sample", plan="chain")
        build.count_launch("serve_cond", "infer", plan="chain")
        return torch.ones(1)

    monkeypatch.setattr(graphs, "capture_stream", lambda device: None)
    monkeypatch.setattr(graphs, "_warm_up", lambda fn, stream, device: fn())
    monkeypatch.setattr(graphs, "_capture", lambda graph, fn, stream: fn())
    monkeypatch.setattr(torch.cuda, "CUDAGraph",
                        lambda: types.SimpleNamespace(replay=lambda: None))
    build.reset_launches()
    try:
        g = graphs.Graph(launches, device="cpu")
        once = {"serve_cond:plan=chain_l2zs": 1, "serve_cond:plan=chain": 2}
        assert g.launches == {"serve_cond": 3, "serve_cond:sample": 2,
                              "serve_cond:infer": 1}
        assert g.launches.plans == once
        for n in range(1, 4):   # the warm-up ran for real
            assert build.plan_launches() == {k: n * v
                                             for k, v in once.items()}
            assert build.launches()["serve_cond"] == 3 * n
            assert build.variant_launches() == {"serve_cond:sample": 2 * n,
                                                "serve_cond:infer": n}
            g.replay()
        build.count_launch("serve_cond", "infer")   # no plan named
        assert build.plan_launches() == {k: 4 * v for k, v in once.items()}
    finally:
        build.reset_launches()
    assert build.plan_launches() == {}


class _Cycle:
    """An object in a reference cycle: only the cyclic collector frees it,
    as it frees a dropped ``GraphedEval`` (its body closes over it)."""

    def __init__(self):
        self.me = self


@pytest.mark.parametrize("raises", [False, True], ids=["returns", "raises"])
def test_capture_collects_first_and_holds_the_collector_off(monkeypatch,
                                                            raises):
    """A dead graph freed by the collector during a capture invalidates
    the capture on the card ("operation not permitted when stream is
    capturing" from the graph's teardown): ``_capture`` collects every
    dead cycle before the capture, keeps the collector off inside it, and
    puts it back after, also when the captured call raises."""
    import gc
    import weakref

    events = []

    class FakeCapture:
        def __init__(self, graph, stream=None):
            events.append(("graph", graph, stream))

        def __enter__(self):
            events.append("begin")

        def __exit__(self, *exc):
            events.append("end")

    monkeypatch.setattr(torch.cuda, "graph", FakeCapture)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: events.append("sync"))
    dead = _Cycle()
    ref = weakref.ref(dead)
    del dead
    assert ref() is not None and gc.isenabled()

    def fn():
        events.append(("in capture", ref() is None, gc.isenabled()))
        if raises:
            raise RuntimeError("captured call failed")
        return 7

    if raises:
        with pytest.raises(RuntimeError, match="captured call failed"):
            graphs._capture("g", fn, "s")
    else:
        assert graphs._capture("g", fn, "s") == 7
    assert events == ["sync", ("graph", "g", "s"), "begin",
                      ("in capture", True, False), "end"]
    assert gc.isenabled()


def test_graph_cache_keys(fake_graphs):
    """Same key, same graph (replayed); a ragged batch's key, a new graph;
    the plain versions, a graph of their own."""
    cache = graphs.GraphCache("cpu")
    calls = []

    def fn(rows):
        return lambda: calls.append(rows) or torch.full((rows,), rows)

    assert torch.equal(cache((8,), fn(8)), torch.full((8,), 8))
    assert torch.equal(cache((8,), fn(8)), torch.full((8,), 8))
    assert len(cache.graphs()) == 1 and fake_graphs[0].replays == 1
    cache((3,), fn(3))
    assert len(cache.graphs()) == 2 and len(fake_graphs) == 2
    cache((8,), fn(8))
    assert fake_graphs[0].replays == 2 and fake_graphs[1].replays == 0
    with build.plain_versions():
        cache((8,), fn(8))
        cache((8,), fn(8))
    assert len(cache.graphs()) == 3 and fake_graphs[2].replays == 1
    assert calls == [8, 8, 3, 8, 8, 8]


def test_graphed_scorer_equals_eager_scorer(fake_graphs):
    """GraphedScore through score_table (the static input filled from the
    pinned table by ``stage``) against make_scorer_fn's eager calls, one
    seed per batch, bitwise; a ragged batch gets its own graph; a batch
    not staged is copied in."""
    config, params, _, X, Y = _model("joint", torch.float32)
    fn = make_scorer_fn(params, config, 3, device="cpu")
    g = GraphedScore(fn, D_X, 1, "cpu")
    Xn, Yn = X.numpy(), Y.numpy()
    batches = fixed_batches(N, 24)             # 24, 24, 16 kept of 24
    batches[-1] = (48, 16, 16)                 # a ragged last batch

    def run(call, stage):
        return score_table(call, Xn, Yn, D_X, 1, batches,
                           torch.device("cpu"), stage=stage)

    for seed in (0, 7):
        got = run(lambda i, xb, yb: g(xb, yb, seed + i), g.stage)
        want = run(lambda i, xb, yb: fn(xb, yb, seed + i), None)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    assert len(fake_graphs) == 2
    assert [f.replays for f in fake_graphs] == [3, 1]
    xb, yb = X[:24], Y[:24]
    for a, b in zip(g(xb, yb, 3), fn(xb, yb, 3)):
        assert torch.equal(a, b)
    assert fake_graphs[0].replays == 4


class _HostWaits(TorchDispatchMode):
    """Fails on an operation that reads a value to the host, picks a shape
    from values, or copies from host memory: on the card, inside a
    captured step, each would wait for the card or fail the capture."""

    BAD = {"_local_scalar_dense", "item", "nonzero", "masked_select",
           "unique", "_unique2", "lift_fresh", "lift_fresh_copy"}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.BAD:
            raise AssertionError(f"{func} inside the step")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("case", list(CASES))
def test_step_body_waits_for_nothing(case):
    """The captured step body, after one warm-up step (which makes the
    constant tables and Adam's moments), runs no operation that makes the
    host wait or copies from host memory. Under a dispatch mode a
    composite backward formula takes its subclass-safe path (torch.prod's
    reads a count of zeros to the host only outside one), so the capture
    on the card checks those. Adam's update runs outside the check: on
    the CPU it reads its step count to the host, on the card it is
    capturable (its count on the device; the card tests capture it under
    ``torch.cuda.set_sync_debug_mode("error")``)."""
    config, params, tc, X, Y = _model(case)
    init, step, _, _ = make_trainer(config, tc)
    state, gen = init(params), torch.Generator().manual_seed(0)
    gamma = torch.full((), gamma_schedule(tc, 0), dtype=torch.float64)
    loss = torch.zeros((), dtype=X.dtype)
    train.write_step(step, state, X, Y, gen, gamma, loss)
    adam_step = state.opt_state.step

    def unchecked_adam_step():
        with _disable_current_modes():
            adam_step()

    state.opt_state.step = unchecked_adam_step
    with _HostWaits():
        train.write_step(step, state, X, Y, gen, gamma, loss)
    assert torch.isfinite(loss)


def test_host_waits_mode_catches_a_sync():
    with pytest.raises(AssertionError, match="local_scalar_dense"):
        with _HostWaits():
            float(torch.ones(3).sum())
    with pytest.raises(AssertionError, match="lift_fresh"):
        with _HostWaits():
            torch.tensor(2.0)


def test_adam_is_capturable_on_the_card_only(tmp_path):
    """On the CPU Adam stays as it was (capturable off); a checkpoint whose
    Adam was capturable (saved from the card) restores into a CPU
    template with the template's flag, and resumes bitwise."""
    config, params, tc, X, Y = _model("joint")
    init, step, chunk, _ = make_trainer(config, tc)
    state, gen = init(params), torch.Generator().manual_seed(0)
    assert not state.opt_state.param_groups[0]["capturable"]
    state, _ = chunk(state, X, Y, gen)
    path = checkpoint.save_checkpoint(str(tmp_path), state.step, state, gen)
    saved = torch.load(path, weights_only=True)
    saved["state"]["opt_state"]["param_groups"][0]["capturable"] = True
    torch.save(saved, path)
    like = {"state": init(params), "generator": torch.Generator()}
    back = checkpoint.restore_checkpoint(str(tmp_path), state.step, like)
    assert not back["state"].opt_state.param_groups[0]["capturable"]
    s1, l1 = chunk(state, X, Y, gen)
    s2, l2 = chunk(back["state"], X, Y, back["generator"])
    assert torch.equal(l1, l2)
    for a, b in zip(_leaves(s1), _leaves(s2), strict=True):
        assert torch.equal(a, b)


def test_fit_on_the_cpu_stays_eager(monkeypatch):
    """fit on CPU tensors makes no graph."""
    def refuse(*a, **k):
        raise AssertionError("a graph on the CPU path")

    monkeypatch.setattr(graphs, "Graph", refuse)
    config, params, tc, X, Y = _model("joint")
    tc = dataclasses.replace(tc, iterations=10)
    _, state = train.fit(torch.Generator().manual_seed(0), config, params,
                         X, Y, tc)
    assert state.step == 10


def test_dgp_suite_torch_entry_point():
    """pyproject's console scripts name the port's suite runner beside its
    train and serve entry points, and each resolves to its main."""
    root = Path(__file__).resolve().parents[1]
    scripts = tomllib.loads((root / "pyproject.toml").read_text())[
        "project"]["scripts"]
    assert scripts["dgp-suite-torch"] == (
        "dgps_with_iwvi_torch.experiments.run_suite:main")
    for name in ("dgp-train-torch", "dgp-serve-torch", "dgp-suite-torch"):
        module, attr = scripts[name].split(":")
        fn = getattr(importlib.import_module(module), attr)
        assert callable(fn) and fn.__name__ == "main"
        assert fn.__module__ == module


# ---- evaluation.evaluate: one graph replay per chunk (GraphedEval)

N_EVAL, BS_EVAL, S_EVAL = 40, 16, 5   # three chunks, the last of 8 rows
EVAL_CASES = {"LGG": "joint", "no_white": "no_white",
              "multiclass": "multiclass_matern"}


@pytest.fixture
def eval_cache(monkeypatch):
    """An empty evaluation cache for the test, the module's own put back
    after it."""
    from collections import OrderedDict

    from dgps_with_iwvi_torch.evaluation import metrics

    monkeypatch.setattr(metrics, "_programs", OrderedDict())
    return metrics


def _eval_model(case: str):
    """(config, params at a random q(u), X, Y, likelihood) in float64 for
    one of CASES; the test rows are the last N_EVAL of the data."""
    config, params, _, X, Y = _model(case)
    rng = np.random.default_rng(3)
    for lp in params["layers"]:
        if "q_mu" in lp:
            lp["q_mu"] = lp["q_mu"] + torch.from_numpy(
                0.5 * rng.standard_normal(lp["q_mu"].shape))
    return config, params, X[-N_EVAL:], Y[-N_EVAL:], config.likelihood


def _tree_copy(tree, dtype):
    if isinstance(tree, dict):
        return {k: _tree_copy(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_copy(v, dtype) for v in tree)
    return tree.to(dtype, copy=True)


def _with_new_q_mu(params, scale: float, dtype=torch.float64):
    """The same tree with new tensors throughout (in `dtype`) and q_mu
    moved."""
    out = _tree_copy(params, dtype)
    for lp in out["layers"]:
        if "q_mu" in lp:
            lp["q_mu"] += scale
    return out


@pytest.mark.parametrize("case", list(EVAL_CASES))
def test_graphed_evaluate_equals_eager_evaluate(fake_graphs, eval_cache,
                                                monkeypatch, case):
    """evaluate through GraphedEval (the first chunk the warm-up, then two
    replays, the last a ragged tail of 8 zero-padded rows) against the
    eager chunks: every point's log-density and mean and every metric
    bitwise, in float64."""
    metrics = eval_cache
    config, params, X, Y, lik = _eval_model(EVAL_CASES[case])
    kw = dict(y_std=np.array([1.5]), num_samples=S_EVAL,
              batch_size=BS_EVAL, likelihood=lik, device="cpu")
    want = metrics._points(params, config, X, Y, 7, S_EVAL, BS_EVAL, None,
                           False)
    want_metrics = metrics.evaluate(params, config, X, Y, 7, **kw)
    assert not fake_graphs
    got = metrics._points(params, config, X, Y, 7, S_EVAL, BS_EVAL, None,
                          True)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b)
    monkeypatch.setattr(metrics, "_replays", lambda device, mesh: True)
    got_metrics = metrics.evaluate(params, config, X, Y, 7, **kw)
    assert set(got_metrics) == set(want_metrics)
    np.testing.assert_equal(got_metrics, want_metrics)   # NaN == NaN
    assert len(fake_graphs) == 1 and fake_graphs[0].replays == 5
    assert len(metrics.eval_programs()) == 1


def test_second_call_copies_its_params_into_the_graph(fake_graphs,
                                                      eval_cache):
    """The stale-address trap: a graph reads the tensors it captured, so a
    second call with other parameter tensors (another run of the suite)
    must copy them into the graph's own. One program and one graph serve
    both calls; the second equals eager on the second parameters."""
    metrics = eval_cache
    config, params, X, Y, _ = _eval_model("joint")
    other = _with_new_q_mu(params, 0.25)
    first = metrics._points(params, config, X, Y, 1, S_EVAL, BS_EVAL, None,
                            True)
    got = metrics._points(other, config, X, Y, 1, S_EVAL, BS_EVAL, None,
                          True)
    want = metrics._points(other, config, X, Y, 1, S_EVAL, BS_EVAL, None,
                           False)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(first[0], got[0])
    (program,) = metrics.eval_programs()
    assert len(fake_graphs) == 1 and fake_graphs[0].replays == 5
    assert len(program.graphs.graphs()) == 1
    mine = metrics._leaves(program.params)
    assert not {id(t) for t in mine} & {
        id(t) for t in metrics._leaves(params) + metrics._leaves(other)}
    for a, b in zip(mine, metrics._leaves(other), strict=True):
        assert torch.equal(a, b)


def test_eval_cache_keys_and_bound(fake_graphs, eval_cache):
    """A program per (config, S, chunk rows, dtypes, parameter shapes):
    another S or chunk size, a new program; past EVAL_GRAPHS the least
    recently used is dropped and a later call with its key captures
    anew."""
    metrics = eval_cache
    config, params, X, Y, _ = _eval_model("joint")

    def run(S, bs=BS_EVAL, x=X, y=Y, p=params):
        return metrics._points(p, config, x, y, 0, S, bs, None, True)

    run(1)
    run(1, bs=8)
    run(1, x=X.float(), y=Y.float(),        # float32: another key
        p=_with_new_q_mu(params, 0.0, torch.float32))
    assert len(metrics.eval_programs()) == 3 and len(fake_graphs) == 3
    run(1)                                      # most recent again
    assert len(fake_graphs) == 3
    for S in range(2, 2 + metrics.EVAL_GRAPHS):
        run(S)
    assert len(metrics.eval_programs()) == metrics.EVAL_GRAPHS
    run(1, bs=8)                                # was dropped: a new one
    assert len(fake_graphs) == 4 + metrics.EVAL_GRAPHS


def test_cpu_and_mesh_evaluate_never_capture(monkeypatch, eval_cache,
                                             tmp_path):
    """evaluate on the CPU and under a mesh (a gloo world of one rank,
    made and destroyed here) makes no graph; only an unsharded call on the
    card replays."""
    import torch.distributed as dist

    from dgps_with_iwvi_torch.parallel import make_mesh

    metrics = eval_cache

    def refuse(*a, **k):
        raise AssertionError("a graph on an eager path")

    monkeypatch.setattr(graphs, "Graph", refuse)
    config, params, X, Y, _ = _eval_model("joint")
    kw = dict(y_std=np.ones(1), num_samples=S_EVAL, batch_size=BS_EVAL,
              device="cpu")
    plain = metrics.evaluate(params, config, X, Y, 2, **kw)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh(device="cpu")
        sharded = metrics.evaluate(params, config, X, Y, 2, mesh=mesh, **kw)
    finally:
        dist.destroy_process_group()
    assert not metrics.eval_programs()
    np.testing.assert_allclose(sharded["test_loglik"], plain["test_loglik"],
                               rtol=1e-12)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert metrics._replays(cuda, None)
    assert not metrics._replays(cuda, mesh)
    assert not metrics._replays(cpu, None)


# every prediction route and family of CASES (the training-only policies
# predict as "joint" does)
EVAL_BODY_CASES = ["joint", "use_pallas", "multiscale_priors", "no_white",
                   "q_diag", "multiclass_matern", "softmax", "ordinal",
                   "bernoulli", "student_t"]


@pytest.mark.parametrize("case", EVAL_BODY_CASES)
def test_eval_body_waits_for_nothing(fake_graphs, eval_cache, case):
    """The captured evaluation chunk, after the warm-up chunk (which makes
    the constant tables), runs no operation that makes the host wait or
    copies from host memory."""
    metrics = eval_cache
    config, params, X, Y, _ = _eval_model(case)
    metrics._points(params, config, X, Y, 0, S_EVAL, BS_EVAL, None, True)
    (program,) = metrics.eval_programs()
    with torch.no_grad(), _HostWaits():
        ld, mean = program._body()
    assert bool(torch.isfinite(ld).all()) and bool(
        torch.isfinite(mean).all())
