"""The program's spans (``utils/trace.py``): off without a profiler, and
under one the spans of ``Scorer.score``, ``fit`` and the graphs, nested
as ``utils.trace`` lists them.

The ``cuda`` case needs the card and skips without one; this file imports
no JAX, so on the card it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_trace.py
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dgps_with_iwvi_torch.models import BuildArgs, build_model
from dgps_with_iwvi_torch.serving import Scorer
from dgps_with_iwvi_torch.training import TrainConfig, fit, make_trainer
from dgps_with_iwvi_torch.training import train
from dgps_with_iwvi_torch.utils import graphs, trace

N, M, K, B, S = 48, 8, 4, 16, 3
LGG = BuildArgs(configuration="LGG", mode="IW", num_inducing=M,
                num_iw_samples=K)


def _model(device="cpu"):
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N, 3)).astype(np.float32)
    Y = (np.sin(X[:, :1]) + 0.1 * rng.standard_normal((N, 1))).astype(
        np.float32)
    config, params = build_model(0, LGG, X, Y, device=device)
    return config, params, X, Y


def _train(device="cpu"):
    config, params, X, Y = _model(device)
    tc = TrainConfig(natgrad="final", minibatch_size=B, steps_per_call=5,
                     iterations=10, gamma=1e-2)
    return (config, params, tc, torch.as_tensor(X, device=device),
            torch.as_tensor(Y, device=device))


def _score(device="cpu"):
    config, params, X, Y = _model(device)
    # 48 rows in batches of 32: two batches, the last one padded
    return Scorer(params, config, S, device=device).score(
        X, Y, seed=3, max_batch=32)


def _fit(device="cpu"):
    config, params, tc, X, Y = _train(device)
    seen = []
    fit(torch.Generator(device=device).manual_seed(0), config, params, X, Y,
        tc, callback=lambda step, loss, state: seen.append(step))
    return seen


def _spans(prof) -> list:
    """[(name without the prefix, start_ns, end_ns)] of the program's
    spans on the host, in order of their start."""
    return sorted(
        ((e.name()[len(trace.PREFIX):], e.start_ns(),
          e.start_ns() + e.duration_ns())
         for e in prof.profiler.kineto_results.events()
         if e.name().startswith(trace.PREFIX)
         and not str(e.device_type()).endswith("CUDA")),
        key=lambda s: s[1])


def _names(spans) -> list:
    return [n for n, _, _ in spans]


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_span_is_a_shared_no_op_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    assert trace.span("a") is trace.span("b")
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(trace.span("a"), torch.profiler.record_function)


@pytest.mark.parametrize("call", [_score, _fit], ids=["score", "fit"])
def test_no_span_is_entered_without_a_profiler(call, monkeypatch):
    def entered(name):
        raise AssertionError(f"record_function({name!r}) was entered")

    monkeypatch.setattr(torch.profiler, "record_function", entered)
    call()


def test_scoring_spans_nest_as_listed():
    """One ``serving.score``; inside it the table, then per batch its
    upload and the batch, then the copy-back and the output dict, one
    after another (no pinning on the CPU)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _score()
    spans = _spans(prof)
    assert _names(spans) == [
        "serving.score", "serving.table", "serving.upload", "serving.batch",
        "serving.upload", "serving.batch", "serving.copyback",
        "serving.unpack"]
    outer, steps = spans[0], spans[1:]
    assert all(_inside(s, outer) for s in steps)
    assert all(a[2] <= b[1] for a, b in zip(steps, steps[1:]))


def test_fit_spans_one_of_each_per_chunk():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        seen = _fit()
    assert seen == [5, 10]
    spans = _spans(prof)
    assert _names(spans) == ["fit.chunk", "fit.readback", "fit.callback"] * 2
    assert all(a[2] <= b[1] for a, b in zip(spans, spans[1:]))


class _FakeCUDAGraph:
    def register_generator_state(self, gen):
        pass

    def replay(self):
        pass


def test_graph_spans_one_capture_then_a_replay_per_step(monkeypatch):
    """A graphed chunk on the CPU, its CUDA calls replaced (as
    tests/test_torch_graphs.py does): the first step is the capture's
    warm-up, each later step one replay."""
    monkeypatch.setattr(graphs, "capture_stream", lambda device: None)
    monkeypatch.setattr(graphs, "_warm_up", lambda fn, stream, device: fn())
    monkeypatch.setattr(graphs, "_capture", lambda graph, fn, stream: fn())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeCUDAGraph)
    config, params, tc, X, Y = _train()
    init, step, _, _ = make_trainer(config, tc)
    state, gen = init(params), torch.Generator().manual_seed(0)
    chunk = train.graphed_chunk_fn(step, tc, state, X, Y, gen)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            state, _ = chunk(state, X, Y, gen)
    assert _names(_spans(prof)) == ["graphs.capture"] + ["graphs.replay"] * 9


@pytest.mark.cuda
def test_on_the_card_a_capture_then_replays():
    """On the card: ``fit``'s graphed steps (ten in two chunks) capture
    once and replay per step after the first; ``Scorer.score``'s two
    batches of one shape capture once and replay once, a second call
    replays both."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _fit("cuda")
    names = _names(_spans(prof))
    assert names.count("graphs.capture") == 1
    assert names.count("graphs.replay") == 9
    assert [n for n in names if n.startswith("fit.")] == [
        "fit.chunk", "fit.readback", "fit.callback"] * 2

    config, params, X, Y = _model("cuda")
    scorer = Scorer(params, config, S, device="cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for seed in (3, 5):
            scorer.score(X, Y, seed=seed, max_batch=32)
    spans = _spans(prof)
    names = _names(spans)
    assert names.count("graphs.capture") == 1
    assert names.count("graphs.replay") == 3
    assert names.count("serving.pin") == 2
    batches = [s for s in spans if s[0] == "serving.batch"]
    graphed = [s for s in spans if s[0].startswith("graphs.")]
    assert all(any(_inside(g, b) for b in batches) for g in graphed)
