"""CUDA graphs: the port's counterpart of the reference's ``jax.jit``.

The reference runs a chunk of training steps and every scoring request as
one compiled XLA program (``training/train.py:345``, ``serving.py:191``).
Eager PyTorch issues each op from the host instead, and a step of about
665 launches leaves the card idle most of the time. Here a call is
captured once as a CUDA graph and then replayed with one launch from the
host. ``training.train.fit`` replays a captured training step and
``serving.Scorer`` a captured request; the CPU path stays eager.

``Graph(fn, device=...)`` first runs ``fn()`` for real on the capture
stream (the warm-up, whose result is the call's own), so that a kernel's
first launch (its ``cudaFuncSetAttribute``, the nvcc build of
``build.library``), lazily made state (Adam's moments, a constant table,
cuBLAS's workspace) and K2's per-stream scratch all come before the
capture; then it captures a second call. The capture runs nothing: every
replay does the captured work on the same tensors, so ``fn`` must read
and write static tensors, and its outputs at the capture (``Graph.out``)
are overwritten by every replay. Registered generators advance at each
replay as an eager call would advance them.

``GraphCache`` keeps one graph per static key (input shapes and policy),
as ``jax.jit`` keeps one executable per static signature; the key also
holds whether ``ops.hopper.build.plain_versions()`` is in force, since a
graph bakes the kernels it captured.

Launch counts (``ops.hopper.build``): the warm-up counts as an eager
call; the capture records its launches into the graph's tally, and each
replay adds the tally once, so the counts stay exact per call.

Every graph is captured on one stream per device, so that K2's scratch,
kept per (device, stream), is one buffer sized at the first warm-up. All
graphs replay on the caller's current stream; two graphs must not replay
at once on two streams, since they share that scratch. If capture fails
the call raises: nothing falls back to the eager path. A capture starts
after a full garbage collection and holds the collector off until it
ends (``_capture``): a dead graph freed inside a capture invalidates it.
"""

from __future__ import annotations

import gc
import time

import torch

from ..ops.hopper import build

_streams: dict = {}


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream every graph on `device` warms up and is captured on."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    stream = _streams.get(index)
    if stream is None:
        stream = _streams[index] = torch.cuda.Stream(device=index)
    return stream


def _tensors(out) -> list:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (list, tuple)):
        return [t for v in out for t in _tensors(v)]
    if isinstance(out, dict):
        return [t for v in out.values() for t in _tensors(v)]
    return []


def _warm_up(fn, stream, device):
    """fn() run for real on `stream`, ordered after the caller's stream and
    before its later work; its outputs are marked as used on the caller's
    stream, so that freeing them there is safe."""
    current = torch.cuda.current_stream(device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        out = fn()
    current.wait_stream(stream)
    for t in _tensors(out):
        t.record_stream(current)
    return out


def _capture(graph, fn, stream):
    """fn() captured into `graph` on `stream`, with Python's cyclic garbage
    collector run to its end first and held off during the capture. A
    dropped graph in a reference cycle (a ``GraphedEval`` and its body, a
    finished ``fit``'s chunk function) is freed only by that collector,
    and freeing a CUDA graph is an operation a capturing stream does not
    permit: collected during a capture, it invalidates the capture. The
    card is synchronized first, so no dropped graph is still running."""
    torch.cuda.synchronize()
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, stream=stream):
            return fn()
    finally:
        if enabled:
            gc.enable()


class Graph:
    """One call of ``fn()`` as a CUDA graph, with the kernel launches that
    its capture recorded (``launches``) and the wall seconds of its warm-up
    and capture (``capture_s``; the capture waits for the warm-up's work
    on the card)."""

    def __init__(self, fn, *, device, generators=()):
        t0 = time.perf_counter()
        stream = capture_stream(device)
        self.first = _warm_up(fn, stream, device)
        self._graph = torch.cuda.CUDAGraph()
        for gen in generators:
            self._graph.register_generator_state(gen)
        with build.capturing() as self.launches:
            self.out = _capture(self._graph, fn, stream)
        self.capture_s = time.perf_counter() - t0

    def replay(self):
        """Launch the graph on the current stream; returns ``out``."""
        self._graph.replay()
        build.replayed(self.launches)
        return self.out


class GraphCache:
    """One ``Graph`` per static key on one device, with the generators that
    every graph draws from registered."""

    def __init__(self, device, generators=()):
        self.device = torch.device(device)
        self.generators = tuple(generators)
        self._graphs: dict = {}

    def graphs(self) -> list:
        """The graphs captured so far."""
        return list(self._graphs.values())

    def __call__(self, key, fn):
        """fn()'s result: for a new key the warm-up's, after which the call
        is captured; else one replay of the key's graph (its ``out``)."""
        full = (key, build.plain_requested())
        graph = self._graphs.get(full)
        if graph is None:
            graph = self._graphs[full] = Graph(
                fn, device=self.device, generators=self.generators)
            return graph.first
        return graph.replay()
