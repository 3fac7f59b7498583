"""The traced window: torch.profiler (CUPTI) over the benchmark's spans.

The benchmark marks what its host thread is doing with spans of its own
(``span``: ``torch.profiler.record_function`` ranges named
``perfbench.*``), which the profiler stamps on the clock of the device's
kernels. ``Trace`` holds the window's device operations (kernels, copies,
sets) and those spans. Busy time is the union of the device operations'
intervals, so operations that overlap on two streams count once.
"""

from __future__ import annotations

import dataclasses

import torch

PREFIX = "perfbench."
WINDOW = PREFIX + "window"


class Window:
    """The window of a run and the benchmark's spans inside it: with
    `on`, a profiler runs from ``start`` to ``stop`` and each span is a
    ``torch.profiler.record_function`` range; without, all of it is a
    no-op. Spans nest: ``exit`` closes the innermost."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None
        self.spans: list = []

    def start(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()
        self.enter("window")

    def enter(self, name: str):
        if self.on:
            rf = torch.profiler.record_function(PREFIX + name)
            rf.__enter__()
            self.spans.append(rf)

    def exit(self):
        if self.on:
            self.spans.pop().__exit__(None, None, None)

    def stop(self):
        """The Trace of the window (None without the profiler); the
        caller has synchronized the device."""
        while self.spans:
            self.exit()
        if self.prof is None:
            return None
        self.prof.stop()
        return read(self.prof)


@dataclasses.dataclass
class Trace:
    ops: list        # [(name, start_ns, end_ns, kind)] device operations
    spans: list      # [(name, start_ns, end_ns)] the benchmark's spans
    window: tuple    # (start_ns, end_ns)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def kernels(self) -> list:
        return [o for o in self.ops if o[3] == "kernel"]

    def busy_ns(self) -> int:
        return sum(e - s for s, e in union((o[1], o[2]) for o in self.ops))

    def gaps(self) -> list:
        """[(start_ns, end_ns)] of the window with no device operation."""
        out, t = [], self.window[0]
        for s, e in union((o[1], o[2]) for o in self.ops):
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.window[1] > t:
            out.append((t, self.window[1]))
        return out

    def span_at(self, t: int) -> str:
        """The innermost benchmark span open at time t ("window" where
        the benchmark's own loop runs between its calls)."""
        best = None
        for name, s, e in self.spans:
            if s <= t < e and (best is None or s >= best[1]):
                best = (name, s)
        return best[0][len(PREFIX):] if best else "window"


def union(intervals) -> list:
    """Sorted, merged [(start, end)] of intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def overlap_ns(merged: list, s: int, e: int) -> int:
    """How much of [s, e) the merged intervals cover."""
    return sum(max(0, min(e, b) - max(s, a)) for a, b in merged
               if a < e and b > s)


def _kind(ev) -> str | None:
    """'kernel', 'gpu_memcpy' or 'gpu_memset' for a device operation,
    'span' for one of the benchmark's spans, else None."""
    name = ev.name()
    annotation = getattr(ev, "is_user_annotation", None)
    if name.startswith(PREFIX) or (annotation is not None and annotation()):
        cpu = str(ev.device_type()).endswith("CPU")
        return "span" if cpu and name.startswith(PREFIX) else None
    if not str(ev.device_type()).endswith("CUDA"):
        return None
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def read(prof) -> Trace:
    """The window of a finished profile: its device operations and spans,
    clipped to the benchmark's window span."""
    ops, spans = [], []
    for ev in prof.profiler.kineto_results.events():
        kind = _kind(ev)
        if kind is None:
            continue
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if kind == "span":
            spans.append((ev.name(), s, e))
        else:
            ops.append((ev.name(), s, e, kind))
    windows = [(s, e) for n, s, e in spans if n == WINDOW]
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} window spans")
    w0, w1 = windows[0]
    ops = [(n, max(s, w0), min(e, w1), k) for n, s, e, k in ops
           if e > w0 and s < w1]
    return Trace(ops, spans, (w0, w1))


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, summed by name, and the
    longest idle gaps, each named by the span the host was in."""
    by = {}
    for name, s, e, _ in trace.ops:
        by[name] = by.get(name, 0) + (e - s)
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(trace.gaps(), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n[:160], ns / 1e9] for n, ns in ops],
            "idle_gaps": [[trace.span_at(s), (e - s) / 1e9]
                          for s, e in gaps]}
