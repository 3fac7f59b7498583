"""The program's spans, on the profiler's clock.

``span(name)`` marks what the host thread is doing: while a
``torch.profiler`` profile runs, it is a ``torch.profiler.record_function``
range named ``"dgps." + name``, stamped on the same clock as the device's
kernels and copies; otherwise it is one shared no-op context, and a span
costs one check of whether a profiler runs (~90 ns). There is no flag and
no exporter: a profile's trace (``experiments/main.py --profile_dir``,
``experiments.profile_step``) is the export.

The spans and what each covers:

- ``serving.score``: one ``Scorer.score`` call; inside it, from
  ``serving.score_table`` (which ``ServingArtifact.score`` and the serve
  CLI also run): ``serving.table`` (the host table, to the transport
  dtype), ``serving.pin`` (pinning it), per batch ``serving.upload``
  (its copy to the card) and ``serving.batch`` (the scorer's call, a
  graph's seeding and replay, and the batch's results cast), then
  ``serving.copyback`` (the results to the host) and ``serving.unpack``
  (the output dict);
- ``graphs.capture``: a graph's warm-up and capture (``utils.graphs``);
  ``graphs.replay``: one replay;
- ``fit.chunk``: one chunk of ``training.fit``'s steps;
  ``fit.readback``: the chunk's mean loss to the host; ``fit.callback``:
  the callback after the chunk.

A CUDA graph does not replay a range recorded during its capture, so
there is no span inside a replayed step.
"""

from __future__ import annotations

import contextlib

import torch

PREFIX = "dgps."

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records ``PREFIX + name`` while a profiler runs."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(PREFIX + name)
    return _OFF
