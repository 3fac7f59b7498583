"""Host milliseconds per scoring call: the part of each
``Scorer.score`` call (the benchmark's ``score.call`` span) in which no
operation ran on the device, summed over the traced calls, per call.
Layer: scorer loop (table staging, pinning, copies, launches). Moves
score_rows_per_s."""

SPAN = "perfbench.score.call"


def read(ctx):
    calls = ctx.units.get("calls")
    if not calls or not ctx.trace.ops:
        return None
    from perfbench.tracing import overlap_ns, union

    busy = union((o[1], o[2]) for o in ctx.trace.ops)
    idle = sum((e - s) - overlap_ns(busy, s, e)
               for n, s, e in ctx.trace.spans if n == SPAN)
    return idle / 1e6 / calls
