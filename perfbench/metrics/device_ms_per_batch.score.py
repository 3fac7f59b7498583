"""Device milliseconds per scored batch: the union of the device's
operations over the traced calls, per batch of the mix's batch_rows
rows. Layer: model (the conditional and its kernels). Moves
score_rows_per_s."""


def read(ctx):
    batches = ctx.units.get("batches")
    if not batches or not ctx.trace.ops:
        return None
    return ctx.trace.busy_ns() / 1e6 / batches
