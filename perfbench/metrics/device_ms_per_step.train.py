"""Device milliseconds per training step: the union of the device's
operations over the traced chunks (overlapping streams count once), per
step. Layer: trainer and model. Moves train_steps_per_s."""


def read(ctx):
    steps = ctx.units.get("steps")
    if not steps or not ctx.trace.ops:
        return None
    return ctx.trace.busy_ns() / 1e6 / steps
