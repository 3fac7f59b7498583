"""Device kernels per replayed training step, counted in the profiler's
trace. Layer: graphs (one CUDA graph replay per step). Moves
train_steps_per_s."""


def read(ctx):
    steps = ctx.units.get("steps")
    if not steps or not ctx.trace.ops:
        return None
    return len(ctx.trace.kernels()) / steps
