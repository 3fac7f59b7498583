"""The device's idle share of the traced training window, in %: the
part of the window in which no operation ran on the device. Layer:
device. Moves train_steps_per_s."""


def read(ctx):
    if not ctx.units.get("steps") or not ctx.trace.ops:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_ns() / 1e9 / ctx.trace.window_s)
