"""The device's idle share of the traced scoring window, in %: the part
of the window in which no operation (kernel or copy) ran on the device.
Layer: device. Moves score_rows_per_s."""


def read(ctx):
    if not ctx.units.get("calls") or not ctx.trace.ops:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_ns() / 1e9 / ctx.trace.window_s)
