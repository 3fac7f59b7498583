"""The whole scored batch's share of the card's bf16 peak, in %: the
frozen FLOP count per row (``work.score_flops_per_row``, products only)
times the rows of the traced calls, over the window's seconds and the
data sheet's 989 TFLOP/s. Layer: the whole batch. Moves
score_rows_per_s."""


def read(ctx):
    rows = ctx.units.get("rows")
    p = ctx.work.peaks(ctx.card)
    if not rows or p is None:
        return None
    flops = ctx.work.score_flops_per_row(
        ctx.specs, ctx.cfg["model"]["num_inducing"],
        ctx.traffic["num_samples"], ctx.traffic["batch_rows"])
    return 100.0 * flops * rows / ctx.trace.window_s / p["bf16"]
