"""The whole training step's share of the card's bf16 peak, in %: the
frozen FLOP count of one step (``work.train_step_flops``, products
only, over the rows the step computes: its minibatch, or the whole
training set on the full-batch step) times the steps of the traced
window, over its seconds and the data sheet's 989 TFLOP/s. Layer: the
whole step. Moves train_steps_per_s."""


def read(ctx):
    steps = ctx.units.get("steps")
    p = ctx.work.peaks(ctx.card)
    if not steps or p is None:
        return None
    m = ctx.cfg["model"]
    rows, full = ctx.work.step_rows(ctx.cfg["dataset"],
                                    ctx.traffic["minibatch_size"])
    flops = ctx.work.train_step_flops(
        ctx.specs, m["encoder_hidden"], 1, m["num_inducing"],
        m["num_iw_samples"], rows, full=full)
    return 100.0 * flops * steps / ctx.trace.window_s / p["bf16"]
