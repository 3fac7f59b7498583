"""K3's share of its roofline in training, in %: the least time of K3's
work per step (one call per GP layer over A [K, M, B], B the rows the
step computes, from the frozen formulas of ``work.py`` and the data
sheet's peaks) times the steps, over the device time of the kernels in
K3's namespace (``k3_epilogue_bwd``); None where the step launches no
K3 (the full-batch step's exact class takes the plain path). Layer:
kernels. Moves train_steps_per_s."""

NAMESPACE = "k3_epilogue_bwd"


def read(ctx):
    steps = ctx.units.get("steps")
    ns = sum(e - s for n, s, e, _ in ctx.trace.kernels() if NAMESPACE in n)
    if not steps or not ns or ctx.work.peaks(ctx.card) is None:
        return None
    m = ctx.cfg["model"]
    bound = ctx.work.k3_bound_s_per_step(
        ctx.card, ctx.specs, m["num_inducing"], m["num_iw_samples"],
        ctx.work.step_rows(ctx.cfg["dataset"],
                           ctx.traffic["minibatch_size"])[0])
    return 100.0 * bound * steps / (ns / 1e9)
