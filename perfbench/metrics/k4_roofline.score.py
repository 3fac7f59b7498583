"""K4's share of its roofline in scoring, in %: the least time of K4's
work per batch (one call per GP layer over S x batch rows, 'sample' on
inner layers and 'infer' on the final one, from the frozen formulas of
``work.py`` and the data sheet's peaks) times the batches, over the
device time of the kernels in K4's namespace (``k4_serve_cond``).
Layer: kernels. Moves score_rows_per_s."""

NAMESPACE = "k4_serve_cond"


def read(ctx):
    batches = ctx.units.get("batches")
    ns = sum(e - s for n, s, e, _ in ctx.trace.kernels() if NAMESPACE in n)
    if not batches or not ns or ctx.work.peaks(ctx.card) is None:
        return None
    bound = ctx.work.k4_bound_s_per_batch(
        ctx.card, ctx.specs, ctx.cfg["model"]["num_inducing"],
        ctx.traffic["num_samples"], ctx.traffic["batch_rows"])
    return 100.0 * bound * batches / (ns / 1e9)
