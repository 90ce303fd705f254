"""step_mfu.train_densify: the FP32 operations that the traced training steps
needed (``gsbench.work.step_ops``: counted from shapes and from the
reference's counts of entries and pairs on the steps' inputs, over the
active rows alone: the parked rows' work is not what the algorithm needs,
so the capacity's padding shows as lost share) over the
traced window's seconds times the card's 67 TFLOP/s, in %."""

from gsbench import work as W


def read(ctx):
    if ctx.loop != "train_densify" or ctx.trace.window_s <= 0:
        return None
    ops = sum(W.step_ops(s["n"], s["params"], s["pixels"], s["evaluated"],
                         s["applied"], s["aabb"], s["entries"], s["quad"],
                         s["cull"]) for s in ctx.work())
    return 100.0 * ops / (ctx.trace.window_s * W.FP32_OPS_PER_S)
