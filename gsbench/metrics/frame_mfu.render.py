"""frame_mfu.render: the FP32 operations that the traced frames needed
(``gsbench.work.frame_ops``: counted from shapes and from the reference's
counts of slots and pairs on the frames' poses) over the traced window's
seconds times the card's 67 TFLOP/s, in %."""

from gsbench import work as W


def read(ctx):
    if ctx.loop != "render" or ctx.trace.window_s <= 0:
        return None
    ops = sum(W.frame_ops(s["n"], s["evaluated"], s["applied"], s["aabb"],
                          s["quad"], s["cull"]) for s in ctx.work())
    return 100.0 * ops / (ctx.trace.window_s * W.FP32_OPS_PER_S)
