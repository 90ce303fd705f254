"""step_mfu.train_b4: the FP32 operations that the traced batched steps
needed (``gsbench/work_batched.py``: every view's render, loss and backward
from the reference's counts of entries and pairs on its inputs, the
activation, its backward and Adam once a step) over the traced window's
seconds times the card's 67 TFLOP/s, in %."""

from gsbench import work as W
from gsbench import work_batched as WB


def read(ctx):
    if ctx.loop != "train_b4" or ctx.trace.window_s <= 0:
        return None
    ops = sum(WB.step_ops(s) for s in ctx.work())
    return 100.0 * ops / (ctx.trace.window_s * W.FP32_OPS_PER_S)
