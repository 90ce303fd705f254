"""k4_roofline_share.train_b4: the gradient reduction kernel's (K4,
``csrc/segsum.cu``, both its passes) roofline bound over its device time,
in %, over the traced batched steps; the bound sums
``gsbench.work.k4_work`` over every view of every step, on its kept
entries."""

from gsbench import work as W
from gsbench.trace import kernel_ms

KERNELS = ("segsum_starts_kernel", "segsum_sums_kernel")


def read(ctx):
    if ctx.loop != "train_b4":
        return None
    ms = kernel_ms(ctx.trace, lambda k: any(n in k.name for n in KERNELS))
    if ms <= 0:
        return None
    bound = sum(W.bound_s(*W.k4_work(v["entries"], v["n"]))
                for s in ctx.work() for v in s["views"])
    return 100.0 * bound / (ms / 1e3)
