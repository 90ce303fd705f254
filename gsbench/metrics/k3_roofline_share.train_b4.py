"""k3_roofline_share.train_b4: the backward blend kernel's (K3,
``csrc/rasterize_backward.cu``) roofline bound over its device time, in %,
over the traced batched steps; the bound sums ``gsbench.work.k3_work`` over
every view of every step, with the pairs the reference's replay evaluates
and applies on that view's inputs."""

from gsbench import work as W
from gsbench.trace import kernel_ms

KERNEL = "rasterize_backward_kernel"


def read(ctx):
    if ctx.loop != "train_b4":
        return None
    ms = kernel_ms(ctx.trace, lambda k: KERNEL in k.name)
    if ms <= 0:
        return None
    bound = sum(W.bound_s(*W.k3_work(v["entries"], v["num_tiles"], v["pix"],
                                     v["evaluated"], v["applied"], v["quad"]))
                for s in ctx.work() for v in s["views"])
    return 100.0 * bound / (ms / 1e3)
