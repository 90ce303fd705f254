"""k3_roofline_share.train_densify: the backward blend kernel's (K3,
``csrc/rasterize_backward.cu``) roofline bound over its device time, in %,
over the traced steps; the bound counts ``gsbench.work.k3_work`` with the
pairs the reference's replay evaluates and applies on each step's
inputs."""

from gsbench import work as W
from gsbench.trace import kernel_ms

KERNEL = "rasterize_backward_kernel"


def read(ctx):
    if ctx.loop != "train_densify":
        return None
    ms = kernel_ms(ctx.trace, lambda k: KERNEL in k.name)
    if ms <= 0:
        return None
    bound = sum(W.bound_s(*W.k3_work(s["entries"], s["num_tiles"], s["pix"],
                                     s["evaluated"], s["applied"], s["quad"]))
                for s in ctx.work())
    return 100.0 * bound / (ms / 1e3)
