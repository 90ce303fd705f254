"""k2_roofline_share.render: the forward blend kernel's (K2,
``csrc/rasterize.cu``) roofline bound over its device time, in %, over the
traced frames; the bound counts ``gsbench.work.k2_work`` with the pairs the
reference's replay evaluates and applies on each frame's inputs."""

from gsbench import work as W
from gsbench.trace import kernel_ms

KERNEL = "rasterize_forward_kernel"


def read(ctx):
    if ctx.loop != "render":
        return None
    ms = kernel_ms(ctx.trace, lambda k: KERNEL in k.name)
    if ms <= 0:
        return None
    bound = sum(W.bound_s(*W.k2_work(s["entries"], s["num_tiles"], s["pix"],
                                     s["evaluated"], s["applied"], s["quad"]))
                for s in ctx.work())
    return 100.0 * bound / (ms / 1e3)
