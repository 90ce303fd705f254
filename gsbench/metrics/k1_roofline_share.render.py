"""k1_roofline_share.render: the expansion kernel's (K1, ``csrc/expand.cu``)
roofline bound over its device time, in %, over the traced frames. The
bound counts the work of ``gsbench.work.k1_work`` on each frame's inputs."""

from gsbench import work as W
from gsbench.trace import kernel_ms

KERNEL = "expand_kernel"


def read(ctx):
    if ctx.loop != "render":
        return None
    ms = kernel_ms(ctx.trace, lambda k: KERNEL in k.name)
    if ms <= 0:
        return None
    bound = sum(W.bound_s(*W.k1_work(s["n"], s["max_pairs"], s["aabb"],
                                     s["cull"])) for s in ctx.work())
    return 100.0 * bound / (ms / 1e3)
