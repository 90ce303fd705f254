"""elementwise_ms.train_densify: device milliseconds per training step of PyTorch's
elementwise, reduction and concatenation kernels, which the autograd of SH,
projection and activation and the column packing launch (with the smaller
elementwise work of binning and the loss)."""

import re

from gsbench.trace import kernel_ms

PATTERN = re.compile(r"elementwise_kernel|reduce_kernel|CatArrayBatchedCopy")
LOOP = "train_densify"


def read(ctx):
    if ctx.loop != LOOP or ctx.steps <= 0:
        return None
    ms = kernel_ms(ctx.trace, lambda k: PATTERN.search(k.name) is not None)
    return ms / ctx.steps if ms > 0 else None
