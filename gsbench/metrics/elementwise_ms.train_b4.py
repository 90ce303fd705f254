"""elementwise_ms.train_b4: device milliseconds per batched training step of
PyTorch's elementwise, reduction and concatenation kernels, which the
autograd of activation, the column packing and gather, the engine's sums
of the views' gradients and the smaller elementwise work of binning, the
loss and the statistics launch."""

import re

from gsbench.trace import kernel_ms

PATTERN = re.compile(r"elementwise_kernel|reduce_kernel|CatArrayBatchedCopy")
LOOP = "train_b4"


def read(ctx):
    if ctx.loop != LOOP or ctx.steps <= 0:
        return None
    ms = kernel_ms(ctx.trace, lambda k: PATTERN.search(k.name) is not None)
    return ms / ctx.steps if ms > 0 else None
