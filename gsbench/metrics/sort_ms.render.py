"""sort_ms.render: device milliseconds per rendered frame of the sort
kernels (the entry sort of ``ops/binning.py`` and the blend's tile-order
argsort: CUB's radix sort and the small-sort kernels)."""

import re

from gsbench.trace import kernel_ms

PATTERN = re.compile(r"RadixSort|SortKV|radix_sort|segmented_sort")


def read(ctx):
    if ctx.loop != "render" or ctx.steps <= 0:
        return None
    ms = kernel_ms(ctx.trace, lambda k: PATTERN.search(k.name) is not None)
    return ms / ctx.steps if ms > 0 else None
