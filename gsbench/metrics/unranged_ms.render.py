"""unranged_ms.render: device milliseconds per rendered frame of the kernels
launched under none of the program's ranges and outside torch.optim's
``Optimizer.step#`` range: what the program's layer ranges leave uncovered
(``gsbench/layers.py``)."""

from gsbench.layers import unranged_ms


def read(ctx):
    return unranged_ms(ctx, "render")
