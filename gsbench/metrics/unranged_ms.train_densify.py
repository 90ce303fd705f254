"""unranged_ms.train_densify: device milliseconds per training step of the kernels
launched under none of the program's ranges and outside torch.optim's
``Optimizer.step#`` range: what the program's layer ranges leave uncovered
(``gsbench/layers.py``)."""

from gsbench.layers import unranged_ms


def read(ctx):
    return unranged_ms(ctx, "train_densify")
