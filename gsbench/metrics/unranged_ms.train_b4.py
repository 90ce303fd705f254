"""unranged_ms.train_b4: device milliseconds per batched training step of
the kernels launched under none of the program's ranges and outside
torch.optim's ``Optimizer.step#`` range: what the program's layer ranges
leave uncovered (``gsbench/layers.py``); the engine's sums of the views'
gradients lie in ``train_step.accumulate.backward``."""

from gsbench.layers import unranged_ms


def read(ctx):
    return unranged_ms(ctx, "train_b4")
