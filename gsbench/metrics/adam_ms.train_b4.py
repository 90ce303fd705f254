"""adam_ms.train_b4: device milliseconds per batched training step of the
kernels launched inside ``torch.optim``'s ``Optimizer.step`` range (the
program's ``models/trainer.py::optimizer_step``, once a step)."""

from gsbench.trace import kernel_ms

RANGE = "Optimizer.step#"


def read(ctx):
    if ctx.loop != "train_b4" or ctx.steps <= 0:
        return None
    ms = kernel_ms(ctx.trace, lambda k: any(r.startswith(RANGE)
                                            for r in k.ranges))
    return ms / ctx.steps if ms > 0 else None
