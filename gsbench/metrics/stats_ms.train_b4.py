"""stats_ms.train_b4: device milliseconds per batched training step of the
kernels launched in the program's ``train_step.stats`` range
(``models/trainer.py::make_batched_train_step``'s densification
statistics: the views' radii and probe gradients stacked, their norms,
counts and largest radii folded in)."""

from gsbench.layers import layer_ms

LAYERS = ("train_step.stats",)


def read(ctx):
    return layer_ms(ctx, "train_b4", LAYERS)
