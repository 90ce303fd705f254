"""accumulate_ms.train_b4: device milliseconds per batched training step of
the kernels launched in the program's ``train_step.accumulate.backward``
range: the autograd engine's sums of the B views' gradients of the
activated scene (B - 1 sums of 59 floats a gaussian), which each view's
marker on the scene puts there (``models/trainer.py``)."""

from gsbench.layers import layer_ms

LAYERS = ("train_step.accumulate",)


def read(ctx):
    return layer_ms(ctx, "train_b4", LAYERS)
