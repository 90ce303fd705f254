"""activation_ms.train_b4: device milliseconds per batched training step of
the kernels launched in the program's ``train_step.activate`` range
(``models/gaussians.py::GaussianParams.activate``, once a step), forward
and backward; the backward range runs on through the gradients'
accumulation into the leaves and the stack of the per-view probes'
gradients (``gsbench/layers.py``)."""

from gsbench.layers import layer_ms

LAYERS = ("train_step.activate",)


def read(ctx):
    return layer_ms(ctx, "train_b4", LAYERS)
