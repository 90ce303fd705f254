"""activation_ms.train_densify: device milliseconds per training step of the kernels
launched in the program's ``train_step.activate`` range
(``models/gaussians.py::GaussianParams.activate``), forward and backward;
the backward range runs on through the gradients' accumulation into the
leaves (``gsbench/layers.py``)."""

from gsbench.layers import layer_ms

LAYERS = ("train_step.activate",)


def read(ctx):
    return layer_ms(ctx, "train_densify", LAYERS)
