"""loss_ms.train_b4: device milliseconds per batched training step of the
kernels launched in the program's ``train_step.loss`` range
(``models/losses.py::d_ssim_l1_loss`` of each view, and the batch's mean),
forward and backward (``gsbench/layers.py``)."""

from gsbench.layers import layer_ms

LAYERS = ("train_step.loss",)


def read(ctx):
    return layer_ms(ctx, "train_b4", LAYERS)
