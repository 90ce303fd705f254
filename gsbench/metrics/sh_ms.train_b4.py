"""sh_ms.train_b4: device milliseconds per batched training step of the
kernels launched in the program's ``render_view.sh`` range
(``ops/sh_eval.py::compute_colors``), forward and backward, over the
step's views (``gsbench/layers.py``)."""

from gsbench.layers import layer_ms

LAYERS = ("render_view.sh",)


def read(ctx):
    return layer_ms(ctx, "train_b4", LAYERS)
