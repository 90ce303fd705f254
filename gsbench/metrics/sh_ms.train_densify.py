"""sh_ms.train_densify: device milliseconds per training step of the kernels launched
in the program's ``render_view.sh`` range
(``ops/sh_eval.py::compute_colors``), forward and backward
(``gsbench/layers.py``)."""

from gsbench.layers import layer_ms

LAYERS = ("render_view.sh",)


def read(ctx):
    return layer_ms(ctx, "train_densify", LAYERS)
