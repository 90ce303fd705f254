"""sh_ms.render: device milliseconds per rendered frame of the kernels launched
in the program's ``render_view.sh`` range
(``ops/sh_eval.py::compute_colors``) (``gsbench/layers.py``)."""

from gsbench.layers import layer_ms

LAYERS = ("render_view.sh",)


def read(ctx):
    return layer_ms(ctx, "render", LAYERS)
