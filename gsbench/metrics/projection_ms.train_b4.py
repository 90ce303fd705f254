"""projection_ms.train_b4: device milliseconds per batched training step of
the kernels launched in the program's ``render_view.project`` range
(``ops/projection.py::project_gaussians`` and the opacity the tile cull
reads), forward and backward, over the step's views
(``gsbench/layers.py``)."""

from gsbench.layers import layer_ms

LAYERS = ("render_view.project",)


def read(ctx):
    return layer_ms(ctx, "train_b4", LAYERS)
