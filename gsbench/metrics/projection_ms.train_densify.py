"""projection_ms.train_densify: device milliseconds per training step of the kernels
launched in the program's ``render_view.project`` range
(``ops/projection.py::project_gaussians`` and the opacity the tile cull
reads), forward and backward (``gsbench/layers.py``)."""

from gsbench.layers import layer_ms

LAYERS = ("render_view.project",)


def read(ctx):
    return layer_ms(ctx, "train_densify", LAYERS)
