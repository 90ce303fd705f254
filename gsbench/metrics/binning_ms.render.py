"""binning_ms.render: device milliseconds per rendered frame of the kernels
launched in the program's ``render_view.expand`` and ``render_view.sort``
ranges (``ops/binning.py``: K1 and its slot table, the sort, the trim and
the tile ranges): every kernel of binning, not only the sort's
(``gsbench/layers.py``)."""

from gsbench.layers import layer_ms

LAYERS = ("render_view.expand", "render_view.sort")


def read(ctx):
    return layer_ms(ctx, "render", LAYERS)
