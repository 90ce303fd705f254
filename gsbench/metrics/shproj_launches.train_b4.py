"""shproj_launches.train_b4: kernel launches per batched training step in
the program's ``train_step.activate``, ``render_view.sh``,
``render_view.project`` and ``render_view.pack`` ranges, forward or
backward (``gsbench/layers.py``)."""

from gsbench.layers import SH_PROJECTION, layer_launches


def read(ctx):
    return layer_launches(ctx, "train_b4", SH_PROJECTION)
