"""shproj_launches.train_densify: kernel launches per training step in the program's
``train_step.activate``, ``render_view.sh``, ``render_view.project`` and
``render_view.pack`` ranges, forward or backward (``gsbench/layers.py``):
what a fused SH / projection autograd would take off the host's issue."""

from gsbench.layers import SH_PROJECTION, layer_launches


def read(ctx):
    return layer_launches(ctx, "train_densify", SH_PROJECTION)
