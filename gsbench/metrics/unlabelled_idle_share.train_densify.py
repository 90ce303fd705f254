"""unlabelled_idle_share.train_densify: the share (%) of the idle time of the traced
window of training steps in gaps that ``gsbench/trace.py`` labels ``(no host
op)``: idle time that no host range, the program's own or an op's, can name."""

from gsbench.layers import unlabelled_idle_share


def read(ctx):
    return unlabelled_idle_share(ctx, "train_densify")
