"""unlabelled_idle_share.train_b4: the share (%) of the idle time of the
traced window of batched training steps in gaps that ``gsbench/trace.py``
labels ``(no host op)``."""

from gsbench.layers import unlabelled_idle_share


def read(ctx):
    return unlabelled_idle_share(ctx, "train_b4")
