"""active_share.train_densify: the share (%) of the capacity's rows that
are active over the traced steps: 100 x the sum of the program's
``densify.active_rows`` counts over the sum of its ``densify.capacity``
counts, over the last ``ctx.steps`` calls of ``density_control`` (one a
step), as ``utils/profiling.py::counts`` gives them."""

import importlib

PROFILING = "luisacomputegaussiansplatting_tpu_torch.utils.profiling"


def read(ctx):
    if ctx.loop != "train_densify" or ctx.steps <= 0:
        return None
    counts = getattr(importlib.import_module(PROFILING), "counts", None)
    if counts is None:  # a program without the counters
        return None
    active = counts("densify.active_rows")[-ctx.steps:]
    capacity = counts("densify.capacity")[-ctx.steps:]
    if len(active) < ctx.steps or len(capacity) < ctx.steps \
            or sum(capacity) <= 0:
        return None
    return 100.0 * sum(active) / sum(capacity)
