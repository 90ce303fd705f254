"""kept_entry_share.render: the share (%) of the traced frames' tile-rect
(AABB) slots that binning keeps as entries after K1's cull and the trim: 100
x the sum of the program's ``binning.kept_entries`` counts over the sum of
its ``binning.aabb_slots`` counts, over the last ``ctx.steps`` binning calls
(one a frame), as ``utils/profiling.py::counts`` gives them."""

import importlib

PROFILING = "luisacomputegaussiansplatting_tpu_torch.utils.profiling"


def read(ctx):
    if ctx.loop != "render" or ctx.steps <= 0:
        return None
    counts = getattr(importlib.import_module(PROFILING), "counts", None)
    if counts is None:  # a program without the counters
        return None
    kept = counts("binning.kept_entries")[-ctx.steps:]
    slots = counts("binning.aabb_slots")[-ctx.steps:]
    if len(kept) < ctx.steps or len(slots) < ctx.steps or sum(slots) <= 0:
        return None
    return 100.0 * sum(kept) / sum(slots)
