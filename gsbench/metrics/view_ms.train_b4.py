"""view_ms.train_b4: device milliseconds per view of the kernels launched
under the program's ``render_view`` range and its stages' ranges, forward
and backward (SH, projection, expansion, sort, pack, gather, blend,
compose), over the views the traced steps rendered: the sum of the
program's ``train_step.views`` counts of those steps (one a step, only
while a profiler records). Comparable with a single-view step's render."""

import importlib

PROFILING = "luisacomputegaussiansplatting_tpu_torch.utils.profiling"
RANGE = "render_view"


def _in_render(k) -> bool:
    return any(r == RANGE or r.startswith(RANGE + ".") for r in k.ranges)


def read(ctx):
    if ctx.loop != "train_b4" or ctx.steps <= 0:
        return None
    counts = getattr(importlib.import_module(PROFILING), "counts", None)
    if counts is None:  # a program without the counters
        return None
    views = counts("train_step.views")[-ctx.steps:]
    ks = [k for k in ctx.trace.kernels if _in_render(k)]
    if len(views) < ctx.steps or sum(views) <= 0 or not ks:
        return None
    return sum(k.end_us - k.start_us for k in ks) / 1e3 / sum(views)
