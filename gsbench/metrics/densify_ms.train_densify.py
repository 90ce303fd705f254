"""densify_ms.train_densify: device milliseconds per density-control round
of the kernels launched in the program's ``train_step.densify`` range and
its sub-ranges (``models/densify.py``: the decision, the rows' gathers and
scatters, Adam's moment surgery), over the rounds of the traced steps (the
program's ``densify.cloned`` counter keeps one value a round, only while a
profiler records)."""

import importlib

PROFILING = "luisacomputegaussiansplatting_tpu_torch.utils.profiling"
RANGE = "train_step.densify"


def read(ctx):
    if ctx.loop != "train_densify" or ctx.steps <= 0:
        return None
    counts = getattr(importlib.import_module(PROFILING), "counts", None)
    if counts is None:  # a program without the counters
        return None
    rounds = len(counts("densify.cloned"))
    ks = [k for k in ctx.trace.kernels
          if any(r == RANGE or r.startswith(RANGE + ".") for r in k.ranges)]
    if rounds <= 0 or not ks:
        return None
    return sum(k.end_us - k.start_us for k in ks) / 1e3 / rounds
