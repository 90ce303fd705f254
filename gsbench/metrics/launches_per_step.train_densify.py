"""launches_per_step.train_densify: CUDA kernel launches per training step, counted
from the profiler's kernel events (copies and fills are not launches)."""

LOOP = "train_densify"


def read(ctx):
    if ctx.loop != LOOP or ctx.steps <= 0:
        return None
    return len(ctx.trace.kernels) / ctx.steps
