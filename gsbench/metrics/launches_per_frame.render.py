"""launches_per_frame.render: CUDA kernel launches per rendered frame, counted
from the profiler's kernel events (copies and fills are not launches)."""

LOOP = "render"


def read(ctx):
    if ctx.loop != LOOP or ctx.steps <= 0:
        return None
    return len(ctx.trace.kernels) / ctx.steps
