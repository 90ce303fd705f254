"""launches_per_step.train_b4: CUDA kernel launches per batched training
step, counted from the profiler's kernel events (copies and fills, such as
the batch's cameras and targets, are not launches)."""

LOOP = "train_b4"


def read(ctx):
    if ctx.loop != LOOP or ctx.steps <= 0:
        return None
    return len(ctx.trace.kernels) / ctx.steps
