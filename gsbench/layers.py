"""The program's own layer ranges and gap labels, as the per-layer metrics
that read them take them.

While a profiler records, the program opens a ``record_function`` range at
each layer boundary: ``render_view`` and its stages ``render_view.<stage>``,
``train_step`` and its layers ``train_step.<layer>``,
``viewer.frame_to_hwc`` and ``render_sharded.<stage>``; the backward of a
layer runs under ``<layer>.backward``
(``luisacomputegaussiansplatting_tpu_torch/utils/profiling.py``). A kernel
belongs to layer X when X or ``X.backward`` is among the host ranges around
its launch (``gsbench.trace.Kernel.ranges``). A program without those
ranges gives these readers nothing to read: they return None.
"""

from __future__ import annotations

import re

#: the names of the program's ranges
PROGRAM = re.compile(r"(render_view|train_step|viewer|render_sharded)(\.|$)")
#: torch.optim's own range around the optimizer's update
OPTIMIZER = "Optimizer.step#"
#: the label ``gsbench/trace.py`` gives an idle gap that starts under no
#: host op
UNLABELLED = "(no host op)"
#: the layers whose launches a fused SH / projection autograd would remove
SH_PROJECTION = ("train_step.activate", "render_view.sh",
                 "render_view.project", "render_view.pack")


def in_layers(k, layers) -> bool:
    """Whether kernel ``k`` was launched in one of ``layers`` (forward or
    backward)."""
    return any(r in layers or (r.endswith(".backward")
                               and r[:-len(".backward")] in layers)
               for r in k.ranges)


def ranged(k) -> bool:
    """Whether kernel ``k`` was launched under any of the program's
    ranges."""
    return any(PROGRAM.match(r) for r in k.ranges)


def _per_step(ctx, loop: str, kernels, value):
    if ctx.loop != loop or ctx.steps <= 0 or not kernels:
        return None
    return value(kernels) / ctx.steps


def layer_ms(ctx, loop: str, layers) -> float | None:
    """Device milliseconds a step or frame of the kernels in ``layers``."""
    ks = [k for k in ctx.trace.kernels if in_layers(k, layers)]
    return _per_step(ctx, loop, ks, lambda ks: sum(
        k.end_us - k.start_us for k in ks) / 1e3)


def layer_launches(ctx, loop: str, layers) -> float | None:
    """Kernel launches a step or frame in ``layers``."""
    ks = [k for k in ctx.trace.kernels if in_layers(k, layers)]
    return _per_step(ctx, loop, ks, len)


def unranged_ms(ctx, loop: str) -> float | None:
    """Device milliseconds a step or frame of the kernels launched under
    none of the program's ranges and outside the optimizer's update (0 where
    the ranges cover every kernel); None where the program has no ranges."""
    ks = ctx.trace.kernels
    if ctx.loop != loop or ctx.steps <= 0 or not any(ranged(k) for k in ks):
        return None
    out = [k for k in ks if not ranged(k)
           and not any(r.startswith(OPTIMIZER) for r in k.ranges)]
    return sum(k.end_us - k.start_us for k in out) / 1e3 / ctx.steps


def unlabelled_idle_share(ctx, loop: str) -> float | None:
    """The share (%) of the window's idle time in gaps that start under no
    host op."""
    idle = sum(s for _, s in ctx.trace.gaps)
    if ctx.loop != loop or idle <= 0:
        return None
    return 100.0 * sum(s for name, s in ctx.trace.gaps
                       if name == UNLABELLED) / idle
