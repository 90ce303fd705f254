"""The readers of the program's layer ranges, gap labels and counters
(``gsbench/layers.py`` and the metrics that use it) on a synthetic trace,
and on one from a program without ranges, as the parent of the change that
added them has: there they give nothing (the gap share excepted, which
reads the harness's own labels)."""

import types

import pytest

from gsbench import harness
from gsbench.trace import Kernel, Trace

W = "gsbench.window"


def k(t, ms, *ranges):
    """A kernel of ``ms`` device milliseconds at ``t`` us, launched under
    ``ranges`` (innermost first)."""
    return Kernel("kernel", t, t + ms * 1e3, tuple(ranges) + (W,))


TRAIN = Trace(
    kernels=[
        k(0, 1.0, "aten::zeros", "train_step"),
        k(10, 2.0, "aten::mul", "train_step.activate", "train_step"),
        k(20, 4.0, "aten::mul", "render_view.sh", "render_view",
          "train_step"),
        k(30, 8.0, "aten::mul", "render_view.project", "render_view",
          "train_step"),
        k(40, 0.5, "aten::sort", "render_view.sort", "render_view",
          "train_step"),
        k(50, 16.0, "aten::sub", "train_step.loss", "train_step"),
        # the backward, on the engine's thread: only its layer's range
        k(60, 32.0, "aten::mul", "autograd::engine::evaluate_function: X",
          "render_view.sh.backward"),
        k(70, 64.0, "aten::copy_", "train_step.activate.backward"),
        k(80, 3.0, "aten::add", "render_view.pack.backward"),
        k(90, 128.0, "aten::_foreach_add_", "Optimizer.step#Adam.step",
          "train_step.optimizer", "train_step"),
        k(95, 0.25, "aten::copy_"),  # no range: unranged
    ],
    busy_s=0.2, window_s=1.0,
    gaps=[("(no host op)", 0.2), ("train_step.loss", 0.5),
          ("aten::mul", 0.1)])

RENDER = Trace(
    kernels=[
        k(0, 1.0, "aten::mul", "render_view.sh", "render_view"),
        k(10, 2.0, "aten::mul", "render_view.project", "render_view"),
        k(20, 4.0, "expand_kernel", "render_view.expand", "render_view"),
        k(30, 8.0, "aten::sort", "render_view.sort", "render_view"),
        k(40, 0.5, "aten::cat", "render_view.pack", "render_view"),
        k(50, 16.0, "aten::clamp"),  # the loop's own clamp
    ],
    busy_s=0.1, window_s=0.5, gaps=[("(no host op)", 0.1),
                                    ("render_view.blend", 0.3)])

#: metric -> (trace, steps traced, value)
EXPECTED = {
    "sh_ms.train": (TRAIN, 2, 36.0 / 2),
    "projection_ms.train": (TRAIN, 2, 8.0 / 2),
    "activation_ms.train": (TRAIN, 2, 66.0 / 2),
    "loss_ms.train": (TRAIN, 2, 16.0 / 2),
    "unranged_ms.train": (TRAIN, 2, 0.25 / 2),
    "shproj_launches.train": (TRAIN, 2, 6 / 2),
    "shproj_launches.train_host": (TRAIN, 2, 6 / 2),
    "unlabelled_idle_share.train": (TRAIN, 2, 100.0 * 0.2 / 0.8),
    "unlabelled_idle_share.train_host": (TRAIN, 2, 100.0 * 0.2 / 0.8),
    "sh_ms.render": (RENDER, 4, 1.0 / 4),
    "projection_ms.render": (RENDER, 4, 2.0 / 4),
    "binning_ms.render": (RENDER, 4, 12.0 / 4),
    "unranged_ms.render": (RENDER, 4, 16.0 / 4),
    "shproj_launches.render": (RENDER, 4, 3 / 4),
    "shproj_launches.render_host": (RENDER, 4, 3 / 4),
    "unlabelled_idle_share.render": (RENDER, 4, 25.0),
    "unlabelled_idle_share.render_host": (RENDER, 4, 25.0),
}


def ctx_of(trace, steps):
    loop = "train" if trace is TRAIN else "render"
    return harness.MetricContext(loop, trace, steps, lambda: [], {})


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_layer_reader(name):
    trace, steps, want = EXPECTED[name]
    read = harness.load_module("metrics", name).read
    ctx = ctx_of(trace, steps)
    assert read(ctx) == pytest.approx(want, rel=1e-12)
    # a run of the other loop is not this metric's
    other = "render" if ctx.loop == "train" else "train"
    assert read(ctx._replace(loop=other)) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_a_program_without_ranges_gives_nothing(name):
    trace, steps, _ = EXPECTED[name]
    bare = trace._replace(kernels=[
        kk._replace(ranges=tuple(r for r in kk.ranges
                                 if r.startswith(("aten::", "autograd::",
                                                  "Optimizer", W))))
        for kk in trace.kernels])
    got = harness.load_module("metrics", name).read(
        ctx_of(trace, steps)._replace(trace=bare))
    if name.startswith("unlabelled_idle_share"):
        assert got == pytest.approx(EXPECTED[name][2])
    else:
        assert got is None


@pytest.mark.parametrize("counts", [
    {"binning.kept_entries": [7, 80, 90], "binning.aabb_slots": [9, 100, 100]},
    None])
def test_kept_entry_share_reads_the_last_calls(counts, monkeypatch):
    import luisacomputegaussiansplatting_tpu_torch.utils.profiling as prof

    if counts is None:  # a program without counters
        monkeypatch.delattr(prof, "counts")
    else:
        monkeypatch.setattr(prof, "counts", lambda name: list(counts[name]))
    read = harness.load_module("metrics", "kept_entry_share.render").read
    got = read(ctx_of(RENDER, 2))
    assert got == (None if counts is None else pytest.approx(85.0))
    if counts is not None:  # fewer calls than frames: nothing
        assert read(ctx_of(RENDER, 4)) is None


def test_kept_entry_share_from_a_profiled_render(monkeypatch):
    """The counters as the program keeps them: one value a frame."""
    import torch

    from luisacomputegaussiansplatting_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "_COUNTS", {})
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for kept, slots in ((3, 4), (5, 6)):
            profiling.count("binning.kept_entries", torch.tensor(kept))
            profiling.count("binning.aabb_slots", torch.tensor(slots))
    profiling.count("binning.aabb_slots", torch.tensor(99))  # not recording
    read = harness.load_module("metrics", "kept_entry_share.render").read
    assert read(ctx_of(RENDER, 2)) == pytest.approx(80.0)
    assert read(types.SimpleNamespace(loop="train", steps=2)) is None
