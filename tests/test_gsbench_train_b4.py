"""The benchmark's cell ``bicycle-train-b4`` at a test's size on the CPU,
through ``gsbench/harness.py`` (``make_cell`` overrides, as
``gsbench/tests/test_gsbench_registry.py`` runs a cell): the whole run is
``correct``; the control (the reference in bfloat16 in the program's place)
and each fault planted in the reference in the program's place
(``one_view``, ``shared_probe``, ``half_batch``, ``unchanged``) fail its
limits, and the program broken underneath a whole run fails it; the new
per-layer readers on a synthetic trace; the batched step's work counts.

This file imports no JAX.
"""

import functools

import pytest
import torch

from gsbench import harness
from gsbench import work as W
from gsbench import work_batched as WB
from gsbench.reference import render as R
from gsbench.reference import train_batched as RB
from gsbench.trace import Kernel, Trace
from luisacomputegaussiansplatting_tpu_torch.models import trainer
from luisacomputegaussiansplatting_tpu_torch.utils import profiling

torch.set_num_threads(2)

CPU = torch.device("cpu")
CELL = "bicycle-train-b4"
#: the cell at a test's size
TINY = {"config": {"scene": {"n_gaussians": 1500},
                   "dataset": {"width": 64, "height": 48, "images": 12},
                   "render": {"max_pairs": 30000, "max_pairs_sorted": None}},
        "traffic": {"trace_steps": 2}}


@pytest.fixture(autouse=True)
def _no_new_forbidden_modules(monkeypatch):
    """The harness refuses a run in a process that holds JAX; this suite's
    ``conftest.py`` loads JAX for the parity tests before any test, so a
    run here is refused only for the forbidden modules it loads itself."""
    found = harness.forbidden_modules
    before = set(found())
    monkeypatch.setattr(harness, "forbidden_modules",
                        lambda: sorted(set(found()) - before))


def _failing(cell, numbers):
    limits = cell.spec["limits"]
    return [k for k, v in numbers.items() if not v <= limits[k]]


def test_the_cell_runs_and_is_correct():
    cell = harness.make_cell(CELL, 2**32 + 6, CPU, TINY)
    out = harness.run_cell(cell, 0.3, False, 0.0)
    assert out["correct"] and out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"train_step_ms", "peak_device_gib",
                                   "setup_s"}
    assert set(out["checks"]) == {"loss_gap", "grad_gap", "change_gap",
                                  "stats_gap", "overflow"}


@functools.lru_cache(maxsize=None)
def _checked():
    """(cell, the program's records, the reference's) at a test's size."""
    cell = harness.make_cell(CELL, 2**32 + 5, CPU, TINY)
    loop = harness.load_module("loops", cell.traffic["loop"])
    records = loop.release(loop.setup(cell))
    return cell, loop, records, loop.reference(cell, records)


def test_the_program_passes_and_the_control_fails():
    cell, loop, records, ref = _checked()
    assert not _failing(cell, loop.compare(records, ref))
    control = loop.reference(cell, records, "bf16")
    assert _failing(cell, loop.compare(control, ref))


@pytest.mark.parametrize("fault", RB.FAULTS)
def test_each_fault_in_the_programs_place_fails(fault):
    cell, loop, records, ref = _checked()
    failing = _failing(cell, loop.compare(
        loop.reference(cell, records, fault=fault), ref))
    assert failing
    if fault == "shared_probe":  # the probe moves nothing but statistics
        assert failing == ["stats_gap"]


def _run():
    cell = harness.make_cell(CELL, 2**32 + 6, CPU, TINY)
    return harness.run_cell(cell, 0.3, False, 0.0)


def test_a_step_that_leaves_the_state_unchanged_fails(monkeypatch):
    monkeypatch.setattr(trainer, "optimizer_step", lambda *a, **k: None)
    out = _run()
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] > \
        out["checks"]["change_gap"]["limit"]


def test_half_the_image_left_out_of_the_loss_fails(monkeypatch):
    loss = trainer.d_ssim_l1_loss

    def half(pred, target, w=0.2):
        rows = pred.shape[1] // 2
        return loss(pred[:, :rows], target[:, :rows], w)

    monkeypatch.setattr(trainer, "d_ssim_l1_loss", half)
    assert not _run()["correct"]


# ---------------------------------------------------------------------------
# The readers of the cell's per-layer metrics on a synthetic trace
# ---------------------------------------------------------------------------

WIN = "gsbench.window"


def k(t, ms, *ranges, name="kernel"):
    """A kernel of ``ms`` device milliseconds at ``t`` us, launched under
    ``ranges`` (innermost first)."""
    return Kernel(name, t, t + ms * 1e3, tuple(ranges) + (WIN,))


#: one batched step of two views, as the program's ranges lay it out
STEP = Trace(
    kernels=[
        k(0, 1.0, "aten::exp", "train_step.activate", "train_step"),
        k(10, 2.0, "sh_forward_kernel", "render_view.sh", "render_view",
          "train_step"),
        k(20, 4.0, "aten::sort", "render_view.sort", "render_view",
          "train_step"),
        k(30, 2.0, "sh_forward_kernel", "render_view.sh", "render_view",
          "train_step"),
        k(40, 8.0, "aten::sub", "train_step.loss", "train_step"),
        k(50, 16.0, "rasterize_backward_kernel",
          "render_view.blend.backward", name="rasterize_backward_kernel"),
        k(60, 0.5, "segsum_sums_kernel", "render_view.gather.backward",
          name="segsum_sums_kernel"),
        k(70, 32.0, "aten::add_", "autograd::engine::evaluate_function: X",
          "train_step.accumulate.backward", name="elementwise_kernel"),
        k(80, 64.0, "aten::copy_", "train_step.activate.backward"),
        k(90, 128.0, "adam_kernel", "Optimizer.step#Adam.step",
          "train_step.optimizer", "train_step"),
        k(95, 0.25, "aten::sum", "train_step.stats", "train_step",
          name="reduce_kernel"),
    ],
    busy_s=0.2, window_s=1.0,
    gaps=[("(no host op)", 0.2), ("train_step.loss", 0.6)])

VIEW = {"n": 10, "params": 590, "pixels": 12, "evaluated": 100,
        "applied": 50, "aabb": 40, "entries": 10, "num_tiles": 2,
        "pix": 256, "max_pairs": 100, "quad": "mxu", "cull": True}
WORK = [{"n": 10, "params": 590, "views": [VIEW, VIEW]}]

#: metric -> value, over one traced step of two views
EXPECTED = {
    "sh_ms.train_b4": 4.0,
    "projection_ms.train_b4": None,
    "activation_ms.train_b4": 65.0,
    "loss_ms.train_b4": 8.0,
    "adam_ms.train_b4": 128.0,
    "stats_ms.train_b4": 0.25,
    "accumulate_ms.train_b4": 32.0,
    "elementwise_ms.train_b4": 32.25,
    "unranged_ms.train_b4": 0.0,
    "launches_per_step.train_b4": 11.0,
    "shproj_launches.train_b4": 4.0,
    "unlabelled_idle_share.train_b4": 25.0,
    "device_idle_share.train_b4": 80.0,
    "view_ms.train_b4": (2.0 + 4.0 + 2.0 + 16.0 + 0.5) / 2,
    "k3_roofline_share.train_b4": 100.0 * 2 * W.bound_s(*W.k3_work(
        10, 2, 256, 100, 50, "mxu")) / 16e-3,
    "k4_roofline_share.train_b4": 100.0 * 2 * W.bound_s(*W.k4_work(
        10, 10)) / 0.5e-3,
    "step_mfu.train_b4": 100.0 * WB.step_ops(WORK[0]) / W.FP32_OPS_PER_S,
}


def _ctx(loop="train_b4"):
    return harness.MetricContext(loop, STEP, 1, lambda: WORK, {})


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_a_synthetic_step(name, monkeypatch):
    monkeypatch.setattr(profiling, "counts",
                        lambda n: [4, 2] if n == "train_step.views" else [])
    read = harness.load_module("metrics", name).read
    want = EXPECTED[name]
    got = read(_ctx())
    assert got == (None if want is None else pytest.approx(want, rel=1e-12))
    # a run of another loop is not this metric's
    assert read(_ctx("train")) is None


def test_view_ms_without_the_counter_gives_nothing(monkeypatch):
    read = harness.load_module("metrics", "view_ms.train_b4").read
    monkeypatch.setattr(profiling, "counts", lambda n: [])
    assert read(_ctx()) is None
    monkeypatch.delattr(profiling, "counts")  # a program without counters
    assert read(_ctx()) is None


def test_the_step_counts_its_views_under_a_profiler(monkeypatch):
    """``train_step.views``: B once a step, only while a profiler
    records."""
    cell = harness.make_cell(CELL, 2**32 + 7, CPU, TINY)
    loop = harness.load_module("loops", cell.traffic["loop"])
    run = loop._Run(cell)
    monkeypatch.setattr(profiling, "_COUNTS", {})
    run.step()
    assert profiling.counts("train_step.views") == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        run.step()
        run.step()
    assert profiling.counts("train_step.views") == [4, 4]


# ---------------------------------------------------------------------------
# Work counts
# ---------------------------------------------------------------------------


def test_activation_constants_are_the_references_counts():
    torch.manual_seed(0)
    n = 4000
    raw = [torch.rand(n, 3) * 2 - 1, torch.rand(n, 3) * -3 - 2,
           torch.randn(n, 4), torch.randn(n), torch.randn(n, 1, 3),
           torch.randn(n, 15, 3) * 0.05]
    raw = [r.requires_grad_(True) for r in raw]
    out, ops = W.count_ops(R.activate, *raw)
    assert round(ops / n) == WB.OPS_PER_ACTIVATION["forward"]
    total = sum(o.sum() for o in out)
    _, ops = W.count_ops(lambda: total.backward())
    assert round(ops / n) == WB.OPS_PER_ACTIVATION["backward"]
    assert WB.OPS_PER_ACTIVATION["forward"] < W.OPS_PER_GAUSSIAN["forward"]


def test_a_batched_step_counts_activation_and_adam_once():
    """B views: B single-view steps' work less B - 1 activations, their
    backwards and Adams; at one view, a single-view step's."""
    one = WB.step_ops({"n": 10, "params": 590, "views": [VIEW]})
    assert one == W.step_ops(10, 590, 12, 100, 50, 40, 10, "mxu", True)
    act = 10 * sum(WB.OPS_PER_ACTIVATION.values())
    four = WB.step_ops({"n": 10, "params": 590, "views": [VIEW] * 4})
    assert four == 4 * one - 3 * (act + 590 * W.OPS_PER_ADAM_ELEMENT)
