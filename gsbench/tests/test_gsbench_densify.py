"""The densification-phase cell, ``bicycle-train-densify``, on the CPU at a
test's size: a sound run is ``correct``; the control (the reference in
bfloat16 in the program's place) and each fault of the round fail their
check, planted in the program (a whole run) and in the reference (as the
calibration reads them); the configuration states graphdeco's numbers; the
readers of the density-control range and counters."""

import json
import math
import os

import pytest
import torch

from gsbench import harness, inputs
from gsbench.reference import densify as RD
from gsbench.trace import Kernel, Trace
from luisacomputegaussiansplatting_tpu_torch.models import densify as pd

CELL = "bicycle-train-densify"
CPU = torch.device("cpu")
BENCH = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
#: the cell at a test's size: 1,500 actives in 4,000 rows at 96x64, a round
#: every 2 steps (at this resolution nearly every gaussian passes
#: graphdeco's 2e-4, so the threshold is raised), a tenth of the actives in
#: the scale tail so that the checked round splits
TINY = {"config": {"scene": {"n_gaussians": 1500, "capacity": 4000,
                             "tail_share": 0.1},
                   "dataset": {"width": 96, "height": 64, "images": 12},
                   "render": {"max_pairs": 60000, "max_pairs_sorted": None},
                   "densify": {"interval": 2, "grad_threshold": 3e-3}},
        "traffic": {"trace_from": 7502, "trace_steps": 2}}
FAULTS = {
    # the round leaves Adam's moments of the rewritten rows as they were
    "no_surgery": ("moment_gap", lambda mp: mp.setattr(
        pd, "_zero_adam_moments_where", lambda *a, **k: None)),
    # split children keep their parent's scales
    "no_shrink": ("row_gap", lambda mp: mp.setattr(
        pd.DensifyConfig, "split_shrink", property(lambda self: 1.0))),
    # no round at all
    "skipped": ("round_count_gap", lambda mp: mp.setattr(
        pd.DensifySchedule, "wants_round", lambda self, i: False)),
}


def _cell(seed):
    return harness.make_cell(CELL, seed, CPU, TINY)


def _failing(cell, numbers):
    limits = cell.spec["limits"]
    return [k for k, v in numbers.items() if not v <= limits[k]]


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_is_correct_at_a_test_size(trace):
    cell = _cell(2**31 + 77)
    out = harness.run_cell(cell, 0.5, bool(trace), 0.0, BENCH)
    assert out["correct"] is True and out["failed"] == 0, out["checks"]
    assert set(out["checks"]) == set(cell.spec["limits"])
    e2e, per = harness.cell_metrics(BENCH, CELL)
    if trace:
        assert set(out["metrics"]) <= {m["name"] for m in per}
        # the counters exist on the CPU too; the times need the card
        assert 0 < out["metrics"]["active_share.train_densify"]["value"] < 100
    else:
        assert set(out["metrics"]) == {m["name"] for m in e2e}


def test_the_control_fails():
    cell = _cell(2**32 + 5)
    loop = harness.load_module("loops", cell.traffic["loop"])
    records = loop.release(loop.setup(cell))
    ref = loop.reference(cell, records)
    assert not _failing(cell, loop.compare(records, ref))
    counts = records["round"]["after"]["counts"]
    assert counts["cloned"] > 0 and counts["split"] > 0 \
        and counts["pruned"] > 0
    assert _failing(cell, loop.compare(loop.reference(cell, records, "bf16"),
                                       ref))
    # each fault, planted in the reference in the program's place
    for fault, (check, _) in FAULTS.items():
        bad = loop.compare(loop.reference(cell, records, fault=fault), ref)
        assert check in _failing(cell, bad), (fault, bad)


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_faulty_round_in_the_program_fails(fault, monkeypatch):
    check, plant = FAULTS[fault]
    plant(monkeypatch)
    out = harness.run_cell(_cell(2**32 + 6), 0.3, False, 0.0, BENCH)
    assert not out["correct"]
    assert out["checks"][check]["value"] > out["checks"][check]["limit"]


def test_the_configuration_states_graphdecos_numbers():
    cfg = harness.load_json("configs", "mip360-bicycle-densify-3M-in-6M.json")
    dz, tc = cfg["densify"], cfg["train"]
    # cameras_extent: 1.1 x the largest distance of a training camera from
    # the cameras' centroid (graphdeco's getNerfppNorm)
    pos = torch.stack([v.position for v in inputs.train_views(
        cfg["dataset"], CPU)]).double()
    radius = float((pos - pos.mean(0)).norm(dim=1).max()) * 1.1
    assert dz["scene_extent"] == pytest.approx(radius, rel=1e-6)
    assert tc["spatial_lr_scale"] == dz["scene_extent"]
    # the means' rate at the first step's iteration, decaying over the rest
    # of graphdeco's 30,000
    start = cfg["start_iteration"]
    t = start / 30_000
    assert tc["lr_means"] == pytest.approx(math.exp(
        (1 - t) * math.log(1.6e-4) + t * math.log(1.6e-6)), rel=1e-12)
    assert tc["lr_means_final"] == 1.6e-6
    assert tc["lr_means_decay_steps"] == 30_000 - start
    assert (dz["start"], dz["stop"], dz["interval"], dz["reset_interval"],
            dz["size_prune_after"]) == (500, 15_000, 100, 3000, 3000)
    # graphdeco passes 20 px, but its densification_postfix zeroes
    # max_radii2D before the screen test, which therefore never prunes
    assert (dz["grad_threshold"], dz["percent_dense"], dz["min_opacity"],
            dz["max_screen_radius"], dz["max_world_scale_frac"]) == (
        2e-4, 0.01, 0.005, 0, 0.1)
    # the round after the last check step is due, with size prunes, and no
    # reset falls near the window
    spec = harness.load_json("workloads", CELL + ".json")
    last = start + spec["check_steps"] - 1
    assert RD.schedule(last, dz) == (True, True)
    assert dz["reset_interval"] - last % dz["reset_interval"] > 1000
    assert cfg["scene"]["capacity"] == 2 * cfg["scene"]["n_gaussians"]


def _k(t, ms, *ranges):
    return Kernel("kernel", t, t + ms * 1e3, tuple(ranges) + ("gsbench.window",))


TRACE = Trace(
    kernels=[
        _k(0, 1.0, "aten::mul", "render_view.sh", "render_view",
           "train_step"),
        _k(10, 2.0, "aten::mul", "train_step.activate", "train_step"),
        _k(20, 4.0, "aten::nonzero", "train_step.densify.plan",
           "train_step.densify"),
        _k(30, 8.0, "aten::index_put_", "train_step.densify.write",
           "train_step.densify"),
        _k(40, 16.0, "aten::masked_fill_", "train_step.densify.adam",
           "train_step.densify"),
        _k(50, 32.0, "aten::randn", "train_step.densify"),
        _k(60, 64.0, "aten::add", "Optimizer.step#Adam.step",
           "train_step.optimizer", "train_step"),
        Kernel("vectorized_elementwise_kernel", 200, 300,
               ("aten::sub", "train_step.loss", "train_step",
                "gsbench.window")),
        _k(400, 0.5, "aten::copy_"),
    ],
    busy_s=0.2, window_s=1.0, gaps=[("(no host op)", 0.3), ("aten::item", 0.1)])


def _ctx(loop="train_densify", steps=4):
    return harness.MetricContext(loop, TRACE, steps, lambda: [], {})


@pytest.mark.parametrize("counts", [
    {"densify.cloned": [3, 5], "densify.active_rows": [1, 2, 3, 4, 6, 6],
     "densify.capacity": [8, 8, 8, 8, 8, 8]},
    None])
def test_density_control_readers(counts, monkeypatch):
    import luisacomputegaussiansplatting_tpu_torch.utils.profiling as prof

    if counts is None:  # a program without the counters
        monkeypatch.delattr(prof, "counts")
    else:
        monkeypatch.setattr(prof, "counts",
                            lambda name: list(counts.get(name, [])))
    ms = harness.load_module("metrics", "densify_ms.train_densify").read
    share = harness.load_module("metrics", "active_share.train_densify").read
    if counts is None:
        assert ms(_ctx()) is None and share(_ctx()) is None
        return
    assert ms(_ctx()) == pytest.approx(60.0 / 2)
    assert share(_ctx()) == pytest.approx(100.0 * 19 / 32)
    for read in (ms, share):
        assert read(_ctx(loop="train")) is None
    monkeypatch.setattr(prof, "counts", lambda name: [])
    assert ms(_ctx()) is None and share(_ctx()) is None


@pytest.mark.parametrize("name", [
    "sh_ms", "activation_ms", "adam_ms", "launches_per_step",
    "device_idle_share", "unranged_ms", "loss_ms", "elementwise_ms",
    "shproj_launches", "unlabelled_idle_share"])
def test_the_steps_readers_read_this_loop_alone(name):
    read = harness.load_module("metrics", name + ".train_densify").read
    assert read(_ctx()) is not None
    assert read(_ctx(loop="train")) is None
    other = harness.load_module("metrics", name + ".train").read
    assert other(_ctx()) is None
