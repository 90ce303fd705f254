"""Training traffic: closed-loop single-view densifying steps.

The program's step is ``models/trainer.py::make_densify_train_step`` (the
train CLI's step at one view a step): render the view, the L1 + D-SSIM
loss against the view's target, the backward, ``optimizer_step`` (Adam),
then the densification statistics, with every row active. Each step takes
the next view of seeded shuffles of the dataset's training views and reads
its loss on the host, as a trainer logging its loss does, so the next step
starts when this one has ended.

Set-up builds the step once and drives it through the cell's first
``check_steps`` steps, which warm it up and which the check reads: the
first step's loss, gradient (from Adam's first moment after one step) and
statistics, and the parameters' change after the last. The window goes on
with the same object.
"""

from __future__ import annotations

import math
import time

import torch

from gsbench import inputs, trace
from gsbench.reference import render as R
from gsbench.reference import train as RT
from luisacomputegaussiansplatting_tpu_torch.config import RenderConfig
from luisacomputegaussiansplatting_tpu_torch.models import densify, trainer
from luisacomputegaussiansplatting_tpu_torch.models.gaussians import GaussianParams
from luisacomputegaussiansplatting_tpu_torch.ops import expand, rasterize, segsum
from luisacomputegaussiansplatting_tpu_torch.utils.camera import CameraView

KERNELS = (expand.KERNEL, rasterize.KERNEL, rasterize.BACKWARD_KERNEL,
           segsum.KERNEL)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def load_kernels(dev, libs) -> dict:
    """Build (in a fresh checkout) or load the program's kernels; the
    seconds nvcc took per library."""
    if dev.type != "cuda":
        return {}
    for k in libs:
        k.lib()
    return {k.name: k.build_seconds for k in libs}


class _Run:
    """The step, its state and its feed."""

    def __init__(self, cell):
        cfg, dev, seed = cell.config, cell.device, cell.seed
        ds = cfg["dataset"]
        self.width, self.height = ds["width"], ds["height"]
        parts = self.parts = {}
        t = time.perf_counter()
        parts["kernels_built_s"] = load_kernels(dev, KERNELS)
        parts["kernels_s"] = time.perf_counter() - t
        t = time.perf_counter()
        raw = inputs.draw_params(cfg["scene"], seed, dev)
        self.views = inputs.train_views(ds, dev)
        self.targets = inputs.draw_targets(len(self.views), self.width,
                                           self.height, seed, dev)
        _sync(dev)
        parts["inputs_s"] = time.perf_counter() - t
        t = time.perf_counter()
        tc = trainer.TrainConfig(**cfg["train"])
        self.state, self.opt = trainer.init_train_state(GaussianParams(*raw),
                                                        tc)
        del raw
        n = cfg["scene"]["n_gaussians"]
        self.dstate = densify.init_densify_state(n, n, device=dev)
        self.step_fn = trainer.make_densify_train_step(
            self.opt, self.width, self.height,
            cfg=RenderConfig(**cfg["render"]),
            sh_degree=cfg["scene"]["sh_degree"], tc=tc,
            bg_color=tuple(ds["background"]))
        self.cams = [CameraView(*v) for v in self.views]
        self.plan = inputs.view_stream(len(self.views), seed)
        self.order = []  # the view of each step, in order
        self.overflow = []  # per step, a () bool tensor
        self.trace_steps = cell.traffic["trace_steps"]
        parts["program_s"] = time.perf_counter() - t

    def step(self) -> float:
        v = next(self.plan)
        self.order.append(v)
        self.state, self.dstate, loss, aux = self.step_fn(
            self.state, self.dstate, self.cams[v], self.targets[v])
        self.overflow.append(aux.overflow)
        return loss.item()


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t.detach().to(torch.float32)))


def setup(cell):
    run = _Run(cell)
    t = time.perf_counter()
    n_check = cell.spec["check_steps"]
    losses = []
    for k in range(n_check):
        losses.append(run.step())
        if k == 0:
            d = run.dstate
            stats = RT.stats_norms((d.grad_sum, d.count, d.max_radii))
            # Adam's first moment after one step is (1 - beta1) * gradient;
            # a step that reached no optimizer left none
            grads = []
            for group in run.opt.param_groups:
                (p,) = group["params"]
                m = run.opt.state.get(p, {}).get("exp_avg")
                grads.append(0.0 if m is None else
                             _norm(m) / (1.0 - group["betas"][0]))
    start = inputs.draw_params(cell.config["scene"], cell.seed, cell.device)
    change = [_norm(p.detach() - s) for p, s in zip(run.state.params, start)]
    del start
    run.check = {
        "losses": losses, "grad_norms": grads, "change_norms": change,
        "stats": stats,
        "overflow": sum(bool(o) for o in run.overflow),
        "views": list(run.order),
    }
    run.parts["check_steps_s"] = time.perf_counter() - t
    return run


def window(run, seconds: float) -> dict:
    first = len(run.order)
    t0 = time.perf_counter()
    deadline = t0 + seconds
    bad = 0
    while True:
        bad += not math.isfinite(run.step())
        t1 = time.perf_counter()
        if t1 >= deadline:
            break
    steps = len(run.order) - first
    bad += sum(bool(o) for o in run.overflow[first:])
    return {"e2e": {"train_step_ms": (t1 - t0) * 1e3 / steps},
            "attempted": steps, "failed": bad}


def traced(run) -> dict:
    first = len(run.order)
    n = run.trace_steps
    with trace.profiler() as prof, trace.window():
        bad = sum(not math.isfinite(run.step()) for _ in range(n))
    bad += sum(bool(o) for o in run.overflow[first:])
    run.traced_views = run.order[first:]
    return {"profile": prof, "steps": n, "attempted": n,
            "failed": bad}


def release(run) -> dict:
    records = {"check": run.check, "setup_parts": run.parts}
    if getattr(run, "traced_views", None) is not None:
        # the work of the traced steps is counted on the parameters they
        # left (Adam moved them by a few learning rates since)
        records["traced_views"] = run.traced_views
        records["params"] = tuple(p.detach() for p in run.state.params)
    del run.step_fn, run.opt, run.state, run.dstate, run.targets
    return records


def settings(cell) -> R.RenderSettings:
    return R.RenderSettings.from_config(cell.config["render"])


def gap(a: float, b: float) -> float:
    """|a - b| / |b|."""
    return abs(a - b) / abs(b) if b else (0.0 if a == b else math.inf)


def worst_leaf(prog, ref, keep=None) -> float:
    """The largest |prog norm - ref norm| of a leaf, over the larger of the
    reference's norm of that leaf and of the median leaf."""
    keep = keep or [True] * len(ref)
    kept = [r for r, k in zip(ref, keep) if k]
    median = sorted(kept)[len(kept) // 2]
    return max(abs(p - r) / max(r, median)
               for p, r, k in zip(prog, ref, keep) if k)


def reference(cell, records: dict, precision: str = "f32",
              fault: str | None = None) -> dict:
    """The reference's own first steps from the seed, over the views the
    program's took, as the program's check records them."""
    cfg, dev = cell.config, cell.device
    ds = cfg["dataset"]
    used = records["check"]["views"]
    raw = inputs.draw_params(cfg["scene"], cell.seed, dev)
    views = inputs.train_views(ds, dev)
    targets = inputs.draw_targets(len(views), ds["width"], ds["height"],
                                  cell.seed, dev)
    ref = RT.train_steps(raw, [views[v] for v in used],
                         [targets[v] for v in used], ds["width"],
                         ds["height"], tuple(ds["background"]),
                         settings(cell), cfg["train"], len(used),
                         cfg["scene"]["sh_degree"], precision, fault)
    return {"check": {"losses": ref["losses"], "grad_norms": ref["grad_norms"],
                      "change_norms": ref["change_norms"],
                      "stats": RT.stats_norms(ref["stats"]),
                      "overflow": ref["overflow"], "views": used}}


def compare(records: dict, ref: dict) -> dict:
    """The numbers that decide ``correct``: the first steps of ``records``
    against the reference's ``ref``."""
    got, want = records["check"], ref["check"]
    # the loss and the statistics of the first step: from the second on, a
    # rounding-level difference in Adam's update can move a radius across
    # an integer and an entry in or out, which makes a later step's loss
    # and statistics a seed's tail rather than the program's precision.
    # Leaves whose reference gradient is rounding-level move under Adam by
    # round-off alone: the change leaves them out
    g_med = sorted(want["grad_norms"])[len(want["grad_norms"]) // 2]
    moving = [g >= 1e-3 * g_med for g in want["grad_norms"]]
    if want["overflow"]:
        raise RuntimeError("the reference overflows: raise the "
                           "configuration's capacities")
    return {
        "loss_gap": gap(got["losses"][0], want["losses"][0]),
        "grad_gap": worst_leaf(got["grad_norms"], want["grad_norms"]),
        "change_gap": worst_leaf(got["change_norms"], want["change_norms"],
                                 moving),
        "stats_gap": max(gap(p, r) for p, r in zip(got["stats"],
                                                   want["stats"])),
        "overflow": float(got["overflow"]),
    }


def verify(cell, records: dict) -> dict:
    return compare(records, reference(cell, records))


def work(cell, records: dict) -> list:
    """Per traced step, the work the reference counts on its inputs."""
    cfg, dev = cell.config, cell.device
    ds = cfg["dataset"]
    rs = settings(cell)
    views = inputs.train_views(ds, dev)
    params = records["params"]
    n = params[0].shape[0]
    n_params = sum(p.numel() for p in params)
    out = []
    with torch.no_grad():
        for v in records["traced_views"]:
            frame = R.render(params, views[v], ds["width"], ds["height"],
                             tuple(ds["background"]), rs,
                             cfg["scene"]["sh_degree"])
            out.append(count_frame(frame, rs, ds["width"], ds["height"], n,
                                   n_params))
            del frame
    return out


def count_frame(frame, rs, width, height, n, n_params) -> dict:
    grid_x, grid_y = R.tile_grid(width, height, rs.tile)
    evaluated, applied = R.pair_counts(frame.payload, frame.binned, grid_x,
                                       width, height, rs)
    return {"evaluated": evaluated, "applied": applied,
            "aabb": frame.binned.aabb, "entries": frame.binned.num_rendered,
            "num_tiles": grid_x * grid_y, "pix": rs.tile * rs.tile,
            "n": n, "params": n_params, "pixels": width * height,
            "max_pairs": rs.max_pairs, "quad": rs.blend_quad,
            "cull": rs.tile_cull}
