"""Batched training traffic: closed-loop multi-view densifying steps.

The program's step is ``models/trainer.py::make_batched_train_step`` (the
train CLI's step at ``--views_per_step`` B, the configuration's
``views_per_step``): each of the B views renders
from the once-activated scene, the loss is the mean of the views' L1 +
D-SSIM losses, one backward, one ``optimizer_step`` (Adam), then the
densification statistics per view, with every row active. A step takes
the next B views of seeded shuffles of the dataset's
training views (``inputs.view_stream``), whose cameras and targets are
copied into the stacked tensors the step takes (contiguous copies on the
device, no kernel), and reads its loss on the host, so the next step
starts when this one has ended.

Set-up builds the step once and drives it through the cell's first
``check_steps`` steps, which warm it up and which the check reads: the
first step's loss, gradient (from Adam's first moment after one step, over
1 - beta1) and statistics, and the parameters' change after the last,
against ``reference/train_batched.py``'s steps over the same views. The
window goes on with the same object: the window, the traced steps, what a
run leaves and the comparison are ``loops/train.py``'s, a step being one
entry (a list of B views) of ``run.order``.
"""

from __future__ import annotations

import time

import torch

from gsbench import inputs
from gsbench.loops import train as T
from gsbench.reference import render as R
from gsbench.reference import train as RT
from gsbench.reference import train_batched as RB
from luisacomputegaussiansplatting_tpu_torch.config import RenderConfig
from luisacomputegaussiansplatting_tpu_torch.models import densify, trainer
from luisacomputegaussiansplatting_tpu_torch.models.gaussians import GaussianParams
from luisacomputegaussiansplatting_tpu_torch.utils.camera import CameraView


class _Run:
    """The step, its state, its feed and the stacked tensors it takes."""

    def __init__(self, cell):
        cfg, dev, seed = cell.config, cell.device, cell.seed
        ds = cfg["dataset"]
        self.width, self.height = ds["width"], ds["height"]
        self.batch = cfg["views_per_step"]
        parts = self.parts = {}
        t = time.perf_counter()
        parts["kernels_built_s"] = T.load_kernels(dev, T.KERNELS)
        parts["kernels_s"] = time.perf_counter() - t
        t = time.perf_counter()
        raw = inputs.draw_params(cfg["scene"], seed, dev)
        views = inputs.train_views(ds, dev)
        self.n_views = len(views)
        self.targets = inputs.draw_targets(self.n_views, self.width,
                                           self.height, seed, dev)
        T._sync(dev)
        parts["inputs_s"] = time.perf_counter() - t
        t = time.perf_counter()
        tc = trainer.TrainConfig(**cfg["train"])
        self.state, self.opt = trainer.init_train_state(GaussianParams(*raw),
                                                        tc)
        del raw
        n = cfg["scene"]["n_gaussians"]
        self.dstate = densify.init_densify_state(n, n, device=dev)
        self.step_fn = trainer.make_batched_train_step(
            self.opt, self.width, self.height,
            cfg=RenderConfig(**cfg["render"]),
            sh_degree=cfg["scene"]["sh_degree"], tc=tc,
            bg_color=tuple(ds["background"]))
        # every view's camera stacked, and the batch's tensors
        self.cams = CameraView(*(torch.stack(x) for x in zip(*views)))
        self.batch_cams = CameraView(*(
            torch.empty((self.batch, *x.shape[1:]), dtype=x.dtype, device=dev)
            for x in self.cams))
        self.batch_targets = torch.empty(
            (self.batch, *self.targets.shape[1:]), dtype=self.targets.dtype,
            device=dev)
        self.plan = inputs.view_stream(self.n_views, seed)
        self.order = []  # the views of each step, in order
        self.overflow = []  # per step, a () bool tensor
        self.trace_steps = cell.traffic["trace_steps"]
        parts["program_s"] = time.perf_counter() - t

    def step(self) -> float:
        batch = [next(self.plan) for _ in range(self.batch)]
        self.order.append(batch)
        for i, v in enumerate(batch):
            self.batch_targets[i].copy_(self.targets[v])
            for buf, src in zip(self.batch_cams, self.cams):
                buf[i].copy_(src[v])
        self.state, self.dstate, loss, overflow = self.step_fn(
            self.state, self.dstate, self.batch_cams, self.batch_targets)
        self.overflow.append(overflow)
        return loss.item()


def setup(cell):
    run = _Run(cell)
    t = time.perf_counter()
    losses = []
    for k in range(cell.spec["check_steps"]):
        losses.append(run.step())
        if k == 0:
            d = run.dstate
            stats = RT.stats_norms((d.grad_sum, d.count, d.max_radii))
            # Adam's first moment after one step is (1 - beta1) * gradient
            grads = []
            for group in run.opt.param_groups:
                (p,) = group["params"]
                m = run.opt.state.get(p, {}).get("exp_avg")
                grads.append(0.0 if m is None else
                             T._norm(m) / (1.0 - group["betas"][0]))
    start = inputs.draw_params(cell.config["scene"], cell.seed, cell.device)
    change = [T._norm(p.detach() - s) for p, s in zip(run.state.params, start)]
    del start
    run.check = {
        "losses": losses, "grad_norms": grads, "change_norms": change,
        "stats": stats,
        "overflow": sum(bool(o) for o in run.overflow),
        "views": [v for batch in run.order for v in batch],
    }
    run.parts["check_steps_s"] = time.perf_counter() - t
    return run


window, traced, release, compare = T.window, T.traced, T.release, T.compare


def reference(cell, records: dict, precision: str = "f32",
              fault: str | None = None) -> dict:
    """The reference's own first steps from the seed, over the views the
    program's took, as the program's check records them; ``fault`` one of
    ``reference/train_batched.py``'s ``FAULTS``."""
    cfg, dev = cell.config, cell.device
    ds = cfg["dataset"]
    used = records["check"]["views"]
    batch = cfg["views_per_step"]
    raw = inputs.draw_params(cfg["scene"], cell.seed, dev)
    views = inputs.train_views(ds, dev)
    targets = inputs.draw_targets(len(views), ds["width"], ds["height"],
                                  cell.seed, dev)
    ref = RB.train_batched_steps(
        raw, [views[v] for v in used], [targets[v] for v in used],
        ds["width"], ds["height"], tuple(ds["background"]), T.settings(cell),
        cfg["train"], len(used) // batch, batch, cfg["scene"]["sh_degree"],
        precision, fault)
    return {"check": {"losses": ref["losses"], "grad_norms": ref["grad_norms"],
                      "change_norms": ref["change_norms"],
                      "stats": RT.stats_norms(ref["stats"]),
                      "overflow": ref["overflow"], "views": used}}


def verify(cell, records: dict) -> dict:
    return compare(records, reference(cell, records))


def work(cell, records: dict) -> list:
    """Per traced step: its gaussians and parameter elements, and each
    view's work as the reference counts it on its inputs
    (``gsbench/work_batched.py``)."""
    cfg, dev = cell.config, cell.device
    ds = cfg["dataset"]
    rs = T.settings(cell)
    views = inputs.train_views(ds, dev)
    params = records["params"]
    n = params[0].shape[0]
    n_params = sum(p.numel() for p in params)
    out = []
    with torch.no_grad():
        for batch in records["traced_views"]:
            counted = []
            for v in batch:
                frame = R.render(params, views[v], ds["width"],
                                 ds["height"], tuple(ds["background"]), rs,
                                 cfg["scene"]["sh_degree"])
                counted.append(T.count_frame(frame, rs, ds["width"],
                                             ds["height"], n, n_params))
                del frame
            out.append({"n": n, "params": n_params, "views": counted})
    return out
