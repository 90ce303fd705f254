"""Training traffic in the densification phase: closed-loop single-view
densifying steps with graphdeco's density control, mid-schedule.

The program's step is ``make_densify_train_step``, as in ``loops/train.py``
(render, L1 + D-SSIM, backward, Adam, the statistics), on a scene of
``scene.n_gaussians`` active rows in ``scene.capacity``; after each step
the program's ``models/densify.py::density_control`` does what the
configuration's ``DensifySchedule`` asks after that global iteration: a
round (clone, split, prune, Adam's moments zeroed on the rewritten rows), an
opacity reset. The first step is iteration ``start_iteration``; the
schedule counts from there. Each step takes the next view of seeded
shuffles of the training views and reads its loss on the host.

Set-up drives the cell's first ``check_steps`` steps: the first step's
loss, gradient and statistics and the parameters' change after the last
are compared with the reference's steps from the seed, as in
``loops/train.py``; the round after the last check step is compared with
the reference's round (``gsbench/reference/densify.py``) on the program's
own state before it (parameters, statistics, Adam's moments, the split
noise's generator state), both copied to host memory so that the card's
peak does not move. A step whose render or round overflowed its capacity
fails.

``--trace 1`` steps untraced up to iteration ``trace_from`` - 1, then
profiles ``trace_steps`` steps (a round among them).
"""

from __future__ import annotations

import math
import sys
import time

import torch

from gsbench import inputs, trace
from gsbench.loops import train as T
from gsbench.reference import densify as RD
from gsbench.reference import render as R
from gsbench.reference import train as RT
from luisacomputegaussiansplatting_tpu_torch.config import RenderConfig
from luisacomputegaussiansplatting_tpu_torch.models import densify, trainer
# the density control's entry point and schedule: a program without them
# cannot run this traffic, and fails here, before any set-up
from luisacomputegaussiansplatting_tpu_torch.models.densify import (
    DensifySchedule, density_control)
from luisacomputegaussiansplatting_tpu_torch.models.gaussians import (
    GaussianParams, pad_params_to)
from luisacomputegaussiansplatting_tpu_torch.utils.camera import CameraView


def draw_params(sc: dict, seed: int, device):
    """The scene at capacity, raw: the first ``n_gaussians`` rows are
    ``inputs.draw_params``'s scene, where a seeded ``tail_share`` of them
    take scales log-uniform in [``tail_scale_min``, ``tail_scale_max``]
    (each axis its own) and a seeded ``fade_share`` opacities log-uniform
    in [``fade_opacity_min``, ``fade_opacity_max``], each where it is; the
    rest of the rows are parked as the train CLI parks them
    (``pad_params_to``)."""
    raw = list(inputs.draw_params(sc, seed, device))
    n = sc["n_gaussians"]
    gen = torch.Generator(device=device).manual_seed(
        inputs.sub_seed(seed, "tail"))
    u = torch.rand((n, 6), generator=gen, device=device)

    def log_uniform(x, lo, hi):
        lo, hi = math.log(lo), math.log(hi)
        return x * (hi - lo) + lo

    tail = (u[:, 0] < sc["tail_share"])[:, None]
    raw[1] = torch.where(tail, log_uniform(u[:, 1:4], sc["tail_scale_min"],
                                           sc["tail_scale_max"]), raw[1])
    op = torch.exp(log_uniform(u[:, 5], sc["fade_opacity_min"],
                               sc["fade_opacity_max"]))
    raw[3] = torch.where(u[:, 4] < sc["fade_share"],
                         torch.log(op) - torch.log1p(-op), raw[3])
    del u, tail, op
    return tuple(pad_params_to(GaussianParams(*(t.contiguous() for t in raw)),
                               sc["capacity"]))


def _cpu(ts):
    return [None if t is None else t.detach().to("cpu", copy=True)
            for t in ts]


def _moments(opt, params):
    """Adam's (exp_avg, exp_avg_sq) of each parameter, None before its
    first update."""
    st = [opt.state.get(p, {}) for p in params]
    return ([s.get("exp_avg") for s in st], [s.get("exp_avg_sq") for s in st])


class _Run:
    """The step, the density control after it, their state and feed."""

    def __init__(self, cell):
        cfg, dev, seed = cell.config, cell.device, cell.seed
        ds, sc, dz = cfg["dataset"], cfg["scene"], cfg["densify"]
        self.width, self.height = ds["width"], ds["height"]
        parts = self.parts = {}
        t = time.perf_counter()
        parts["kernels_built_s"] = T.load_kernels(dev, T.KERNELS)
        parts["kernels_s"] = time.perf_counter() - t
        t = time.perf_counter()
        raw = draw_params(sc, seed, dev)
        self.views = inputs.train_views(ds, dev)
        self.targets = inputs.draw_targets(len(self.views), self.width,
                                           self.height, seed, dev)
        T._sync(dev)
        parts["inputs_s"] = time.perf_counter() - t
        t = time.perf_counter()
        tc = trainer.TrainConfig(**cfg["train"])
        self.state, self.opt = trainer.init_train_state(GaussianParams(*raw),
                                                        tc)
        del raw
        self.dstate = densify.init_densify_state(sc["n_gaussians"],
                                                 sc["capacity"], device=dev)
        self.step_fn = trainer.make_densify_train_step(
            self.opt, self.width, self.height,
            cfg=RenderConfig(**cfg["render"]), sh_degree=sc["sh_degree"],
            tc=tc, bg_color=tuple(ds["background"]))
        self.schedule = DensifySchedule(
            **{k: dz[k] for k in ("start", "stop", "interval",
                                  "reset_interval", "size_prune_after")})
        self.dcfg = densify.DensifyConfig(
            **{k: dz[k] for k in RD.Settings._fields},
            reset_opacity_to=dz["reset_opacity_to"])
        self.extent = dz["scene_extent"]
        self.gen = torch.Generator(device=dev).manual_seed(
            inputs.sub_seed(seed, "split"))
        self.iteration = cfg["start_iteration"] - 1  # steps done
        self.cams = [CameraView(*v) for v in self.views]
        self.plan = inputs.view_stream(len(self.views), seed)
        self.order, self.overflow = [], []
        self.rounds = []  # (iteration, DensifyInfo, active mask after)
        self.trace_from = cell.traffic["trace_from"]
        self.trace_steps = cell.traffic["trace_steps"]
        parts["program_s"] = time.perf_counter() - t

    def train_step(self):
        v = next(self.plan)
        self.order.append(v)
        self.state, self.dstate, loss, aux = self.step_fn(
            self.state, self.dstate, self.cams[v], self.targets[v])
        self.overflow.append(aux.overflow)
        self.iteration += 1
        return loss

    def control(self):
        self.opt, self.dstate, info = density_control(
            self.iteration, self.schedule, self.state.params, self.opt,
            self.dstate, self.gen, self.extent, self.dcfg)
        if info is not None:
            self.rounds.append((self.iteration, info, self.dstate.active))
        return info

    def step(self) -> float:
        loss = self.train_step()
        self.control()
        return loss.item()

    def snapshot(self):
        """The state a round reads or writes, in host memory."""
        params = list(self.state.params)
        m, v = _moments(self.opt, params)
        d = self.dstate
        return {"params": _cpu(params), "exp_avg": _cpu(m),
                "exp_avg_sq": _cpu(v),
                "stats": _cpu((d.grad_sum, d.count, d.max_radii)),
                "active": d.active.to("cpu", copy=True)}


def setup(cell):
    run = _Run(cell)
    t = time.perf_counter()
    n_check = cell.spec["check_steps"]
    losses = []
    for k in range(n_check):
        loss = run.train_step()
        losses.append(loss.item())
        if k == 0:
            d = run.dstate
            stats = RT.stats_norms((d.grad_sum, d.count, d.max_radii))
            grads = [0.0 if m is None else T._norm(m) / (1.0 - g["betas"][0])
                     for m, g in zip(_moments(run.opt, run.state.params)[0],
                                     run.opt.param_groups)]
        if k < n_check - 1:
            run.control()
    raw = draw_params(cell.config["scene"], cell.seed, cell.device)
    change = [T._norm(p.detach() - s) for p, s in zip(run.state.params, raw)]
    del raw
    # the round after the last check step, on the state before it
    before = run.snapshot()
    before["generator"] = run.gen.get_state()
    before["iteration"] = run.iteration
    info = run.control()
    after = run.snapshot()
    after["counts"] = ({"cloned": 0, "split": 0, "pruned": 0} if info is None
                       else {"cloned": int(info.n_cloned),
                             "split": int(info.n_split),
                             "pruned": int(info.n_pruned)})
    after["counts"]["active"] = int(after["active"].sum())
    after["overflow"] = info is not None and bool(info.overflow)
    run.check = {
        "losses": losses, "grad_norms": grads, "change_norms": change,
        "stats": stats, "overflow": sum(bool(o) for o in run.overflow),
        "views": list(run.order),
    }
    run.round_check = {"before": before, "after": after}
    run.parts["check_steps_s"] = time.perf_counter() - t
    return run


def _failed(run, first_step: int, first_round: int) -> int:
    """Steps from ``first_step`` on whose render overflowed, and rounds
    from ``first_round`` on that dropped children."""
    return (sum(bool(o) for o in run.overflow[first_step:])
            + sum(bool(info.overflow) for _, info, _ in
                  run.rounds[first_round:]))


def window(run, seconds: float) -> dict:
    first, first_round = len(run.order), len(run.rounds)
    t0 = time.perf_counter()
    deadline = t0 + seconds
    bad = 0
    while True:
        bad += not math.isfinite(run.step())
        t1 = time.perf_counter()
        if t1 >= deadline:
            break
    steps = len(run.order) - first
    bad += _failed(run, first, first_round)
    return {"e2e": {"train_step_ms": (t1 - t0) * 1e3 / steps},
            "attempted": steps, "failed": bad}


def traced(run) -> dict:
    first, first_round = len(run.order), len(run.rounds)
    bad = 0
    while run.iteration < run.trace_from - 1:
        bad += not math.isfinite(run.step())
    n = run.trace_steps
    lead = len(run.order) - first
    start = len(run.order)
    with trace.profiler() as prof, trace.window():
        bad += sum(not math.isfinite(run.step()) for _ in range(n))
    bad += _failed(run, first, first_round)
    run.traced_views = run.order[start:]
    return {"profile": prof, "steps": n, "attempted": lead + n,
            "failed": bad}


def release(run) -> dict:
    records = {"check": run.check, "round": run.round_check,
               "setup_parts": run.parts}
    records["rounds"] = [
        {"after": it, "cloned": int(info.n_cloned), "split": int(info.n_split),
         "pruned": int(info.n_pruned), "active": int(act.sum()),
         "overflow": bool(info.overflow)} for it, info, act in run.rounds]
    for r in records["rounds"]:
        print(f"round after {r['after']}: +{r['cloned']} cloned +{r['split']} "
              f"split -{r['pruned']} pruned -> {r['active']} active"
              + (" (overflow)" if r["overflow"] else ""), file=sys.stderr)
    if getattr(run, "traced_views", None) is not None:
        # the work of the traced steps, counted on the active rows of the
        # parameters they left
        active = run.dstate.active
        records["traced_views"] = run.traced_views
        records["params"] = tuple(p.detach()[active]
                                  for p in run.state.params)
    del run.step_fn, run.opt, run.state, run.dstate, run.targets
    return records


def _to(x, dev):
    return None if x is None else x.to(dev)


def reference(cell, records: dict, precision: str = "f32",
              fault: str | None = None) -> dict:
    """The reference's first steps from the seed over the active rows (the
    parked ones take no part in a step), and its round on the program's
    state before the program's round. ``precision="bf16"`` rounds the
    round's inputs to bfloat16 too; ``fault`` is one of ``loops/train``'s
    or of ``reference/densify.densify_round``'s."""
    cfg, dev = cell.config, cell.device
    ds, sc = cfg["dataset"], cfg["scene"]
    used = records["check"]["views"]
    n = sc["n_gaussians"]
    raw = tuple(p[:n].contiguous()
                for p in draw_params(sc, cell.seed, dev))
    views = inputs.train_views(ds, dev)
    targets = inputs.draw_targets(len(views), ds["width"], ds["height"],
                                  cell.seed, dev)
    step_fault = fault if fault in ("half_batch", "unchanged") else None
    ref = RT.train_steps(raw, [views[v] for v in used],
                         [targets[v] for v in used], ds["width"],
                         ds["height"], tuple(ds["background"]),
                         T.settings(cell), cfg["train"], len(used),
                         sc["sh_degree"], precision, step_fault)
    del raw, views, targets
    check = {"losses": ref["losses"], "grad_norms": ref["grad_norms"],
             "change_norms": ref["change_norms"],
             "stats": RT.stats_norms(ref["stats"]),
             "overflow": ref["overflow"], "views": used}
    del ref

    b = records["round"]["before"]
    rnd = R.bf16 if precision == "bf16" else (lambda x: x)
    params = [rnd(p.to(dev)) for p in b["params"]]
    grad_sum, count, max_radii = (t.to(dev) for t in b["stats"])
    gen = torch.Generator(device=dev)
    gen.set_state(b["generator"])
    dz = cfg["densify"]
    s = RD.Settings.from_config(dz)
    noise = torch.randn((params[0].shape[0], s.split_children, 3),
                        generator=gen, dtype=torch.float32, device=dev)
    due, size_prune = RD.schedule(b["iteration"], dz)
    if not due:
        raise RuntimeError("the configuration asks for no round after the "
                           "last check step")
    out = RD.densify_round(
        params, [_to(t, dev) for t in b["exp_avg"]],
        [_to(t, dev) for t in b["exp_avg_sq"]], rnd(grad_sum), count,
        max_radii, b["active"].to(dev), noise, dz["scene_extent"], s,
        size_prune, fault if step_fault is None else None)
    return {"check": check,
            "round": {"after": {"params": out.params, "exp_avg": out.exp_avg,
                                "exp_avg_sq": out.exp_avg_sq,
                                "active": out.active, "counts": out.counts,
                                "overflow": out.overflow}}}


def _field_gap(got, want, rows=None) -> float:
    """max |got - want| over max |want| (over ``rows`` where given)."""
    if want is None or got is None:
        return 0.0 if want is got else math.inf
    got = got.to(want.device)
    scale = float((want if rows is None else want[rows]).abs().max()) \
        if want.numel() else 0.0
    diff = float((got - want).abs().max()) if want.numel() else 0.0
    return diff / scale if scale > 0 else (0.0 if diff == 0 else math.inf)


def compare(records: dict, ref: dict) -> dict:
    """The numbers that decide ``correct``: the first steps as
    ``loops/train.py`` compares them, then the round: its counts, the
    active mask, every row of every field (over the largest magnitude of
    that field's active rows) and Adam's moments."""
    out = T.compare(records, ref)
    got, want = records["round"]["after"], ref["round"]["after"]
    if want["overflow"]:
        raise RuntimeError("the reference's round overflows: raise the "
                           "configuration's capacity")
    active = want["active"]
    out["round_count_gap"] = float(max(
        abs(got["counts"][k] - want["counts"][k]) for k in want["counts"]))
    out["active_gap"] = float(
        (got["active"].to(active.device) != active).sum())
    out["row_gap"] = max(_field_gap(g, w, active) for g, w in
                         zip(got["params"], want["params"]))
    out["moment_gap"] = max(
        _field_gap(g, w) for key in ("exp_avg", "exp_avg_sq")
        for g, w in zip(got[key], want[key]))
    out["round_overflow"] = float(got["overflow"])
    return out


def verify(cell, records: dict) -> dict:
    return compare(records, reference(cell, records))


def work(cell, records: dict) -> list:
    """Per traced step, the work the reference counts on the active rows
    of the parameters the traced steps left."""
    cfg, dev = cell.config, cell.device
    ds = cfg["dataset"]
    rs = T.settings(cell)
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
            out.append(T.count_frame(frame, rs, ds["width"], ds["height"], n,
                                     n_params))
            del frame
    return out
