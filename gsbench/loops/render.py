"""Render traffic: closed-loop forward frames along a camera path.

Each frame is the program's ``ops/render.py::render_view`` under
``no_grad`` (the call the render CLI and the viewer make), clamped and
cast to a uint8 HWC image on the device and copied to host memory by the
viewer's ``frame_to_hwc``; the next frame is asked for when that image is
on the host. A frame's latency runs from the ask to the image on the host.
The path walks 360 poses one degree apart from a seeded start; the window
keeps a seeded uniform sample of ``check_frames`` of its frames (the
cell's; reservoir sampling) for the check.
"""

from __future__ import annotations

import importlib
import random
import statistics
import time

import torch

from gsbench import inputs, trace
from gsbench.loops.train import count_frame, load_kernels
from gsbench.reference import render as R
from luisacomputegaussiansplatting_tpu_torch.apps.viewer import ViewerServer
from luisacomputegaussiansplatting_tpu_torch.config import RenderConfig
from luisacomputegaussiansplatting_tpu_torch.models.gaussians import GaussianParams
from luisacomputegaussiansplatting_tpu_torch.ops import expand, rasterize
from luisacomputegaussiansplatting_tpu_torch.utils.camera import CameraView

# the module, not the package's ``render`` function of the same name
render = importlib.import_module(
    "luisacomputegaussiansplatting_tpu_torch.ops.render")

KERNELS = (expand.KERNEL, rasterize.KERNEL)


class _Run:
    def __init__(self, cell):
        cfg, dev, tr = cell.config, cell.device, cell.traffic
        parts = self.parts = {}
        t = time.perf_counter()
        parts["kernels_built_s"] = load_kernels(dev, KERNELS)
        parts["kernels_s"] = time.perf_counter() - t
        t = time.perf_counter()
        raw = inputs.draw_params(cfg["scene"], cell.seed, dev)
        self.path = inputs.RenderPath(cfg["dataset"], tr, cell.seed, dev)
        with torch.no_grad():
            self.scene = GaussianParams(*raw).activate()
        del raw
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        parts["inputs_s"] = time.perf_counter() - t
        self.cams = [CameraView(*v) for v in self.path.views]
        self.cfg = RenderConfig(**cfg["render"])
        self.bg = tuple(cfg["dataset"]["background"])
        self.sh_degree = cfg["scene"]["sh_degree"]
        self.sample = random.Random(inputs.sub_seed(cell.seed, "sample"))
        self.kept = []  # (frame, pose, host image, num_rendered, overflow)
        self.n_check = cell.spec["check_frames"]
        self.trace_frames = tr["trace_frames"]
        self.frames = 0
        self.overflow = []

    def frame(self, k: int):
        """Frame k of the path: (uint8 HWC host image, aux)."""
        a = self.path.index(k)
        with torch.no_grad():
            img, aux = render.render_view(
                *self.scene, self.cams[a], self.path.width, self.path.height,
                self.bg, self.cfg, self.sh_degree)
            hwc = ViewerServer.frame_to_hwc(torch.clamp(img, 0.0, 1.0))
        return hwc, aux

    def timed_frame(self) -> float:
        """Ask for the next frame; its latency in seconds. A seeded
        reservoir keeps ``check_frames`` frames of the window uniformly."""
        k = self.frames
        t = time.perf_counter()
        hwc, aux = self.frame(k)
        lat = time.perf_counter() - t
        self.overflow.append(aux.overflow)
        item = (k, self.path.index(k), hwc, aux.num_rendered, aux.overflow)
        if k < self.n_check:
            self.kept.append(item)
        else:
            j = self.sample.randrange(k + 1)
            if j < self.n_check:
                self.kept[j] = item
        self.frames += 1
        return lat


def setup(cell):
    run = _Run(cell)
    t = time.perf_counter()
    for k in range(cell.traffic["warmup_frames"]):
        run.frame(-1 - k)
    run.parts["warmup_s"] = time.perf_counter() - t
    return run


def window(run, seconds: float) -> dict:
    t0 = time.perf_counter()
    deadline = t0 + seconds
    lat = []
    while True:
        lat.append(run.timed_frame())
        t1 = time.perf_counter()
        if t1 >= deadline:
            break
    n = len(lat)
    p95 = statistics.quantiles(lat, n=20, method="inclusive")[18] if n > 1 \
        else lat[0]
    return {"e2e": {"render_frame_ms": (t1 - t0) * 1e3 / n,
                    "render_frame_p95_ms": p95 * 1e3},
            "attempted": n,
            "failed": sum(bool(o) for o in run.overflow)}


def traced(run) -> dict:
    first = run.frames
    n = run.trace_frames
    with trace.profiler() as prof, trace.window():
        for _ in range(n):
            run.timed_frame()
    run.traced_poses = [run.path.index(k) for k in range(first, first + n)]
    return {"profile": prof, "steps": n, "attempted": n,
            "failed": sum(bool(o) for o in run.overflow[first:])}


def release(run) -> dict:
    kept = [(k, a, hwc, int(nr), bool(ov)) for k, a, hwc, nr, ov in run.kept]
    records = {"kept": kept, "setup_parts": run.parts,
               "overflow": sum(bool(o) for o in run.overflow),
               "traced_poses": getattr(run, "traced_poses", None)}
    del run.scene, run.kept, run.overflow
    return records


def _reference_frames(cell, poses, precision: str = "f32"):
    """(pose, reference Frame) of each pose, on the reference's own
    parameters from the seed, in ``precision``."""
    cfg, dev = cell.config, cell.device
    rs = R.RenderSettings.from_config(cfg["render"])
    raw = inputs.draw_params(cfg["scene"], cell.seed, dev)
    path = inputs.RenderPath(cfg["dataset"], cell.traffic, cell.seed, dev)
    with torch.no_grad():
        for a in poses:
            yield a, R.render(raw, path.views[a], path.width, path.height,
                              tuple(cfg["dataset"]["background"]), rs,
                              cfg["scene"]["sh_degree"], precision)


def reference(cell, records: dict, precision: str = "f32") -> dict:
    """The reference's delivered image and entry count at each kept
    frame's pose, as the program's records keep them."""
    kept = []
    for (k, a, *_), (_, f) in zip(records["kept"], _reference_frames(
            cell, [item[1] for item in records["kept"]], precision)):
        kept.append((k, a, R.to_uint8_hwc(f.image).cpu().numpy(),
                     f.binned.num_rendered, f.binned.overflow))
    return {"kept": kept, "overflow": sum(item[4] for item in kept)}


def compare(records: dict, ref: dict) -> dict:
    """The numbers that decide ``correct``: each kept frame's image and
    entry count against the reference's at its pose."""
    if ref["overflow"]:
        raise RuntimeError("the reference overflows: raise the "
                           "configuration's capacities")
    level, entries = 0, 0.0
    for (_, _, hwc, nr, _), (_, _, want, r, _) in zip(records["kept"],
                                                      ref["kept"]):
        level = max(level, int(abs(hwc.astype(int) - want.astype(int)).max()))
        entries = max(entries, abs(nr - r) / max(r, 1))
    return {"image_level_gap": float(level), "num_rendered_gap": entries,
            "overflow": float(records["overflow"])}


def verify(cell, records: dict) -> dict:
    return compare(records, reference(cell, records))


def work(cell, records: dict) -> list:
    """Per traced frame, the work the reference counts on its pose."""
    cfg = cell.config
    rs = R.RenderSettings.from_config(cfg["render"])
    n = cfg["scene"]["n_gaussians"]
    tr = cell.traffic
    return [count_frame(frame, rs, tr["width"], tr["height"], n, 0)
            for _, frame in _reference_frames(cell, records["traced_poses"])]
