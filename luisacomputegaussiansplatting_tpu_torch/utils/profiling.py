"""Profiling utilities (port of ``utils/profiling.py``).

The reference's only instrumentation is a wall clock around the frame
loop (app/main.cpp:225,317-320) and an ImGui FPS counter. Here:

  * ``Timer`` — per-call time of a function: CUDA events around the reps
    on the card, the host clock on the CPU.
  * ``trace(logdir)`` — a ``torch.profiler`` trace of the CPU and, on the
    card, CUDA activity, exported as a Chrome trace.
  * ``stage_timings`` / ``backward_timings`` — per-stage times of the
    render pipeline and of its backward, with the JAX package's stage keys.
  * ``fwd_bwd_frame`` — the differentiable frame ``bench.py`` times (loss =
    image sum, backward to the five gaussian groups and the background),
    which ``bench_cuda.py`` times and the functions below profile.
  * ``frame_profile`` — the device ops of ONE full forward + backward frame
    under ``torch.profiler``: each op's and each kernel's device time and
    the frame's device-busy share. Stages are attributed inside the full
    frame, not in isolated probes, which can get the sign of a change
    wrong once stages overlap or share caches. ``call_profile`` does the
    same for any one call, such as a training step.
  * ``backward_events`` / ``scatter_ops`` — the ops a profile recorded
    inside the autograd engine (a backward, without the forward and the
    optimizer around it), and those of them that add into their output at
    indices: a backward of the port is held to none of those.

Everything runs on the device of the scene's tensors; the device numbers
exist only on the card (``frame_profile`` reports host times on the CPU).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch


def _device_of(tensors) -> torch.device:
    """The device of the first tensor; with none, the card if there is one
    (a closure's work is synchronised there, never timed as enqueued)."""
    for t in tensors:
        if torch.is_tensor(t):
            return t.device
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


class _Clock:
    """Elapsed milliseconds of the work enqueued between ``start()`` and
    ``stop()``: CUDA events on the card (no host sync inside), the host
    clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def start(self):
        if self.cuda:
            torch.cuda.synchronize()
            self._a = torch.cuda.Event(enable_timing=True)
            self._a.record()
        else:
            self._t = time.perf_counter()

    def stop(self) -> float:
        if self.cuda:
            b = torch.cuda.Event(enable_timing=True)
            b.record()
            torch.cuda.synchronize()
            return self._a.elapsed_time(b)
        return (time.perf_counter() - self._t) * 1e3


class Timer:
    """Mean seconds per call over ``reps`` calls after ``warmup`` calls."""

    def __init__(self, warmup: int = 1, reps: int = 5):
        self.warmup = warmup
        self.reps = reps

    def time(self, fn: Callable, *args) -> float:
        """Seconds per call of ``fn(*args)`` on the device of ``args``."""
        clock = _Clock(_device_of(args))
        for _ in range(self.warmup):
            fn(*args)
        clock.start()
        for _ in range(self.reps):
            fn(*args)
        return clock.stop() / 1e3 / self.reps


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed work (CPU and, on the card, CUDA activity) and
    write it to ``logdir/trace.json`` (Chrome trace format, readable in
    Perfetto). Yields the ``torch.profiler.profile`` object."""
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=_activities()) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def fwd_bwd_frame(leaves, bg, camera, cfg, sh_degree: int = 3):
    """One differentiable frame: ``render_aux`` of the five gaussian groups
    ``leaves`` over the background ``bg`` (tensors that require grad),
    loss = image sum, backward to all six. Returns (loss, gradients,
    aux)."""
    from ..ops.render import render_aux

    img, aux = render_aux(*leaves, camera, bg_color=bg, cfg=cfg,
                          sh_degree=sh_degree)
    loss = img.sum()
    grads = torch.autograd.grad(loss, [*leaves, bg])
    return loss.detach(), grads, aux


def _leaves(tensors):
    return [t.detach().requires_grad_(True) for t in tensors]


def _stages(scene, camera, cfg, sh_degree):
    """(view, ``render_stages`` of one frame), no autograd."""
    from ..ops.render import render_stages

    args = scene.render_args()
    view = camera.to_view(args[0].device)
    with torch.no_grad():
        return view, render_stages(*args, view, camera.width, camera.height,
                                   cfg, sh_degree)


def stage_timings(scene, camera, cfg=None, sh_degree: int = 3, reps: int = 5,
                  include_backward: bool = True) -> Dict[str, float]:
    """Per-stage seconds of one frame at this scene/camera/config, each
    stage timed on its own.

    Stages: sh_eval, projection, binning, payload, rasterize_fwd,
    full_forward, and (optionally) full_fwd_bwd (``fwd_bwd_frame``).
    """
    from ..config import RenderConfig
    from ..ops.binning import bin_gaussians, bin_gaussians_nopack
    from ..ops.projection import project_gaussians
    from ..ops.rasterize import rasterize_forward
    from ..ops.render import _selection_opacity, build_payload, render
    from ..ops.sh_eval import compute_colors

    cfg = cfg or RenderConfig()
    w, h = camera.width, camera.height
    view, (proj, (gx, gy), binned, payload, colors, cull_op) = _stages(
        scene, camera, cfg, sh_degree)
    means, scales, quats, opac, sh = scene.render_args()
    sel_op = _selection_opacity(opac, cfg)
    binner = bin_gaussians_nopack if cfg.pack_mode == "none" else bin_gaussians
    t = Timer(reps=reps)
    out: Dict[str, float] = {}
    with torch.no_grad():
        out["sh_eval"] = t.time(
            lambda m, s: compute_colors(m, s, view.position, sh_degree),
            means, sh)
        out["projection"] = t.time(
            lambda m, s, q: project_gaussians(
                m, s, q, view, cfg, width=w, height=h,
                opacities=sel_op if cfg.tight_radius else None),
            means, scales, quats)
        out["binning"] = t.time(
            lambda p: binner(p, gx, gy, cfg.max_pairs, cull_op, cfg.tile_wh,
                             cfg.alpha_min, cfg.expansion,
                             cfg.max_pairs_sorted, cfg.interpret,
                             cfg.sort_mode), proj)
        out["payload"] = t.time(
            lambda p, c, o: build_payload(p, c, o, binned,
                                          cfg.grad_reduce_dtype,
                                          cfg.payload_dtype,
                                          cfg.grad_reduce_method),
            proj, colors, opac)
        out["rasterize_fwd"] = t.time(
            lambda p: rasterize_forward(p, binned.tile_starts,
                                        binned.tile_counts, gx, w, h, cfg),
            payload)
        out["full_forward"] = t.time(
            lambda *a: render(*a, camera, cfg=cfg, sh_degree=sh_degree),
            means, scales, quats, opac, sh)
    if include_backward:
        def frame(*a):
            *leaves, bg = _leaves(a)
            return fwd_bwd_frame(leaves, bg, camera, cfg, sh_degree)

        out["full_fwd_bwd"] = t.time(frame, means, scales, quats, opac, sh,
                                     torch.zeros(3, device=means.device))
    return out


def _chained_time(fn, args, reps: int = 4) -> float:
    """Seconds per call with CHAINED-dependent repetitions: each rep's salt
    input hangs on the previous rep's output (a device value, read by no
    host), as ``bench.py`` times its frames. ``fn`` takes (salt, *args)
    and returns a tensor or a sequence whose first item is one. Two
    warm-up calls, then the mean over ``reps`` chained calls."""
    def first(out):
        return out if torch.is_tensor(out) else first(out[0])

    def salt_of(out):
        return first(out).reshape(-1)[0].detach().float() * 1e-30

    dev = _device_of(args)
    out = fn(torch.zeros((), device=dev), *args)
    out = fn(salt_of(out), *args)  # warm
    clock = _Clock(dev)
    clock.start()
    for _ in range(reps):
        out = fn(salt_of(out), *args)
    return clock.stop() / 1e3 / reps


def backward_timings(scene, camera, cfg=None, sh_degree: int = 3,
                     reps: int = 4) -> Dict[str, float]:
    """Attribute the backward pass: per-pullback-stage seconds.

    Stages (their sum should match fwd_bwd_total - forward):
      rast_bwd   — d_image -> d_payload (tiles to image and the blend's
                   forward and backward)
      reduce_bwd — d_payload -> d_table (gather_payload's backward: sort
                   and segment-sum, with its forward gather)
      params_bwd — d_table -> d_params (payload table, projection and SH,
                   forward and backward)
    plus `forward` and `fwd_bwd_total` (backward to the five gaussian
    groups) for the cross-check. All use chained-dependent timing.
    """
    from ..config import RenderConfig
    from ..ops.projection import project_gaussians
    from ..ops.rasterize import rasterize_tiles
    from ..ops.render import _tiles_to_image, gather_payload, payload_table, render
    from ..ops.sh_eval import compute_colors

    cfg = cfg or RenderConfig()
    w, h = camera.width, camera.height
    view, (proj, (gx, gy), binned, payload, colors, _) = _stages(
        scene, camera, cfg, sh_degree)
    means, scales, quats, opac, sh = scene.render_args()
    dev = means.device
    out: Dict[str, float] = {}

    def forward(salt, m):
        with torch.no_grad():
            return render(m, scales, quats, opac, sh, camera,
                          bg_color=torch.zeros(3, device=dev) + salt,
                          cfg=cfg, sh_degree=sh_degree)

    out["forward"] = _chained_time(forward, (means,), reps)

    def rast_bwd(salt, pl):
        (p,) = _leaves([pl])
        color, trans = rasterize_tiles(p, binned.tile_starts,
                                       binned.tile_counts, gx, w, h, cfg)
        img_c, img_t = _tiles_to_image(color, trans, gx, gy, w, h,
                                       cfg.tile_wh)
        loss = (img_c * (1.0 + salt)).sum() + img_t.sum()
        return torch.autograd.grad(loss, p)

    out["rast_bwd"] = _chained_time(rast_bwd, (payload,), reps)

    with torch.no_grad():
        table = payload_table(proj, colors, opac)
    d_payload = torch.ones_like(payload)

    def reduce_bwd(salt, tb):
        (t,) = _leaves([tb])
        pl = gather_payload(t, binned.entry_gid, cfg.payload_dtype,
                            cfg.grad_reduce_dtype, cfg.grad_reduce_method)
        return torch.autograd.grad((pl * (d_payload * (1.0 + salt))).sum(), t)

    out["reduce_bwd"] = _chained_time(reduce_bwd, (table,), reps)

    d_table = torch.ones_like(table)

    def params_bwd(salt, *a):
        leaves = _leaves(a)
        m, s, q, o, shc = leaves
        cl = compute_colors(m, shc, view.position, sh_degree)
        pr = project_gaussians(m, s, q, view, cfg, width=w, height=h,
                               opacities=o if cfg.tight_radius else None)
        tb = payload_table(pr, cl, o)
        return torch.autograd.grad((tb * (d_table * (1.0 + salt))).sum(),
                                   leaves)

    out["params_bwd"] = _chained_time(params_bwd,
                                      (means, scales, quats, opac, sh), reps)

    def fwd_bwd(salt, *a):
        bg = (torch.zeros(3, device=dev) + salt).requires_grad_(True)
        return fwd_bwd_frame(_leaves(a), bg, camera, cfg, sh_degree)[0]

    out["fwd_bwd_total"] = _chained_time(fwd_bwd,
                                         (means, scales, quats, opac, sh),
                                         reps)
    return out


class FrameProfile(NamedTuple):
    """One profiled call: a forward + backward frame, a training step."""

    device: str  # "cuda" or "cpu"
    wall_ms: float  # the call, profiler on: CUDA events (host clock on CPU)
    busy_ms: Optional[float]  # union of the device's kernel and copy spans
    busy_share: Optional[float]  # busy_ms / wall_ms (None on the CPU)
    #: (op, ms, calls), most time first: each op's self device time (the
    #: kernels it launched itself) on the card, its self CPU time on the CPU
    ops: List[Tuple[str, float, int]]
    #: (kernel, ms, calls) of the device events by name (empty on the CPU)
    kernels: List[Tuple[str, float, int]]
    #: (op, ms, calls), most time first: each op's device time with that of
    #: the ops it called (``aten::select_backward``'s fill and copy, say);
    #: empty on the CPU
    totals: List[Tuple[str, float, int]]


def _union_ms(spans) -> float:
    """Total length of the union of (start_us, end_us) spans, in ms."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total / 1e3


def frame_profile(scene, camera, cfg=None,
                  sh_degree: int = 3) -> FrameProfile:
    """Profile ONE full differentiable frame: ``render_aux`` under autograd,
    loss = image sum, backward to the five gaussian groups and the
    background (the frame ``bench.py`` times), after one unprofiled
    warm-up frame (see :func:`call_profile`)."""
    from ..config import RenderConfig

    cfg = cfg or RenderConfig()
    args = scene.render_args()
    dev = args[0].device

    def frame():
        *leaves, bg = _leaves([*args, torch.zeros(3, device=dev)])
        return fwd_bwd_frame(leaves, bg, camera, cfg, sh_degree)

    frame()  # warm-up: kernel builds, allocator
    return call_profile(frame, dev)


def call_profile(fn: Callable, dev: torch.device) -> FrameProfile:
    """Profile ONE call of ``fn()`` whose work runs on ``dev`` (a training
    step, a frame). The busy share is the union of the device's kernel and
    copy spans over the call's wall time; the profiler's own host overhead
    lengthens the call, so it reads lower than in an unprofiled call."""
    clock = _Clock(dev)
    with torch.profiler.profile(activities=_activities()) as prof:
        clock.start()
        fn()
        wall_ms = clock.stop()
    on_card = dev.type == "cuda"
    avg = prof.key_averages()
    if on_card:
        ops = [(e.key, e.self_device_time_total / 1e3, e.count) for e in avg
               if e.self_device_time_total > 0
               and e.device_type == torch.autograd.DeviceType.CPU]
        totals = sorted(((e.key, e.device_time_total / 1e3, e.count)
                         for e in avg if e.device_time_total > 0
                         and e.device_type == torch.autograd.DeviceType.CPU),
                        key=lambda x: -x[1])
        dev_events = [e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
        by_name: Dict[str, List[float]] = {}
        for e in dev_events:
            acc = by_name.setdefault(e.name, [0.0, 0])
            acc[0] += (e.time_range.end - e.time_range.start) / 1e3
            acc[1] += 1
        kernels = sorted(((k, v[0], int(v[1])) for k, v in by_name.items()),
                         key=lambda x: -x[1])
        busy = _union_ms((e.time_range.start, e.time_range.end)
                         for e in dev_events)
        share = busy / wall_ms if wall_ms > 0 else None
    else:
        ops = [(e.key, e.self_cpu_time_total / 1e3, e.count) for e in avg
               if e.self_cpu_time_total > 0]
        kernels, busy, share, totals = [], None, None, []
    ops.sort(key=lambda x: -x[1])
    return FrameProfile(dev.type, wall_ms, busy, share, ops, kernels, totals)


#: aten ops that add floats into their output at given indices (float
#: atomics on the card, whose order varies from run to run)
SCATTER_OPS = ("index_add", "scatter_add", "scatter_reduce")
_ENGINE = "autograd::engine::evaluate_function"


def _in_backward(event) -> bool:
    e = event.cpu_parent
    while e is not None:
        if e.name.startswith(_ENGINE):
            return True
        e = e.cpu_parent
    return False


def backward_events(prof) -> list:
    """The events of a ``torch.profiler`` profile that ran under the
    autograd engine: a backward's ops, whatever ran around it."""
    return [e for e in prof.events() if _in_backward(e)]


def scatter_ops(events) -> List[str]:
    """The names of the profiler events that add into their output:
    scatter-adds and ``index_put`` with ``accumulate=True`` (read from the
    recorded inputs: profile with ``record_shapes=True``)."""
    bad = []
    for e in events:
        if any(s in e.name for s in SCATTER_OPS):
            bad.append(e.name)
        elif "index_put" in e.name:
            inputs = getattr(e, "concrete_inputs", None) or []
            if len(inputs) > 3 and inputs[3] is True:
                bad.append(e.name + "(accumulate=True)")
    return bad
