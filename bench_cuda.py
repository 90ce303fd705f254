"""Benchmark of the PyTorch / CUDA port: the differentiable 1080p frame on
one NVIDIA GPU, the counterpart of ``bench.py`` (which stays the JAX
package's benchmark).

    python3 bench_cuda.py

Two scales run, each in its own subprocess under a timeout
(``BENCH_CHILD_TIMEOUT`` seconds, default 900), with ``bench.py``'s
configurations verbatim:

  * headline: 2M gaussians, the production config of ``bench.py:57-63``
    (tile 32, no-pack, ellipse-tile cull, post-sort trim, fused sort, bf16
    payload and gradient reduction, ``blend_quad="mxu"``);
  * north_star: 6M gaussians, the same config at ``bench.py:66-73``'s
    capacities.

The scene is ``random_scene(n, seed=0, extent=3.0, scale_range=(0.004,
0.02))``: the numpy realisation of bench's distributions. ``bench.py``
draws its scene on the device with ``jax.random`` (``random_scene_device``),
so the two scenes have the same distributions and other numbers. The camera
is bench's (``bench.py:101-104``).

One frame is ``render_aux`` under autograd, loss = image sum, backward to
all five gaussian groups (and the background); ``overflow`` must be False.
Timing is chained-dependent as in ``bench.py:133-140``: rep i's background
hangs on rep i-1's loss, so no rep can start before the previous one ends;
each rep is timed with CUDA events.

Prints ONE json line with ``bench.py``'s keys (``metric``, ``value``,
``unit``, ``vs_baseline``, ``timing``, ``north_star``), the headline's
per-rep times, and ``device``: the card's name and power limit as
``nvidia-smi`` reports them. ``vs_baseline`` is null: ``bench.py``'s
baseline is a TPU figure, not a yardstick for this card. Without a CUDA
device it exits non-zero.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

WIDTH, HEIGHT = 1920, 1080

# (n_gaussians, cfg kwargs, timed reps): bench.py's CONFIGS verbatim
CONFIGS = {
    "headline": (
        2_000_000,
        dict(max_pairs=4_500_000, tile=32, pack_mode="none",
             tile_cull=True, max_pairs_sorted=3_900_000,
             grad_reduce_dtype="bf16", payload_dtype="bf16",
             sort_mode="fused", blend_quad="mxu"),
        10,
    ),
    "north_star": (
        6_000_000,
        dict(max_pairs=13_000_000, tile=32, pack_mode="none",
             tile_cull=True, max_pairs_sorted=10_600_000,
             grad_reduce_dtype="bf16", payload_dtype="bf16",
             sort_mode="fused", blend_quad="mxu"),
        5,
    ),
}


def scene_camera_config(name, device="cuda", n_gaussians=None, width=WIDTH,
                        height=HEIGHT, **cfg_overrides):
    """(scene, camera, cfg, reps) of one configuration; the overrides
    shrink it for a CPU run."""
    from luisacomputegaussiansplatting_tpu_torch import RenderConfig, look_at_camera, random_scene

    n, kw, reps = CONFIGS[name]
    scene = random_scene(n_gaussians or n, seed=0, extent=3.0,
                         scale_range=(0.004, 0.02), device=device)
    cam = look_at_camera((3.5, -3.0, 2.2), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0),
                         fov=65.0, width=width, height=height)
    return scene, cam, RenderConfig(**{**kw, **cfg_overrides}), reps


def run_config(name, device="cuda", reps=None, n_gaussians=None,
               width=WIDTH, height=HEIGHT, **cfg_overrides):
    """Time the forward + backward frame of one configuration.

    Returns {"px_s", "ms" (mean over the reps), "median_ms", "reps_ms",
    "first_ms", "num_rendered", "peak_gib" (None off the card), "device"}.
    Raises if the capacities overflow.
    """
    import torch

    from luisacomputegaussiansplatting_tpu_torch.utils.profiling import fwd_bwd_frame

    dev = torch.device(device)
    scene, cam, cfg, default_reps = scene_camera_config(
        name, dev, n_gaussians, width, height, **cfg_overrides)
    reps = reps or default_reps
    leaves = [t.detach().clone().requires_grad_(True)
              for t in scene.render_args()]
    bg0 = torch.zeros(3, device=dev)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)

    def clock():
        if on_card:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def ms(a, b):
        if on_card:
            torch.cuda.synchronize(dev)
            return a.elapsed_time(b)
        return (b - a) * 1e3

    # first frame: kernel builds and warm-up; its overflow flag is read
    t0 = clock()
    val, _g, aux = fwd_bwd_frame(leaves, bg0.clone().requires_grad_(True),
                                 cam, cfg)
    first_ms = ms(t0, clock())
    if bool(aux.overflow):
        raise RuntimeError(f"bench[{name}]: capacity overflow, raise "
                           "max_pairs / max_pairs_sorted")
    # chained-dependent reps: rep i's bg hangs on rep i-1's loss
    marks = [clock()]
    for _ in range(reps):
        bg = (bg0 + val * 1e-20).requires_grad_(True)
        val, _g, _aux = fwd_bwd_frame(leaves, bg, cam, cfg)
        marks.append(clock())
    if on_card:
        torch.cuda.synchronize(dev)
    reps_ms = [ms(a, b) for a, b in zip(marks, marks[1:])]
    mean_ms = sum(reps_ms) / len(reps_ms)
    return {
        "px_s": width * height / (mean_ms / 1e3),
        "ms": mean_ms,
        "median_ms": statistics.median(reps_ms),
        "reps_ms": reps_ms,
        "first_ms": first_ms,
        "num_rendered": int(aux.num_rendered),
        "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                     if on_card else None),
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
    }


def card():
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in out.rsplit(",", 1))
    return {"name": name, "power_limit": limit}


def run_child(name):
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps(run_config(name)))


def main():
    import torch

    if not torch.cuda.is_available():
        print("bench_cuda: no CUDA device is available", file=sys.stderr)
        return 1
    me = os.path.abspath(__file__)
    child_timeout = float(os.environ.get("BENCH_CHILD_TIMEOUT", "900"))
    results = {}
    for name in CONFIGS:
        try:
            proc = subprocess.run(
                [sys.executable, "-u", me, "--child", name],
                capture_output=True, text=True, timeout=child_timeout,
            )
            if proc.returncode != 0:
                raise RuntimeError(f"rc {proc.returncode}: "
                                   f"{proc.stderr.strip()[-2000:]}")
            results[name] = json.loads(proc.stdout.strip().splitlines()[-1])
        except (subprocess.TimeoutExpired, RuntimeError, ValueError,
                IndexError) as e:
            print(f"bench_cuda[{name}] failed: {e!r}", file=sys.stderr,
                  flush=True)
            results[name] = None
        else:
            print(f"bench_cuda[{name}]: {json.dumps(results[name])}",
                  file=sys.stderr, flush=True)

    head, ns = results["headline"], results["north_star"]
    out = {
        "metric": "pixels_per_s_per_chip_fwd_bwd_1080p",
        "value": head["px_s"] if head else None,
        "unit": "pixels/s/chip",
        "vs_baseline": None,
        "timing": "chained-dependent",
        "headline": {
            "scene": "2M gaussians",
            "fwd_bwd_ms": head["ms"] if head else None,
            "reps_ms": head["reps_ms"] if head else None,
        },
        "north_star": {
            "scene": "6M gaussians (bicycle scale)",
            "pixels_per_s_per_chip": ns["px_s"] if ns else None,
            "fwd_bwd_ms": ns["ms"] if ns else None,
        },
        "device": card(),
    }
    print(json.dumps(out))
    return 0 if head and ns else 1


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        run_child(sys.argv[2])
    else:
        sys.exit(main())
