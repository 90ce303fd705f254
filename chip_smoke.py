#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --compare ROOT [--grads FILE]

Builds the hand-written kernels from ``luisacomputegaussiansplatting_tpu_torch/
csrc`` (one nvcc per source, all at once), holds each against its plain
PyTorch version, and drives the port's render and training paths end to end:

  0. the card (nvidia-smi name and power limit), torch/CUDA versions and the
     kernel build time, with ptxas' registers and spills of every kernel;
  1. forward kernels against plain versions at test scale: first the
     expansion on adversarial fan-outs (``adversarial_fanouts``: empty
     gaussians at both ends and in runs, one gaussian over every tile,
     ``max_pairs`` inside a rect row, a saturated total, no tile at all),
     cull off and on; then a 20K-gaussian random scene at 320x240 over tile
     16, 32 and 32x16, both pack modes, cull off and on — the expansion
     kernel must equal the plain expansion bit for bit, the blend kernel
     must agree with the plain rasterizer within BLEND_TOL below, at every
     number of pixels a thread, each instance the same bits; the fused
     sort's fallback (2^22 tiles) and threshold (2^19 - 1 tiles) and the
     near cull (``NEAR_MEANS``) equal to the same calls on the CPU;
  2. the render CLI in-process on a 200K-gaussian scene at 1600x1063, then
     on the 2M bench scene from its PLY (the native loader) at 1920x1080
     with the strict defaults and the reference's L (``--max-pairs`` 20M):
     no overflow, ``rep_ms`` logged;
  3. the forward slice: a 2M-gaussian random scene at 1920x1080 through
     ``render_aux`` with the strict-parity config, re-run stage by stage with
     the plain versions, and timed (the forward blend at each number of
     pixels a thread; the expansion's prefix sums and kernel apart); the
     digest of the forward blend's colour and T;
  4. backward kernels against plain versions at phase 1's scale and
     settings: the backward blend against ``rasterize_backward_reference``
     on a random residual, the segment-sum in f32 and bf16 against
     ``index_add_`` and its first pass (the segment starts) against
     ``segment_starts_reference`` bit for bit, first on adversarial sorted
     ids (one id of 100K rows, empty ids at both ends, ids -1 and >= n_out
     with NaN rows, n_out = 1, every row dropped, no rows); each kernel run
     twice must give the same bits;
  5. the differentiable slice at phase 3's size: loss = image sum, backward
     to all five gaussian groups and the background, in f32 and with the
     bf16 gradient reduction; stage by stage against the plain versions;
     the forward and the backward blend at each number of pixels a thread
     held and timed; the forward+backward frame timed over chained reps;
     then five training steps with ``make_train_step``;
  6. the production slice: first phases 1 and 4 again with
     ``blend_quad="mxu"``; then ``bench.py``'s headline configuration (tile 32,
     no-pack, cull, trim, fused sort, bf16 payload and gradient reduction,
     ``blend_quad="mxu"``) through ``bench_cuda.run_config``'s scene and
     frame at 2M gaussians and 1920x1080: one forward + backward frame with
     its launch counts (no vpu blend), three ring views indexed from a
     stacked CameraView bit-identical to single frames in image,
     ``num_rendered`` and gradients, the mxu blend kernels against their
     plain versions on the frame's payload and residual (each at every
     number of pixels a thread; the forward's digest), the five groups'
     gradients against the all-plain backward, the mxu image against the
     vpu image, the expansion and the segment-sum at the frame's shapes
     (the longest segment logged), the timed frames and five training
     steps; the north star (6M gaussians) through ``run_config``; and one
     production frame under ``torch.profiler``
     (``utils/profiling.frame_profile``), with the device ms of add_,
     fill_ and copy_ and of what select_backward ran, which must be none:
     the columns cross through ``utils/packing.py``;
  7. densifying, batched training at the production configuration: capacity
     2M from 1M actives (the bench scene's first half, means moved by
     N(0, 0.01), opacity logits lowered by 1) towards the full scene's
     renders from 4 views on a ring (the bench camera's), 10 steps of
     ``make_batched_train_step`` (B = 4), a ``densify_step`` round with the
     ``DensifyConfig`` defaults, 10 more steps, ``reset_opacity`` and 5
     steps of ``make_densify_train_step``; the loss falls, no overflow,
     exact launch counts every step, the round grows the active count and
     equals its re-run on the CPU from copies of its inputs and noise
     (``check_round``), as does a second round on copies of the state with
     a ``percent_dense`` at which it splits; then the four kernels against
     their plain versions on one ring view's stages with the active mask
     (``check_masked_view``); one profiled batched step, with phase 6's op
     sums and no select_backward; inactive rows stay parked and culled;
  8. the dataset loaders, the train CLI and the viewer: (a) a COLMAP
     binary model in mip-NeRF-360 layout (``sparse/0/*.bin``, ``images/``)
     of 8 renders of the 2M bench scene at 1920x1080 on the bench camera's
     ring and 300K points (its first means, moved by N(0, 0.01)), loaded
     back by ``load_colmap`` (cameras within 1e-5, targets within 1/255);
     (b) ``train_cli.main`` on it at bench.py's production configuration,
     2M capacity, B = 4, 60 steps with densify rounds at 20, 30 and 40, an
     opacity reset at 30, checkpoints and evals every 20: the loss and
     view 0's PSNR improve, the active count rises every round, no
     overflow, exactly 4 launches of each production kernel every step,
     the exported PLY read equal by the native and the numpy loaders;
     (c) the same run resumed from step 60 to 70; (d) the CLI's defaults
     (one view, vpu, tile 16, f32) with ``max_pairs`` a third of the first
     view's entries: it grows; (e) the viewer on the 2M scene at its
     defaults over loopback at 1280x720 and 1920x1080, 20 frames on a ring
     each, every request's time in four parts (render by CUDA events;
     copy, flip and cast; JPEG; HTTP), each frame >= 35 dB against
     ``render_view``, a malformed query answered 400;
  9. the sharded path (``parallel/``) on ``bench.py``'s production
     configuration at 2M gaussians and 1920x1080 with the sort "2key" and no
     post-sort trim (the settings the sharded path rejects): (a) the
     frame's 60 x 34 tiles in 4 bands of 9 tile rows, K2 and K3 in both
     blend modes on each band's ranges at its first global tile
     (``tile_offset``) against their plain versions and equal bit for bit
     to the whole frame's blend; (b) world size 1 over NCCL in this
     process: ``render_sharded`` forward and backward against
     ``render_aux`` (image within 2e-5, gradients within GRAD_TOL), exactly
     one launch of K1, K2 mxu, K3 mxu and K4 f32, the frame's time beside
     the single-device frame's and its peak memory, five steps of
     ``make_sharded_train_step`` on a 1x1 mesh with densify (the first
     profiled: its backward runs no scatter-add) and a sharded densify
     round; (c) four spawned ranks sharing the one card through gloo with
     CUDA tensors (NCCL takes one rank per device), 500K gaussians each:
     the assembled image within 2e-5 of 9b's, the gradients within
     GRAD_TOL, then five training steps on a 2x2 mesh (the first profiled
     as in 9b on every rank). These are
     four processes on one card exchanging through the host, not a
     multi-GPU number.
  10. the real-scene quality proof
     (``luisacomputegaussiansplatting_tpu_torch/scripts/real_scene_proof.py``)
     at the JAX script's full presets: gen in its own process (a
     70K-gaussian procedural scene, its PLY round trip rendered at
     1600x1063, 40 views at 800x800 on the interp rig), train in this
     process (the train CLI, 4,000 steps of two views at 200K capacity
     from 30K points, a densify round every 150 steps, a checkpoint every
     500; K1, K2 vpu, K3 vpu and K4 f32 twice every step; step
     P10_PROFILE_STEP under the profiler), eval in its own
     process (4 held-out poses at 1600x1063: PSNR >= P10_PSNR, SSIM >=
     P10_SSIM), parity (the render CLI at the strict settings on the card
     and on the CPU: the same ``num_rendered``, the frames within
     P10_PARITY_MAX and P10_PARITY_MEAN, JAX's, and within the port's own
     P10_PORT_PARITY_MAX and P10_PORT_PARITY_MEAN); after train, the four
     kernels against their plain versions (``check_masked_view``) on the
     trained state at capacity, training view 0 and the train CLI's
     RenderConfig. The report lands in
     ``build/chip_smoke/phase10/proof_report.json`` with the card, each
     stage's seconds, the densify trajectory and the final loss.

Every phase runs, in order; to rehearse one, import this module and call
its ``phaseN`` function. ``--compare ROOT`` prints only one JSON line,
computed by the port package of the tree at ROOT (to hold another tree to
this one's bits and time and profile both with the same code): on phase
3's and phase 6's frames, the forward and backward blends' digests, K2's
and the expansion's device times, and the differentiable frame's image,
five-gradient and background digests, median ms, peak GiB, busy ms and
the op sums of phase 6's profile; then phase 7's batched step: the
digests of its gradients and statistics, its ms, peak GiB, busy ms and op
sums. With ``--grads FILE`` the first tree saves the batched step's
gradients there and each later tree prints its max relative difference
from them.

BLEND_TOL: max |diff| <= 5e-4 on colour and T, except at most 1e-5 of the
pixels (transmittance-stop flips), which stay <= 2e-2.
GRAD_TOL (backward blend, and the five groups' gradients): |diff| <= 1e-4 x
the field's max |plain|, except at most 1e-5 of the entries (stop flips),
which stay <= 2e-2 x that max.
MXU_VS_VPU (phase 6, the mxu image against the vpu image on one payload):
BLEND_TOL, whose 5e-4 is the bound of tests/test_rasterize.py:384. The two
modes evaluate alpha with rounding errors up to ~1e-4 relative, so a pair
whose alpha lies that close to alpha_min or the stop is applied by one and
not the other, which moves its pixel by ~alpha_min; at 2M gaussians and
1920x1080, 3 pixels of 2,073,600 were over 5e-4 (20 allowed).
SUM_TOL (segment-sum against index_add_, another summation order): |diff|
<= 1e-5 x the column's max |sum|; on phase 4's adversarial ids against
index_add_ in float64, whose float32 sum over one id's 100K rows is itself
~2e-5 off.

Every failed check exits non-zero; with no CUDA device it fails at once. The
last line of standard output is one JSON object naming the device; the line
before it is the per-kernel JSON record; the line before that, the card's
name and power limit.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import io
import json
import math
import os
import re
import shutil
import statistics
import struct
import subprocess
import sys
import time

TOL = 5e-4
FLIP_TOL = 2e-2
FLIP_SHARE = 1e-5
GRAD_TOL = 1e-4
SUM_TOL = 1e-5
#: K2's colour and T digests on phase 3's (vpu) and phase 6's (mxu) frames:
#: a change of the blend kernels keeps them (at tile offset 0)
K2_DIGESTS = {"phase3": "abe890a81d73127e", "phase6": "26de40ffff84368b"}
ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "luisacomputegaussiansplatting_tpu_torch/csrc"
JAX_OPS = "luisacomputegaussiansplatting_tpu/ops"
# device_ms' spin before each timed call: ~2.5 ms at the H100's ~1.98 GHz
SPIN_CYCLES = 5_000_000

# published peaks of one H100 SXM (NVIDIA data sheet), for the bounds
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# FP32 operations per (entry, pixel) pair, counted from the kernels: for
# every evaluated pair the power and its test (vpu: the conic quadratic;
# mxu: the pixel polynomial, 5 multiplies and 5 adds, and the guard test);
# for an applied pair the forward adds exp, log1p, exp, a division and the
# colour sums, the backward also the nine gradient terms and their share of
# the shuffles
OPS_PER_PAIR = {"vpu": 10, "mxu": 11}
OPS_PER_APPLIED = {"forward": 15, "backward": 50}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn()`` over ``reps`` runs after one warm-up,
    timed with CUDA events on the current stream."""
    from luisacomputegaussiansplatting_tpu_torch.utils.profiling import Timer

    return Timer(warmup=1, reps=reps).time(fn) * 1e3


def device_ms(fn, reps=5):
    """Mean device milliseconds of one ``fn()`` over ``reps`` calls after
    one: CUDA events around the call alone, without the host time of its
    wrapper (which ``cuda_ms`` includes where the host is the slower). Each
    call is queued behind a spin kernel (``torch.cuda._sleep``, ~2.5 ms),
    so the device runs the call's kernels back to back however long the
    host takes to launch them; the run fails if the spin ended before the
    host had queued the call, whose time would then hold the host's."""
    import torch

    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        queued_in_time = not start.query()
        torch.cuda.synchronize()
        check(queued_in_time, "device_ms: the spin kernel ended before the "
                              "call was queued")
        total += start.elapsed_time(end)
    return total / reps


def timed_once(fn):
    """(result, milliseconds) of one run of ``fn()``, with CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def bound(nbytes, ops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    FP32 operations over the FP32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_libs():
    from luisacomputegaussiansplatting_tpu_torch.ops import expand, rasterize, segsum

    return [expand.KERNEL, rasterize.KERNEL, rasterize.BACKWARD_KERNEL,
            segsum.KERNEL]


def reset_launches():
    for k in kernel_libs():
        k.reset_launches()


def read_launches():
    """Launches per kernel since the last reset, per variant where the
    kernel has variants: ``rasterize_vpu``/``rasterize_mxu``,
    ``rasterize_backward_vpu``/``_mxu``, ``segsum_f32``/``_bf16``."""
    counts = {}
    for k in kernel_libs():
        if k.variant_launches:
            counts.update({f"{k.name}_{v}": n
                           for v, n in k.variant_launches.items()})
        else:
            counts[k.name] = k.launches
    return counts


def check_launches(tag, got, **nonzero):
    """The launches of one path are exactly ``nonzero`` and 0 for every
    other kernel and variant."""
    want = {k: nonzero.get(k, 0) for k in got}
    check(set(nonzero) <= set(got), f"{tag}: unknown kernels {nonzero}")
    log(f"{tag}: launches {got}")
    check(got == want, f"{tag}: launches {got}, expected {want}")


def used_slots(binned):
    """Payload slots the tile ranges cover: the binners lay the ranges end
    to end from slot 0. The backward blend writes only these."""
    return int(binned.tile_starts[-1]) + int(binned.tile_counts[-1])


def compare_expansion(proj, grid_x, num_tiles, max_pairs, cull_op, tile, cfg):
    """Kernel vs plain expansion: every output identical bit for bit.
    Returns the kernel's outputs and the max |kernel - plain| over them."""
    import torch

    from luisacomputegaussiansplatting_tpu_torch.ops.binning import expand_entries
    from luisacomputegaussiansplatting_tpu_torch.ops.expand import expand_entries_kernel

    k = expand_entries_kernel(proj, grid_x, num_tiles, max_pairs, cull_op,
                              tile, cfg.alpha_min)
    p = expand_entries(proj, grid_x, num_tiles, max_pairs, cull_op, tile,
                       cfg.alpha_min)
    torch.cuda.synchronize()
    names = ("tile_id", "depth", "gid", "total")
    max_err = 0.0
    for name, a, b in zip(names, k, p):
        a64, b64 = a.double(), b.double()
        # equal values (the invalid slots' +inf included) differ by 0
        err = torch.where(a64 == b64, 0.0, (a64 - b64).abs())
        max_err = max(max_err, float(err.max()) if err.numel() else 0.0)
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        n_diff = int((a != b).sum())
        check(n_diff == 0, f"expansion kernel != plain in {name}: "
                           f"{n_diff} of {a.numel()} differ")
    return k, max_err


def blend_diff(ck, tk, cp, tp, grid_x, grid_y, width, height, tile):
    """(max |diff|, pixels over TOL, image pixels) between two rasterizer
    outputs, over the image's pixels and all four channels."""
    import torch

    from luisacomputegaussiansplatting_tpu_torch.ops.render import _tiles_to_image

    ik, jk = _tiles_to_image(ck, tk, grid_x, grid_y, width, height, tile)
    ip, jp = _tiles_to_image(cp, tp, grid_x, grid_y, width, height, tile)
    d = torch.maximum((ik - ip).abs().amax(dim=0), (jk - jp).abs())
    check(bool(torch.isfinite(ik).all() and torch.isfinite(jk).all()),
          "non-finite rasterizer output")
    return float(d.max()), int((d > TOL).sum()), width * height


def check_blend(tag, max_d, n_over, n_pix):
    allowed = int(FLIP_SHARE * n_pix)
    log(f"{tag}: blend kernel vs plain max|d|={max_d:.3e} "
        f"pixels>{TOL:g}: {n_over} (allowed {allowed})")
    check(n_over <= allowed and max_d <= FLIP_TOL,
          f"{tag}: blend kernel disagrees with the plain rasterizer")


def check_fields(tag, what, got, want, names, rows=None):
    """GRAD_TOL per field (column) of ``got`` vs ``want`` (items x fields),
    over ``rows`` (a bool mask of the items to hold, default all). Returns
    the largest |diff| over max |want| of any field."""
    import torch

    if rows is not None:
        got, want = got[rows], want[rows]
    check(bool(torch.isfinite(got).all()), f"{tag}: non-finite {what}")
    allowed = int(FLIP_SHARE * got.shape[0])
    worst, parts = 0.0, []
    for i, name in enumerate(names):
        scale = float(want[:, i].abs().max()) + 1e-30
        rel = (got[:, i] - want[:, i]).abs() / scale
        n_over = int((rel > GRAD_TOL).sum())
        worst = max(worst, float(rel.max()))
        parts.append(f"{name} {float(rel.max()):.2e}/{n_over}")
        check(n_over <= allowed and float(rel.max()) <= FLIP_TOL,
              f"{tag}: {what} {name} kernel vs plain: max rel "
              f"{float(rel.max()):.3e}, {n_over} over {GRAD_TOL:g} "
              f"(allowed {allowed})")
    log(f"{tag}: {what} max|d|/max|plain| (count over {GRAD_TOL:g}, allowed "
        f"{allowed}): {' '.join(parts)}")
    return worst


def check_sums(tag, got, want):
    """SUM_TOL per column; returns the max |diff|."""
    import torch

    check(bool(torch.isfinite(got).all()), f"{tag}: non-finite sums")
    scale = want.abs().amax(dim=0) + 1e-30
    rel = float(((got - want).abs() / scale).max())
    check(rel <= SUM_TOL, f"{tag}: segment-sum kernel vs index_add_: max "
                          f"|d|/max|sum| {rel:.3e} > {SUM_TOL:g}")
    return float((got - want).abs().max()), rel


def pair_counts(payload, tile_starts, tile_counts, grid_x, width, height, cfg,
                tile_offset=0):
    """(evaluated, applied) (entry, pixel) pairs of a blend over this
    payload: every in-image pixel against its tile's real entries up to and
    including the one where it stops, and of those the pairs it applies;
    from the plain forward's replay (for the kernels' bounds)."""
    import torch

    from luisacomputegaussiansplatting_tpu_torch.ops.rasterize_ref import (
        _tile_batches,
        replay,
        tile_pixel_coords,
    )

    tw, th = cfg.tile_wh
    starts = tile_starts.to(torch.int64)
    counts = tile_counts.to(torch.int64)
    evaluated = applied = 0
    with torch.no_grad():
        for sel in _tile_batches(tile_counts, tw * th, payload.device):
            pixels = tile_pixel_coords(sel, grid_x, width, height, tw, th,
                                       tile_offset)
            r = replay(payload, starts[sel], counts[sel], pixels, cfg)
            if r.t_after.shape[1] == 0:
                continue
            ok = r.t_after >= cfg.transmittance_eps  # True until the stop
            real = (r.in_range & (r.f[5] > 0))[:, :, None]
            stopped = ~ok[:, -1, :]
            per_pixel = (ok & real).sum(1) + stopped.to(torch.int64)
            evaluated += int((per_pixel * (pixels.t0 > 0)).sum())
            applied += int(r.applied.sum())
    return evaluated, applied


def phase0():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    log(f"card: {smi[0]}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    libs = kernel_libs()
    # one nvcc per source, all started together
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda k: k.lib(), libs))
    for k in libs:
        built = "cached" if k.build_seconds is None else f"{k.build_seconds:.2f} s"
        log(f"kernel {k.name}: built ({built})")
        # ptxas: registers, shared memory and spills of each kernel
        for line in k.build_log.splitlines():
            if "Used" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas {k.name}: {line.strip()}")
    log(f"kernel build total: {time.perf_counter() - t0:.2f} s")
    return smi[0]


def test_scenes(dev, blend="vpu"):
    """Phase 1 and 4's settings: (tag, cfg, camera, scene), in one blend
    mode."""
    from luisacomputegaussiansplatting_tpu_torch import RenderConfig, look_at_camera, random_scene

    scene = random_scene(20_000, seed=1, device=dev)
    cam = look_at_camera((3.0, -2.5, 2.0), (0, 0, 0), (0, 0, 1), fov=70.0,
                         width=320, height=240)
    for tile, tile_h in ((16, None), (32, None), (32, 16)):
        for pack in ("chunk", "none"):
            for cull in (False, True):
                tag = f"tile={tile}x{tile_h or tile} pack={pack} cull={cull}"
                cfg = RenderConfig(max_pairs=2_000_000, tile=tile,
                                   tile_h=tile_h, pack_mode=pack,
                                   tile_cull=cull, blend_quad=blend)
                yield tag, cfg, cam, scene


def cull_opacity(scene, cfg):
    """The opacity the tile cull reads (None without the cull), as
    ``render_view`` passes it."""
    from luisacomputegaussiansplatting_tpu_torch.ops.render import _selection_opacity

    return _selection_opacity(scene.opacities, cfg) if cfg.tile_cull else None


def bin_and_payload(scene, cam, cfg, expansion=None):
    """(proj, grid, binned, payload) of a scene (no autograd): the stages of
    ``render_view`` at ``cfg`` (``render_stages``), with another expansion
    where ``expansion`` names one."""
    import torch

    from luisacomputegaussiansplatting_tpu_torch.ops.render import render_stages

    if expansion is not None:
        cfg = dataclasses.replace(cfg, expansion=expansion)
    args = scene.render_args()
    with torch.no_grad():
        s = render_stages(*args, cam.to_view(args[0].device), cam.width,
                          cam.height, cfg)
    return s.proj, s.grid, s.binned, s.payload


def adversarial_fanouts(grid_x=120, grid_y=68, n=4000, seed=5):
    """(tag, fields, max_pairs) of projected scenes, as numpy arrays in the
    field order of ``ProjectedGaussians`` plus the opacities, whose fan-outs
    the frames do not reach: gaussians with no tile at both ends and in runs
    of 1 to 100 (whole warps of them included), one gaussian over every tile
    of the grid, ``max_pairs`` cutting a gaussian in the middle of a rect
    row, an AABB total past 2^31 - 1 (saturated), and no tile at all. Each
    rect is a box of tiles inside the grid with its mean inside it and a
    conic whose reach is about the box."""
    import numpy as np

    rng = np.random.default_rng(seed)
    tw = th = 16

    def small_rects(k):
        w = rng.integers(1, 7, k)
        h = rng.integers(1, 7, k)
        x0 = rng.integers(0, grid_x - 6, k)
        y0 = rng.integers(0, grid_y - 6, k)
        return np.stack([x0, y0, x0 + w, y0 + h], 1)

    def scene(rects):
        rects = np.asarray(rects, dtype=np.int64)
        k = rects.shape[0]
        area = (rects[:, 2] - rects[:, 0]) * (rects[:, 3] - rects[:, 1])
        wpx = np.maximum(rects[:, 2] - rects[:, 0], 1) * tw
        hpx = np.maximum(rects[:, 3] - rects[:, 1], 1) * th
        mx = rects[:, 0] * tw + rng.random(k) * wpx
        my = rects[:, 1] * th + rng.random(k) * hpx
        sx, sy = wpx / 6.0, hpx / 6.0
        rho = rng.uniform(-0.6, 0.6, k)
        det = (sx * sy) ** 2 * (1 - rho**2)
        conic = np.stack([sy**2 / det, -rho * sx * sy / det, sx**2 / det], 1)
        radius = np.where(area > 0, np.ceil(3 * np.maximum(sx, sy)), 0)
        return [
            np.stack([mx, my], 1).astype(np.float32),           # means2d
            rng.uniform(0.5, 20.0, k).astype(np.float32),       # depth
            conic.astype(np.float32),                           # conic
            radius.astype(np.int32),                            # radius
            rects[:, :2].astype(np.int32),                      # rect_min
            rects[:, 2:].astype(np.int32),                      # rect_max
            area.astype(np.int32),                              # tiles_touched
            area > 0,                                           # valid
            rng.uniform(0.005, 1.0, k).astype(np.float32),      # opacities
        ]

    def total(fields):
        return int(fields[6].astype(np.int64).sum())

    rects = small_rects(n)
    empty = np.zeros(n, dtype=bool)
    empty[:40] = empty[-40:] = True
    at = 100
    for run in (1, 5, 31, 32, 33, 64, 100):
        empty[at:at + run] = True
        at += run + 37
    rects[empty, 2:] = rects[empty, :2]
    fields = scene(rects)
    yield "no tiles at both ends and in runs", fields, total(fields) + 1000

    rects = small_rects(n)
    rects[n // 2] = (0, 0, grid_x, grid_y)
    fields = scene(rects)
    yield "one gaussian over every tile", fields, total(fields) + 500
    start = int(fields[6][: n // 2].astype(np.int64).sum())
    yield ("max_pairs in the middle of a rect row", fields,
           start + 3 * grid_x + 5)

    rects = small_rects(n)
    rects[-2:] = (0, 0, 2**15, 2**15)  # 2^30 tiles each
    fields = scene(rects)
    yield ("a saturated total", fields,
           int(fields[6][:-2].astype(np.int64).sum()) + 3000)

    rects = small_rects(64)
    rects[:, 2:] = rects[:, :2]
    yield "no tile at all", scene(rects), 5000


def check_adversarial_fanouts(name, dev):
    """K1 on ``adversarial_fanouts``, with the cull off and on, bit for bit
    against the plain expansion (``compare_expansion``); the total
    saturates where it must."""
    import torch

    from luisacomputegaussiansplatting_tpu_torch import RenderConfig
    from luisacomputegaussiansplatting_tpu_torch.ops.projection import ProjectedGaussians

    gx, gy = 120, 68
    cfg = RenderConfig()
    for tag, fields, max_pairs in adversarial_fanouts(gx, gy):
        proj = ProjectedGaussians(*(torch.from_numpy(f).to(dev)
                                    for f in fields[:8]))
        op = torch.from_numpy(fields[8]).to(dev)
        total = int(fields[6].astype("int64").sum())
        for cull in (False, True):
            k, _ = compare_expansion(proj, gx, gx * gy, max_pairs,
                                     op if cull else None, 16, cfg)
            want = min(total, 2**31 - 1)
            check(int(k[3]) == want, f"{name} {tag}: total {int(k[3])} != "
                                     f"{want}")
            kept = int((k[2] >= 0).sum())
            log(f"{name} expansion {tag} cull={cull}: identical to plain; "
                f"{fields[0].shape[0]} gaussians, total {int(k[3])}, "
                f"max_pairs {max_pairs}, kept {kept}")


#: phase 1: the grids of tests/test_torch_binning.py's fused-sort cases,
#: (tiles, whether "fused" falls back to "2key"), and the means of
#: tests/test_torch_projection.py's near cull (z = 0.1 and behind the
#: camera culled; two at exactly ``near`` kept)
FUSED_GRIDS = ((1 << 22, True), ((1 << 19) - 1, False))
NEAR_MEANS = ((0, 0, 0.1), (0, 0, 0.25), (0, 0, -2.0), (0, 0, 3.0),
              (0, 0, 0.2), (0.01, 0.02, 0.2))


def check_sort_and_near_cull(name, dev):
    """The fused sort's fallback and threshold cases and the projection's
    near cull on the card against the same calls on the CPU: the sorted
    (tile, gid) equal exactly (``torch.sort`` on the card is another
    code), the cull's decisions equal and the radii within 1
    (``tests/test_projection.py``'s ceil boundaries)."""
    import numpy as np
    import torch

    from luisacomputegaussiansplatting_tpu_torch import RenderConfig, look_at_camera
    from luisacomputegaussiansplatting_tpu_torch.ops.binning import _sort_entries
    from luisacomputegaussiansplatting_tpu_torch.ops.projection import project_gaussians

    n = 4096
    for num_tiles, falls_back in FUSED_GRIDS:
        rng = np.random.default_rng(3)
        cpu = [torch.from_numpy(x) for x in (
            rng.integers(0, num_tiles, n).astype(np.int32),
            rng.uniform(0.2, 30.0, n).astype(np.float32),
            np.arange(n, dtype=np.int32))]
        card = [x.to(dev) for x in cpu]
        want = _sort_entries(*cpu, num_tiles, "fused")
        got = _sort_entries(*card, num_tiles, "fused")
        two = _sort_entries(*card, num_tiles, "2key")
        check(all(torch.equal(a.cpu(), b) for a, b in zip(got, want)),
              f"{name}: the fused sort of {num_tiles} tiles differs from "
              "the CPU's")
        check(torch.equal(got[1], two[1]) == falls_back,
              f"{name}: the fused sort of {num_tiles} tiles "
              f"{'does not fall' if falls_back else 'falls'} back to 2key")
        log(f"{name}: fused sort of {n} entries over {num_tiles} tiles equal "
            f"to the CPU's, {'the' if falls_back else 'not the'} 2-key order")

    means = torch.tensor(NEAR_MEANS, dtype=torch.float32)
    scales = torch.full(means.shape, 0.05)
    quats = torch.tensor([[0.0, 0.0, 0.0, 1.0]]).repeat(means.shape[0], 1)
    cam = look_at_camera((0, 0, 0), (0, 0, 1), (0, 1, 0), width=64,
                         height=64)
    with torch.no_grad():
        want = project_gaussians(means, scales, quats, cam, RenderConfig())
        got = project_gaussians(means.to(dev), scales.to(dev),
                                quats.to(dev), cam, RenderConfig())
    r_card, r_cpu = got.radius.cpu(), want.radius
    log(f"{name}: near cull, radii card {r_card.tolist()} CPU "
        f"{r_cpu.tolist()}, valid card {got.valid.cpu().tolist()} CPU "
        f"{want.valid.tolist()}")
    check(torch.equal(got.valid.cpu(), want.valid)
          and torch.equal(r_card > 0, r_cpu > 0)
          and int((r_card - r_cpu).abs().max()) <= 1
          and want.valid.tolist() == [False, True, False, True, True, True],
          f"{name}: the near cull differs from the CPU's")


def forward_instances(tile_w, tile_h):
    """The pixels a thread at which K2 can blend a tile: those that make
    whole warps."""
    from luisacomputegaussiansplatting_tpu_torch.ops.rasterize import FORWARD_PIXELS_PER_THREAD

    return [per for per in FORWARD_PIXELS_PER_THREAD
            if per == 1 or (tile_w * tile_h) % (32 * per) == 0]


def blend_digest(color, trans):
    """sha256 (first 16 hex digits) of a forward blend's colour and T
    bytes, to compare two builds of K2 bit for bit across processes."""
    import hashlib

    h = hashlib.sha256(color.contiguous().cpu().numpy().tobytes())
    h.update(trans.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def tensor_digest(t):
    """sha256 (first 16 hex digits) of a tensor's float32 values, with 0.0
    added first: -0.0 and +0.0 digest alike (a sum into a zero-filled
    buffer turns a lone -0.0 into +0.0)."""
    import hashlib

    v = (t.detach().float() + 0.0).contiguous().cpu().numpy()
    return hashlib.sha256(v.tobytes()).hexdigest()[:16]


#: the ops a full-size zero-filled cotangent per column runs as: each
#: ``aten::select_backward`` fills a buffer the size of its input (fill_)
#: and writes its column (copy_); the engine adds the buffers (add_)
COTANGENT_OPS = ("aten::add_", "aten::fill_", "aten::copy_")


def op_sums(prof):
    """Device ms of a ``FrameProfile``: the self time of add_, fill_ and
    copy_, and the whole time of what select_backward ran."""
    self_ms = {name: ms for name, ms, _ in prof.ops}
    out = {op.split("::")[1]: self_ms.get(op, 0.0) for op in COTANGENT_OPS}
    out["select_backward"] = sum(ms for name, ms, _ in prof.totals
                                 if name == "aten::select_backward")
    return out


def log_op_sums(tag, prof):
    sums = op_sums(prof)
    log(f"{tag}: device ms add_ {sums['add_']:.3f}, fill_ "
        f"{sums['fill_']:.3f}, copy_ {sums['copy_']:.3f} (sum "
        f"{sums['add_'] + sums['fill_'] + sums['copy_']:.3f}); ops born of "
        f"select_backward {sums['select_backward']:.3f}")
    return sums


def forward_variants(tag, payload, ranges, gx, gy, w, h, cfg, color, trans,
                     plain, reps):
    """K2 at every number of pixels a thread that the tile admits: each the
    same bits as the wrapper's ``color``/``trans``, within BLEND_TOL of the
    plain forward ``plain`` (colour, T), and, where ``reps``, timed. Logs
    the times beside the wrapper's choice; returns {pixels a thread: ms}."""
    import torch

    from luisacomputegaussiansplatting_tpu_torch.ops.rasterize import _launch_forward, forward_launch_shape

    tw, th = cfg.tile_wh
    times = {}
    for per in forward_instances(tw, th):

        def launch(per=per):
            return _launch_forward(payload, *ranges, gx, w, h, cfg, per)

        with torch.no_grad():
            ck, tk = launch()
            check(torch.equal(ck, color) and torch.equal(tk, trans),
                  f"{tag}: K2 at {per} px/thread differs from the wrapper's "
                  "bits")
            check_blend(f"{tag} {per} px/thread",
                        *blend_diff(ck, tk, *plain, gx, gy, w, h, cfg.tile_wh))
            if reps:
                times[per] = cuda_ms(launch, reps)
    timed = "".join(f"; {p} px/thread {ms:.3f} ms" for p, ms in times.items())
    log(f"{tag}: forward blend {cfg.blend_quad} instances "
        f"{forward_instances(tw, th)} bit-identical{timed}; the wrapper "
        f"takes {forward_launch_shape(tw, th)[1]}")
    return times


def phase1(dev, blend="vpu", name="phase1"):
    import torch

    from luisacomputegaussiansplatting_tpu_torch.ops.binning import bin_gaussians, bin_gaussians_nopack
    from luisacomputegaussiansplatting_tpu_torch.ops.rasterize import rasterize_forward
    from luisacomputegaussiansplatting_tpu_torch.ops.rasterize_ref import rasterize_reference

    if blend == "vpu":
        check_adversarial_fanouts(name, dev)
        check_sort_and_near_cull(name, dev)
    for tag, cfg, cam, scene in test_scenes(dev, blend):
        tag = f"{name} {tag}"
        w, h = cam.width, cam.height
        proj, (gx, gy), bk, payload = bin_and_payload(scene, cam, cfg)
        with torch.no_grad():
            cull_op = scene.opacities if cfg.tile_cull else None
            k, _ = compare_expansion(proj, gx, gx * gy, cfg.max_pairs,
                                     cull_op, cfg.tile_wh, cfg)
            binner = bin_gaussians if cfg.pack_mode == "chunk" else bin_gaussians_nopack
            bp = binner(proj, gx, gy, cfg.max_pairs, cull_op, cfg.tile_wh,
                        cfg.alpha_min, expansion="xla")
            for f in bk._fields:
                check(torch.equal(getattr(bk, f), getattr(bp, f)),
                      f"{tag}: binning {f} differs kernel vs plain")
            check(not bool(bk.overflow), f"{tag}: overflow")
            ck, tk = rasterize_forward(payload, bk.tile_starts,
                                       bk.tile_counts, gx, w, h, cfg)
            cp, tp = rasterize_reference(payload, bk.tile_starts,
                                         bk.tile_counts, gx, w, h, cfg)
            torch.cuda.synchronize()
        log(f"{tag}: expansion identical, total={int(k[3])} "
            f"num_rendered={int(bk.num_rendered)}")
        check_blend(tag, *blend_diff(ck, tk, cp, tp, gx, gy, w, h,
                                     cfg.tile_wh))
        forward_variants(tag, payload, (bk.tile_starts, bk.tile_counts), gx,
                         gy, w, h, cfg, ck, tk, (cp, tp), 0)


def run_render_cli(argv):
    """``render_cli.main(argv)`` in-process: (rc, stdout, stderr)."""
    from luisacomputegaussiansplatting_tpu_torch.apps import render_cli

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = render_cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


def bench_scene_ply():
    """The 2M bench scene (``bench_cuda``'s) saved as a PLY under
    build/chip_smoke; returns its path."""
    from luisacomputegaussiansplatting_tpu_torch import random_scene, save_ply

    path = os.path.join(ROOT, "build", "chip_smoke", "bench2m.ply")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    t0 = time.perf_counter()
    save_ply(random_scene(2_000_000, seed=0, extent=3.0,
                          scale_range=(0.004, 0.02), device="cpu"), path)
    log(f"phase2: the 2M bench scene saved as a PLY "
        f"({os.path.getsize(path) / 2**20:.0f} MiB) in "
        f"{time.perf_counter() - t0:.2f} s")
    return path


def phase2(card):
    out_dir = os.path.join(ROOT, "build", "chip_smoke")
    rc, out, err = run_render_cli([
        "--synthetic", "200000", "--res", "1600x1063", "--exp_N", "3",
        "--max-pairs", "16000000", "--out", out_dir,
    ])
    for line in out.splitlines():
        log(f"phase2 cli: {line}")
    check(rc == 0, f"render_cli returned {rc}")
    check("overflow" not in err, f"render_cli: {err}")
    check("num_rendered:" in out and "rep_ms:" in out,
          "render_cli printed no num_rendered / rep_ms line")
    # the strict row: the 2M bench scene from its PLY (the native loader),
    # the bench camera, the strict defaults and the reference's L = 20M
    rc, out, err = run_render_cli([
        "--ply", bench_scene_ply(), "--res", "1920x1080", "--world",
        "blender", "--cam-pos", "3.5,-3.0,2.2", "--cam-target", "0,0,0",
        "--fov", "65", "--exp_N", "3", "--max-pairs", "20000000",
        "--out", out_dir,
    ])
    for line in out.splitlines():
        log(f"phase2 strict 2M cli: {line}")
    check(rc == 0, f"render_cli (strict 2M) returned {rc}")
    check("overflow" not in err, f"render_cli (strict 2M): {err}")
    rep = [ln for ln in out.splitlines() if ln.startswith("rep_ms:")]
    check(len(rep) == 1, "render_cli (strict 2M) printed no rep_ms line")
    log(f"phase2 strict 2M at max_pairs 20M, no overflow: {rep[0]} [{card}]")


def headline(dev):
    """Phase 3 and 5's configuration: (scene, camera, cfg)."""
    from luisacomputegaussiansplatting_tpu_torch import RenderConfig, look_at_camera, random_scene

    # numpy-RNG realisation of the JAX bench.py headline scene (bench.py
    # draws it with jax.random: same distributions, other numbers)
    scene = random_scene(2_000_000, seed=0, extent=3.0,
                         scale_range=(0.004, 0.02), device=dev)
    cam = look_at_camera((3.5, -3.0, 2.2), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0),
                         fov=65.0, width=1920, height=1080)
    return scene, cam, RenderConfig(max_pairs=16_000_000)


def phase3(dev):
    import torch

    from luisacomputegaussiansplatting_tpu_torch.ops.binning import bin_gaussians, expand_entries
    from luisacomputegaussiansplatting_tpu_torch.ops.expand import expand_entries_kernel
    from luisacomputegaussiansplatting_tpu_torch.ops.rasterize import rasterize_forward
    from luisacomputegaussiansplatting_tpu_torch.ops.rasterize_ref import rasterize_reference
    from luisacomputegaussiansplatting_tpu_torch.ops.render import _tiles_to_image, render_aux

    scene, cam, cfg = headline(dev)
    w, h = cam.width, cam.height
    args = scene.render_args()

    with torch.no_grad():
        # the main path, with the launch counts taken over exactly this run
        reset_launches()
        img, aux = render_aux(*args, cam, cfg=cfg)
        torch.cuda.synchronize()
        launches = read_launches()
        check_launches("phase3 main path", launches, expand=1,
                       rasterize_vpu=1)
        check(not bool(aux.overflow), "phase3: overflow")
        check(tuple(img.shape) == (3, h, w), f"image shape {tuple(img.shape)}")
        check(bool(torch.isfinite(img).all()), "non-finite image")
        num_rendered = int(aux.num_rendered)
        check(num_rendered > 0, "nothing rendered")

        # the stages again, kernel against plain, on the same card
        proj, (gx, gy), bp, payload = bin_and_payload(scene, cam, cfg,
                                                      expansion="xla")
        nt = gx * gy
        k, k1_err = compare_expansion(proj, gx, nt, cfg.max_pairs, None,
                                      cfg.tile_wh, cfg)
        aabb_total = int(k[3])
        bk = bin_gaussians(proj, gx, gy, cfg.max_pairs, None, cfg.tile_wh,
                           cfg.alpha_min, expansion="auto")
        for f in bk._fields:
            check(torch.equal(getattr(bk, f), getattr(bp, f)),
                  f"phase3: binning {f} differs kernel vs plain")
        check(int(bk.num_rendered) == num_rendered,
              "phase3: num_rendered differs from the main path")
        ck, tk = rasterize_forward(payload, bp.tile_starts, bp.tile_counts,
                                   gx, w, h, cfg)
        cp, tp = rasterize_reference(payload, bp.tile_starts, bp.tile_counts,
                                     gx, w, h, cfg)
        blend = blend_diff(ck, tk, cp, tp, gx, gy, w, h, cfg.tile_wh)
        check_blend("phase3", *blend)
        digest = blend_digest(ck, tk)
        log(f"phase3: K2 digest {digest}")
        check(digest == K2_DIGESTS["phase3"],
              f"phase3: K2 digest {digest} != {K2_DIGESTS['phase3']}")
        forward_variants(
            "phase3", payload, (bp.tile_starts, bp.tile_counts), gx, gy, w,
            h, cfg, ck, tk, (cp, tp), 5)
        # the main-path image against the all-plain one
        img_p, t_p = _tiles_to_image(cp, tp, gx, gy, w, h, cfg.tile_wh)
        d = torch.maximum((img - img_p).abs().amax(dim=0),
                          (aux.transmittance - t_p).abs())
        check_blend("phase3 frame", float(d.max()), int((d > TOL).sum()),
                    w * h)

        reps = 5
        k1_ms = cuda_ms(lambda: expand_entries_kernel(
            proj, gx, nt, cfg.max_pairs, None, cfg.tile_wh, cfg.alpha_min), reps)
        k1_split = expansion_split(proj, gx, nt, cfg.max_pairs, None, cfg)
        k1_plain = cuda_ms(lambda: expand_entries(
            proj, gx, nt, cfg.max_pairs, None, cfg.tile_wh, cfg.alpha_min), reps)
        k2_ms = cuda_ms(lambda: rasterize_forward(
            payload, bp.tile_starts, bp.tile_counts, gx, w, h, cfg), reps)
        k2_plain = cuda_ms(lambda: rasterize_reference(
            payload, bp.tile_starts, bp.tile_counts, gx, w, h, cfg), 2)

        render_aux(*args, cam, cfg=cfg)  # warm-up
        frames = []
        for _ in range(5):
            frames.append(timed_once(lambda: render_aux(*args, cam,
                                                        cfg=cfg))[1])
        peak = torch.cuda.max_memory_allocated() / 2**30
        evaluated, applied = pair_counts(payload, bp.tile_starts,
                                         bp.tile_counts, gx, w, h, cfg)
        k2_dev = device_ms(lambda: rasterize_forward(
            payload, bp.tile_starts, bp.tile_counts, gx, w, h, cfg))

    frame_ms = statistics.median(frames)
    log(f"phase3: 2M gaussians 1920x1080 strict-parity: aabb_total={aabb_total} "
        f"num_rendered={num_rendered} capacity={payload.shape[1]}")
    log(f"phase3: frame_ms median of 5 = {frame_ms:.3f} "
        f"(all: {' '.join(f'{v:.3f}' for v in frames)}); peak mem {peak:.2f} GiB")
    log(f"phase3: expansion kernel {k1_ms:.3f} ms (device time: prefix "
        f"sums {k1_split[0]:.3f}, the kernel alone {k1_split[1]:.3f}) vs "
        f"plain {k1_plain:.3f} ms; blend kernel {k2_ms:.3f} ms (device time "
        f"{k2_dev:.3f}) vs plain {k2_plain:.3f} ms")
    log(f"phase3: blend pairs evaluated {evaluated} applied {applied}")

    # bounds from this run's inputs: each input read once, each output
    # written once; the slots the ranges use of the payload
    used = used_slots(bp)
    n_g = scene.means.shape[0]
    k1_bytes = n_g * 28 + cfg.max_pairs * 12  # ends, rects, depth -> 3 x 4 B
    k1_bound = bound(k1_bytes, cfg.max_pairs * n_g.bit_length())
    pix = cfg.tile_wh[0] * cfg.tile_wh[1]
    k2_bytes = used * 9 * 4 + nt * 8 + nt * pix * 16
    k2_bound = bound(k2_bytes, evaluated * OPS_PER_PAIR["vpu"]
                     + applied * OPS_PER_APPLIED["forward"])
    context = dict(scene=scene, cam=cam, cfg=cfg, pairs=(evaluated, applied),
                   used=used)
    return [
        {"name": "expand_entries", "route": "cuda",
         "source": f"{PKG}/expand.cu",
         "replaces": f"{JAX_OPS}/expand_pallas.py:137",
         "launches": launches["expand"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound[0],
         "bound_by": k1_bound[1], "library_ms": None},
        {"name": "rasterize_forward", "route": "cuda",
         "source": f"{PKG}/rasterize.cu",
         "replaces": f"{JAX_OPS}/rasterize_pallas.py:282",
         "launches": launches["rasterize_vpu"], "max_abs_err": blend[0],
         "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound[0],
         "bound_by": k2_bound[1], "library_ms": None},
    ], context


def expansion_split(proj, gx, nt, max_pairs, cull_op, cfg):
    """(device ms of ``prefix_sums``, device ms of K1's launch on its
    output): the expansion wrapper's two parts timed apart (``device_ms``),
    the second the kernel alone."""
    from luisacomputegaussiansplatting_tpu_torch.ops.expand import _launch_expand, prefix_sums

    _, ends, total_f = prefix_sums(proj.tiles_touched)
    return (device_ms(lambda: prefix_sums(proj.tiles_touched)),
            device_ms(lambda: _launch_expand(ends, total_f, proj, gx, nt,
                                             max_pairs, cull_op, cfg.tile_wh,
                                             cfg.alpha_min)))


def random_residual(color, trans, seed):
    """[dL/dC, dL/dT, C_final, T_final] with normal cotangents drawn on the
    device from ``seed`` and the forward's own C and T."""
    import torch

    from luisacomputegaussiansplatting_tpu_torch.ops.rasterize import make_residual

    gen = torch.Generator(device=color.device).manual_seed(seed)
    d_color = torch.randn(color.shape, generator=gen, device=color.device)
    d_trans = torch.randn(trans.shape, generator=gen, device=color.device)
    return make_residual(d_color, d_trans, color, trans)


def backward_stages(tag, payload, binned, residual, gx, w, h, cfg, n_out):
    """The backward blend kernel (twice: same bits in every slot it writes,
    those of the tile ranges) against the plain backward, then the
    segment-sum kernel in f32 and bf16 (twice each) against index_add_, on
    the kernel's own per-entry gradient. Returns the kernel outputs and the
    measured errors."""
    import torch

    from luisacomputegaussiansplatting_tpu_torch.ops.rasterize import rasterize_backward
    from luisacomputegaussiansplatting_tpu_torch.ops.rasterize_ref import rasterize_backward_reference
    from luisacomputegaussiansplatting_tpu_torch.ops.segsum import reduce_fields_by_id, segment_sum_reference

    ranges = (binned.tile_starts, binned.tile_counts)
    dk = rasterize_backward(payload, *ranges, residual, gx, w, h, cfg)
    dk2 = rasterize_backward(payload, *ranges, residual, gx, w, h, cfg)
    dp, plain_ms = timed_once(lambda: rasterize_backward_reference(
        payload, *ranges, residual, gx, w, h, cfg))
    used = used_slots(binned)
    check(torch.equal(dk[:, :used], dk2[:, :used]),
          f"{tag}: backward blend kernel is not deterministic (two runs "
          "differ)")
    fields = ("mx", "my", "ca", "cb", "cc", "op", "r", "g", "b")
    err = check_fields(tag, "d_payload", dk.t(), dp.t(), fields,
                       rows=binned.entry_gid >= 0)
    b2_abs = float((dk[:, :used] - dp[:, :used]).abs().max())
    out = {"b2": (dk, dp, b2_abs, err, plain_ms)}
    for dtype in ("f32", "bf16"):
        s1 = reduce_fields_by_id(binned.entry_gid, dk, n_out, dtype)
        s2 = reduce_fields_by_id(binned.entry_gid, dk, n_out, dtype)
        check(torch.equal(s1, s2), f"{tag}: segment-sum {dtype} kernel is not "
                                   "deterministic (two runs differ)")
        sp = segment_sum_reference(binned.entry_gid, dk.t(), n_out, dtype)
        abs_err, rel = check_sums(f"{tag} segsum {dtype}", s1, sp)
        out[dtype] = (s1, sp, abs_err, rel)
    key = torch.where(binned.entry_gid >= 0, binned.entry_gid,
                      torch.full_like(binned.entry_gid, n_out))
    check_starts(tag, torch.sort(key, stable=True)[0], n_out)
    log(f"{tag}: backward blend same bits twice, max|d|={b2_abs:.3e} "
        f"(rel {err:.2e}); segment-sum same bits twice, f32 max|d|/max|sum|="
        f"{out['f32'][3]:.2e} bf16 {out['bf16'][3]:.2e}; starts identical")
    return out


def check_starts(tag, sorted_ids, n_out):
    """The segment-sum's first pass against its plain version, bit for
    bit."""
    import torch

    from luisacomputegaussiansplatting_tpu_torch.ops.segsum import segment_starts_kernel, segment_starts_reference

    got = segment_starts_kernel(sorted_ids, n_out)
    want = segment_starts_reference(sorted_ids, n_out)
    check(torch.equal(got, want), f"{tag}: segment starts kernel != plain in "
                                  f"{int((got != want).sum())} of {n_out + 1}")


def adversarial_segments(dev):
    """(tag, ascending int32 ids, (L, 9) rows, n_out) that the frames do not
    reach: one id with 100K rows amid singletons, ids with no rows at both
    ends, ids -1 and >= n_out with NaN rows, n_out = 1, every row dropped,
    no rows. Rows alternate between a field-major view (the backward's
    layout) and row-major."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(11)

    def randint(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev,
                             dtype=torch.int32)

    cases = [
        ("one id of 100K rows amid 100K singletons", torch.cat([
            torch.arange(0, 200_000, 2, dtype=torch.int32, device=dev),
            torch.full((100_000,), 123_457, dtype=torch.int32, device=dev)]),
         300_000),
        ("no rows for ids [0, 400K) and [600K, 1M)",
         randint(400_000, 600_000, 300_000), 1_000_000),
        ("ids -1 and >= n_out with NaN rows", randint(-1, 50_003, 200_000),
         50_000),
        ("n_out = 1", randint(-1, 3, 5_000), 1),
        ("every row dropped", randint(1_000, 1_010, 5_000), 1_000),
        ("no rows", randint(0, 1, 0), 1_000),
    ]
    for i, (tag, ids, n_out) in enumerate(cases):
        ids = torch.sort(ids)[0]
        # positive rows: a sum of one sign, so SUM_TOL measures the
        # kernel's rounding and not the cancellation of a random walk
        rows = torch.rand((9, ids.shape[0]), generator=gen, device=dev) + 0.5
        rows[:, (ids < 0) | (ids >= n_out)] = float("nan")
        yield tag, ids, (rows.t() if i % 2 == 0 else rows.t().contiguous()), n_out


def float64_sums(ids, rows, n_out, dtype):
    """``segment_sum_reference`` with ``index_add_`` in float64: the rows as
    the reduction adds them (bf16-rounded for "bf16"), summed with no
    rounding that SUM_TOL could see. A float32 ``index_add_`` over one id's
    100K rows is itself ~2e-5 of the sum off."""
    import torch

    from luisacomputegaussiansplatting_tpu_torch.ops.segsum import _round_rows

    keep = (ids >= 0) & (ids < n_out)
    key = torch.where(keep, ids, torch.full_like(ids, n_out)).to(torch.int64)
    vals = torch.where(keep[:, None], _round_rows(rows, dtype), 0.0)
    out = torch.zeros((n_out + 1, rows.shape[1]), dtype=torch.float64,
                      device=rows.device)
    return out.index_add_(0, key, vals.double())[:n_out].float()


def check_adversarial_segments(name, dev):
    """K4 in both row types on ``adversarial_segments``: the same bits
    twice, within SUM_TOL of index_add_ (in float64), and its first pass
    identical to the plain one."""
    import torch

    from luisacomputegaussiansplatting_tpu_torch.ops.segsum import segment_starts_reference, segment_sum_kernel

    for tag, ids, rows, n_out in adversarial_segments(dev):
        tag = f"{name} segsum {tag}"
        check_starts(tag, ids, n_out)
        longest = int(segment_starts_reference(ids, n_out).diff().max())
        parts = []
        for dtype in ("f32", "bf16"):
            s1 = segment_sum_kernel(ids, rows, n_out, dtype)
            s2 = segment_sum_kernel(ids, rows, n_out, dtype)
            check(torch.equal(s1, s2), f"{tag}: {dtype} kernel is not "
                                       "deterministic (two runs differ)")
            _, rel = check_sums(f"{tag} {dtype}", s1,
                                float64_sums(ids, rows, n_out, dtype))
            parts.append(f"{dtype} max|d|/max|sum| {rel:.2e}")
        torch.cuda.synchronize()
        log(f"{tag}: rows {ids.shape[0]}, n_out {n_out}, longest segment "
            f"{longest}; starts identical, same bits twice, {'; '.join(parts)}")


def backward_variants(tag, payload, binned, residual, gx, w, h, cfg, dp,
                      reps):
    """K3 at every number of pixels a thread that the tile admits, each
    held to GRAD_TOL of the plain backward ``dp`` and timed; logs the
    times beside the wrapper's choice and returns {pixels a thread: ms}."""
    import torch

    from luisacomputegaussiansplatting_tpu_torch.ops.rasterize import BACKWARD_PIXELS_PER_THREAD, _launch_backward, backward_launch_shape

    tw, th = cfg.tile_wh
    ranges = (binned.tile_starts, binned.tile_counts)
    fields = ("mx", "my", "ca", "cb", "cc", "op", "r", "g", "b")
    times = {}
    for per in BACKWARD_PIXELS_PER_THREAD:
        if (tw * th) % (32 * per):
            continue

        def launch(per=per):
            return _launch_backward(payload, *ranges, residual, gx, w, h,
                                    cfg, per)

        with torch.no_grad():
            check_fields(f"{tag} {per} px/thread", "d_payload", launch().t(),
                         dp.t(), fields, rows=binned.entry_gid >= 0)
            times[per] = cuda_ms(launch, reps)
    chosen = backward_launch_shape(tw, th)[1]
    log(f"{tag}: backward blend {cfg.blend_quad} by pixels a thread: "
        + ", ".join(f"{p}: {ms:.3f} ms" for p, ms in times.items())
        + f"; the wrapper takes {chosen}")
    return times


def phase4(dev, blend="vpu", name="phase4"):
    import torch

    from luisacomputegaussiansplatting_tpu_torch.ops.rasterize import rasterize_forward

    check_adversarial_segments(name, dev)
    for i, (tag, cfg, cam, scene) in enumerate(test_scenes(dev, blend)):
        tag = f"{name} {tag}"
        w, h = cam.width, cam.height
        _proj, (gx, _gy), binned, payload = bin_and_payload(scene, cam, cfg)
        with torch.no_grad():
            color, trans = rasterize_forward(payload, binned.tile_starts,
                                             binned.tile_counts, gx, w, h, cfg)
            residual = random_residual(color, trans, seed=i)
            backward_stages(tag, payload, binned, residual, gx, w, h, cfg,
                            scene.means.shape[0])
            torch.cuda.synchronize()


def grad_leaves(scene):
    return [t.detach().clone().requires_grad_(True)
            for t in scene.render_args()]


def phase5(dev, ctx):
    import torch

    from luisacomputegaussiansplatting_tpu_torch.models import TrainConfig, init_train_state, make_train_step
    from luisacomputegaussiansplatting_tpu_torch.ops.projection import project_gaussians
    from luisacomputegaussiansplatting_tpu_torch.ops.rasterize import make_residual, rasterize_backward, rasterize_forward
    from luisacomputegaussiansplatting_tpu_torch.ops.rasterize_ref import rasterize_reference
    from luisacomputegaussiansplatting_tpu_torch.ops.render import _tiles_to_image, payload_table, render_aux
    from luisacomputegaussiansplatting_tpu_torch.ops.segsum import segment_sum_kernel, segment_sum_reference
    from luisacomputegaussiansplatting_tpu_torch.ops.sh_eval import compute_colors
    from luisacomputegaussiansplatting_tpu_torch.utils.profiling import fwd_bwd_frame as fwd_bwd

    scene, cam, cfg = ctx["scene"], ctx["cam"], ctx["cfg"]
    w, h = cam.width, cam.height
    cfg16 = dataclasses.replace(cfg, grad_reduce_dtype="bf16")
    leaves = grad_leaves(scene)
    bg = torch.zeros(3, device=dev, requires_grad=True)
    names = ("means", "scales", "quats", "opacities", "sh", "bg")

    # the differentiable paths, each with the launch counts over exactly it:
    # one frame launches each kernel of its path once, and only its own
    # segment-sum variant
    one = {"expand": 1, "rasterize_vpu": 1, "rasterize_backward_vpu": 1}
    reset_launches()
    loss, grads, aux = fwd_bwd(leaves, bg, cam, cfg)
    torch.cuda.synchronize()
    launches = read_launches()
    check_launches("phase5 f32 frame", launches, **one, segsum_f32=1)
    reset_launches()
    _loss16, grads16, _ = fwd_bwd(leaves, bg, cam, cfg16)
    torch.cuda.synchronize()
    launches16 = read_launches()
    check_launches("phase5 bf16-reduce frame", launches16, **one,
                   segsum_bf16=1)
    check(not bool(aux.overflow), "phase5: overflow")
    check(bool(torch.isfinite(loss)), "phase5: non-finite loss")
    for name, g, leaf in zip(names, grads, [*leaves, bg]):
        check(g.shape == leaf.shape and bool(torch.isfinite(g).all()),
              f"phase5: gradient of {name} is not finite or mis-shaped")
        check(float(g.abs().max()) > 0, f"phase5: zero gradient of {name}")

    # stage by stage: the same frame with plain versions
    with torch.no_grad():
        proj, (gx, gy), binned, payload = bin_and_payload(scene, cam, cfg)
        color, trans = rasterize_forward(payload, binned.tile_starts,
                                         binned.tile_counts, gx, w, h, cfg)
    c_leaf = color.requires_grad_(True)
    t_leaf = trans.requires_grad_(True)
    img_c, img_t = _tiles_to_image(c_leaf, t_leaf, gx, gy, w, h, cfg.tile_wh)
    d_color, d_trans = torch.autograd.grad(
        (img_c + bg.detach()[:, None, None] * img_t[None]).sum(),
        [c_leaf, t_leaf])
    with torch.no_grad():
        residual = make_residual(d_color, d_trans, color.detach(),
                                 trans.detach())
        st = backward_stages("phase5", payload, binned, residual, gx, w, h,
                             cfg, scene.means.shape[0])
    dk, dp, b2_abs, _b2_rel, b2_plain = st["b2"]

    # the five groups' gradients through the all-plain backward
    n = scene.means.shape[0]
    with torch.no_grad():
        d_table = segment_sum_reference(binned.entry_gid, dp.t(), n)
    colors = compute_colors(leaves[0], leaves[4], cam.position)
    proj_g = project_gaussians(leaves[0], leaves[1], leaves[2], cam, cfg)
    table = payload_table(proj_g, colors, leaves[3])
    plain = list(torch.autograd.grad(table, leaves, grad_outputs=d_table,
                                     allow_unused=True, retain_graph=True))
    plain = [torch.zeros_like(l) if g is None else g
             for g, l in zip(plain, leaves)]
    with torch.no_grad():
        t_img = _tiles_to_image(color, trans, gx, gy, w, h, cfg.tile_wh)[1]
        plain.append(t_img.sum().expand(3).clone())  # dL/dbg = sum T
        for name, g, p in zip(names, grads, plain):
            check_fields("phase5", "gradient", g.reshape(-1, 1),
                         p.reshape(-1, 1), [name])
        for name, g32, g16 in zip(names, grads, grads16):
            rel = float((g32 - g16).abs().max() / (g32.abs().max() + 1e-30))
            log(f"phase5: grad {name} bf16 reduce vs f32: max|d|/max {rel:.2e}")
            check(rel <= 2e-2, f"phase5: bf16 reduce gradient of {name} "
                               f"is {rel:.2e} off the f32 one")

    # times of the kernels and their plain versions at the frame's shapes
    reps = 5
    ranges = (binned.tile_starts, binned.tile_counts)
    with torch.no_grad():
        plain_fwd = rasterize_reference(payload, *ranges, gx, w, h, cfg)
    forward_variants("phase5", payload, ranges, gx, gy, w, h, cfg, color,
                     trans, plain_fwd, reps)
    del plain_fwd
    backward_variants("phase5", payload, binned, residual, gx, w, h, cfg, dp,
                      reps)
    with torch.no_grad():
        b2_ms = cuda_ms(lambda: rasterize_backward(
            payload, *ranges, residual, gx, w, h, cfg), reps)
        key = torch.where(binned.entry_gid >= 0, binned.entry_gid,
                          torch.full_like(binned.entry_gid, n))
        (sorted_key, perm), sort_ms = timed_once(
            lambda: torch.sort(key, stable=True))
        rows, gather_ms = timed_once(lambda: dk[:, perm])
        rows_t = rows.t()
        n_valid = int((sorted_key < n).sum())
        seg = {}
        for dtype in ("f32", "bf16"):
            ms = cuda_ms(lambda: segment_sum_kernel(sorted_key, rows_t, n,
                                                    dtype), reps)
            plain_ms = cuda_ms(lambda: segment_sum_reference(
                sorted_key, rows_t, n, dtype), reps)
            lib_rows = torch.where((sorted_key < n)[:, None],
                                   rows_t if dtype == "f32" else
                                   rows_t.to(torch.bfloat16).float(), 0.0)
            key64 = sorted_key.to(torch.int64)
            acc = torch.zeros((n + 1, 9), device=dev)
            lib_ms = cuda_ms(lambda: acc.index_add_(0, key64, lib_rows), reps)
            seg[dtype] = (ms, plain_ms, lib_ms)
        d_table_k = segment_sum_kernel(sorted_key, rows_t, n, "f32")
    _, vjp_ms = timed_once(lambda: torch.autograd.grad(
        table, leaves, grad_outputs=d_table_k, allow_unused=True))

    # the differentiable frame: median of 5 chained reps (rep i's bg hangs
    # on rep i-1's loss, bench.py:133-140)
    with torch.no_grad():
        render_aux(*leaves, cam, cfg=cfg)  # warm-up after the VJPs
        fwd_ms = statistics.median(
            timed_once(lambda: render_aux(*leaves, cam, cfg=cfg))[1]
            for _ in range(3))
    torch.cuda.reset_peak_memory_stats()
    val = loss
    fwd_bwd(leaves, bg, cam, cfg)  # warm-up
    frames = []
    for _ in range(5):
        bg_i = (bg.detach() + val * 1e-20).requires_grad_(True)
        (val, _g, _a), ms = timed_once(lambda: fwd_bwd(leaves, bg_i, cam, cfg))
        frames.append(ms)
    peak = torch.cuda.max_memory_allocated() / 2**30
    frame_ms = statistics.median(frames)
    log(f"phase5: fwd+bwd frame median of 5 = {frame_ms:.3f} ms (all: "
        f"{' '.join(f'{v:.3f}' for v in frames)}); peak mem {peak:.2f} GiB")
    log(f"phase5 stages (ms): forward frame (median of 3) {fwd_ms:.3f}; "
        f"backward blend "
        f"kernel {b2_ms:.3f}; sort {sort_ms:.3f}; row gather {gather_ms:.3f}; "
        f"segment-sum kernel f32 {seg['f32'][0]:.3f} bf16 {seg['bf16'][0]:.3f}; "
        f"projection+SH VJP {vjp_ms:.3f}")
    log(f"phase5: backward blend {b2_ms:.3f} ms vs plain {b2_plain:.3f} ms; "
        f"segment-sum f32 {seg['f32'][0]:.3f} ms (plain {seg['f32'][1]:.3f}, "
        f"index_add_ {seg['f32'][2]:.3f}); bf16 {seg['bf16'][0]:.3f} ms "
        f"(plain {seg['bf16'][1]:.3f}, index_add_ {seg['bf16'][2]:.3f}); "
        f"rows summed {n_valid} of {key.shape[0]}")

    # five training steps from a perturbed start towards the scene's render
    with torch.no_grad():
        target = render_aux(*scene.render_args(), cam, cfg=cfg)[0]
    start = scene.to_params()
    start = start._replace(opacity_logits=start.opacity_logits - 1.0)
    tc = TrainConfig(lr_opacity=0.1)
    state, opt = init_train_state(start, tc)
    step = make_train_step(opt, w, h, cfg=cfg, tc=tc)
    view = cam.to_view(dev)
    n_steps = 5
    reset_launches()
    losses, step_ms = [], []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        state, step_loss, step_aux = step(state, view, target)
        losses.append(float(step_loss))  # synchronises
        step_ms.append((time.perf_counter() - t0) * 1e3)
        check(not bool(step_aux.overflow), "phase5 training: overflow")
    check_launches("phase5 training", read_launches(),
                   **{k: n_steps for k in one}, segsum_f32=n_steps)
    log(f"phase5 training: losses {' '.join(f'{v:.6f}' for v in losses)}; "
        f"ms per step median {statistics.median(step_ms):.3f} (all: "
        f"{' '.join(f'{v:.3f}' for v in step_ms)})")
    check(all(map(math.isfinite, losses)), "phase5 training: non-finite loss")
    check(losses[-1] < losses[0], "phase5 training: the loss did not fall")

    # bounds from this run's inputs
    nt = gx * gy
    pix = cfg.tile_wh[0] * cfg.tile_wh[1]
    evaluated, applied = ctx["pairs"]
    # the payload slots in range read, their gradients written
    b2_bytes = ctx["used"] * 9 * 4 * 2 + nt * pix * 32 + nt * 8
    b2_bound = bound(b2_bytes, evaluated * OPS_PER_PAIR["vpu"]
                     + applied * OPS_PER_APPLIED["backward"])
    seg_bound = bound(n_valid * (9 * 4 + 4) + n * 9 * 4, n_valid * 9)
    record = [
        {"name": "rasterize_backward", "route": "cuda",
         "source": f"{PKG}/rasterize_backward.cu",
         "replaces": f"{JAX_OPS}/rasterize_pallas.py:448",
         "launches": launches["rasterize_backward_vpu"],
         "max_abs_err": b2_abs,
         "ms": b2_ms, "plain_ms": b2_plain, "bound_ms": b2_bound[0],
         "bound_by": b2_bound[1], "library_ms": None},
    ]
    # each variant's count from the frame that runs it
    for dtype, line, counts in (("f32", 46, launches),
                                ("bf16", 129, launches16)):
        ms, plain_ms, lib_ms = seg[dtype]
        record.append(
            {"name": f"segment_sum_{dtype}", "route": "cuda",
             "source": f"{PKG}/segsum.cu",
             "replaces": f"{JAX_OPS}/segsum.py:{line}",
             "launches": counts[f"segsum_{dtype}"],
             "max_abs_err": st[dtype][2], "ms": ms, "plain_ms": plain_ms,
             "bound_ms": seg_bound[0], "bound_by": seg_bound[1],
             "library_ms": lib_ms})
    return record


def entry_counts(scene, cam, cfg):
    """(AABB slots, entries the tile cull keeps) of a scene at ``cfg``: the
    expansion kernel at the configuration's capacity (the kept count is
    exact while the AABB total fits)."""
    import torch

    from luisacomputegaussiansplatting_tpu_torch.ops.expand import expand_entries_kernel
    from luisacomputegaussiansplatting_tpu_torch.ops.projection import project_gaussians, tile_grid

    with torch.no_grad():
        proj = project_gaussians(scene.means, scene.scales, scene.quats, cam,
                                 cfg)
        gx, gy = tile_grid(cam.width, cam.height, cfg.tile_wh)
        _t, _d, gid, total = expand_entries_kernel(
            proj, gx, gx * gy, cfg.max_pairs, cull_opacity(scene, cfg),
            cfg.tile_wh, cfg.alpha_min)
        return int(total), int((gid >= 0).sum())


def log_frames(tag, res):
    log(f"{tag}: fwd+bwd frame median of {len(res['reps_ms'])} chained reps "
        f"= {res['median_ms']:.3f} ms, mean {res['ms']:.3f} (all: "
        f"{' '.join(f'{v:.3f}' for v in res['reps_ms'])}); first frame "
        f"{res['first_ms']:.3f} ms; num_rendered {res['num_rendered']}; "
        f"peak mem {res['peak_gib']:.2f} GiB; {res['px_s']:.1f} px/s")


#: phase 6: views on the bench camera's ring rendered from one stacked
#: CameraView, as the batched step renders its views
P6_STACKED_VIEWS = 3


def check_stacked_views(scene, cam, cfg, dev):
    """``P6_STACKED_VIEWS`` ring views, each indexed from a stacked
    CameraView as ``models/trainer.py``'s batched step does, rendered under
    autograd (loss = image sum) against single ``render_aux`` frames of the
    same cameras: image, ``num_rendered`` and the five groups' gradients
    bit-identical (the kernels use no atomics and their order is fixed)."""
    import torch

    from luisacomputegaussiansplatting_tpu_torch.ops.render import render_aux, render_view
    from luisacomputegaussiansplatting_tpu_torch.utils.camera import CameraView

    cams = ring_cameras(cam, P6_STACKED_VIEWS)
    views = CameraView(*(torch.stack(x)
                         for x in zip(*[c.to_view(dev) for c in cams])))
    leaves = grad_leaves(scene)
    names = GRAD_NAMES[:5]
    counts = []
    for v, c in enumerate(cams):
        img, aux = render_view(*leaves, CameraView(*(x[v] for x in views)),
                               c.width, c.height, cfg=cfg)
        grads = torch.autograd.grad(img.sum(), leaves)
        img1, aux1 = render_aux(*leaves, c, cfg=cfg)
        grads1 = torch.autograd.grad(img1.sum(), leaves)
        counts.append(int(aux.num_rendered))
        check(not bool(aux.overflow), f"phase6 stacked view {v}: overflow")
        check(torch.equal(img, img1),
              f"phase6 stacked view {v}: the image differs from render_aux's")
        check(counts[-1] == int(aux1.num_rendered),
              f"phase6 stacked view {v}: num_rendered differs")
        for name, a, b in zip(names, grads, grads1):
            check(torch.equal(a, b), f"phase6 stacked view {v}: the "
                                     f"gradient of {name} differs")
    log(f"phase6: {len(cams)} ring views indexed from a stacked CameraView, "
        f"num_rendered {counts}: image, num_rendered and the five groups' "
        "gradients bit-identical to single render_aux frames")


def phase6(dev):
    """The production slice: bench.py's headline (2M) and north-star (6M)
    configurations at 1920x1080, ``blend_quad="mxu"``."""
    import torch

    import bench_cuda
    from luisacomputegaussiansplatting_tpu_torch.models import TrainConfig, init_train_state, make_train_step
    from luisacomputegaussiansplatting_tpu_torch.ops.binning import expand_entries
    from luisacomputegaussiansplatting_tpu_torch.ops.expand import expand_entries_kernel
    from luisacomputegaussiansplatting_tpu_torch.ops.projection import project_gaussians
    from luisacomputegaussiansplatting_tpu_torch.ops.rasterize import make_residual, rasterize_backward, rasterize_forward
    from luisacomputegaussiansplatting_tpu_torch.ops.rasterize_ref import rasterize_reference
    from luisacomputegaussiansplatting_tpu_torch.ops.render import _tiles_to_image, payload_table, render_aux
    from luisacomputegaussiansplatting_tpu_torch.ops.segsum import segment_starts_reference, segment_sum_kernel, segment_sum_reference
    from luisacomputegaussiansplatting_tpu_torch.ops.sh_eval import compute_colors
    from luisacomputegaussiansplatting_tpu_torch.utils.profiling import frame_profile, fwd_bwd_frame

    # the timed frames first, each scale alone on the card: bench's chained
    # reps through the bench's own function
    heads = bench_cuda.run_config("headline", dev)
    log_frames("phase6 headline", heads)
    scene, cam, cfg, _ = bench_cuda.scene_camera_config("north_star", dev)
    ns_counts = entry_counts(scene, cam, cfg)
    del scene
    ns = bench_cuda.run_config("north_star", dev)
    log(f"phase6 north star: 6M gaussians, AABB slots {ns_counts[0]} of "
        f"max_pairs {cfg.max_pairs}, kept by the cull {ns_counts[1]} of "
        f"max_pairs_sorted {cfg.max_pairs_sorted}")
    log_frames("phase6 north star", ns)

    scene, cam, cfg, _ = bench_cuda.scene_camera_config("headline", dev)
    w, h = cam.width, cam.height
    n = scene.means.shape[0]
    leaves = grad_leaves(scene)
    bg = torch.zeros(3, device=dev, requires_grad=True)
    names = ("means", "scales", "quats", "opacities", "sh", "bg")

    # the main path: one production frame, the launch counts over exactly it
    reset_launches()
    loss, grads, aux = fwd_bwd_frame(leaves, bg, cam, cfg)
    torch.cuda.synchronize()
    launches = read_launches()
    check_launches("phase6 production frame", launches, expand=1,
                   rasterize_mxu=1, rasterize_backward_mxu=1, segsum_bf16=1)
    check(not bool(aux.overflow), "phase6: overflow")
    check(bool(torch.isfinite(loss)), "phase6: non-finite loss")
    for name, g, leaf in zip(names, grads, [*leaves, bg]):
        check(g.shape == leaf.shape and bool(torch.isfinite(g).all()),
              f"phase6: gradient of {name} is not finite or mis-shaped")
        check(float(g.abs().max()) > 0, f"phase6: zero gradient of {name}")
    num_rendered = int(aux.num_rendered)
    aabb, kept = entry_counts(scene, cam, cfg)
    log(f"phase6 headline: 2M gaussians, AABB slots {aabb} of max_pairs "
        f"{cfg.max_pairs}, kept by the cull {kept} of max_pairs_sorted "
        f"{cfg.max_pairs_sorted}, num_rendered {num_rendered}")
    check_stacked_views(scene, cam, cfg, dev)

    # the stages again: the expansion kernel with the cull on the frame's
    # bf16-rounded opacities against the plain expansion, the binning with
    # either expansion, then on the frame's payload the mxu kernels against
    # their plain versions and the mxu image against the vpu image
    with torch.no_grad():
        proj, (gx, gy), binned, payload = bin_and_payload(scene, cam, cfg)
        check(int(binned.num_rendered) == num_rendered,
              "phase6: num_rendered differs from the main path")
        cull_op = cull_opacity(scene, cfg)
        _k, k1_err = compare_expansion(proj, gx, gx * gy, cfg.max_pairs,
                                       cull_op, cfg.tile_wh, cfg)
        _p, _g, bp, _pl = bin_and_payload(scene, cam, cfg, expansion="xla")
        for f in binned._fields:
            check(torch.equal(getattr(binned, f), getattr(bp, f)),
                  f"phase6: binning {f} differs kernel vs plain expansion")
        log(f"phase6: expansion kernel with the cull identical to plain "
            f"(total {int(_k[3])}), binning identical with either expansion")
        del _k, _p, _g, bp, _pl
        ranges = (binned.tile_starts, binned.tile_counts)
        ck, tk = rasterize_forward(payload, *ranges, gx, w, h, cfg)
        cp, tp = rasterize_reference(payload, *ranges, gx, w, h, cfg)
        blend = blend_diff(ck, tk, cp, tp, gx, gy, w, h, cfg.tile_wh)
        check_blend("phase6 mxu", *blend)
        digest = blend_digest(ck, tk)
        log(f"phase6: K2 mxu digest {digest}")
        check(digest == K2_DIGESTS["phase6"],
              f"phase6: K2 digest {digest} != {K2_DIGESTS['phase6']}")
        forward_variants("phase6 mxu", payload, ranges, gx, gy, w, h, cfg,
                         ck, tk, (cp, tp), 5)
        cfg_vpu = dataclasses.replace(cfg, blend_quad="vpu")
        cv, tv = rasterize_forward(payload, *ranges, gx, w, h, cfg_vpu)
        d_max, n_over, n_pix = blend_diff(ck, tk, cv, tv, gx, gy, w, h,
                                          cfg.tile_wh)
        allowed = int(FLIP_SHARE * n_pix)
        log(f"phase6: mxu image vs vpu image max|d|={d_max:.3e} "
            f"pixels>{TOL:g}: {n_over} (allowed {allowed})")
        check(n_over <= allowed and d_max <= FLIP_TOL,
              "phase6: the mxu image is too far from the vpu image")
        del cp, tp, cv, tv

    # the frame's residual (loss = image sum over the background), then
    # the mxu backward kernel against its plain version, twice
    c_leaf = ck.clone().requires_grad_(True)
    t_leaf = tk.clone().requires_grad_(True)
    img_c, img_t = _tiles_to_image(c_leaf, t_leaf, gx, gy, w, h, cfg.tile_wh)
    d_color, d_trans = torch.autograd.grad(
        (img_c + bg.detach()[:, None, None] * img_t[None]).sum(),
        [c_leaf, t_leaf])
    with torch.no_grad():
        residual = make_residual(d_color, d_trans, ck, tk)
        st = backward_stages("phase6 mxu", payload, binned, residual, gx, w,
                             h, cfg, n)
    dk, dp, b3_abs, _b3_rel, b3_plain = st["b2"]
    k4_err = st["bf16"][2]
    backward_variants("phase6 mxu", payload, binned, residual, gx, w, h, cfg,
                      dp, 5)

    # the five groups' gradients through the all-plain backward, with the
    # frame's bf16 reduction
    with torch.no_grad():
        d_table = segment_sum_reference(binned.entry_gid, dp.t(), n,
                                        cfg.grad_reduce_dtype)
    colors = compute_colors(leaves[0], leaves[4], cam.position)
    proj_g = project_gaussians(leaves[0], leaves[1], leaves[2], cam, cfg)
    table = payload_table(proj_g, colors, leaves[3])
    plain = list(torch.autograd.grad(table, leaves, grad_outputs=d_table,
                                     allow_unused=True))
    plain = [torch.zeros_like(l) if g is None else g
             for g, l in zip(plain, leaves)]
    with torch.no_grad():
        t_img = _tiles_to_image(ck, tk, gx, gy, w, h, cfg.tile_wh)[1]
        plain.append(t_img.sum().expand(3).clone())  # dL/dbg = sum T
        for name, g, p in zip(names, grads, plain):
            check_fields("phase6", "gradient", g.reshape(-1, 1),
                         p.reshape(-1, 1), [name])
    del table, proj_g, colors, plain, d_table, dp, st

    # kernel and plain times at the frame's shapes, and the forward frame
    reps = 5
    with torch.no_grad():
        k2_ms = cuda_ms(lambda: rasterize_forward(
            payload, *ranges, gx, w, h, cfg), reps)
        k2_plain = cuda_ms(lambda: rasterize_reference(
            payload, *ranges, gx, w, h, cfg), 2)
        k3_ms = cuda_ms(lambda: rasterize_backward(
            payload, *ranges, residual, gx, w, h, cfg), reps)
        render_aux(*scene.render_args(), cam, cfg=cfg)  # warm-up
        fwd = [timed_once(lambda: render_aux(*scene.render_args(), cam,
                                             cfg=cfg))[1] for _ in range(5)]
        evaluated, applied = pair_counts(payload, *ranges, gx, w, h, cfg)
        # K1 and K4 at this frame's shapes (tile 32 with the cull; the
        # trimmed stream's rows, rounded to bf16), with their bounds
        k1_ms = cuda_ms(lambda: expand_entries_kernel(
            proj, gx, gx * gy, cfg.max_pairs, cull_op, cfg.tile_wh,
            cfg.alpha_min), reps)
        k1_plain = cuda_ms(lambda: expand_entries(
            proj, gx, gx * gy, cfg.max_pairs, cull_op, cfg.tile_wh,
            cfg.alpha_min), reps)
        k1_split = expansion_split(proj, gx, gx * gy, cfg.max_pairs, cull_op,
                                   cfg)
        k2_dev = device_ms(lambda: rasterize_forward(
            payload, *ranges, gx, w, h, cfg))
        key = torch.where(binned.entry_gid >= 0, binned.entry_gid,
                          torch.full_like(binned.entry_gid, n))
        sorted_key, perm = torch.sort(key, stable=True)
        rows_t = dk[:, perm].t()
        n_valid = int((sorted_key < n).sum())
        k4_ms = cuda_ms(lambda: segment_sum_kernel(sorted_key, rows_t, n,
                                                   "bf16"), reps)
        k4_plain = cuda_ms(lambda: segment_sum_reference(
            sorted_key, rows_t, n, "bf16"), reps)
        lib_rows = torch.where((sorted_key < n)[:, None],
                               rows_t.to(torch.bfloat16).float(), 0.0)
        key64 = sorted_key.to(torch.int64)
        acc = torch.zeros((n + 1, 9), device=dev)
        k4_lib = cuda_ms(lambda: acc.index_add_(0, key64, lib_rows), reps)
        seg_len = segment_starts_reference(sorted_key, n).diff()
        longest = int(seg_len.max())
        n_long = int((seg_len > 32).sum())
        n_ids = int((seg_len > 0).sum())
        del lib_rows, key64, acc, seg_len
    # the cull reads 24 more bytes a gaussian and does ~40 flops a slot
    k1_bound = bound(n * (28 + 24) + cfg.max_pairs * 12, aabb * 40)
    k4_bound = bound(n_valid * (9 * 4 + 4) + n * 9 * 4, n_valid * 9)
    log(f"phase6: expansion kernel {k1_ms:.3f} ms (device time: prefix "
        f"sums {k1_split[0]:.3f}, the kernel alone {k1_split[1]:.3f}; plain "
        f"{k1_plain:.3f}; bound {k1_bound[0]:.3f} {k1_bound[1]}); "
        f"segment-sum kernel bf16 {k4_ms:.3f} ms (bound "
        f"{k4_bound[0]:.3f} {k4_bound[1]}; plain {k4_plain:.3f}, index_add_ "
        f"{k4_lib:.3f}), rows summed {n_valid} of {key.shape[0]}")
    log(f"phase6: segments: {n_ids} of {n} ids have rows; the longest has "
        f"{longest} rows; {n_long} have more than 32 (summed by a warp)")
    log(f"phase6: forward frame median of 5 = {statistics.median(fwd):.3f} "
        f"ms (all: {' '.join(f'{v:.3f}' for v in fwd)})")
    log(f"phase6: mxu blend kernel {k2_ms:.3f} ms (device time {k2_dev:.3f}) "
        f"vs plain {k2_plain:.3f} ms; mxu backward blend kernel {k3_ms:.3f} ms vs plain "
        f"{b3_plain:.3f} ms; pairs evaluated {evaluated} applied {applied}")

    # five training steps at this config, towards the scene's own render
    with torch.no_grad():
        target = render_aux(*scene.render_args(), cam, cfg=cfg)[0]
    start = scene.to_params()
    start = start._replace(opacity_logits=start.opacity_logits - 1.0)
    tc = TrainConfig(lr_opacity=0.1)
    state, opt = init_train_state(start, tc)
    step = make_train_step(opt, w, h, cfg=cfg, tc=tc)
    view = cam.to_view(dev)
    n_steps = 5
    reset_launches()
    losses, step_ms = [], []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        state, step_loss, step_aux = step(state, view, target)
        losses.append(float(step_loss))  # synchronises
        step_ms.append((time.perf_counter() - t0) * 1e3)
        check(not bool(step_aux.overflow), "phase6 training: overflow")
    check_launches("phase6 training", read_launches(), expand=n_steps,
                   rasterize_mxu=n_steps, rasterize_backward_mxu=n_steps,
                   segsum_bf16=n_steps)
    log(f"phase6 training: losses {' '.join(f'{v:.6f}' for v in losses)}; "
        f"ms per step median {statistics.median(step_ms):.3f} (all: "
        f"{' '.join(f'{v:.3f}' for v in step_ms)})")
    check(all(map(math.isfinite, losses)), "phase6 training: non-finite loss")
    check(losses[-1] < losses[0], "phase6 training: the loss did not fall")
    del state, opt, step, target

    # one production frame under the profiler
    prof = frame_profile(scene, cam, cfg)
    check(prof.busy_ms is not None and prof.busy_ms > 0,
          "phase6 profile: no device time recorded")
    log(f"phase6 profile: one fwd+bwd frame {prof.wall_ms:.3f} ms with the "
        f"profiler on, device busy {prof.busy_ms:.3f} ms: share "
        f"{prof.busy_share:.3f} of the profiled frame, "
        f"{prof.busy_ms / heads['median_ms']:.3f} of the unprofiled median")
    for what, rows in (("op (self device ms)", prof.ops),
                       ("kernel (device ms)", prof.kernels)):
        log(f"phase6 profile: top 15 by {what}, of {len(rows)}:")
        for name, ms, calls in rows[:15]:
            log(f"  {ms:9.3f} ms {calls:5d}x  {name[:100]}")
    # the columns cross through utils/packing.py: no select_backward
    sums = log_op_sums("phase6 profile", prof)
    check(sums["select_backward"] == 0,
          "phase6 profile: the frame ran select_backward")

    # bounds from this run's inputs (as phases 3 and 5)
    nt = gx * gy
    pix = cfg.tile_wh[0] * cfg.tile_wh[1]
    used = used_slots(binned)
    k2_bound = bound(used * 9 * 4 + nt * 8 + nt * pix * 16,
                     evaluated * OPS_PER_PAIR["mxu"]
                     + applied * OPS_PER_APPLIED["forward"])
    k3_bound = bound(used * 9 * 4 * 2 + nt * pix * 32 + nt * 8,
                     evaluated * OPS_PER_PAIR["mxu"]
                     + applied * OPS_PER_APPLIED["backward"])
    return [
        {"name": "expand_entries_production", "route": "cuda",
         "source": f"{PKG}/expand.cu",
         "replaces": f"{JAX_OPS}/expand_pallas.py:137",
         "launches": launches["expand"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound[0],
         "bound_by": k1_bound[1], "library_ms": None},
        {"name": "rasterize_forward_mxu", "route": "cuda",
         "source": f"{PKG}/rasterize.cu",
         "replaces": f"{JAX_OPS}/rasterize_pallas.py:282",
         "launches": launches["rasterize_mxu"], "max_abs_err": blend[0],
         "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound[0],
         "bound_by": k2_bound[1], "library_ms": None},
        {"name": "rasterize_backward_mxu", "route": "cuda",
         "source": f"{PKG}/rasterize_backward.cu",
         "replaces": f"{JAX_OPS}/rasterize_pallas.py:448",
         "launches": launches["rasterize_backward_mxu"],
         "max_abs_err": b3_abs, "ms": k3_ms, "plain_ms": b3_plain,
         "bound_ms": k3_bound[0], "bound_by": k3_bound[1],
         "library_ms": None},
        {"name": "segment_sum_bf16_production", "route": "cuda",
         "source": f"{PKG}/segsum.cu",
         "replaces": f"{JAX_OPS}/segsum.py:129",
         "launches": launches["segsum_bf16"], "max_abs_err": k4_err,
         "ms": k4_ms, "plain_ms": k4_plain, "bound_ms": k4_bound[0],
         "bound_by": k4_bound[1], "library_ms": k4_lib},
    ]


def ring_cameras(cam, n):
    """``cam`` and n - 1 more on its ring about the z axis through the
    origin (the same distance and height), 360/n degrees apart, all looking
    at the origin."""
    from luisacomputegaussiansplatting_tpu_torch import look_at_camera

    x, y, z = cam.position
    out = [cam]
    for k in range(1, n):
        a = 2.0 * math.pi * k / n
        pos = (x * math.cos(a) - y * math.sin(a),
               x * math.sin(a) + y * math.cos(a), z)
        out.append(look_at_camera(pos, (0.0, 0.0, 0.0), (0.0, 0.0, 1.0),
                                  fov=cam.fov, width=cam.width,
                                  height=cam.height))
    return out


def state_copy(params, opt, dstate, dev):
    """Copies of a round's inputs on ``dev``: leaf parameters, an Adam over
    them holding copies of ``opt``'s moments (Adam's ``step`` stays where
    it was), and the densify state."""
    from luisacomputegaussiansplatting_tpu_torch.models import DensifyState, GaussianParams, init_train_state

    state, opt2 = init_train_state(GaussianParams(
        *(p.detach().to(dev) for p in params)))
    for p, q in zip(params, state.params):
        opt2.state[q] = {k: (v if k == "step" else v.to(dev)).detach().clone()
                         for k, v in opt.state[p].items()}
    return (state.params, opt2,
            DensifyState(*(t.to(dev).clone() for t in dstate)))


def check_round(tag, plan, cpu_plan, params, cpu_params, opt, cpu_opt,
                before_moments, state, cpu_state, info, cpu_info):
    """The densify round on the card against its CPU run on the same
    inputs and noise: the plan (masks, overflow, children and their slots),
    the new active mask and the counters identical; the rewritten rows
    within 1e-6 x the field's max |value| there, every other row the same
    bits; the Adam moments zero in every row that did not survive and
    unchanged elsewhere. Returns the largest relative difference."""
    import torch

    from luisacomputegaussiansplatting_tpu_torch.models import GaussianParams

    for f in plan._fields:
        check(torch.equal(getattr(plan, f).cpu(), getattr(cpu_plan, f)),
              f"{tag}: plan {f} differs card vs CPU")
    check(torch.equal(state.active.cpu(), cpu_state.active),
          f"{tag}: active mask differs card vs CPU")
    for f in info._fields:
        check(getattr(info, f).item() == getattr(cpu_info, f).item(),
              f"{tag}: counter {f} differs card vs CPU")
    dest = cpu_plan.dest
    kept = torch.ones(cpu_state.active.shape[0], dtype=torch.bool)
    kept[dest] = False
    worst = 0.0
    for f, p, q in zip(GaussianParams._fields, params, cpu_params):
        p, q = p.detach().cpu(), q.detach()
        check(torch.equal(p[kept], q[kept]),
              f"{tag}: {f} differs card vs CPU outside the rewritten rows")
        if dest.numel():
            scale = float(q[dest].abs().max()) or 1.0
            rel = float((p[dest] - q[dest]).abs().max()) / scale
            worst = max(worst, rel)
            check(rel <= 1e-6, f"{tag}: rewritten rows of {f} differ card "
                               f"vs CPU by {rel:.3e} of their max")
    gone = ~cpu_plan.survivors
    for g, cg, (name, m0) in zip(opt.param_groups, cpu_opt.param_groups,
                                 before_moments):
        st = opt.state[g["params"][0]]
        cst = cpu_opt.state[cg["params"][0]]
        for key, before in zip(("exp_avg", "exp_avg_sq"), m0):
            m = st[key].cpu()
            check(torch.equal(m, cst[key]),
                  f"{tag}: {name} {key} differs card vs CPU")
            check(not m[gone].any(),
                  f"{tag}: {name} {key} not zeroed in a retired or new row")
            check(torch.equal(m[~gone], before[~gone]),
                  f"{tag}: {name} {key} changed in a surviving row")
    return worst


def checked_round(tag, params, opt, dstate, extent, dcfg, seed, card):
    """One densify round through ``densify_step`` on the parameters' device,
    its noise from a generator seeded ``seed``; then the same round on the
    CPU from copies of its inputs and that noise, held to it by
    ``check_round``. The round launches no kernel, does not overflow, and
    the active count adds up. Returns (params, opt, densify state, the
    counters, the round's ms on the host clock)."""
    import torch

    from luisacomputegaussiansplatting_tpu_torch.models import densify_plan, densify_round, densify_step

    dev = params.means.device
    n_before = int(dstate.num_active)
    cpu_params, cpu_opt, cpu_dstate = state_copy(params, opt, dstate,
                                                 torch.device("cpu"))
    moments0 = [(g["name"], tuple(opt.state[g["params"][0]][k].cpu().clone()
                                  for k in ("exp_avg", "exp_avg_sq")))
                for g in opt.param_groups]
    plan = densify_plan(params, dstate, extent, dcfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    gen_state = gen.get_state()
    reset_launches()
    sync(dev)
    t0 = time.perf_counter()
    out, opt, dstate, info = densify_step(params, opt, dstate, gen, extent,
                                          dcfg)
    counters = {f: getattr(info, f).item() for f in info._fields}
    sync(dev)
    round_ms = (time.perf_counter() - t0) * 1e3
    check_launches(f"{tag}: densify round", read_launches())
    check(out is params, f"{tag}: the round made new parameters")
    n_after = int(dstate.num_active)
    log(f"{tag}: densify round {round_ms:.3f} ms: {counters}; active "
        f"{n_before} -> {n_after} of {dstate.active.shape[0]} {card}")
    check(not counters["overflow"], f"{tag}: the densify round overflowed")
    check(n_after == n_before + counters["n_cloned"] + counters["n_split"]
          * (dcfg.split_children - 1) - counters["n_pruned"],
          f"{tag}: the active count does not add up")
    gen.set_state(gen_state)
    noise = torch.randn((dstate.active.shape[0], dcfg.split_children, 3),
                        generator=gen, device=dev).cpu()
    cpu_plan = densify_plan(cpu_params, cpu_dstate, extent, dcfg)
    _, _, cpu_dstate, cpu_info = densify_round(cpu_params, cpu_opt,
                                               cpu_dstate, noise, extent,
                                               dcfg)
    worst = check_round(tag, plan, cpu_plan, params, cpu_params, opt,
                        cpu_opt, moments0, dstate, cpu_dstate, info,
                        cpu_info)
    log(f"{tag}: the round on the card equals its CPU run: plan, active "
        f"mask and counters identical, rewritten rows within {worst:.3e} of "
        f"their max, moments zeroed in {int((~plan.survivors).sum())} rows "
        f"{card}")
    return params, opt, dstate, counters, round_ms


def check_masked_view(tag, params, active, cam, cfg, card):
    """The four production kernels against their plain versions on one
    view of the densifying path: its stages with the active mask (inactive
    rows at radius 0), then K1 bit for bit, K2 within TOL, K3 within
    GRAD_TOL and K4 (f32 and bf16) within SUM_TOL on that view's payload."""
    import torch

    from luisacomputegaussiansplatting_tpu_torch.ops.rasterize import rasterize_forward
    from luisacomputegaussiansplatting_tpu_torch.ops.rasterize_ref import rasterize_reference
    from luisacomputegaussiansplatting_tpu_torch.ops.render import render_stages

    w, h = cam.width, cam.height
    with torch.no_grad():
        scene = params.activate()
        s = render_stages(*scene.render_args(), cam.to_view(active.device),
                          w, h, cfg, active_mask=active)
        check(not bool(s.binned.overflow), f"{tag}: overflow")
        check(not bool(s.proj.radius[~active].any()),
              f"{tag}: an inactive row has a radius")
        gx, gy = s.grid
        _, k1_err = compare_expansion(s.proj, gx, gx * gy, cfg.max_pairs,
                                      s.cull_op, cfg.tile_wh, cfg)
        ranges = (s.binned.tile_starts, s.binned.tile_counts)
        ck, tk = rasterize_forward(s.payload, *ranges, gx, w, h, cfg)
        cp, tp = rasterize_reference(s.payload, *ranges, gx, w, h, cfg)
        blend = blend_diff(ck, tk, cp, tp, gx, gy, w, h, cfg.tile_wh)
        check_blend(tag, *blend)
        st = backward_stages(tag, s.payload, s.binned,
                             random_residual(ck, tk, 17), gx, w, h, cfg,
                             active.shape[0])
    log(f"{tag}: {int(s.binned.num_rendered)} entries of "
        f"{int(active.sum())} actives; kernel vs plain: K1 max|d| "
        f"{k1_err:.3e}, K2 max|d| {blend[0]:.3e}, K3 max|d| "
        f"{st['b2'][2]:.3e} (rel {st['b2'][3]:.2e}), K4 max|d|/max|sum| f32 "
        f"{st['f32'][3]:.2e} bf16 {st['bf16'][3]:.2e} {card}")


P7_VIEWS = 4


def batched_setup(dev):
    """Phase 7's start, through whichever port package is first on
    ``sys.path``: (cfg, cams, views, targets, the state and its optimizer,
    the densify state, the batched step). The bench scene's first half at
    2M capacity, means moved by N(0, 0.01), opacity logits lowered by 1;
    the targets are the full scene's renders from ``P7_VIEWS`` views on the
    bench camera's ring."""
    import torch

    import bench_cuda
    from luisacomputegaussiansplatting_tpu_torch.models import init_densify_state, init_train_state, make_batched_train_step, pad_params_to
    from luisacomputegaussiansplatting_tpu_torch.ops.render import render_aux
    from luisacomputegaussiansplatting_tpu_torch.utils.camera import CameraView

    scene, cam, cfg, _ = bench_cuda.scene_camera_config("headline", dev)
    cap = scene.means.shape[0]
    n0 = cap // 2
    cams = ring_cameras(cam, P7_VIEWS)
    views = CameraView(*(torch.stack(x) for x in
                         zip(*(c.to_view(dev) for c in cams))))
    targets = []
    with torch.no_grad():
        for i, c in enumerate(cams):
            img, aux = render_aux(*scene.render_args(), c, cfg=cfg)
            check(not bool(aux.overflow), f"phase7: target {i} overflows")
            targets.append(img)
    targets = torch.stack(targets)
    gen = torch.Generator(device=dev).manual_seed(7)
    start = scene.to_params()
    start = start._replace(
        means=start.means[:n0] + 0.01 * torch.randn(
            (n0, 3), generator=gen, device=dev),
        log_scales=start.log_scales[:n0], quats=start.quats[:n0],
        opacity_logits=start.opacity_logits[:n0] - 1.0,
        sh_dc=start.sh_dc[:n0], sh_rest=start.sh_rest[:n0])
    del scene
    state, opt = init_train_state(pad_params_to(start, cap))
    del start
    dstate = init_densify_state(n0, cap, device=dev)
    bstep = make_batched_train_step(opt, cam.width, cam.height, cfg=cfg)
    return cfg, cams, views, targets, state, opt, dstate, bstep


def phase7(dev, card):
    """Densifying, batched training at the production configuration: 2M
    capacity from 1M actives at 1920x1080, B = 4 views a step."""
    import torch

    from luisacomputegaussiansplatting_tpu_torch.models import DensifyConfig, make_densify_train_step, reset_opacity
    from luisacomputegaussiansplatting_tpu_torch.utils.camera import CameraView
    from luisacomputegaussiansplatting_tpu_torch.utils.profiling import call_profile

    on_card = dev.type == "cuda"
    cfg, cams, views, targets, state, opt, dstate, bstep = batched_setup(dev)
    w, h = cams[0].width, cams[0].height
    cap = state.params.means.shape[0]
    n0 = int(dstate.active.sum())
    n_views = P7_VIEWS
    extent = 3.0
    per_step = dict(expand=n_views, rasterize_mxu=n_views,
                    rasterize_backward_mxu=n_views, segsum_bf16=n_views)
    tag = f"[{card}]"

    def batched(first, n):
        nonlocal state, dstate
        losses, ms = [], []
        for i in range(first, first + n):
            reset_launches()
            t0 = time.perf_counter()
            state, dstate, loss, overflow = bstep(state, dstate, views,
                                                  targets)
            losses.append(float(loss))  # synchronises
            ms.append((time.perf_counter() - t0) * 1e3)
            check(not bool(overflow), f"phase7: batched step {i} overflows")
            check_launches(f"phase7 batched step {i}", read_launches(),
                           **per_step)
            check(not bool(dstate.count[~dstate.active].any()),
                  f"phase7: batched step {i} saw an inactive row")
        return losses, ms

    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    losses, ms = batched(0, 10)
    check(all(map(math.isfinite, losses)), "phase7: non-finite loss")
    check(losses[-1] < losses[0], "phase7: the loss did not fall over the "
                                  "first 10 batched steps")
    log(f"phase7: 10 batched steps (B = {n_views}, {n0} active of {cap}, "
        f"{w}x{h}): losses {' '.join(f'{v:.6f}' for v in losses)} {tag}")

    # the densify round, on the card through densify_step and again on
    # the CPU from copies of its inputs and the noise it drew
    dcfg = DensifyConfig()
    visible = dstate.active & (dstate.count > 0)
    avg = (dstate.grad_sum / torch.clamp(dstate.count, min=1.0))[visible]
    qs = torch.quantile(avg, torch.tensor([0.5, 0.9, 0.99, 0.999, 1.0],
                                          device=dev))
    log(f"phase7: avg NDC grad of {int(visible.sum())} visible actives: "
        f"p50 {qs[0]:.3e} p90 {qs[1]:.3e} p99 {qs[2]:.3e} p99.9 {qs[3]:.3e} "
        f"max {qs[4]:.3e}; above grad_threshold {dcfg.grad_threshold:g}: "
        f"{int((avg > dcfg.grad_threshold).sum())} {tag}")
    # the round on the live state; then, on copies of the state from
    # before it, a round that splits: the bench scene's scales lie in
    # [0.004, 0.02], under the default percent_dense x extent (0.03), so
    # the default round only clones
    copies = state_copy(state.params, opt, dstate, dev)
    params, opt, dstate, counters, _ = checked_round(
        "phase7", state.params, opt, dstate, extent, dcfg, 11, tag)
    check(counters["n_cloned"] + counters["n_split"] > 0,
          "phase7: the densify round grew nothing")
    split_cfg = DensifyConfig(percent_dense=0.004)
    log(f"phase7 split round: on copies of the state before the round, "
        f"DensifyConfig(percent_dense={split_cfg.percent_dense:g}) "
        f"(split above a scale of {split_cfg.percent_dense * extent:g})")
    split_counters = checked_round("phase7 split round", *copies, extent,
                                   split_cfg, 13, tag)[3]
    check(split_counters["n_split"] > 0, "phase7 split round: nothing split")
    del copies

    losses2, ms2 = batched(10, 10)
    check(all(map(math.isfinite, losses2)), "phase7: non-finite loss")
    peak = (torch.cuda.max_memory_allocated(dev) / 2**30 if on_card
            else float("nan"))
    log(f"phase7: 10 batched steps after the round: losses "
        f"{' '.join(f'{v:.6f}' for v in losses2)} {tag}")
    log(f"phase7: batched step (B = {n_views}) median of the last 5 "
        f"{statistics.median(ms2[-5:]):.3f} ms (all 20: "
        f"{' '.join(f'{v:.3f}' for v in ms + ms2)}); peak memory "
        f"{peak:.2f} GiB {tag}")
    # the kernels against their plain versions on this path's inputs: one
    # ring view (the plain backward takes seconds) after the round
    check_masked_view("phase7 ring view 1", state.params, dstate.active,
                      cams[1], cfg, tag)

    # one more batched step under the profiler: where its time goes
    def one_step():
        nonlocal state, dstate
        state, dstate, loss, _ = bstep(state, dstate, views, targets)
        return float(loss)

    prof = call_profile(one_step, dev)
    if on_card:
        check(prof.busy_ms is not None and prof.busy_ms > 0,
              "phase7 profile: no device time recorded")
        log(f"phase7 profile: one batched step {prof.wall_ms:.3f} ms with "
            f"the profiler on, device busy {prof.busy_ms:.3f} ms: share "
            f"{prof.busy_share:.3f} {tag}")
        sums = log_op_sums(f"phase7 profile {tag}", prof)
        check(sums["select_backward"] == 0,
              "phase7 profile: the step ran select_backward")
    log("phase7 profile: top 12 ops by self device ms (host ms off the "
        f"card), of {len(prof.ops)} {tag}:")
    for name, op_ms, calls in prof.ops[:12]:
        log(f"  {op_ms:9.3f} ms {calls:5d}x  {name[:100]}")

    sync(dev)
    t0 = time.perf_counter()
    params, opt = reset_opacity(state.params, dstate, dcfg, opt)
    sync(dev)
    log(f"phase7: reset_opacity {(time.perf_counter() - t0) * 1e3:.3f} ms "
        f"{tag}")

    dstep = make_densify_train_step(opt, w, h, cfg=cfg)
    view0 = CameraView(*(x[0] for x in views))
    losses3 = []
    for i in range(5):
        reset_launches()
        state, dstate, loss, aux = dstep(state, dstate, view0, targets[0])
        losses3.append(float(loss))
        check(not bool(aux.overflow), f"phase7: densify step {i} overflows")
        check_launches(f"phase7 densify step {i}", read_launches(),
                       expand=1, rasterize_mxu=1,
                       rasterize_backward_mxu=1, segsum_bf16=1)
        check(not bool(aux.radii[~dstate.active].any()),
              f"phase7: densify step {i} drew an inactive row")
    check(all(map(math.isfinite, losses3)), "phase7: non-finite loss")
    parked = ~dstate.active
    check(bool((params.opacity_logits[parked] == -15.0).all()
               & (params.log_scales[parked] == -18.0).all()),
          "phase7: an inactive row is not parked")
    log(f"phase7: 5 densifying steps on the bench view after the reset: "
        f"losses {' '.join(f'{v:.6f}' for v in losses3)}; "
        f"{int(parked.sum())} inactive rows parked and culled {tag}")


# ---- phase 8: the dataset loaders, the train CLI and the viewer -----------

P8_VIEWS = 8
P8_RES = (1920, 1080)
P8_SCENE = 2_000_000
P8_CAPACITY = 2_000_000
P8_POINTS = 300_000
P8_FOV = 60.0
P8_MAX_PAIRS = 16_000_000
P8_VIEWER_RES = ((1280, 720), (1920, 1080))


def p8_train_argv(root, out_dir, dev):
    """8b's argv: bench.py:57-63's production configuration in the CLI's
    flags, graphdeco's schedule cut to 60 steps, B = 4 views a step."""
    return [
        "--colmap", root, "--out", out_dir, "--device", str(dev),
        "--capacity", str(P8_CAPACITY),
        "--views-per-step", "4", "--tile", "32", "--pack", "none",
        "--tile-cull", "--sort", "fused", "--payload", "bf16",
        "--grad-reduce-dtype", "bf16", "--blend", "mxu",
        "--max-pairs", str(P8_MAX_PAIRS), "--densify-from", "10",
        "--densify-interval", "10", "--densify-until", "40",
        "--opacity-reset-interval", "30", "--ckpt-every", "20",
        "--eval-every", "20", "--log-every", "10",
    ]


LOG_RE = re.compile(r"\[(\d+)/(\d+)\] loss (\S+)  active (\d+)  (\S+) it/s")
DENSIFY_RE = re.compile(r"\[(\d+)\] densify: \+(\d+) cloned \+(\d+) split "
                        r"-(\d+) pruned -> (\d+) active")
EVAL_RE = re.compile(r"eval view0 PSNR (\S+) dB  SSIM (\S+)")


def rotation_to_qvec(r):
    """A rotation matrix -> COLMAP's (w, x, y, z) unit quaternion (the
    inverse of ``io.dataset._qvec2rot``)."""
    t = r[0, 0] + r[1, 1] + r[2, 2]
    if t > 0:
        s = math.sqrt(t + 1.0) * 2.0
        q = (0.25 * s, (r[2, 1] - r[1, 2]) / s, (r[0, 2] - r[2, 0]) / s,
             (r[1, 0] - r[0, 1]) / s)
    elif r[0, 0] > r[1, 1] and r[0, 0] > r[2, 2]:
        s = math.sqrt(1.0 + r[0, 0] - r[1, 1] - r[2, 2]) * 2.0
        q = ((r[2, 1] - r[1, 2]) / s, 0.25 * s, (r[0, 1] + r[1, 0]) / s,
             (r[0, 2] + r[2, 0]) / s)
    elif r[1, 1] > r[2, 2]:
        s = math.sqrt(1.0 + r[1, 1] - r[0, 0] - r[2, 2]) * 2.0
        q = ((r[0, 2] - r[2, 0]) / s, (r[0, 1] + r[1, 0]) / s, 0.25 * s,
             (r[1, 2] + r[2, 1]) / s)
    else:
        s = math.sqrt(1.0 + r[2, 2] - r[0, 0] - r[1, 1]) * 2.0
        q = ((r[1, 0] - r[0, 1]) / s, (r[0, 2] + r[2, 0]) / s,
             (r[1, 2] + r[2, 1]) / s, 0.25 * s)
    return q


def write_colmap_model(root, cams, names, xyz, rgb):
    """A COLMAP binary model in mip-NeRF-360 layout: ``sparse/0/{cameras,
    images,points3D}.bin`` (one PINHOLE camera, square pixels) for the
    ``images/`` the caller writes. Each point's track is one observation."""
    import numpy as np

    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse, exist_ok=True)
    w, h = cams[0].width, cams[0].height
    f = 0.5 * h / math.tan(math.radians(cams[0].fov) * 0.5)
    with open(os.path.join(sparse, "cameras.bin"), "wb") as fh:
        fh.write(struct.pack("<Q", 1))
        fh.write(struct.pack("<iiQQ", 1, 1, w, h))  # camera 1, PINHOLE
        fh.write(struct.pack("<4d", f, f, w / 2, h / 2))
    with open(os.path.join(sparse, "images.bin"), "wb") as fh:
        fh.write(struct.pack("<Q", len(cams)))
        for i, (c, name) in enumerate(zip(cams, names)):
            # world -> camera: rows right, down, front (COLMAP: +z forward,
            # +y down)
            r = np.array([c.right, [-u for u in c.up], c.front])
            fh.write(struct.pack("<i", i + 1))
            fh.write(struct.pack("<4d", *rotation_to_qvec(r)))
            fh.write(struct.pack("<3d", *(-r @ np.asarray(c.position))))
            fh.write(struct.pack("<i", 1))
            fh.write(name.encode() + b"\x00")
            fh.write(struct.pack("<Q", 0))  # no 2D points
    rec = np.zeros(len(xyz), np.dtype([
        ("id", "<u8"), ("xyz", "<f8", 3), ("rgb", "u1", 3), ("error", "<f8"),
        ("track_len", "<u8"), ("image_id", "<i4"), ("point2d", "<i4")]))
    rec["id"] = np.arange(len(xyz))
    rec["xyz"] = xyz
    rec["rgb"] = rgb
    rec["error"] = 0.5
    rec["track_len"] = 1
    rec["image_id"] = 1
    with open(os.path.join(sparse, "points3D.bin"), "wb") as fh:
        fh.write(struct.pack("<Q", len(xyz)))
        fh.write(rec.tobytes())


def phase8_dataset(scene, work, dev, tag):
    """8a: the COLMAP binary dataset of the bench scene's renders, written
    and loaded back. Returns (root, the loaded dataset)."""
    import numpy as np
    import torch

    from luisacomputegaussiansplatting_tpu_torch import RenderConfig, look_at_camera
    from luisacomputegaussiansplatting_tpu_torch.io.dataset import load_colmap, load_colmap_points3d
    from luisacomputegaussiansplatting_tpu_torch.ops.render import render_aux
    from luisacomputegaussiansplatting_tpu_torch.utils.image import write_png
    from luisacomputegaussiansplatting_tpu_torch.utils.sh import SH_C0

    root = os.path.join(work, "scene")
    os.makedirs(os.path.join(root, "images"))
    # the bench camera's pose (bench.py:101-104) on a ring about its target
    cam = look_at_camera((3.5, -3.0, 2.2), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0),
                         fov=P8_FOV, width=P8_RES[0], height=P8_RES[1])
    cams = ring_cameras(cam, P8_VIEWS)
    names = [f"view{i:02d}.png" for i in range(P8_VIEWS)]
    t0 = time.perf_counter()
    renders = []
    with torch.no_grad():
        for c, name in zip(cams, names):
            img, aux = render_aux(*scene.render_args(), c,
                                  cfg=RenderConfig(max_pairs=P8_MAX_PAIRS))
            check(not bool(aux.overflow), f"phase8a: {name} overflows")
            img = torch.clamp(img, 0.0, 1.0).cpu().numpy()
            renders.append(img)
            write_png(os.path.join(root, "images", name), img)  # top-down
    rng = np.random.default_rng(8)
    xyz = (scene.means[:P8_POINTS].cpu().numpy().astype(np.float64)
           + rng.normal(0.0, 0.01, (P8_POINTS, 3)))
    dc = scene.sh[:P8_POINTS, 0, :].cpu().numpy()
    rgb = (np.clip(dc * SH_C0 + 0.5, 0.0, 1.0) * 255.0).astype(np.uint8)
    write_colmap_model(root, cams, names, xyz, rgb)
    log(f"phase8a: wrote {P8_VIEWS} views at {P8_RES[0]}x{P8_RES[1]} "
        f"(renders of the {scene.means.shape[0]}-gaussian bench scene) and "
        f"{P8_POINTS} points as a COLMAP binary model in "
        f"{time.perf_counter() - t0:.2f} s {tag}")

    t0 = time.perf_counter()
    data = load_colmap(root)
    load_s = time.perf_counter() - t0
    check(len(data) == P8_VIEWS, f"phase8a: loaded {len(data)} views")
    worst_pos = worst_axis = worst_px = 0.0
    for c, lc, ref, tgt in zip(cams, data.cameras, renders, data.targets):
        check((lc.width, lc.height) == P8_RES, "phase8a: image size")
        worst_pos = max(worst_pos, float(np.abs(
            np.subtract(lc.position, c.position)).max()))
        worst_axis = max(worst_axis, float(np.abs(np.concatenate([
            np.subtract(lc.front, c.front), np.subtract(lc.up, c.up)])).max()))
        check(abs(lc.fov - P8_FOV) < 1e-6, f"phase8a: fov {lc.fov}")
        worst_px = max(worst_px, float(np.abs(tgt - ref).max()))
    check(worst_pos <= 1e-5 and worst_axis <= 1e-5,
          f"phase8a: cameras off by {worst_pos:.3e} / {worst_axis:.3e}")
    check(worst_px <= 1.0 / 255.0 + 1e-6,
          f"phase8a: a target is {worst_px:.3e} from its render")
    t0 = time.perf_counter()
    pts, cols = load_colmap_points3d(root)
    pts_s = time.perf_counter() - t0
    check(pts.shape == (P8_POINTS, 3) and np.array_equal(
        pts, xyz.astype(np.float32)) and np.array_equal(
        cols, rgb.astype(np.float32) / 255.0), "phase8a: points3D differ")
    log(f"phase8a: load_colmap {load_s:.3f} s ({P8_VIEWS} PNGs, extent "
        f"{data.scene_extent:.4f}), load_colmap_points3d {pts_s:.3f} s; "
        f"cameras within {worst_pos:.2e} (position) / {worst_axis:.2e} "
        f"(axes), targets within {worst_px:.3e} of their renders {tag}")
    return root, data


class StepProbe:
    """A train CLI step factory whose steps record their kernel launches
    (the counts' difference around the step) and CUDA-event span."""

    def __init__(self, make):
        self.make = make
        self.launches = []
        self.events = []
        self.host = []  # host clock at each step's start and end

    def __call__(self, *args, **kw):
        import torch

        step = self.make(*args, **kw)

        def probed(*a):
            t0 = time.perf_counter()
            before = read_launches()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = step(*a)
            end.record()
            after = read_launches()
            self.launches.append({k: after[k] - before[k] for k in after})
            self.events.append((start, end))
            self.host.append((t0, time.perf_counter()))
            return out

        return probed

    def step_ms(self):
        import torch

        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events]


class DensifyProbe:
    """The train CLI's ``densify_step`` with each round's avg NDC gradient
    quantiles (visible actives, before the round) and its host time."""

    def __init__(self, real):
        self.real = real
        self.rounds = []

    def __call__(self, params, opt, dstate, gen, extent, cfg):
        import torch

        visible = dstate.active & (dstate.count > 0)
        avg = (dstate.grad_sum / torch.clamp(dstate.count, min=1.0))[visible]
        qs = torch.quantile(avg, torch.tensor(
            [0.5, 0.9, 0.99, 0.999, 1.0], device=avg.device)).tolist()
        above = int((avg > cfg.grad_threshold).sum())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.real(params, opt, dstate, gen, extent, cfg)
        torch.cuda.synchronize()
        self.rounds.append(dict(visible=int(visible.sum()), quantiles=qs,
                                above=above, threshold=cfg.grad_threshold,
                                ms=(time.perf_counter() - t0) * 1e3))
        return out


def run_train_cli(tag, argv, main=None, **probes):
    """``train_cli.main(argv)`` (or ``main(argv)``, an entry point that runs
    it) in-process with ``probes`` put in place of the train CLI module's
    names of the same name: (rc, stdout, stderr); the output is logged
    line by line."""
    from luisacomputegaussiansplatting_tpu_torch.apps import train_cli

    saved = {k: getattr(train_cli, k) for k in probes}
    out, err = io.StringIO(), io.StringIO()
    try:
        for k, v in probes.items():
            setattr(train_cli, k, v)
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = (main or train_cli.main)(argv)
    finally:
        for k, v in saved.items():
            setattr(train_cli, k, v)
        for line in out.getvalue().splitlines():
            log(f"{tag} cli: {line}")
        for line in err.getvalue().splitlines():
            log(f"{tag} cli stderr: {line}")
    return rc, out.getvalue(), err.getvalue()


def check_exported_ply(tag, path, n_active):
    """The CLI's PLY: the port's native loader reads it equal to its numpy
    reader (means and SH bit for bit, the rest within 2e-7)."""
    import numpy as np

    from luisacomputegaussiansplatting_tpu_torch.io.native import load_gsply_native
    from luisacomputegaussiansplatting_tpu_torch.io.ply import load_ply

    t0 = time.perf_counter()
    out = load_gsply_native(path)
    native_s = time.perf_counter() - t0
    check(out is not None, f"{tag}: the native loader refused {path}")
    means, sh, opacity, scales, quats = out
    t0 = time.perf_counter()
    ref = load_ply(path, use_native=False, device="cpu")
    numpy_s = time.perf_counter() - t0
    check(means.shape[0] == n_active, f"{tag}: {means.shape[0]} rows saved, "
                                      f"{n_active} active")
    check(np.array_equal(means, ref.means.numpy())
          and np.array_equal(sh, ref.sh.numpy()),
          f"{tag}: native means / SH differ from numpy's")
    for name, a, b in (("opacity", opacity, ref.opacities),
                       ("scales", scales, ref.scales),
                       ("quats", quats, ref.quats)):
        d = float(np.abs(a - b.numpy()).max() /
                  max(1.0, float(np.abs(b.numpy()).max())))
        check(d <= 2e-7, f"{tag}: native {name} off by {d:.3e}")
    log(f"{tag}: PLY {os.path.getsize(path) / 2**20:.1f} MiB, {n_active} "
        f"gaussians: native loader {native_s:.3f} s, numpy {numpy_s:.3f} s, "
        f"equal (means/SH bit for bit)")


def phase8_train(root, work, dev, tag):
    """8b and 8c: production training through the CLI from the COLMAP
    points, then a resume from its last checkpoint."""
    import torch

    from luisacomputegaussiansplatting_tpu_torch.apps import train_cli

    out_dir = os.path.join(work, "train")
    argv = p8_train_argv(root, out_dir, dev)
    steps = StepProbe(train_cli.make_batched_train_step)
    rounds = DensifyProbe(train_cli.densify_step)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    t0 = time.perf_counter()
    rc, out, err = run_train_cli("phase8b", argv + ["--iters", "60"],
                                 make_batched_train_step=steps,
                                 densify_step=rounds)
    t_end = time.perf_counter()
    total = read_launches()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    check(rc == 0, f"phase8b: train_cli returned {rc}")
    logs = {int(m[0]): m for m in LOG_RE.findall(out)}
    check(sorted(logs) == [10, 20, 30, 40, 50, 60],
          f"phase8b: log lines at {sorted(logs)}")
    loss = {k: float(m[2]) for k, m in logs.items()}
    psnr = [float(m[0]) for m in EVAL_RE.findall(out)]
    rnds = [tuple(map(int, m)) for m in DENSIFY_RE.findall(err)]
    check(loss[60] < loss[10], f"phase8b: loss {loss[10]} at 10, "
                               f"{loss[60]} at 60")
    check(len(psnr) == 3 and psnr[2] > psnr[0],
          f"phase8b: view-0 PSNR {psnr} at 20, 40, 60")
    check([r[0] for r in rnds] == [20, 30, 40], f"phase8b: rounds {rnds}")
    actives = [P8_POINTS] + [r[4] for r in rnds]
    check(all(b > a for a, b in zip(actives, actives[1:])),
          f"phase8b: the active count {actives} did not rise every round")
    check("[overflow]" not in err and "WARNING" not in err,
          "phase8b: overflow")
    per_step = dict(expand=4, rasterize_mxu=4, rasterize_backward_mxu=4,
                    segsum_bf16=4)
    check(len(steps.launches) == 60, f"phase8b: {len(steps.launches)} steps")
    want = {k: per_step.get(k, 0) for k in total}
    bad = [i + 1 for i, got in enumerate(steps.launches) if got != want]
    check(not bad, f"phase8b: steps {bad} launched other than {per_step}")
    for k in per_step:
        check(total[k] > 0, f"phase8b: {k} never launched")
    ms = steps.step_ms()
    n_final = int(logs[60][3])
    first, last = steps.host[0][0], steps.host[-1][1]
    log(f"phase8b: 60 steps (B = 4, capacity {P8_CAPACITY}, from "
        f"{P8_POINTS} COLMAP points, {P8_RES[0]}x{P8_RES[1]}): CLI wall "
        f"{t_end - t0:.2f} s = set-up {first - t0:.2f} (dataset, init) + "
        f"loop {last - first:.2f} (steps, rounds, evals, checkpoints) + "
        f"tail {t_end - last:.2f} (export, final eval); "
        f"{logs[60][4]} it/s at step 60; step "
        f"median {statistics.median(ms):.3f} ms by CUDA events (first "
        f"{ms[0]:.3f}, after the rounds {statistics.median(ms[40:]):.3f}); "
        f"peak memory {peak:.2f} GiB {tag}")
    log(f"phase8b: loss {' '.join(f'{k}:{v:.5f}' for k, v in loss.items())}; "
        f"view-0 PSNR at 20/40/60 {psnr}; actives {actives} {tag}")
    log(f"phase8b: launches over the run {total}; exactly {per_step} "
        f"every step")
    for r, p in zip(rnds, rounds.rounds):
        q = p["quantiles"]
        log(f"phase8b round at {r[0]}: +{r[1]} cloned +{r[2]} split "
            f"-{r[3]} pruned -> {r[4]}; {p['ms']:.3f} ms; avg NDC grad of "
            f"{p['visible']} visible actives: p50 {q[0]:.3e} p90 {q[1]:.3e} "
            f"p99 {q[2]:.3e} p99.9 {q[3]:.3e} max {q[4]:.3e}; above "
            f"{p['threshold']:g}: {p['above']} {tag}")
    ply = os.path.join(out_dir, "scene_trained.ply")
    check_exported_ply("phase8b", ply, n_final)

    # 8c: the same argv resumed from step 60, ten more steps
    rc, out, err = run_train_cli("phase8c",
                                 argv + ["--iters", "70", "--resume"])
    check(rc == 0, f"phase8c: train_cli returned {rc}")
    check("resumed from step 60" in out, "phase8c: no resume from step 60")
    logs = LOG_RE.findall(out)
    check([int(m[0]) for m in logs] == [70], f"phase8c: log lines {logs}")
    check(int(logs[0][3]) == n_final,
          f"phase8c: {logs[0][3]} active after the resume, {n_final} saved")
    check("[overflow]" not in err, "phase8c: overflow")
    log(f"phase8c: resumed at step 60 with {n_final} actives, loss "
        f"{logs[0][2]} at 70 {tag}")


def phase8_defaults(root, data, work, dev, tag):
    """8d: the CLI's defaults (one view a step, vpu, tile 16, f32) with
    max_pairs below the first view's entries: the capacity grows."""
    import numpy as np
    import torch

    from luisacomputegaussiansplatting_tpu_torch.apps import train_cli
    from luisacomputegaussiansplatting_tpu_torch.config import RenderConfig
    from luisacomputegaussiansplatting_tpu_torch.ops.projection import project_gaussians

    base = ["--colmap", root, "--capacity", str(P8_CAPACITY), "--iters", "12",
            "--log-every", "4", "--out", os.path.join(work, "defaults"),
            "--device", str(dev)]
    # the first view's entries at the CLI's own init (tile 16, no cull:
    # every AABB slot is an entry)
    args = train_cli.build_parser().parse_args(base)
    with contextlib.redirect_stdout(io.StringIO()):
        params = train_cli._init_params(args, data, np.random.default_rng(0),
                                        dev)
    with torch.no_grad():
        scene = params.activate()
        proj = project_gaussians(scene.means, scene.scales, scene.quats,
                                 data.cameras[0], RenderConfig())
        entries = int(proj.tiles_touched.sum())
    del params, scene, proj
    max_pairs = entries // 3
    reset_launches()
    rc, out, err = run_train_cli("phase8d",
                                 base + ["--max-pairs", str(max_pairs)])
    got = read_launches()
    check(rc == 0, f"phase8d: train_cli returned {rc}")
    grows = re.findall(r"\[overflow\] raising max_pairs to (\d+)", err)
    check(len(grows) >= 1, "phase8d: max_pairs never grew")
    for k in ("expand", "rasterize_vpu", "rasterize_backward_vpu",
              "segsum_f32"):
        check(got[k] > 0, f"phase8d: {k} never launched")
    for k in ("rasterize_mxu", "rasterize_backward_mxu", "segsum_bf16"):
        check(got[k] == 0, f"phase8d: {k} launched")
    log(f"phase8d: view 0 has {entries} entries at the init; max_pairs "
        f"{max_pairs} grew to {', '.join(grows)}; launches {got} {tag}")


def timed_viewer_class():
    """A ``ViewerServer`` whose ``render_jpeg`` records each request's
    parts in ``parts``: the render (CUDA events), the device-to-host copy
    with the flip and the uint8 cast, and the JPEG encode (host clock)."""
    import torch

    from luisacomputegaussiansplatting_tpu_torch.apps.viewer import ViewerServer

    class TimedViewer(ViewerServer):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.parts = []

        def render_jpeg(self, pos, front, up, fov, bg):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with self._lock:
                start.record()
                img = self.render_frame(pos, front, up, fov, bg)
                end.record()
                end.synchronize()
                t1 = time.perf_counter()
                hwc = self.frame_to_hwc(img)
                t2 = time.perf_counter()
            jpeg = self.encode_jpeg(hwc)
            t3 = time.perf_counter()
            self.parts.append((start.elapsed_time(end), (t2 - t1) * 1e3,
                               (t3 - t2) * 1e3))
            return jpeg

    return TimedViewer


def phase8_viewer(scene, dev, tag):
    """8e: the viewer on the 2M bench scene at its defaults, served over
    loopback at 1280x720 and 1920x1080: 20 frames on a ring each, their
    latency in four parts, each frame against ``render_view``."""
    import threading
    import urllib.error
    import urllib.request
    from http.server import ThreadingHTTPServer

    import numpy as np
    import torch
    from PIL import Image

    from luisacomputegaussiansplatting_tpu_torch import RenderConfig, look_at_camera
    from luisacomputegaussiansplatting_tpu_torch.apps.viewer import make_handler
    from luisacomputegaussiansplatting_tpu_torch.ops.render import render_view

    # the viewer's defaults (apps/viewer.py main) at max_pairs 16M
    cfg = RenderConfig(max_pairs=P8_MAX_PAIRS, tile=16, pack_mode="none",
                       sort_mode="fused", payload_dtype="bf16",
                       tight_radius=True, tile_cull=True)
    start = (3.5, -3.0, 2.2)
    ring = [c.position for c in ring_cameras(look_at_camera(
        start, (0.0, 0.0, 0.0), (0.0, 0.0, 1.0)), 20)]
    poses = [(p, tuple(-np.asarray(p) / np.linalg.norm(p)), (0.0, 0.0, 1.0))
             for p in ring]
    for w, h in P8_VIEWER_RES:
        srv = timed_viewer_class()(
            scene, w, h, cfg, name="bench 2M", init_pos=start,
            init_target=(0.0, 0.0, 0.0), world_up=(0.0, 0.0, 1.0), fov=P8_FOV,
            device=dev)
        t0 = time.perf_counter()
        srv.warmup()
        warm_ms = (time.perf_counter() - t0) * 1e3
        with torch.no_grad():
            for pos, front, up in poses:
                _, aux = render_view(*srv.scene_args,
                                     srv._build_view(pos, front, up, P8_FOV),
                                     w, h, cfg=cfg)
                check(not bool(aux.overflow),
                      f"phase8e {w}x{h}: a ring pose overflows")
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(srv))
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{httpd.server_port}"
        try:
            with urllib.request.urlopen(url + "/", timeout=60) as r:
                check(r.status == 200 and b"lcgs-tpu viewer" in r.read(),
                      "phase8e: no page")
            reset_launches()
            total_ms, frames = [], []
            for pos, front, up in poses:
                q = (f"pos={','.join(map(str, pos))}&front="
                     f"{','.join(map(str, front))}&up=0,0,1&fov={P8_FOV}"
                     "&bg=%23000000")
                t0 = time.perf_counter()
                with urllib.request.urlopen(f"{url}/frame?{q}",
                                            timeout=60) as r:
                    body = r.read()
                total_ms.append((time.perf_counter() - t0) * 1e3)
                check(r.headers["Content-Type"] == "image/jpeg",
                      "phase8e: not a JPEG")
                frames.append(body)
            launches = read_launches()
            try:
                urllib.request.urlopen(f"{url}/frame?pos=1,2", timeout=60)
                bad = 200
            except urllib.error.HTTPError as e:
                bad = e.code
            check(bad == 400, f"phase8e: a malformed query got {bad}")
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=30)
        check(len(srv.parts) == len(poses), "phase8e: requests not timed")
        check(launches["expand"] == len(poses)
              and launches["rasterize_vpu"] == len(poses),
              f"phase8e: launches {launches}")
        render, d2h, jpeg = (list(x) for x in zip(*srv.parts))
        rest = [t - r - c - j for t, r, c, j in zip(total_ms, render, d2h,
                                                     jpeg)]
        psnrs = []
        for (pos, front, up), body in zip(poses, frames):
            got = np.asarray(Image.open(io.BytesIO(body)), np.float64)
            want = srv.frame_to_hwc(srv.render_frame(pos, front, up, P8_FOV,
                                                     (0.0, 0.0, 0.0)))
            mse = float(np.mean((got - want) ** 2))
            psnrs.append(10.0 * math.log10(255.0 ** 2 / max(mse, 1e-12)))
        check(min(psnrs) >= 35.0, f"phase8e {w}x{h}: PSNR {min(psnrs):.2f}")
        med = statistics.median
        log(f"phase8e {w}x{h}: {len(poses)} frames over loopback, median ms: "
            f"request {med(total_ms):.3f} = render {med(render):.3f} (CUDA "
            f"events) + copy/flip/cast {med(d2h):.3f} + JPEG "
            f"{med(jpeg):.3f} + HTTP/parsing {med(rest):.3f}; first frame "
            f"(kernel build, warm-up) {warm_ms:.1f} ms; JPEG "
            f"{statistics.mean(map(len, frames)) / 1024:.0f} KiB; served vs "
            f"render_view PSNR min {min(psnrs):.2f} dB; launches {launches} "
            f"{tag}")
        log(f"phase8e {w}x{h}: request ms "
            f"{' '.join(f'{v:.2f}' for v in total_ms)}")


def phase8(dev, card):
    """The dataset loaders, the train CLI and the viewer at full width: a
    COLMAP binary dataset of the 2M bench scene's renders (8a), production
    training through the CLI from its 300K points at 2M capacity (8b), a
    resume (8c), the CLI's defaults with capacity growth (8d), and the
    viewer's latency (8e)."""
    from luisacomputegaussiansplatting_tpu_torch import random_scene

    tag = f"[{card}]"
    work = os.path.join(ROOT, "build", "chip_smoke", "phase8")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t0 = time.perf_counter()
    scene = random_scene(P8_SCENE, seed=0, extent=3.0,
                         scale_range=(0.004, 0.02), device=dev)
    root, data = phase8_dataset(scene, work, dev, tag)
    phase8_train(root, work, dev, tag)
    phase8_defaults(root, data, work, dev, tag)
    del data
    phase8_viewer(scene, dev, tag)
    log(f"phase8: {time.perf_counter() - t0:.1f} s")


#: phase 9: the production frame's tile grid (60 x 34 tiles of 32) in bands
P9_BANDS = 4
P9_REPS = 10
P9_STEPS = 5
#: phase 9c: ranks sharing the one card, each its quarter of the 2M scene
P9_RANKS = 4
P9_RANK_PAIRS = 1_500_000  # max_pairs_local of a 9c rank (CHUNK-rounded)
#: keyword arguments of ``bench_cuda.scene_camera_config`` that shrink
#: phase 9's scene for a rehearsal on the CPU (none on the card)
P9_SHRINK = {}


def p9_config(dev, shrink=None):
    """The production configuration of ``bench.py`` with the two settings
    the sharded path rejects changed: the sort is "2key" and the post-sort
    trim is off (``_validate_sharded_cfg``)."""
    import bench_cuda

    return bench_cuda.scene_camera_config(
        "headline", dev, sort_mode="2key", max_pairs_sorted=None,
        **(P9_SHRINK if shrink is None else shrink))


def p9_timed(fn, dev):
    """(result, milliseconds) of one run: CUDA events on the card, the host
    clock in a CPU rehearsal."""
    if dev.type == "cuda":
        return timed_once(fn)
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def band_blend_diff(ck, tk, cp, tp):
    """(max |diff|, pixels over TOL, pixels) between two blends of a band's
    tiles, over colour and T (pixels past the image are 0 in both)."""
    import torch

    d = torch.maximum((ck - cp).abs().amax(dim=2), (tk - tp).abs()[..., 0])
    check(bool(torch.isfinite(ck).all() and torch.isfinite(tk).all()),
          "non-finite band blend")
    return float(d.max()), int((d > TOL).sum()), d.numel()


def phase9a(scene, cam, cfg):
    """K2 and K3, vpu and mxu, on each band of the production frame's ranges
    at its first global tile: against their plain versions with the same
    offset, and equal bit for bit to the whole-frame blend's tiles (K2) and
    to the whole-frame backward's slots (K3). Returns the kernels-line
    records of band 1's mxu blends (its time beside its plain version's)."""
    import torch

    from luisacomputegaussiansplatting_tpu_torch.ops.rasterize import rasterize_backward, rasterize_forward
    from luisacomputegaussiansplatting_tpu_torch.ops.rasterize_ref import rasterize_backward_reference, rasterize_reference

    w, h = cam.width, cam.height
    _proj, (gx, gy), binned, payload = bin_and_payload(scene, cam, cfg)
    on_card = payload.is_cuda
    rows = -(-gy // P9_BANDS)
    fields = ("mx", "my", "ca", "cb", "cc", "op", "r", "g", "b")
    out = {}
    for blend in ("vpu", "mxu"):
        bcfg = dataclasses.replace(cfg, blend_quad=blend)
        ranges = (binned.tile_starts, binned.tile_counts)
        with torch.no_grad():
            c_all, t_all = rasterize_forward(payload, *ranges, gx, w, h, bcfg)
            residual = random_residual(c_all, t_all, 9)
            d_all = rasterize_backward(payload, *ranges, residual, gx, w, h,
                                       bcfg)
        for d in range(P9_BANDS):
            lo, hi = d * rows * gx, min((d + 1) * rows * gx, gx * gy)
            if hi <= lo:  # a band wholly past the image
                continue
            tag = f"phase9a {blend} band {d} (tiles {lo}-{hi - 1})"
            band = (binned.tile_starts[lo:hi], binned.tile_counts[lo:hi])
            slots = torch.zeros(payload.shape[1], dtype=torch.bool,
                                device=payload.device)
            for s, c in zip(band[0].tolist(), band[1].tolist()):
                slots[s:s + c] = True
            keep = slots & (binned.entry_gid >= 0)
            with torch.no_grad():
                ck, tk = rasterize_forward(payload, *band, gx, w, h, bcfg,
                                           tile_offset=lo)
                cp, tp = rasterize_reference(payload, *band, gx, w, h, bcfg,
                                             tile_offset=lo)
                # a block blends one tile on its own: the kernels give a
                # band's tiles the whole frame's bits (the plain versions,
                # batched by shape, need not)
                check(not on_card or (torch.equal(ck, c_all[lo:hi])
                                      and torch.equal(tk, t_all[lo:hi])),
                      f"{tag}: K2 at the offset differs from the whole "
                      "frame's tiles")
                max_d = band_blend_diff(ck, tk, cp, tp)
                check_blend(tag, *max_d)
                dk = rasterize_backward(payload, *band, residual[lo:hi], gx,
                                        w, h, bcfg, tile_offset=lo)
                check(not on_card
                      or torch.equal(dk[:, slots], d_all[:, slots]),
                      f"{tag}: K3 at the offset differs from the whole "
                      "frame's slots")
                dp = rasterize_backward_reference(
                    payload, *band, residual[lo:hi], gx, w, h, bcfg,
                    tile_offset=lo)
                b3 = check_fields(tag, "d_payload", dk.t(), dp.t(), fields,
                                  rows=keep)
            if d == 1 and blend == "mxu":
                out = dict(band=band, lo=lo, residual=residual[lo:hi],
                           k2_err=max_d[0], k3_err=float(
                               (dk[:, keep] - dp[:, keep]).abs().max()),
                           k3_rel=b3)
        log(f"phase9a {blend}: {P9_BANDS} bands of {rows} tile rows, K2 and "
            "K3 at each band's offset equal the whole frame's bits and "
            "their plain versions")
    # band 1's mxu kernels timed beside their plain versions, with bounds
    band, lo, res = out["band"], out["lo"], out["residual"]
    reps = 5
    with torch.no_grad():
        k2_ms = cuda_ms(lambda: rasterize_forward(
            payload, *band, gx, w, h, cfg, tile_offset=lo), reps)
        k2_plain = cuda_ms(lambda: rasterize_reference(
            payload, *band, gx, w, h, cfg, tile_offset=lo), 2)
        k3_ms = cuda_ms(lambda: rasterize_backward(
            payload, *band, res, gx, w, h, cfg, tile_offset=lo), reps)
        k3_plain = cuda_ms(lambda: rasterize_backward_reference(
            payload, *band, res, gx, w, h, cfg, tile_offset=lo), 2)
        evaluated, applied = pair_counts(payload, *band, gx, w, h, cfg,
                                         tile_offset=lo)
    nt = band[0].shape[0]
    pix = cfg.tile_wh[0] * cfg.tile_wh[1]
    used = int(band[1].sum())
    k2_bound = bound(used * 9 * 4 + nt * 8 + nt * pix * 16,
                     evaluated * OPS_PER_PAIR["mxu"]
                     + applied * OPS_PER_APPLIED["forward"])
    k3_bound = bound(used * 9 * 4 * 2 + nt * pix * 32 + nt * 8,
                     evaluated * OPS_PER_PAIR["mxu"]
                     + applied * OPS_PER_APPLIED["backward"])
    log(f"phase9a band 1 (offset {lo}, {nt} tiles, {used} entries): mxu "
        f"blend {k2_ms:.3f} ms (plain {k2_plain:.3f}, bound "
        f"{k2_bound[0]:.3f} {k2_bound[1]}); mxu backward blend "
        f"{k3_ms:.3f} ms (plain {k3_plain:.3f}, bound {k3_bound[0]:.3f} "
        f"{k3_bound[1]}); pairs evaluated {evaluated} applied {applied}")
    return [
        {"name": "rasterize_forward_mxu_band", "route": "cuda",
         "source": f"{PKG}/rasterize.cu",
         "replaces": f"{JAX_OPS}/rasterize_pallas.py:282",
         "max_abs_err": out["k2_err"], "ms": k2_ms, "plain_ms": k2_plain,
         "bound_ms": k2_bound[0], "bound_by": k2_bound[1],
         "library_ms": None},
        {"name": "rasterize_backward_mxu_band", "route": "cuda",
         "source": f"{PKG}/rasterize_backward.cu",
         "replaces": f"{JAX_OPS}/rasterize_pallas.py:448",
         "max_abs_err": out["k3_err"], "ms": k3_ms, "plain_ms": k3_plain,
         "bound_ms": k3_bound[0], "bound_by": k3_bound[1],
         "library_ms": None},
    ]


def p9_frame(shard, cam, mesh, cfg, scfg):
    """One sharded forward + backward frame (loss = the sum of the rank's
    band, so the ranks' losses add up to the image sum): (band, aux, the
    shard's five gradients)."""
    import torch

    from luisacomputegaussiansplatting_tpu_torch.parallel.render_sharded import render_sharded

    band, aux = render_sharded(*shard, cam, mesh, cfg=cfg, scfg=scfg)
    grads = torch.autograd.grad(band.sum(), shard)
    return band, aux, grads


#: the autograd Functions of the sharded frame, whose backwards a profile
#: reads beside the forward's ``render_sharded.<stage>`` ranges
P9_FUNCTIONS = ("_TakeTableRows", "_SliceBuckets", "_ExchangeRows",
                "_PermuteRows", "_PackGather", "_RasterizeTiles")


def p9_stage_profile(fn, dev):
    """[(stage, ms)] of one profiled call of ``fn`` (a sharded frame): the
    forward's ``render_sharded.<stage>`` ranges and the backwards of the
    exchange's Functions, each with the device time of the kernels under
    it (host time in a CPU rehearsal)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        sync(dev)
    out = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CPU:
            continue  # the ranges' spans on the device timeline
        name = e.key.replace("autograd::engine::evaluate_function: ", "bwd ")
        if e.key.startswith("render_sharded.") or (
                name.startswith("bwd ")
                and name[4:].removesuffix("Backward") in P9_FUNCTIONS):
            total = e.device_time_total if dev.type == "cuda" else e.cpu_time_total
            out.append((name, total / 1e3))
    return out


def p9_sharded_k1_k4(scene, cam, cfg, scfg, n):
    """K1 at the sharded frame's shapes (the band-padded grid) and K4 f32 on
    its stream's ids (the tile-sorted local entries, stably sorted by id)
    with rows of the frame's size: times, plain times, bounds, errors."""
    import torch

    from luisacomputegaussiansplatting_tpu_torch.ops.binning import expand_entries
    from luisacomputegaussiansplatting_tpu_torch.ops.expand import expand_entries_kernel
    from luisacomputegaussiansplatting_tpu_torch.ops.projection import project_gaussians
    from luisacomputegaussiansplatting_tpu_torch.ops.segsum import segment_sum_kernel, segment_sum_reference
    from luisacomputegaussiansplatting_tpu_torch.parallel.render_sharded import band_layout

    lay = band_layout(cam.width, cam.height, cfg, 1)
    nt = lay.tiles_per_dev
    l_loc = scfg.max_pairs_local
    cull_op = cull_opacity(scene, cfg)
    reps = 5
    with torch.no_grad():
        proj = project_gaussians(scene.means, scene.scales, scene.quats, cam,
                                 cfg)
        k, k1_err = compare_expansion(proj, lay.grid_x, nt, l_loc, cull_op,
                                      cfg.tile_wh, cfg)
        aabb = int(k[3])
        k1_ms = cuda_ms(lambda: expand_entries_kernel(
            proj, lay.grid_x, nt, l_loc, cull_op, cfg.tile_wh,
            cfg.alpha_min), reps)
        k1_plain = cuda_ms(lambda: expand_entries(
            proj, lay.grid_x, nt, l_loc, cull_op, cfg.tile_wh,
            cfg.alpha_min), reps)
        _t, order = torch.sort(k[0], stable=False)
        gid = k[2][order]
        key = torch.where(gid >= 0, gid, torch.full_like(gid, n))
        sorted_key, perm = torch.sort(key, stable=True)
        gen = torch.Generator(device=gid.device).manual_seed(9)
        rows = torch.randn((gid.shape[0], 9), generator=gen,
                           device=gid.device)[perm]
        got = segment_sum_kernel(sorted_key, rows, n, "f32")
        want = segment_sum_reference(sorted_key, rows, n, "f32")
        k4_err, _rel = check_sums("phase9b segsum f32", got, want)
        k4_ms = cuda_ms(lambda: segment_sum_kernel(sorted_key, rows, n,
                                                   "f32"), reps)
        k4_plain = cuda_ms(lambda: segment_sum_reference(
            sorted_key, rows, n, "f32"), reps)
        key64 = sorted_key.to(torch.int64)
        lib_rows = torch.where((sorted_key < n)[:, None], rows, 0.0)
        acc = torch.zeros((n + 1, 9), device=gid.device)
        k4_lib = cuda_ms(lambda: acc.index_add_(0, key64, lib_rows), reps)
        n_valid = int((sorted_key < n).sum())
    k1_bound = bound(n * (28 + 24) + l_loc * 12, aabb * 40)
    k4_bound = bound(n_valid * (9 * 4 + 4) + n * 9 * 4, n_valid * 9)
    log(f"phase9b: K1 at the band-padded grid ({nt} tiles, max_pairs_local "
        f"{l_loc}, AABB slots {aabb}) {k1_ms:.3f} ms (plain {k1_plain:.3f}, "
        f"bound {k1_bound[0]:.3f} {k1_bound[1]}); K4 f32 on the frame's ids "
        f"{k4_ms:.3f} ms (plain {k4_plain:.3f}, index_add_ {k4_lib:.3f}, "
        f"bound {k4_bound[0]:.3f} {k4_bound[1]}), rows summed {n_valid}")
    return [
        {"name": "expand_entries_sharded", "route": "cuda",
         "source": f"{PKG}/expand.cu",
         "replaces": f"{JAX_OPS}/expand_pallas.py:137",
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain,
         "bound_ms": k1_bound[0], "bound_by": k1_bound[1],
         "library_ms": None},
        {"name": "segment_sum_f32_sharded", "route": "cuda",
         "source": f"{PKG}/segsum.cu",
         "replaces": f"{JAX_OPS}/segsum.py:46",
         "max_abs_err": k4_err, "ms": k4_ms, "plain_ms": k4_plain,
         "bound_ms": k4_bound[0], "bound_by": k4_bound[1],
         "library_ms": k4_lib},
    ]


def backward_scatter_check(tag, fn):
    """``fn()`` (a training step) under the profiler: fails if its backward
    ran a scatter-add (``utils/profiling.scatter_ops`` of the ops under the
    autograd engine); logs the backward's aten ops and their counts.
    Returns (the result, {op: calls})."""
    import collections

    import torch

    from luisacomputegaussiansplatting_tpu_torch.utils.profiling import backward_events, scatter_ops

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            record_shapes=True) as prof:
        out = fn()
    events = backward_events(prof)
    counts = dict(collections.Counter(
        e.name for e in events if e.name.startswith("aten::")).most_common())
    bad = scatter_ops(events)
    log(f"{tag}: the backward's aten ops (calls): "
        + ", ".join(f"{k.removeprefix('aten::')} {v}"
                    for k, v in counts.items()))
    check(counts, f"{tag}: the profile recorded no backward")
    check(not bad, f"{tag}: the backward ran scatter-adds {sorted(set(bad))}")
    return out, counts


def p9_train(tag, mesh, cams, scene, cfg, scfg, dev, steps):
    """``steps`` sharded training steps with densify on ``mesh`` (this
    rank's shard of a 2M-capacity state with every other row active,
    opacity logits lowered by 1, towards the full scene's renders of
    ``cams``), the first under the profiler, whose backward must run no
    scatter-add (``backward_scatter_check``), then one sharded densify
    round. Returns (losses, ms per step, overflow seen, launches of the
    first step, the round's counters)."""
    import torch

    from luisacomputegaussiansplatting_tpu_torch.models import DensifyConfig, DensifyState, init_densify_state, init_train_state
    from luisacomputegaussiansplatting_tpu_torch.ops.render import render_aux
    from luisacomputegaussiansplatting_tpu_torch.parallel.train_sharded import densify_sharded, make_sharded_train_step
    from luisacomputegaussiansplatting_tpu_torch.utils.camera import CameraView

    n = scene.num_gaussians
    n_gs = mesh.size(1)
    g = mesh.get_local_rank("gs")
    p = n // n_gs
    mine = slice(g * p, (g + 1) * p)
    with torch.no_grad():
        targets = torch.stack([render_aux(*scene.render_args(), c,
                                          cfg=cfg)[0] for c in cams])
    start = scene.to_params()
    start = start._replace(opacity_logits=start.opacity_logits - 1.0)
    state, opt = init_train_state(type(start)(*(x[mine] for x in start)))
    # half the rows active, every other one, so each gs shard holds its
    # share of the entries
    d_full = init_densify_state(n, n, device=dev)
    d_full = d_full._replace(active=torch.arange(n, device=dev) % 2 == 0)
    dstate = DensifyState(*(x[mine].clone() for x in d_full))
    step, _o, pad = make_sharded_train_step(opt, mesh, cams[0].width,
                                            cams[0].height, cfg=cfg,
                                            scfg=scfg, densify=True)
    views = [c.to_view(dev) for c in cams]
    views = CameraView(*(torch.stack(x) for x in zip(*views)))
    padded = pad(targets)
    del targets
    losses, ms, over, first = [], [], False, None
    for i in range(steps):
        reset_launches()
        t0 = time.perf_counter()
        if i == 0:
            (state, dstate, loss, ov), _ = backward_scatter_check(
                f"{tag} step 0", lambda: step(state, dstate, views, padded))
        else:
            state, dstate, loss, ov = step(state, dstate, views, padded)
        losses.append(float(loss))  # synchronises
        ms.append((time.perf_counter() - t0) * 1e3)
        over = over or bool(ov)
        if i == 0:
            first = read_launches()
    gen = torch.Generator(device=dev).manual_seed(0)
    _p, opt, dstate, info = densify_sharded(
        state.params, opt, dstate, gen, 3.0, DensifyConfig(), mesh)
    log(f"{tag}: losses {' '.join(f'{v:.6f}' for v in losses)}; ms per "
        f"step median {statistics.median(ms):.3f} (all: "
        f"{' '.join(f'{v:.3f}' for v in ms)}); densify round: "
        f"+{int(info.n_cloned)} cloned +{int(info.n_split)} split "
        f"-{int(info.n_pruned)} pruned")
    return losses, ms, over, first, info


def phase9b(scene, cam, cfg, dev, tmp):
    """World size 1 in this process (NCCL on the card): the sharded frame
    against the single-device frame, its launches, times and peak memory;
    then sharded training on a 1x1 mesh and a sharded densify round.
    Returns (kernels-line records, the frame's launches, the frame's image
    and gradients for 9c)."""
    import torch
    import torch.distributed as dist

    from luisacomputegaussiansplatting_tpu_torch.config import CHUNK
    from luisacomputegaussiansplatting_tpu_torch.ops.render import render_aux
    from luisacomputegaussiansplatting_tpu_torch.parallel.mesh import initialize_multihost, make_mesh
    from luisacomputegaussiansplatting_tpu_torch.parallel.render_sharded import ShardedRenderConfig, gather_image

    on_card = dev.type == "cuda"
    initialize_multihost(f"file://{tmp}/store9b", 1, 0,
                         backend="nccl" if on_card else "gloo")
    try:
        mesh = make_mesh((1,), ("gs",), device=dev.type)
        cap = -(-cfg.max_pairs // CHUNK) * CHUNK
        scfg = ShardedRenderConfig(max_pairs_local=cap, exchange_capacity=cap)
        n = scene.num_gaussians
        leaves = grad_leaves(scene)

        # the main path: one sharded frame, the launches over exactly it
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        band, aux, grads = p9_frame(leaves, cam, mesh, cfg, scfg)
        sync(dev)
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated(dev) / 2**30 if on_card else None
        check_launches("phase9b sharded frame", launches, expand=1,
                       rasterize_mxu=1, rasterize_backward_mxu=1,
                       segsum_f32=1)
        check(not bool(aux.overflow), "phase9b: overflow")
        image = gather_image(band, mesh, cam.width, cam.height)

        # the single-device frame on the same configuration
        leaves1 = grad_leaves(scene)
        img1, aux1 = render_aux(*leaves1, cam, cfg=cfg)
        grads1 = torch.autograd.grad(img1.sum(), leaves1)
        img_d = float((image - img1.detach()).abs().max())
        log(f"phase9b: sharded image vs single-device image max|d|="
            f"{img_d:.3e}; num_rendered sharded {int(aux.num_rendered)} "
            f"(the expansion's entries), single-device "
            f"{int(aux1.num_rendered)} (after the cull)")
        check(img_d <= 2e-5, "phase9b: the sharded image differs from the "
                             "single-device image")
        names = ("means", "scales", "quats", "opacities", "sh")
        for name, a, b in zip(names, grads, grads1):
            check(bool(torch.isfinite(a).all()) and float(a.abs().max()) > 0,
                  f"phase9b: gradient of {name} not finite or zero")
            check_fields("phase9b", "gradient", a.reshape(-1, 1),
                         b.reshape(-1, 1), [name])
        del leaves1, img1, aux1, grads1, band

        # reps of both frames, in turns, each synchronised
        def sharded():
            return p9_frame(leaves, cam, mesh, cfg, scfg)[2][0]

        def single():
            img, _ = render_aux(*leaves, cam, cfg=cfg)
            return torch.autograd.grad(img.sum(), leaves)[0]

        times = {"sharded": [], "single": []}
        for _ in range(P9_REPS):
            for key, fn in (("single", single), ("sharded", sharded)):
                times[key].append(p9_timed(fn, dev)[1])
        med = {k: statistics.median(v) for k, v in times.items()}
        log(f"phase9b: fwd+bwd frame median of {P9_REPS}: sharded (world "
            f"size 1) {med['sharded']:.3f} ms, single-device "
            f"{med['single']:.3f} ms, the exchange path "
            f"{med['sharded'] - med['single']:.3f} ms; peak memory of the "
            f"sharded frame {peak if peak is None else round(peak, 3)} GiB "
            f"(all sharded: {' '.join(f'{v:.3f}' for v in times['sharded'])}"
            f"; single: {' '.join(f'{v:.3f}' for v in times['single'])})")
        stages = p9_stage_profile(sharded, dev)
        log("phase9b: one profiled sharded frame, ms of device time under "
            "each stage: " + "; ".join(f"{k} {v:.3f}" for k, v in stages))
        records = p9_sharded_k1_k4(scene, cam, cfg, scfg, n)
        for r, k in zip(records, ("expand", "segsum_f32")):
            r["launches"] = launches[k]
        ref = {"image": image.cpu(),
               "grads": [g.detach().cpu() for g in grads],
               "num_rendered": int(aux.num_rendered)}
        del leaves, grads

        # training on a 1x1 mesh, then a sharded densify round
        mesh2 = make_mesh((1, 1), ("data", "gs"), device=dev.type)
        losses, _ms, over, first, _info = p9_train(
            "phase9b training (1x1 mesh)", mesh2, [cam], scene, cfg, scfg,
            dev, P9_STEPS)
        check_launches("phase9b training step", first, expand=1,
                       rasterize_mxu=1, rasterize_backward_mxu=1,
                       segsum_f32=1)
        check(not over, "phase9b training: overflow")
        check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
              "phase9b training: the loss did not fall")
    finally:
        dist.destroy_process_group()
    return records, launches, ref


def p9c_rank(rank, tmp, dev_type, shrink, rank_pairs):
    """One of 9c's ranks: its quarter of the 2M scene on the one card,
    gloo with the card's tensors (NCCL takes one rank per device); the
    sharded frame, then sharded training on a 2x2 mesh. Rank 0 saves the
    assembled image, the gathered gradients and the numbers."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from luisacomputegaussiansplatting_tpu_torch.parallel.mesh import initialize_multihost, make_mesh
    from luisacomputegaussiansplatting_tpu_torch.parallel.render_sharded import ShardedRenderConfig, gather_image
    from luisacomputegaussiansplatting_tpu_torch.parallel.train_sharded import exchange_band_halos

    dev = torch.device(dev_type, 0) if dev_type == "cuda" else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cudnn.allow_tf32 = False
    initialize_multihost(f"file://{tmp}/store9c", P9_RANKS, rank,
                         backend="gloo")
    try:
        scene, cam, cfg, _ = p9_config(dev, shrink)
        n = scene.num_gaussians
        p = n // P9_RANKS
        shard = [x[rank * p:(rank + 1) * p].detach().clone()
                 .requires_grad_(True) for x in scene.render_args()]
        mesh = make_mesh((P9_RANKS,), ("gs",), device=dev.type)
        scfg = ShardedRenderConfig(max_pairs_local=rank_pairs)
        times = []
        for _ in range(3):  # the first builds nothing (9b did) but warms up
            reset_launches()
            (band, aux, grads), ms = p9_timed(
                lambda: p9_frame(shard, cam, mesh, cfg, scfg), dev)
            times.append(ms)
        launches = read_launches()
        image = gather_image(band, mesh, cam.width, cam.height)
        group = mesh.get_group("gs")
        # the SSIM halo swap of a training step: prediction and target of
        # one band (6 channels) with its neighbours
        x = torch.rand((6, band.shape[1], band.shape[2]), device=dev)
        halo_ms = [p9_timed(lambda: exchange_band_halos(x, group, rank,
                                                        P9_RANKS), dev)[1]
                   for _ in range(5)]
        full = []
        for gr in grads:
            parts = [torch.empty_like(gr) for _ in range(P9_RANKS)]
            dist.all_gather(parts, gr.contiguous(), group=group)
            full.append(torch.cat(parts).cpu())
        if rank == 0:
            torch.save({"image": image.cpu(), "grads": full,
                        "overflow": bool(aux.overflow),
                        "num_rendered": int(aux.num_rendered),
                        "frame_ms": times, "launches": launches,
                        "halo_ms": halo_ms, "band": tuple(x.shape)},
                       os.path.join(tmp, "p9c_frame.pt"))
        del band, grads, full, shard
        mesh2 = make_mesh((2, P9_RANKS // 2), ("data", "gs"), device=dev.type)
        cams = ring_cameras(cam, 2)
        losses, ms, over, first, _info = p9_train(
            f"phase9c training rank {rank} (2x2 mesh)", mesh2, cams, scene,
            cfg, scfg, dev, P9_STEPS)
        if rank == 0:
            with open(os.path.join(tmp, "p9c_train.json"), "w") as f:
                json.dump({"losses": losses, "ms": ms, "overflow": over,
                           "launches": first}, f)
    finally:
        dist.destroy_process_group()


def phase9c(ref, dev, tmp):
    """Four ranks on the one card through gloo: the assembled frame and the
    gradients against 9b's, then five training steps on a 2x2 mesh."""
    import torch
    import torch.multiprocessing as mp

    mp.start_processes(p9c_rank, args=(tmp, dev.type, P9_SHRINK,
                                       P9_RANK_PAIRS),
                       nprocs=P9_RANKS, join=True, start_method="spawn")
    got = torch.load(os.path.join(tmp, "p9c_frame.pt"))
    img_d = float((got["image"] - ref["image"]).abs().max())
    log(f"phase9c: {P9_RANKS} ranks on one card (gloo): image vs 9b max|d|="
        f"{img_d:.3e}; num_rendered {got['num_rendered']} (9b: "
        f"{ref['num_rendered']}); overflow {got['overflow']}; sharded frame "
        f"ms (rank 0, the ranks share the card and exchange through the "
        f"host): {' '.join(f'{v:.3f}' for v in got['frame_ms'])}; rank 0 "
        f"launches {got['launches']}; a halo swap of a {got['band']} band "
        f"ms {' '.join(f'{v:.3f}' for v in got['halo_ms'])}")
    check(not got["overflow"], "phase9c: overflow")
    check(img_d <= 2e-5, "phase9c: the image differs from 9b's")
    names = ("means", "scales", "quats", "opacities", "sh")
    for name, a, b in zip(names, got["grads"], ref["grads"]):
        check_fields("phase9c", "gradient", a.reshape(-1, 1),
                     b.reshape(-1, 1), [name])
    with open(os.path.join(tmp, "p9c_train.json")) as f:
        tr = json.load(f)
    log(f"phase9c training (2x2 mesh, rank 0): losses "
        f"{' '.join(f'{v:.6f}' for v in tr['losses'])}; ms per step "
        f"{' '.join(f'{v:.3f}' for v in tr['ms'])}; launches of the first "
        f"step {tr['launches']}")
    check(not tr["overflow"], "phase9c training: overflow")
    check(all(map(math.isfinite, tr["losses"]))
          and tr["losses"][-1] < tr["losses"][0],
          "phase9c training: the loss did not fall")


def phase9(dev, card):
    """The sharded path (``parallel/``) on the card: 9a the kernels' tile
    offset on the production frame's bands, 9b world size 1 over NCCL in
    this process, 9c four ranks sharing the card through gloo."""
    import tempfile

    t0 = time.perf_counter()
    scene, cam, cfg, _ = p9_config(dev)
    records = phase9a(scene, cam, cfg)
    with tempfile.TemporaryDirectory() as tmp:
        rec, launches, ref = phase9b(scene, cam, cfg, dev, tmp)
        # the band kernels' launches: those of 9b's sharded frame
        records[0]["launches"] = launches["rasterize_mxu"]
        records[1]["launches"] = launches["rasterize_backward_mxu"]
        records += rec
        del scene
        t1 = time.perf_counter()
        phase9c(ref, dev, tmp)
    log(f"phase9: 9a+9b {t1 - t0:.1f} s, 9c {time.perf_counter() - t1:.1f} s "
        f"({card})")
    return records


# ---- phase 10: the real-scene quality proof --------------------------------

PROOF = "luisacomputegaussiansplatting_tpu_torch.scripts.real_scene_proof"
#: the proof's gates, against the JAX package's run of the same proof
#: (docs/proof_r5/proof_report.json: held-out PSNR 21.81 dB and SSIM 0.949,
#: its device frame against the CPU's max 8.09e-3 and mean 1.40e-5); the
#: 0.5 dB allow for the other random numbers (numpy and torch, not jax)
P10_PSNR = 21.3
P10_SSIM = 0.94
P10_PNG_TOL = 1.5 / 255.0
P10_PARITY_MAX = 8.1e-3
P10_PARITY_MEAN = 1.4e-5
#: and the port's own parity, inside JAX's: its kernels keep the plain
#: versions' op order (measured max 1.33e-5, mean 4.1e-8 on the H100)
P10_PORT_PARITY_MAX = 1e-4
P10_PORT_PARITY_MEAN = 1e-6
#: the train step profiled (degree 3, after the last densify round)
P10_PROFILE_STEP = 3001
FINAL_RE = re.compile(r"final: loss (\S+), view0 PSNR (\S+) dB, SSIM (\S+)")
CKPT_RE = re.compile(r"checkpoint (\d+) saved in (\S+) s")


def p10_argv(stage, root, dev, flags):
    return [stage, "--root", root, "--device", str(dev), "--rig", "interp",
            *flags]


def p10_subprocess(tag, stage, root, dev, flags):
    """One stage of the proof as a user runs it, in its own process: its
    seconds; its output is logged (without the progress dots)."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-u", "-m", PROOF,
                        *p10_argv(stage, root, dev, flags)],
                       capture_output=True, text=True, cwd=ROOT, timeout=900)
    secs = time.perf_counter() - t0
    for line in (r.stdout + r.stderr).splitlines():
        if line.strip("."):
            log(f"{tag}: {line}")
    check(r.returncode == 0, f"{tag}: exited {r.returncode}")
    return secs


class ProfiledStepProbe(StepProbe):
    """A StepProbe whose step number ``at`` (counted from 1 over every step
    factory it made) also runs under ``utils/profiling.call_profile``. It
    keeps the last step's output (``last``) and the RenderConfig the steps
    were made with (``cfg``)."""

    def __init__(self, make, at, dev):
        super().__init__(make)
        self.at, self.dev, self.profile = at, dev, None
        self.last = self.cfg = None

    def __call__(self, *args, **kw):
        from luisacomputegaussiansplatting_tpu_torch.utils.profiling import call_profile

        probed = super().__call__(*args, **kw)
        self.cfg = kw["cfg"]

        def maybe_profiled(*a):
            if len(self.launches) + 1 != self.at:
                self.last = probed(*a)
            else:
                out = []
                self.profile = call_profile(
                    lambda: out.append(probed(*a)), self.dev)
                self.last = out[0]
            return self.last

        return maybe_profiled


def p10_report(root):
    with open(os.path.join(root, "proof_report.json")) as f:
        return json.load(f)


def phase10_train(root, res, dev, tag, flags, ckpt_every):
    """The train stage in this process (the proof's ``main``), each step's
    kernel launches and CUDA-event span recorded, each densify round's
    gradient quantiles; then the four kernels against their plain versions
    on the trained state and training view 0."""
    from luisacomputegaussiansplatting_tpu_torch.apps import train_cli
    from luisacomputegaussiansplatting_tpu_torch.io.dataset import load_nerf_synthetic
    from luisacomputegaussiansplatting_tpu_torch.scripts import real_scene_proof as proof

    argv = p10_argv("train", root, dev, flags) + [
        "--train-extra", f"--ckpt-every {ckpt_every}"]
    steps = ProfiledStepProbe(train_cli.make_batched_train_step,
                              P10_PROFILE_STEP, dev)
    rounds = DensifyProbe(train_cli.densify_step)
    reset_launches()
    t0 = time.perf_counter()
    rc, out, err = run_train_cli("phase10 train", argv, main=proof.main,
                                 make_batched_train_step=steps,
                                 densify_step=rounds)
    secs = time.perf_counter() - t0
    total = read_launches()
    check(rc == 0, f"phase10 train: returned {rc}")
    cli = p10_report(root)["train"]["train_argv"]

    def flag(name):
        return int(cli[cli.index(name) + 1])

    iters, capacity = flag("--iters"), flag("--capacity")
    logs = {int(m[0]): m for m in LOG_RE.findall(out)}
    check(sorted(logs) == list(range(50, iters + 1, 50)),
          f"phase10 train: log lines at {sorted(logs)}")
    loss = {k: float(m[2]) for k, m in logs.items()}
    check(loss[iters] < loss[50],
          f"phase10 train: loss {loss[50]} at 50, {loss[iters]} at {iters}")
    # two views a step: K1, K2 vpu, K3 vpu and K4 f32 twice every step;
    # the final view-0 render adds one K1 and one K2
    per_step = dict(expand=2, rasterize_vpu=2, rasterize_backward_vpu=2,
                    segsum_f32=2)
    check(len(steps.launches) == iters,
          f"phase10 train: {len(steps.launches)} steps")
    want = {k: per_step.get(k, 0) for k in total}
    bad = [i + 1 for i, got in enumerate(steps.launches) if got != want]
    check(not bad, f"phase10 train: steps {bad[:10]} launched other than "
                   f"{per_step}")
    check_launches("phase10 train", total, expand=2 * iters + 1,
                   rasterize_vpu=2 * iters + 1,
                   rasterize_backward_vpu=2 * iters, segsum_f32=2 * iters)
    check("[overflow]" not in err and "WARNING" not in err,
          "phase10 train: overflow")
    rnds = [tuple(map(int, m)) for m in DENSIFY_RE.findall(err)]
    actives = [flag("--init-points")] + [r[4] for r in rnds]
    n_final = int(logs[iters][3])
    check(any(r[1] + r[2] > 0 for r in rnds),
          f"phase10 train: no round cloned or split: {rnds}")
    check(n_final < capacity, f"phase10 train: {n_final} active of "
                              f"{capacity}")
    ckpts = [(int(s), float(t)) for s, t in CKPT_RE.findall(out)]
    check([s for s, _ in ckpts] == list(range(ckpt_every, iters + 1,
                                              ckpt_every)),
          f"phase10 train: checkpoints {ckpts}")
    final = FINAL_RE.search(out)
    check(final is not None, "phase10 train: no final line")
    ms = steps.step_ms()
    first, last = steps.host[0][0], steps.host[-1][1]
    log(f"phase10 train: {iters} steps (2 views of {res}x{res} a step, "
        f"capacity {capacity}) in {secs:.2f} s = set-up {first - t0:.2f} "
        f"+ loop {last - first:.2f} + tail {t0 + secs - last:.2f}; "
        f"{logs[iters][4]} it/s at step {iters}; step median "
        f"{statistics.median(ms):.3f} ms by CUDA events (first "
        f"{ms[0]:.3f}, p90 {sorted(ms)[int(0.9 * len(ms))]:.3f}) {tag}")
    shown = " ".join(f"{k}:{v:.5f}" for k, v in loss.items()
                     if k % 500 == 0 or k == 50)
    log(f"phase10 train: loss {shown}; final {final[1]}, view-0 train PSNR "
        f"{final[2]} dB, SSIM {final[3]} {tag}")
    log(f"phase10 train: densify trajectory (actives) {actives}; final "
        f"{n_final}; checkpoints {ckpts} {tag}")
    for r, p in zip(rnds, rounds.rounds):
        q = p["quantiles"]
        log(f"phase10 round at {r[0]}: +{r[1]} cloned +{r[2]} split "
            f"-{r[3]} pruned -> {r[4]}; {p['ms']:.3f} ms; avg NDC grad of "
            f"{p['visible']} visible actives: p50 {q[0]:.3e} p90 {q[1]:.3e} "
            f"p99 {q[2]:.3e} max {q[4]:.3e}; above {p['threshold']:g}: "
            f"{p['above']}")
    log(f"phase10 train: launches over the run {total}")
    # the kernels on this path's own inputs: the last step's state (its
    # capacity, its active mask), a training view, the train CLI's
    # RenderConfig (tile 32, pack none, vpu, f32 reduction)
    state, dstate = steps.last[:2]
    cam = load_nerf_synthetic(root, max_views=1).cameras[0]
    check_masked_view("phase10 train view 0", state.params, dstate.active,
                      cam, steps.cfg, tag)
    prof = steps.profile
    busy = None
    if prof is not None and dev.type == "cuda":
        check(prof.busy_ms is not None and prof.busy_ms > 0,
              "phase10 profile: no device time recorded")
        busy = prof.busy_ms
        log(f"phase10 profile: step {P10_PROFILE_STEP} {prof.wall_ms:.3f} ms "
            f"with the profiler on, device busy {prof.busy_ms:.3f} ms: share "
            f"{prof.busy_share:.3f} {tag}")
    if prof is not None:
        log(f"phase10 profile: top 10 ops by self device ms (host ms off "
            f"the card), of {len(prof.ops)} {tag}:")
        for name, op_ms, calls in prof.ops[:10]:
            log(f"  {op_ms:9.3f} ms {calls:5d}x  {name[:100]}")
    return dict(seconds=secs, it_s=float(logs[iters][4]),
                step_ms_median=statistics.median(ms), actives=actives,
                final_active=n_final, final_loss=float(final[1]),
                view0_train_psnr=float(final[2]), checkpoints=ckpts,
                profiled_step_busy_ms=busy,
                loss={k: loss[k] for k in sorted(loss) if k % 500 == 0})


def phase10(dev, card, flags=(), ckpt_every=500):
    """The real-scene proof (``scripts/real_scene_proof.py``) at full scale:
    gen (a 70K-gaussian scene, its PLY round trip at 1600x1063, 40 views at
    800x800 on the interp rig), train (4,000 steps at 200K capacity, two
    views a step, a checkpoint every ``ckpt_every``), eval (4 held-out
    poses at 1600x1063) and parity (the render CLI on the card and on the
    CPU). ``flags`` go to every stage after --root and --device: none at
    full scale; a rehearsal on the CPU passes --quick and smaller sizes."""
    tag = f"[{card}]"
    root = os.path.join(ROOT, "build", "chip_smoke", "phase10")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t0 = time.perf_counter()
    with open(os.path.join(root, "proof_report.json"), "w") as f:
        json.dump({"card": card}, f)
    secs = {"gen": p10_subprocess("phase10 gen", "gen", root, dev, flags)}
    gen = p10_report(root)["gen"]
    log(f"phase10 gen: {gen} {tag}")
    check(gen["ply_roundtrip_render_mad"] <= P10_PNG_TOL,
          f"phase10 gen: PLY round trip {gen['ply_roundtrip_render_mad']}")
    check(gen["png_roundtrip_err"] < P10_PNG_TOL,
          f"phase10 gen: PNG round trip {gen['png_roundtrip_err']}")
    run = phase10_train(root, gen["dataset_res"], dev, tag, flags,
                        ckpt_every)
    secs["train"] = run.pop("seconds")
    secs["eval"] = p10_subprocess("phase10 eval", "eval", root, dev, flags)
    ev = p10_report(root)["eval"]
    log(f"phase10 eval: {ev} {tag}")
    check(ev["psnr_mean"] >= P10_PSNR and ev["ssim_mean"] >= P10_SSIM,
          f"phase10 eval: PSNR {ev['psnr_mean']:.3f} dB, SSIM "
          f"{ev['ssim_mean']:.4f} (gates {P10_PSNR}, {P10_SSIM})")
    secs["parity"] = p10_subprocess("phase10 parity", "parity", root, dev,
                                    flags)
    par = p10_report(root)["parity"]
    log(f"phase10 parity: {par} {tag}")
    check(par["dev_num_rendered"] == par["cpu_num_rendered"],
          f"phase10 parity: num_rendered {par['dev_num_rendered']} on the "
          f"card, {par['cpu_num_rendered']} on the CPU")
    check(par["max_abs_diff"] <= P10_PARITY_MAX
          and par["mean_abs_diff"] <= P10_PARITY_MEAN,
          f"phase10 parity: max |diff| {par['max_abs_diff']:.3e}, mean "
          f"{par['mean_abs_diff']:.3e}")
    check(par["max_abs_diff"] <= P10_PORT_PARITY_MAX
          and par["mean_abs_diff"] <= P10_PORT_PARITY_MEAN,
          f"phase10 parity: max |diff| {par['max_abs_diff']:.3e}, mean "
          f"{par['mean_abs_diff']:.3e} over the port's own gates "
          f"({P10_PORT_PARITY_MAX}, {P10_PORT_PARITY_MEAN})")
    rep = p10_report(root)
    rep["run"] = dict(stage_seconds=secs, **run)
    with open(os.path.join(root, "proof_report.json"), "w") as f:
        json.dump(rep, f, indent=1)
    log(f"phase10: stage seconds {secs}; {time.perf_counter() - t0:.1f} s "
        f"{tag}")


def sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


GRAD_NAMES = ("means", "scales", "quats", "opacities", "sh", "bg")


def own_call_profile():
    """``utils/profiling.call_profile`` of this script's own tree, loaded
    from its file, so that ``--compare`` profiles every tree with the same
    code (the module imports only torch at its top)."""
    import importlib.util

    path = os.path.join(ROOT, "luisacomputegaussiansplatting_tpu_torch",
                        "utils", "profiling.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_profiling",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.call_profile


def diff_frame_record(scene, cam, cfg, dev, profile):
    """The differentiable frame of phases 5 and 6 (loss = image sum over a
    zero background, backward to the five groups and the background)
    through the tree's ``render_aux``: digests of the image and the six
    gradients, the median of 5 chained frames after one, the peak memory
    over them, and one profiled frame's busy ms and op sums."""
    import torch

    from luisacomputegaussiansplatting_tpu_torch.ops.render import render_aux

    leaves = grad_leaves(scene)

    def frame(bg):
        img, _aux = render_aux(*leaves, cam, bg_color=bg, cfg=cfg)
        loss = img.sum()
        return img, loss.detach(), torch.autograd.grad(loss, [*leaves, bg])

    bg = torch.zeros(3, device=dev, requires_grad=True)
    img, val, grads = frame(bg)
    out = {"image": tensor_digest(img)}
    out.update({name: tensor_digest(g) for name, g in zip(GRAD_NAMES, grads)})
    del img, grads
    torch.cuda.reset_peak_memory_stats(dev)
    frames = []
    for _ in range(5):
        bg_i = (bg.detach() + val * 1e-20).requires_grad_(True)
        (_img, val, _g), ms = timed_once(lambda: frame(bg_i))
        frames.append(ms)
    del _img, _g
    out["frame_ms"] = statistics.median(frames)
    out["frames_ms"] = frames
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    prof = profile(lambda: frame(bg.detach().clone().requires_grad_(True)),
                   dev)
    out["busy_ms"] = prof.busy_ms
    out["op_ms"] = op_sums(prof)
    return out


def batched_record(dev, profile, grads_file=None):
    """Phase 7's batched step (B = 4) from its start through the tree's
    package: the loss, digests of the six groups' gradients and of the
    accumulated ``grad_sum`` after the first step, the steps' times and
    peak memory, one profiled step's busy ms and op sums. With
    ``grads_file``, the first tree run saves those gradients there and each
    later one gives each group's max |diff| over the saved max |value|."""
    import torch

    _cfg, _cams, views, targets, state, _opt, dstate, bstep = \
        batched_setup(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    state, dstate, loss, overflow = bstep(state, dstate, views, targets)
    check(not bool(overflow), "compare: the batched step overflows")
    groups = dict(zip(state.params._fields,
                      (p.grad for p in state.params)))
    groups["grad_sum"] = dstate.grad_sum
    out = {"loss": float(loss),
           "digests": {k: tensor_digest(v) for k, v in groups.items()}}
    if grads_file and os.path.exists(grads_file):
        ref = torch.load(grads_file)
        out["max_rel_to_saved"] = {
            k: float((v - ref[k].to(dev)).abs().max()
                     / ref[k].abs().max().clamp_min(1e-30))
            for k, v in groups.items()}
    elif grads_file:
        torch.save({k: v.detach().cpu() for k, v in groups.items()},
                   grads_file)
        out["saved_to"] = grads_file
    del groups
    steps = []
    for _ in range(4):
        t0 = time.perf_counter()
        state, dstate, loss, _ = bstep(state, dstate, views, targets)
        float(loss)  # synchronises
        steps.append((time.perf_counter() - t0) * 1e3)
    out["step_ms"] = statistics.median(steps)
    out["steps_ms"] = steps
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30

    def one_step():
        nonlocal state, dstate
        state, dstate, step_loss, _ = bstep(state, dstate, views, targets)
        return float(step_loss)

    prof = profile(one_step, dev)
    out["busy_ms"] = prof.busy_ms
    out["op_ms"] = op_sums(prof)
    return out


def tree_record(dev, grads_file=None):
    """K2's and K3's digests (K3 on a seeded residual), K2's device time
    and the expansion's device times on phase 3's frame (strict: vpu, no
    cull) and phase 6's (production: mxu, the cull), then on each frame the
    differentiable frame (``diff_frame_record``), and phase 7's batched
    step (``batched_record``), through whichever port package is first on
    ``sys.path``: ``--compare ROOT`` runs it on the tree at ROOT, so that
    two trees are held to the same bits and timed and profiled by the same
    code. The expansion's kernel alone is the device time of its wrapper
    less that of ``saturated_ends``, the prefix sums that a tree's wrapper
    runs before its launch (this tree's wrapper runs all of them but the
    saturation, which its kernel does)."""
    import torch

    import bench_cuda
    from luisacomputegaussiansplatting_tpu_torch.ops.expand import expand_entries_kernel, saturated_ends
    from luisacomputegaussiansplatting_tpu_torch.ops.rasterize import rasterize_backward, rasterize_forward

    profile = own_call_profile()
    out = {}
    for frame in ("strict", "production"):
        if frame == "strict":
            scene, cam, cfg = headline(dev)
            proj, (gx, gy), b, payload = bin_and_payload(scene, cam, cfg,
                                                         expansion="xla")
        else:
            scene, cam, cfg, _ = bench_cuda.scene_camera_config("headline",
                                                                dev)
            proj, (gx, gy), b, payload = bin_and_payload(scene, cam, cfg)
        cull_op = cull_opacity(scene, cfg)
        with torch.no_grad():

            def blend():
                return rasterize_forward(payload, b.tile_starts,
                                         b.tile_counts, gx, cam.width,
                                         cam.height, cfg)

            k1 = {"wrapper": device_ms(lambda: expand_entries_kernel(
                      proj, gx, gx * gy, cfg.max_pairs, cull_op, cfg.tile_wh,
                      cfg.alpha_min)),
                  "saturated_ends": device_ms(
                      lambda: saturated_ends(proj.tiles_touched))}
            color, trans = blend()
            residual = random_residual(color, trans, 9)
            d_payload = rasterize_backward(payload, b.tile_starts,
                                           b.tile_counts, residual, gx,
                                           cam.width, cam.height, cfg)
            # K3's digest over the slots the ranges cover (the rest is
            # never written)
            used = d_payload[:, :used_slots(b)].contiguous()
            out[frame] = {"k2_digest": blend_digest(color, trans),
                          "k3_digest": blend_digest(used, used[:, :0]),
                          "k2_device_ms": device_ms(blend),
                          "k1_device_ms": k1}
        del proj, b, payload, cull_op, color, trans, residual, d_payload, used
        out[frame]["diff_frame"] = diff_frame_record(scene, cam, cfg, dev,
                                                     profile)
        del scene
    out["batched"] = batched_record(dev, profile, grads_file)
    return out


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if (argv[:1] == ["--compare"] and len(argv) in (2, 4)
            and argv[2:3] in ([], ["--grads"])):
        # the digests, times and op sums only, from the port package of
        # the tree at argv[1]
        sys.path.insert(0, os.path.abspath(argv[1]))
        try:
            record = tree_record(torch.device("cuda:0"),
                                 argv[3] if len(argv) == 4 else None)
        except SmokeFailure as e:
            print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
            return 1
        print(json.dumps({"tree": argv[1], **record}))
        return 0
    if argv:
        print("usage: chip_smoke.py [--compare ROOT [--grads FILE]]",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    t0 = time.perf_counter()
    record = []
    try:
        card = phase0()
        phase1(dev)
        phase2(card)
        rec, ctx = phase3(dev)
        record += rec
        phase4(dev)
        record += phase5(dev, ctx)
        ctx = None  # phase 3's scene
        # the mxu kernels first at phase 1 and 4's settings (every tile
        # shape, pack mode and cull), then at the production frame
        phase1(dev, "mxu", "phase6 sweep fwd mxu")
        phase4(dev, "mxu", "phase6 sweep bwd mxu")
        record += phase6(dev)
        phase7(dev, card)
        phase8(dev, card)
        record += phase9(dev, card)
        phase10(dev, card)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    log(f"chip_smoke: phases 0-10 passed in {time.perf_counter() - t0:.1f} s")
    log(card)
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
