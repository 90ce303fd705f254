#!/usr/bin/env python3
"""The card's gate for the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --compare ROOT [--grads FILE]

Builds the hand-written kernels from ``luisacomputegaussiansplatting_tpu_torch/
csrc`` (one nvcc per source, all at once), holds each against its plain
PyTorch version, and drives the port's render and training paths end to end,
checking results, digests and kernel launch counts. Speed is the benchmark's
(``gsbench/``, the cells of ``BENCHMARK.json``); this script times only each
kernel alone, once per frame, beside its plain version and its bound in the
benchmark's yardstick (``gsbench/work.py``):

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
     then K5, the SH colour kernels (``phase_sh``), at 6M gaussians and
     degree 3: colours bit for bit and gradients within 1e-5 of their max
     against the plain version, one launch each way, each way's device
     ms beside its byte bound and the plain version's ms; then K6, the
     projection kernels (``phase_projection``), at 6M gaussians on a
     bicycle-cell camera: the eight fields bit for bit (training and render
     calls, the tight radius), gradients within 1e-5 of their max, a
     look-at pose's gradient against the plain version in float64, one
     launch each way, each way's device ms beside its byte bound; then K7,
     the Adam kernel (``phase_adam``), over the six groups of 6M
     gaussians: three updates against ``torch.optim.Adam``'s foreach
     update (moments within 4 ulps, parameters within 1e-6 of each group's
     largest update), one launch a step, its device ms beside its byte
     bound, the foreach update's ms and ``fused=True``'s;
  2. the render CLI in-process on a 200K-gaussian scene at 1600x1063, then
     on the 2M bench scene from its PLY (the native loader) at 1920x1080
     with the strict defaults and the reference's L (``--max-pairs`` 20M):
     no overflow, the CLI's ``rep_ms`` line printed;
  3. the strict frame (tile 16, vpu, f32, 2-key sort, no cull: the lego
     cells' kernel modes): a 2M-gaussian random scene at 1920x1080 through
     ``render_aux`` with the strict-parity config, its launches, re-run
     stage by stage with the plain versions; the forward blend at each
     number of pixels a thread, bit-identical, timed on the device; the
     expansion's prefix sums and kernel timed apart; K2's colour and T
     digest (``K2_DIGESTS``);
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
     bf16 gradient reduction, with their launches; stage by stage against
     the plain versions; the forward and the backward blend at each number
     of pixels a thread held, the backward blend's instances and the f32
     segment-sum timed on the device; then five training steps with
     ``make_train_step``: the loss falls, exact launch counts;
  6. the production frame (tile 32, no-pack, cull, trim, fused sort, bf16
     payload and gradient reduction, ``blend_quad="mxu"``: the bicycle
     cells' kernel modes): first phases 1 and 4 again in mxu; then
     ``bench_cuda.scene_camera_config``'s 2M headline scene at 1920x1080:
     one forward + backward frame with its launch counts (no vpu blend),
     three ring views indexed from a stacked CameraView bit-identical to
     single frames in image, ``num_rendered`` and gradients, the mxu blend
     kernels against their plain versions on the frame's payload and
     residual (each at every number of pixels a thread, timed on the
     device; the forward's digest), the five groups' gradients against the
     all-plain backward, the mxu image against the vpu image, the expansion
     and the bf16 segment-sum at the frame's shapes timed on the device
     (the longest segment logged), five training steps; and one production
     frame under ``torch.profiler`` (``utils/profiling.frame_profile``),
     which must record device time and no ``select_backward``: the columns
     cross through ``utils/packing.py``;
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
     (``check_masked_view``); one profiled batched step with no
     select_backward; inactive rows stay parked and culled;
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
     each, one launch of each forward kernel a request, each frame >= 35 dB
     against ``render_view``, a malformed query answered 400;
  9. the sharded path (``parallel/``) on ``bench.py``'s production
     configuration at 2M gaussians and 1920x1080 with the sort "2key" and no
     post-sort trim (the settings the sharded path rejects): (a) the
     frame's 60 x 34 tiles in 4 bands of 9 tile rows, K2 and K3 in both
     blend modes on each band's ranges at its first global tile
     (``tile_offset``) against their plain versions and equal bit for bit
     to the whole frame's blend; (b) world size 1 over NCCL in this
     process: ``render_sharded`` forward and backward against
     ``render_aux`` (image within 2e-5, gradients within GRAD_TOL), exactly
     one launch of K1, K2 mxu, K3 mxu and K4 f32, K1 at the band-padded
     grid bit for bit and K4 f32 on the frame's ids within SUM_TOL of their
     plain versions, five steps of ``make_sharded_train_step`` on a 1x1
     mesh with densify (the first profiled: its backward runs no
     scatter-add) and a sharded densify round; (c) four spawned ranks
     sharing the one card through gloo with CUDA tensors (NCCL takes one
     rank per device), 500K gaussians each: the assembled image within 2e-5
     of 9b's, the gradients within GRAD_TOL, then five training steps on a
     2x2 mesh (the first profiled as in 9b on every rank). These are four
     processes on one card exchanging through the host;
  10. the real-scene quality proof
     (``luisacomputegaussiansplatting_tpu_torch/scripts/real_scene_proof.py``)
     at the JAX script's full presets: gen in its own process (a
     70K-gaussian procedural scene, its PLY round trip rendered at
     1600x1063, 40 views at 800x800 on the interp rig), train in this
     process (the train CLI, 4,000 steps of two views at 200K capacity
     from 30K points, a densify round every 150 steps, a checkpoint every
     500; K1, K2 vpu, K3 vpu and K4 f32 twice every step, K7 once; step
     P10_PROFILE_STEP under the profiler, with device time and no
     select_backward), eval in its own
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
its ``phaseN`` function. Each kernel's record on the ``"kernels"`` line
holds its device ms (``device_ms``: K1-K4 once on phase 3's or 5's strict
frame and once on phase 6's production frame, K5, K6 and K7 at 6M), its
plain (for K7 torch's foreach Adam) and library (K4 ``index_add_``, K7
torch's ``fused=True`` Adam) ms with host issue (``cuda_ms``), and its
``bound_ms`` and ``bound_by`` (``kernel_bound``: ``gsbench.work.k1_work``
... ``k4_work`` on the frame's counts; K5's and K6's byte and operation
counts a gaussian and K7's an element beside their phases).

``--compare ROOT`` prints only one JSON line of digests, computed by the
port package of the tree at ROOT with this tree's code (to hold another
tree to this one's bits): on phase 3's and phase 6's frames, K2's colour
and T and K3's slots (on a seeded residual), and the differentiable
frame's image and six gradients; then phase 7's first batched step: its
six groups' gradients and ``grad_sum``. With ``--grads FILE`` the first
tree saves the batched step's gradients there and each later tree prints
its max relative difference from them (``max_rel_to_saved``).

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
import struct
import subprocess
import sys
import time

# the benchmark's yardstick, imported before ``--compare ROOT`` puts another
# tree first on sys.path (a tree without gsbench/ can then be compared)
from gsbench import work as W

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


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn()`` over ``reps`` runs after one warm-up,
    timed with CUDA events on the current stream, the host's issue
    included: for the plain and library versions beside a kernel."""
    from luisacomputegaussiansplatting_tpu_torch.utils.profiling import Timer

    return Timer(warmup=1, reps=reps).time(fn) * 1e3


def device_ms(fn, reps=5):
    """Mean device milliseconds of one ``fn()`` over ``reps`` calls after
    one, a kernel's one time: CUDA events around the call alone, without
    the host time of its wrapper (which ``cuda_ms`` includes). Each
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


def kernel_bound(nbytes, ops):
    """A kernel record's ``bound_ms`` and ``bound_by`` in the benchmark's
    yardstick: ``gsbench.work.bound_s`` of (bytes, FP32 operations), as
    ``gsbench.work.k1_work`` ... ``k4_work`` count them, and which of its
    two terms sets it."""
    by_bytes = nbytes / W.HBM_BYTES_PER_S >= ops / W.FP32_OPS_PER_S
    return {"bound_ms": W.bound_s(nbytes, ops) * 1e3,
            "bound_by": "bytes" if by_bytes else "operations"}


def kernel_libs():
    from luisacomputegaussiansplatting_tpu_torch.ops import (
        adam, expand, projection, rasterize, segsum, sh_eval)

    return [expand.KERNEL, rasterize.KERNEL, rasterize.BACKWARD_KERNEL,
            segsum.KERNEL, sh_eval.KERNEL, projection.KERNEL, adam.KERNEL]


def reset_launches():
    for k in kernel_libs():
        k.reset_launches()


def read_launches():
    """Launches per kernel since the last reset, per variant where the
    kernel has variants: ``rasterize_vpu``/``rasterize_mxu``,
    ``rasterize_backward_vpu``/``_mxu``, ``segsum_f32``/``_bf16``,
    ``sh_forward``/``sh_backward``, ``projection_forward``/``_backward``."""
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


# gsbench/reference/render.py::pair_counts counts the same pairs on its own
# square tiles; this one alone takes the port's rectangular tiles and band
# offsets
def pair_counts(payload, tile_starts, tile_counts, grid_x, width, height, cfg,
                tile_offset=0):
    """(evaluated, applied) (entry, pixel) pairs of a blend over this
    payload: every in-image pixel against its tile's real entries up to and
    including the one where it stops, and of those the pairs it applies;
    from the plain forward's replay (for K2's and K3's bounds)."""
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


def select_backward_ms(prof):
    """Device ms of what ``aten::select_backward`` ran in a
    ``FrameProfile``: a full-size zero-filled cotangent a column, which the
    columns crossing through ``utils/packing.py`` avoid."""
    return sum(ms for name, ms, _ in prof.totals
               if name == "aten::select_backward")


def forward_variants(tag, payload, ranges, gx, gy, w, h, cfg, color, trans,
                     plain, reps):
    """K2 at every number of pixels a thread that the tile admits: each the
    same bits as the wrapper's ``color``/``trans``, within BLEND_TOL of the
    plain forward ``plain`` (colour, T), and, where ``reps``, timed on the
    device. Logs the times beside the wrapper's choice; returns {pixels a
    thread: ms}."""
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
                times[per] = device_ms(launch, reps)
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


#: K5's check: the north star's gaussian count, degree 3 over 16 rows
SH_N = 6_000_000
#: per gaussian at degree 3 in f32: the forward reads the mean and 48
#: coefficients and writes RGB; the backward also reads dRGB and writes dSH
#: and d mean
SH_BYTES = {"forward": 12 + 192 + 12, "backward": 12 + 12 + 192 + 192 + 12}
#: FP32 operations a gaussian (direction 12, basis ~40, sums 96; the
#: backward about as many again)
SH_OPS = {"forward": 150, "backward": 300}


def phase_sh(dev, n=SH_N):
    """K5 (``csrc/sh.cu``) at ``n`` gaussians, degree 3: colours bit for bit
    and the three gradients within 1e-5 x their max |plain| against the
    plain version on the card, one launch each way through
    ``compute_colors``, each kernel's device ms beside its byte bound and
    the plain version's ms. Returns the two kernel records."""
    import torch

    from luisacomputegaussiansplatting_tpu_torch.ops import sh_eval

    gen = torch.Generator(device=dev).manual_seed(17)
    means = (torch.rand((n, 3), generator=gen, device=dev) - 0.5) * 6.0
    sh = torch.randn((n, 16, 3), generator=gen, device=dev) * 0.3
    cam = torch.tensor([0.4, -4.6, 2.2], device=dev)
    d_rgb = torch.randn((n, 3), generator=gen, device=dev)

    def plain_graph():
        leaves = [t.clone().requires_grad_(True) for t in (means, sh, cam)]
        return leaves, sh_eval.compute_colors_reference(*leaves, 3)

    sh_eval.KERNEL.reset_launches()
    leaves = [t.clone().requires_grad_(True) for t in (means, sh, cam)]
    rgb = sh_eval.compute_colors(*leaves, 3)
    rgb.backward(d_rgb)
    torch.cuda.synchronize()
    check(sh_eval.KERNEL.variant_launches == {"forward": 1, "backward": 1},
          f"phase_sh: launches {sh_eval.KERNEL.variant_launches}")
    plain_leaves, plain_rgb = plain_graph()
    plain_rgb.backward(d_rgb)
    check(torch.equal(rgb, plain_rgb), "phase_sh: colours differ from plain")
    errs = {}
    for name, got, want in zip(("d_means", "d_sh", "d_cam"), leaves,
                               plain_leaves):
        scale = float(want.grad.abs().max())
        errs[name] = float((got.grad - want.grad).abs().max())
        check(errs[name] <= 1e-5 * scale,
              f"phase_sh: {name} off by {errs[name]} (max |plain| {scale})")
    del leaves, plain_leaves, rgb, plain_rgb

    fwd_ms = device_ms(lambda: sh_eval.sh_forward_kernel(means, sh, cam, 3))
    bwd_ms = device_ms(lambda: sh_eval.sh_backward_kernel(means, sh, cam, 3,
                                                          d_rgb))
    with torch.no_grad():
        plain_fwd = cuda_ms(
            lambda: sh_eval.compute_colors_reference(means, sh, cam, 3), 2)
    plain_leaves, plain_rgb = plain_graph()
    plain_bwd = cuda_ms(lambda: torch.autograd.grad(
        plain_rgb, plain_leaves, d_rgb, retain_graph=True), 2)
    del plain_leaves, plain_rgb
    records = []
    for way, ms, plain in (("forward", fwd_ms, plain_fwd),
                           ("backward", bwd_ms, plain_bwd)):
        b = kernel_bound(SH_BYTES[way] * n, SH_OPS[way] * n)
        log(f"phase_sh: K5 {way} at {n} gaussians {ms:.4f} ms, bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']}): "
            f"{100 * b['bound_ms'] / ms:.1f}% of it; plain {plain:.3f} ms")
        records.append(
            {"name": f"sh_{way}", "route": "cuda", "source": f"{PKG}/sh.cu",
             "replaces": None, "launches": 1,
             "max_abs_err": 0.0 if way == "forward" else errs,
             "ms": ms, "plain_ms": plain, **b, "library_ms": None})
    return records


#: K6's check: the north star's gaussian count, the bicycle cells' camera
PROJ_N = 6_000_000
#: per gaussian: the forward reads the mean, scales and quaternion (40 B),
#: the active mask (1) and the probe (8) and writes the centre (8), depth (4),
#: conic (12), radius (4), both rect corners (16), tiles_touched (4) and valid
#: (1); the backward reads the mean, scales and quaternion and the centre and
#: conic cotangents (20) and writes the three gradients (40): the probe's
#: gradient is the centres' cotangent itself, not a copy
PROJ_BYTES = {"forward": 40 + 1 + 8 + 49, "backward": 40 + 20 + 40}
#: FP32 operations a gaussian (view 18, NDC 12, covariance ~90, EWA ~50,
#: conic and radius ~25, rect ~15; the backward ~400), divisions and square
#: roots counted once
PROJ_OPS = {"forward": 210, "backward": 400}


def phase_projection(dev, n=PROJ_N):
    """K6 (``csrc/projection.cu``) at ``n`` gaussians on a bicycle-cell
    camera: the eight fields bit for bit against the plain version on the
    card (the training call with the mask and the probe, the render call,
    the tight radius), the four gradients within 1e-5 x their max |plain|
    from strided cotangents, one launch each way through
    ``project_gaussians``, a pose's gradient through ``look_at_view`` on the
    same launches (position, target and tangent within 1e-5 x their max of
    the plain version in float64, or no farther from it than twice
    autograd's float32 chain), each kernel's device ms beside its byte bound
    and the plain version's ms. Returns the two kernel records."""
    import torch

    from luisacomputegaussiansplatting_tpu_torch import RenderConfig, look_at_camera
    from luisacomputegaussiansplatting_tpu_torch.io.synthetic import random_scene_device
    from luisacomputegaussiansplatting_tpu_torch.ops import projection
    from luisacomputegaussiansplatting_tpu_torch.utils.camera import look_at_view

    scene = random_scene_device(n, seed=19, scale_range=(0.004, 0.02),
                                sh_degree=0, device=dev)
    means, scales, quats, opac = (scene.means, scene.scales, scene.quats,
                                  scene.opacities)
    cam = look_at_camera((3.5, -3.0, 2.2), (0, 0, 0), (0, 0, 1), fov=65.0,
                         width=1237, height=822)
    view = cam.to_view(dev)
    w, h = cam.width, cam.height
    cfg = RenderConfig(tile=32, tile_cull=True)
    gen = torch.Generator(device=dev).manual_seed(23)
    mask = torch.rand((n,), generator=gen, device=dev) < 0.9
    probe = torch.zeros((n, 2), device=dev)
    # the payload's backward hands the cotangents on as (N, K) views
    d_m2d = torch.randn((2, n), generator=gen, device=dev).t()
    d_conic = torch.randn((3, n), generator=gen, device=dev).t()

    def call(fn, leaves, cfg=cfg, train=True):
        m, s, q, pr = leaves
        return fn(m, s, q, view, cfg, width=w, height=h,
                  active_mask=mask if train else None,
                  means2d_probe=pr if train else None, opacities=opac)

    def fresh():
        return [t.clone().requires_grad_(True)
                for t in (means, scales, quats, probe)]

    with torch.no_grad():
        for tag, c, train in (("training call", cfg, True),
                              ("render call", cfg, False),
                              ("tight radius", RenderConfig(
                                  tile=32, tight_radius=True), True)):
            got = call(projection.project_gaussians, fresh(), c, train)
            want = call(projection.project_gaussians_reference, fresh(), c,
                        train)
            for f in want._fields:
                a, b = getattr(got, f), getattr(want, f)
                if a.dtype == torch.float32:
                    a, b = a.view(torch.int32), b.view(torch.int32)
                check(torch.equal(a, b),
                      f"phase_projection: {tag}: {f} differs from plain")
            log(f"phase_projection: {tag} bit for bit, "
                f"{int(got.valid.sum())} valid of {n}, "
                f"{int(got.tiles_touched.sum())} tiles")
            del got, want

    projection.KERNEL.reset_launches()
    leaves = fresh()
    got = call(projection.project_gaussians, leaves)
    torch.autograd.backward([got.means2d, got.conic], [d_m2d, d_conic])
    torch.cuda.synchronize()
    check(projection.KERNEL.variant_launches
          == {"forward": 1, "backward": 1},
          f"phase_projection: launches {projection.KERNEL.variant_launches}")
    plain_leaves = fresh()
    want = call(projection.project_gaussians_reference, plain_leaves)
    torch.autograd.backward([want.means2d, want.conic], [d_m2d, d_conic])
    errs = {}
    for name, a, b in zip(("d_means", "d_scales", "d_quats", "d_probe"),
                          leaves, plain_leaves):
        scale = float(b.grad.abs().max())
        errs[name] = float((a.grad - b.grad).abs().max())
        check(errs[name] <= 1e-5 * scale,
              f"phase_projection: {name} off by {errs[name]} (max |plain| "
              f"{scale})")
    log(f"phase_projection: gradients within 1e-5 of their max: {errs}")
    del leaves, plain_leaves, got, want

    def pose_grads(fn, dtype=torch.float32):
        """d position, d target, d tan_fovy of a look-at pose whose view
        projects the scene with the training call's cotangents."""
        pose = [torch.tensor(v, dtype=dtype, device=dev).requires_grad_(True)
                for v in ((3.5, -3.0, 2.2), (0.0, 0.0, 0.0),
                          cam.tan_fovy)]
        up = torch.tensor((0.0, 0.0, 1.0), dtype=dtype, device=dev)
        pv = look_at_view(pose[0], pose[1], up, pose[2], w / h)
        c = [t.to(dtype) for t in (means, scales, quats, opac)]
        out = fn(*c[:3], pv, cfg, width=w, height=h, active_mask=mask,
                 opacities=c[3])
        torch.autograd.backward([out.means2d, out.conic],
                                [d_m2d.to(dtype), d_conic.to(dtype)])
        return [t.grad.double() for t in pose]

    projection.KERNEL.reset_launches()
    got = pose_grads(projection.project_gaussians)
    torch.cuda.synchronize()
    check(projection.KERNEL.variant_launches
          == {"forward": 1, "backward": 1},
          f"phase_projection: pose launches "
          f"{projection.KERNEL.variant_launches}")
    want = pose_grads(projection.project_gaussians_reference)
    exact = pose_grads(projection.project_gaussians_reference, torch.float64)
    pose_errs = {}
    for name, g, a, x in zip(("position", "target", "tan_fovy"), got, want,
                             exact):
        scale = float(x.abs().max())
        err_k, err_a = (float((t - x).abs().max()) for t in (g, a))
        pose_errs[name] = (err_k, err_a, scale)
        check(err_k <= 1e-5 * scale or err_k <= 2.0 * err_a + scale * 2 ** -23,
              f"phase_projection: pose {name}: K6 off float64 by {err_k}, "
              f"autograd by {err_a}")
    log(f"phase_projection: pose gradients on K6 (K6, autograd off the "
        f"float64 plain version; its max): {pose_errs}")
    del got, want, exact

    params = projection._params(n, cfg, w, h, 1.0, "inria")
    cam_t = (view.view, view.tan_fovx, view.tan_fovy)
    fwd_ms = device_ms(lambda: projection.projection_forward_kernel(
        means, scales, quats, *cam_t, params, probe, None, mask))
    bwd_ms = device_ms(lambda: projection.projection_backward_kernel(
        means, scales, quats, *cam_t, params, d_m2d, d_conic))
    with torch.no_grad():
        plain_fwd = cuda_ms(lambda: call(
            projection.project_gaussians_reference, fresh()), 2)
    plain_leaves = fresh()
    want = call(projection.project_gaussians_reference, plain_leaves)
    plain_bwd = cuda_ms(lambda: torch.autograd.grad(
        [want.means2d, want.conic], plain_leaves, [d_m2d, d_conic],
        retain_graph=True), 2)
    del plain_leaves, want
    records = []
    for way, ms, plain in (("forward", fwd_ms, plain_fwd),
                           ("backward", bwd_ms, plain_bwd)):
        b = kernel_bound(PROJ_BYTES[way] * n, PROJ_OPS[way] * n)
        log(f"phase_projection: K6 {way} at {n} gaussians {ms:.4f} ms, bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']}): "
            f"{100 * b['bound_ms'] / ms:.1f}% of it; plain {plain:.3f} ms")
        records.append(
            {"name": f"projection_{way}", "route": "cuda",
             "source": f"{PKG}/projection.cu", "replaces": None,
             "launches": 1,
             "max_abs_err": 0.0 if way == "forward" else errs,
             "ms": ms, "plain_ms": plain, **b, "library_ms": None})
    return records



#: K7's check: the north star's gaussian count, the six groups' 59 floats a
#: gaussian (SH degree 3)
ADAM_N = 6_000_000
ADAM_SHAPES = ((3,), (3,), (4,), (), (1, 3), (15, 3))
#: per element: reads the parameter, the gradient and both moments and
#: writes the parameter and both moments, 4 B each
ADAM_BYTES = 7 * 4
#: the moments within ADAM_ULPS float32 ulps of torch's foreach update,
#: relative; the parameters within ADAM_PARAM_TOL x their group's largest
#: update (``tests/test_torch_adam.py``'s tolerances)
ADAM_ULPS = 4
ADAM_PARAM_TOL = 1e-6


def phase_adam(dev, n=ADAM_N):
    """K7 (``csrc/adam.cu``) over the six groups of ``n`` gaussians: three
    updates of ``make_optimizer``'s Adam through ``optimizer_step`` (the
    means learning rate changes every step; 5% of the gradients rounding
    level) against ``torch.optim.Adam``'s foreach update from the same
    parameters and gradients: the moments within ADAM_ULPS ulps, the
    parameters within ADAM_PARAM_TOL x each group's largest update, one
    launch a step; then K7's device ms beside its byte bound, the foreach
    update's ms (plain) and ``fused=True``'s (library). Returns the kernel
    record."""
    import torch

    from luisacomputegaussiansplatting_tpu_torch.models import trainer
    from luisacomputegaussiansplatting_tpu_torch.models.gaussians import GaussianParams
    from luisacomputegaussiansplatting_tpu_torch.ops import adam

    tc = trainer.TrainConfig(lr_means_decay_steps=4)
    gen = torch.Generator(device=dev).manual_seed(29)
    start = GaussianParams(*(torch.randn((n, *s), generator=gen, device=dev)
                             for s in ADAM_SHAPES))
    elems = sum(p.numel() for p in start)
    state, opt = trainer.init_train_state(start, tc)
    lrs = trainer._group_lrs(tc)

    def torch_adam(params, **kw):
        return torch.optim.Adam(
            [{"params": [p], "lr": lrs[name], "name": name}
             for name, p in zip(GaussianParams._fields, params)],
            betas=(0.9, 0.999), eps=tc.adam_eps, **kw)

    twin_params = [p.clone().requires_grad_(True) for p in start]
    twin = torch_adam(twin_params, foreach=True)
    reset_launches()
    for k in range(3):
        for p, q in zip(state.params, twin_params):
            g = torch.randn(p.shape, generator=gen, device=dev)
            tiny = torch.rand(p.shape, generator=gen, device=dev) < 0.05
            p.grad = q.grad = torch.where(tiny, g * 1e-12, g)
        trainer.optimizer_step(opt, tc, k)
        trainer.optimizer_step(twin, tc, k)
    torch.cuda.synchronize()
    check_launches("phase_adam", read_launches(), adam=3)
    ulp = torch.finfo(torch.float32).eps
    errs, differ = {}, 0
    with torch.no_grad():
        for name, p, q, s in zip(GaussianParams._fields, state.params,
                                 twin_params, start):
            a, b = opt.state[p], twin.state[q]
            check(torch.equal(a["step"], b["step"])
                  and a["step"].device.type == "cpu",
                  f"phase_adam: {name}: step {a['step']} against "
                  f"{b['step']}")
            for key in ("exp_avg", "exp_avg_sq"):
                check(bool(((a[key] - b[key]).abs()
                            <= ADAM_ULPS * ulp * b[key].abs()).all()),
                      f"phase_adam: {name} {key} past {ADAM_ULPS} ulps")
                differ += int((a[key] != b[key]).sum())
            scale = float((q - s).abs().max())
            errs[name] = float((p - q).abs().max())
            differ += int((p != q).sum())
            check(errs[name] <= ADAM_PARAM_TOL * scale,
                  f"phase_adam: {name} off by {errs[name]} (largest update "
                  f"{scale})")
    log(f"phase_adam: 3 steps over {elems} elements: parameters within "
        f"{ADAM_PARAM_TOL} of their largest update ({errs}); {differ} of "
        f"{3 * elems} parameter and moment values differ from torch's bits")
    del start

    ms = device_ms(lambda: trainer.optimizer_step(opt, tc, 3))
    plain = cuda_ms(lambda: trainer.optimizer_step(twin, tc, 3), 5)
    del opt, state, twin
    fused = torch_adam(twin_params, fused=True)
    library = cuda_ms(fused.step, 5)
    del fused, twin_params
    b = kernel_bound(ADAM_BYTES * elems, W.OPS_PER_ADAM_ELEMENT * elems)
    log(f"phase_adam: K7 at {elems} elements {ms:.4f} ms, bound "
        f"{b['bound_ms']:.4f} ms ({b['bound_by']}): "
        f"{100 * b['bound_ms'] / ms:.1f}% of it; foreach {plain:.3f} ms, "
        f"fused {library:.3f} ms")
    return [{"name": "adam", "route": "cuda", "source": f"{PKG}/adam.cu",
             "replaces": None, "launches": 1, "max_abs_err": errs, "ms": ms,
             "plain_ms": plain, **b, "library_ms": library}]

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
    from luisacomputegaussiansplatting_tpu_torch.ops.rasterize import forward_launch_shape, rasterize_forward
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
                       rasterize_vpu=1, sh_forward=1,
                       projection_forward=1)
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
        k2_times = forward_variants(
            "phase3", payload, (bp.tile_starts, bp.tile_counts), gx, gy, w,
            h, cfg, ck, tk, (cp, tp), 5)
        # the main-path image against the all-plain one
        img_p, t_p = _tiles_to_image(cp, tp, gx, gy, w, h, cfg.tile_wh)
        d = torch.maximum((img - img_p).abs().amax(dim=0),
                          (aux.transmittance - t_p).abs())
        check_blend("phase3 frame", float(d.max()), int((d > TOL).sum()),
                    w * h)

        # the kernels' device times, the plain versions' with host issue
        k1_split = expansion_split(proj, gx, nt, cfg.max_pairs, None, cfg)
        k1_plain = cuda_ms(lambda: expand_entries(
            proj, gx, nt, cfg.max_pairs, None, cfg.tile_wh, cfg.alpha_min), 5)
        k2_plain = cuda_ms(lambda: rasterize_reference(
            payload, bp.tile_starts, bp.tile_counts, gx, w, h, cfg), 2)
        evaluated, applied = pair_counts(payload, bp.tile_starts,
                                         bp.tile_counts, gx, w, h, cfg)

    k2_ms = k2_times[forward_launch_shape(*cfg.tile_wh)[1]]
    n_g = scene.means.shape[0]
    pix = cfg.tile_wh[0] * cfg.tile_wh[1]
    k1_bound = kernel_bound(*W.k1_work(n_g, cfg.max_pairs, aabb_total, False))
    k2_bound = kernel_bound(*W.k2_work(num_rendered, nt, pix, evaluated,
                                       applied, cfg.blend_quad))
    log(f"phase3: 2M gaussians 1920x1080 strict-parity: aabb_total={aabb_total} "
        f"num_rendered={num_rendered} capacity={payload.shape[1]}")
    log(f"phase3: expansion device ms: prefix sums {k1_split[0]:.3f}, the "
        f"kernel {k1_split[1]:.3f} (bound {k1_bound['bound_ms']:.3f} "
        f"{k1_bound['bound_by']}); plain {k1_plain:.3f} ms; blend kernel "
        f"{k2_ms:.3f} (bound {k2_bound['bound_ms']:.3f} "
        f"{k2_bound['bound_by']}); plain {k2_plain:.3f} ms")
    log(f"phase3: blend pairs evaluated {evaluated} applied {applied}")

    context = dict(scene=scene, cam=cam, cfg=cfg, pairs=(evaluated, applied),
                   entries=num_rendered)
    return [
        {"name": "expand_entries", "route": "cuda",
         "source": f"{PKG}/expand.cu",
         "replaces": f"{JAX_OPS}/expand_pallas.py:137",
         "launches": launches["expand"], "max_abs_err": k1_err,
         "ms": k1_split[1], "plain_ms": k1_plain, **k1_bound,
         "library_ms": None},
        {"name": "rasterize_forward", "route": "cuda",
         "source": f"{PKG}/rasterize.cu",
         "replaces": f"{JAX_OPS}/rasterize_pallas.py:282",
         "launches": launches["rasterize_vpu"], "max_abs_err": blend[0],
         "ms": k2_ms, "plain_ms": k2_plain, **k2_bound, "library_ms": None},
    ], context


def expansion_split(proj, gx, nt, max_pairs, cull_op, cfg):
    """(device ms of ``prefix_sums``, device ms of K1's launch on its
    output): the expansion wrapper's two parts timed apart (``device_ms``),
    the second the kernel alone, K1's time."""
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
    dp = rasterize_backward_reference(payload, *ranges, residual, gx, w, h,
                                      cfg)
    used = used_slots(binned)
    check(torch.equal(dk[:, :used], dk2[:, :used]),
          f"{tag}: backward blend kernel is not deterministic (two runs "
          "differ)")
    fields = ("mx", "my", "ca", "cb", "cc", "op", "r", "g", "b")
    err = check_fields(tag, "d_payload", dk.t(), dp.t(), fields,
                       rows=binned.entry_gid >= 0)
    b2_abs = float((dk[:, :used] - dp[:, :used]).abs().max())
    out = {"b2": (dk, dp, b2_abs, err)}
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
    held to GRAD_TOL of the plain backward ``dp`` and timed on the device;
    logs the times beside the wrapper's choice and returns {pixels a
    thread: ms}."""
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
            times[per] = device_ms(launch, reps)
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
    from luisacomputegaussiansplatting_tpu_torch.ops.rasterize import backward_launch_shape, make_residual, rasterize_forward
    from luisacomputegaussiansplatting_tpu_torch.ops.rasterize_ref import rasterize_backward_reference, rasterize_reference
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
    one = {"expand": 1, "rasterize_vpu": 1, "rasterize_backward_vpu": 1,
           "sh_forward": 1, "sh_backward": 1, "projection_forward": 1,
           "projection_backward": 1}
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
    dk, dp, b2_abs, _b2_rel = st["b2"]

    # the five groups' gradients through the all-plain backward
    n = scene.means.shape[0]
    with torch.no_grad():
        d_table = segment_sum_reference(binned.entry_gid, dp.t(), n)
    colors = compute_colors(leaves[0], leaves[4], cam.position)
    proj_g = project_gaussians(leaves[0], leaves[1], leaves[2], cam, cfg)
    table = payload_table(proj_g, colors, leaves[3])
    plain = list(torch.autograd.grad(table, leaves, grad_outputs=d_table,
                                     allow_unused=True))
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

    # K2 at the frame's shapes is phase 3's; K3 and K4 f32 timed on the
    # device, their plain and library versions with host issue
    ranges = (binned.tile_starts, binned.tile_counts)
    with torch.no_grad():
        plain_fwd = rasterize_reference(payload, *ranges, gx, w, h, cfg)
    forward_variants("phase5", payload, ranges, gx, gy, w, h, cfg, color,
                     trans, plain_fwd, 0)
    del plain_fwd
    k3_times = backward_variants("phase5", payload, binned, residual, gx, w,
                                 h, cfg, dp, 5)
    with torch.no_grad():
        k3_plain = cuda_ms(lambda: rasterize_backward_reference(
            payload, *ranges, residual, gx, w, h, cfg), 1)
        key = torch.where(binned.entry_gid >= 0, binned.entry_gid,
                          torch.full_like(binned.entry_gid, n))
        sorted_key, perm = torch.sort(key, stable=True)
        rows_t = dk[:, perm].t()
        k4_ms = device_ms(lambda: segment_sum_kernel(sorted_key, rows_t, n,
                                                     "f32"))
        k4_plain = cuda_ms(lambda: segment_sum_reference(
            sorted_key, rows_t, n, "f32"), 5)
        lib_rows = torch.where((sorted_key < n)[:, None], rows_t, 0.0)
        key64 = sorted_key.to(torch.int64)
        acc = torch.zeros((n + 1, 9), device=dev)
        k4_lib = cuda_ms(lambda: acc.index_add_(0, key64, lib_rows), 5)
        del lib_rows, key64, acc

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
    losses = []
    for _ in range(n_steps):
        state, step_loss, step_aux = step(state, view, target)
        losses.append(float(step_loss))
        check(not bool(step_aux.overflow), "phase5 training: overflow")
    check_launches("phase5 training", read_launches(),
                   **{k: n_steps for k in one}, segsum_f32=n_steps,
                   adam=n_steps)
    log(f"phase5 training: losses {' '.join(f'{v:.6f}' for v in losses)}")
    check(all(map(math.isfinite, losses)), "phase5 training: non-finite loss")
    check(losses[-1] < losses[0], "phase5 training: the loss did not fall")

    # bounds from this run's inputs, in the benchmark's yardstick
    k3_ms = k3_times[backward_launch_shape(*cfg.tile_wh)[1]]
    nt = gx * gy
    pix = cfg.tile_wh[0] * cfg.tile_wh[1]
    entries = ctx["entries"]
    k3_bound = kernel_bound(*W.k3_work(entries, nt, pix, *ctx["pairs"],
                                       cfg.blend_quad))
    k4_bound = kernel_bound(*W.k4_work(entries, n))
    log(f"phase5: backward blend {k3_ms:.3f} ms (bound "
        f"{k3_bound['bound_ms']:.3f} {k3_bound['bound_by']}) vs plain "
        f"{k3_plain:.3f} ms; segment-sum f32 {k4_ms:.3f} ms (bound "
        f"{k4_bound['bound_ms']:.3f} {k4_bound['bound_by']}; plain "
        f"{k4_plain:.3f}, index_add_ {k4_lib:.3f}); rows summed {entries} "
        f"of {key.shape[0]}")
    return [
        {"name": "rasterize_backward", "route": "cuda",
         "source": f"{PKG}/rasterize_backward.cu",
         "replaces": f"{JAX_OPS}/rasterize_pallas.py:448",
         "launches": launches["rasterize_backward_vpu"],
         "max_abs_err": b2_abs, "ms": k3_ms, "plain_ms": k3_plain,
         **k3_bound, "library_ms": None},
        {"name": "segment_sum_f32", "route": "cuda",
         "source": f"{PKG}/segsum.cu",
         "replaces": f"{JAX_OPS}/segsum.py:46",
         "launches": launches["segsum_f32"], "max_abs_err": st["f32"][2],
         "ms": k4_ms, "plain_ms": k4_plain, **k4_bound,
         "library_ms": k4_lib},
    ]


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
    """The production slice: bench.py's headline configuration (2M
    gaussians) at 1920x1080, ``blend_quad="mxu"``."""
    import torch

    import bench_cuda
    from luisacomputegaussiansplatting_tpu_torch.models import TrainConfig, init_train_state, make_train_step
    from luisacomputegaussiansplatting_tpu_torch.ops.binning import expand_entries
    from luisacomputegaussiansplatting_tpu_torch.ops.projection import project_gaussians
    from luisacomputegaussiansplatting_tpu_torch.ops.rasterize import backward_launch_shape, forward_launch_shape, make_residual, rasterize_forward
    from luisacomputegaussiansplatting_tpu_torch.ops.rasterize_ref import rasterize_backward_reference, rasterize_reference
    from luisacomputegaussiansplatting_tpu_torch.ops.render import _tiles_to_image, payload_table, render_aux
    from luisacomputegaussiansplatting_tpu_torch.ops.segsum import segment_starts_reference, segment_sum_kernel, segment_sum_reference
    from luisacomputegaussiansplatting_tpu_torch.ops.sh_eval import compute_colors
    from luisacomputegaussiansplatting_tpu_torch.utils.profiling import frame_profile, fwd_bwd_frame

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
                   rasterize_mxu=1, rasterize_backward_mxu=1, segsum_bf16=1,
                   sh_forward=1, sh_backward=1, projection_forward=1,
                   projection_backward=1)
    check(not bool(aux.overflow), "phase6: overflow")
    check(bool(torch.isfinite(loss)), "phase6: non-finite loss")
    for name, g, leaf in zip(names, grads, [*leaves, bg]):
        check(g.shape == leaf.shape and bool(torch.isfinite(g).all()),
              f"phase6: gradient of {name} is not finite or mis-shaped")
        check(float(g.abs().max()) > 0, f"phase6: zero gradient of {name}")
    num_rendered = int(aux.num_rendered)
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
        aabb = int(_k[3])
        log(f"phase6 headline: 2M gaussians, AABB slots {aabb} of max_pairs "
            f"{cfg.max_pairs}, kept by the cull {int((_k[2] >= 0).sum())} of "
            f"max_pairs_sorted {cfg.max_pairs_sorted}, num_rendered "
            f"{num_rendered}")
        _p, _g, bp, _pl = bin_and_payload(scene, cam, cfg, expansion="xla")
        for f in binned._fields:
            check(torch.equal(getattr(binned, f), getattr(bp, f)),
                  f"phase6: binning {f} differs kernel vs plain expansion")
        log("phase6: expansion kernel with the cull identical to plain, "
            "binning identical with either expansion")
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
        k2_times = forward_variants("phase6 mxu", payload, ranges, gx, gy, w,
                                    h, cfg, ck, tk, (cp, tp), 5)
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
    dk, dp, b3_abs, _b3_rel = st["b2"]
    k4_err = st["bf16"][2]
    k3_times = backward_variants("phase6 mxu", payload, binned, residual, gx,
                                 w, h, cfg, dp, 5)

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

    # K1 and K4 at this frame's shapes (tile 32 with the cull; the trimmed
    # stream's rows, rounded to bf16) timed on the device, K2 and K3 by
    # their variants above; the plain and library versions with host issue
    with torch.no_grad():
        k2_plain = cuda_ms(lambda: rasterize_reference(
            payload, *ranges, gx, w, h, cfg), 2)
        k3_plain = cuda_ms(lambda: rasterize_backward_reference(
            payload, *ranges, residual, gx, w, h, cfg), 1)
        evaluated, applied = pair_counts(payload, *ranges, gx, w, h, cfg)
        k1_plain = cuda_ms(lambda: expand_entries(
            proj, gx, gx * gy, cfg.max_pairs, cull_op, cfg.tile_wh,
            cfg.alpha_min), 5)
        k1_split = expansion_split(proj, gx, gx * gy, cfg.max_pairs, cull_op,
                                   cfg)
        key = torch.where(binned.entry_gid >= 0, binned.entry_gid,
                          torch.full_like(binned.entry_gid, n))
        sorted_key, perm = torch.sort(key, stable=True)
        rows_t = dk[:, perm].t()
        k4_ms = device_ms(lambda: segment_sum_kernel(sorted_key, rows_t, n,
                                                     "bf16"))
        k4_plain = cuda_ms(lambda: segment_sum_reference(
            sorted_key, rows_t, n, "bf16"), 5)
        lib_rows = torch.where((sorted_key < n)[:, None],
                               rows_t.to(torch.bfloat16).float(), 0.0)
        key64 = sorted_key.to(torch.int64)
        acc = torch.zeros((n + 1, 9), device=dev)
        k4_lib = cuda_ms(lambda: acc.index_add_(0, key64, lib_rows), 5)
        seg_len = segment_starts_reference(sorted_key, n).diff()
        longest = int(seg_len.max())
        n_long = int((seg_len > 32).sum())
        n_ids = int((seg_len > 0).sum())
        del lib_rows, key64, acc, seg_len
    nt = gx * gy
    pix = cfg.tile_wh[0] * cfg.tile_wh[1]
    k1_bound = kernel_bound(*W.k1_work(n, cfg.max_pairs, aabb, True))
    k2_bound = kernel_bound(*W.k2_work(num_rendered, nt, pix, evaluated,
                                       applied, cfg.blend_quad))
    k3_bound = kernel_bound(*W.k3_work(num_rendered, nt, pix, evaluated,
                                       applied, cfg.blend_quad))
    k4_bound = kernel_bound(*W.k4_work(num_rendered, n))
    k2_ms = k2_times[forward_launch_shape(*cfg.tile_wh)[1]]
    k3_ms = k3_times[backward_launch_shape(*cfg.tile_wh)[1]]
    for kernel, ms, plain_ms, b in (
            ("expansion", k1_split[1], k1_plain, k1_bound),
            ("mxu blend", k2_ms, k2_plain, k2_bound),
            ("mxu backward blend", k3_ms, k3_plain, k3_bound),
            ("segment-sum bf16", k4_ms, k4_plain, k4_bound)):
        log(f"phase6: {kernel} kernel {ms:.3f} device ms (bound "
            f"{b['bound_ms']:.3f} {b['bound_by']}); plain {plain_ms:.3f} ms")
    log(f"phase6: expansion prefix sums {k1_split[0]:.3f} device ms; "
        f"index_add_ {k4_lib:.3f} ms; rows summed {num_rendered} of "
        f"{key.shape[0]}; pairs evaluated {evaluated} applied {applied}")
    log(f"phase6: segments: {n_ids} of {n} ids have rows; the longest has "
        f"{longest} rows; {n_long} have more than 32 (summed by a warp)")

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
    losses = []
    for _ in range(n_steps):
        state, step_loss, step_aux = step(state, view, target)
        losses.append(float(step_loss))
        check(not bool(step_aux.overflow), "phase6 training: overflow")
    check_launches("phase6 training", read_launches(), expand=n_steps,
                   rasterize_mxu=n_steps, rasterize_backward_mxu=n_steps,
                   segsum_bf16=n_steps, sh_forward=n_steps,
                   sh_backward=n_steps, projection_forward=n_steps,
                   projection_backward=n_steps, adam=n_steps)
    log(f"phase6 training: losses {' '.join(f'{v:.6f}' for v in losses)}")
    check(all(map(math.isfinite, losses)), "phase6 training: non-finite loss")
    check(losses[-1] < losses[0], "phase6 training: the loss did not fall")
    del state, opt, step, target

    # one production frame under the profiler: the columns cross through
    # utils/packing.py, so no select_backward
    prof = frame_profile(scene, cam, cfg)
    check(prof.busy_ms is not None and prof.busy_ms > 0,
          "phase6 profile: no device time recorded")
    check(select_backward_ms(prof) == 0,
          "phase6 profile: the frame ran select_backward")

    return [
        {"name": "expand_entries_production", "route": "cuda",
         "source": f"{PKG}/expand.cu",
         "replaces": f"{JAX_OPS}/expand_pallas.py:137",
         "launches": launches["expand"], "max_abs_err": k1_err,
         "ms": k1_split[1], "plain_ms": k1_plain, **k1_bound,
         "library_ms": None},
        {"name": "rasterize_forward_mxu", "route": "cuda",
         "source": f"{PKG}/rasterize.cu",
         "replaces": f"{JAX_OPS}/rasterize_pallas.py:282",
         "launches": launches["rasterize_mxu"], "max_abs_err": blend[0],
         "ms": k2_ms, "plain_ms": k2_plain, **k2_bound, "library_ms": None},
        {"name": "rasterize_backward_mxu", "route": "cuda",
         "source": f"{PKG}/rasterize_backward.cu",
         "replaces": f"{JAX_OPS}/rasterize_pallas.py:448",
         "launches": launches["rasterize_backward_mxu"],
         "max_abs_err": b3_abs, "ms": k3_ms, "plain_ms": k3_plain,
         **k3_bound, "library_ms": None},
        {"name": "segment_sum_bf16_production", "route": "cuda",
         "source": f"{PKG}/segsum.cu",
         "replaces": f"{JAX_OPS}/segsum.py:129",
         "launches": launches["segsum_bf16"], "max_abs_err": k4_err,
         "ms": k4_ms, "plain_ms": k4_plain, **k4_bound,
         "library_ms": k4_lib},
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
    counters)."""
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
    out, opt, dstate, info = densify_step(params, opt, dstate, gen, extent,
                                          dcfg)
    counters = {f: getattr(info, f).item() for f in info._fields}
    check_launches(f"{tag}: densify round", read_launches())
    check(out is params, f"{tag}: the round made new parameters")
    n_after = int(dstate.num_active)
    log(f"{tag}: densify round: {counters}; active {n_before} -> {n_after} "
        f"of {dstate.active.shape[0]} {card}")
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
    return params, opt, dstate, counters


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
                    rasterize_backward_mxu=n_views, segsum_bf16=n_views,
                    sh_forward=n_views, sh_backward=n_views,
                    projection_forward=n_views, projection_backward=n_views,
                    adam=1)
    tag = f"[{card}]"

    def batched(first, n):
        nonlocal state, dstate
        losses = []
        for i in range(first, first + n):
            reset_launches()
            state, dstate, loss, overflow = bstep(state, dstate, views,
                                                  targets)
            losses.append(float(loss))
            check(not bool(overflow), f"phase7: batched step {i} overflows")
            check_launches(f"phase7 batched step {i}", read_launches(),
                           **per_step)
            check(not bool(dstate.count[~dstate.active].any()),
                  f"phase7: batched step {i} saw an inactive row")
        return losses

    losses = batched(0, 10)
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
    params, opt, dstate, counters = checked_round(
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

    losses2 = batched(10, 10)
    check(all(map(math.isfinite, losses2)), "phase7: non-finite loss")
    log(f"phase7: 10 batched steps after the round: losses "
        f"{' '.join(f'{v:.6f}' for v in losses2)} {tag}")
    # the kernels against their plain versions on this path's inputs: one
    # ring view (the plain backward takes seconds) after the round
    check_masked_view("phase7 ring view 1", state.params, dstate.active,
                      cams[1], cfg, tag)

    # one more batched step under the profiler: no select_backward
    def one_step():
        nonlocal state, dstate
        state, dstate, loss, _ = bstep(state, dstate, views, targets)
        return float(loss)

    prof = call_profile(one_step, dev)
    if on_card:
        check(prof.busy_ms is not None and prof.busy_ms > 0,
              "phase7 profile: no device time recorded")
        check(select_backward_ms(prof) == 0,
              "phase7 profile: the step ran select_backward")

    params, opt = reset_opacity(state.params, dstate, dcfg, opt)

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
                       rasterize_backward_mxu=1, segsum_bf16=1,
                       sh_forward=1, sh_backward=1, projection_forward=1,
                       projection_backward=1, adam=1)
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
    (the counts' difference around the step)."""

    def __init__(self, make):
        self.make = make
        self.launches = []

    def __call__(self, *args, **kw):
        step = self.make(*args, **kw)

        def probed(*a):
            before = read_launches()
            out = step(*a)
            after = read_launches()
            self.launches.append({k: after[k] - before[k] for k in after})
            return out

        return probed


class DensifyProbe:
    """The train CLI's ``densify_step`` with each round's avg NDC gradient
    quantiles (visible actives, before the round)."""

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
        self.rounds.append(dict(visible=int(visible.sum()), quantiles=qs,
                                above=above, threshold=cfg.grad_threshold))
        return self.real(params, opt, dstate, gen, extent, cfg)


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
    from luisacomputegaussiansplatting_tpu_torch.apps import train_cli

    out_dir = os.path.join(work, "train")
    argv = p8_train_argv(root, out_dir, dev)
    steps = StepProbe(train_cli.make_batched_train_step)
    rounds = DensifyProbe(train_cli.densify_step)
    reset_launches()
    rc, out, err = run_train_cli("phase8b", argv + ["--iters", "60"],
                                 make_batched_train_step=steps,
                                 densify_step=rounds)
    total = read_launches()
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
                    segsum_bf16=4, sh_forward=4, sh_backward=4,
                    projection_forward=4, projection_backward=4, adam=1)
    check(len(steps.launches) == 60, f"phase8b: {len(steps.launches)} steps")
    want = {k: per_step.get(k, 0) for k in total}
    bad = [i + 1 for i, got in enumerate(steps.launches) if got != want]
    check(not bad, f"phase8b: steps {bad} launched other than {per_step}")
    for k in per_step:
        check(total[k] > 0, f"phase8b: {k} never launched")
    n_final = int(logs[60][3])
    log(f"phase8b: 60 steps (B = 4, capacity {P8_CAPACITY}, from "
        f"{P8_POINTS} COLMAP points, {P8_RES[0]}x{P8_RES[1]}) {tag}")
    log(f"phase8b: loss {' '.join(f'{k}:{v:.5f}' for k, v in loss.items())}; "
        f"view-0 PSNR at 20/40/60 {psnr}; actives {actives} {tag}")
    log(f"phase8b: launches over the run {total}; exactly {per_step} "
        f"every step")
    for r, p in zip(rnds, rounds.rounds):
        q = p["quantiles"]
        log(f"phase8b round at {r[0]}: +{r[1]} cloned +{r[2]} split "
            f"-{r[3]} pruned -> {r[4]}; avg NDC grad of "
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
              "segsum_f32", "projection_forward", "projection_backward",
              "adam"):
        check(got[k] > 0, f"phase8d: {k} never launched")
    for k in ("rasterize_mxu", "rasterize_backward_mxu", "segsum_bf16"):
        check(got[k] == 0, f"phase8d: {k} launched")
    log(f"phase8d: view 0 has {entries} entries at the init; max_pairs "
        f"{max_pairs} grew to {', '.join(grows)}; launches {got} {tag}")


def phase8_viewer(scene, dev, tag):
    """8e: the viewer on the 2M bench scene at its defaults, served over
    loopback at 1280x720 and 1920x1080: 20 frames on a ring each, each
    frame against ``render_view``, a malformed query answered 400."""
    import threading
    import urllib.error
    import urllib.request
    from http.server import ThreadingHTTPServer

    import numpy as np
    import torch
    from PIL import Image

    from luisacomputegaussiansplatting_tpu_torch import RenderConfig, look_at_camera
    from luisacomputegaussiansplatting_tpu_torch.apps.viewer import ViewerServer, make_handler
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
        srv = ViewerServer(
            scene, w, h, cfg, name="bench 2M", init_pos=start,
            init_target=(0.0, 0.0, 0.0), world_up=(0.0, 0.0, 1.0), fov=P8_FOV,
            device=dev)
        srv.warmup()
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
            frames = []
            for pos, front, up in poses:
                q = (f"pos={','.join(map(str, pos))}&front="
                     f"{','.join(map(str, front))}&up=0,0,1&fov={P8_FOV}"
                     "&bg=%23000000")
                with urllib.request.urlopen(f"{url}/frame?{q}",
                                            timeout=60) as r:
                    body = r.read()
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
        check(launches["expand"] == len(poses)
              and launches["rasterize_vpu"] == len(poses)
              and launches["projection_forward"] == len(poses)
              and launches["adam"] == 0,
              f"phase8e: launches {launches}")
        psnrs = []
        for (pos, front, up), body in zip(poses, frames):
            got = np.asarray(Image.open(io.BytesIO(body)), np.float64)
            want = srv.frame_to_hwc(srv.render_frame(pos, front, up, P8_FOV,
                                                     (0.0, 0.0, 0.0)))
            mse = float(np.mean((got - want) ** 2))
            psnrs.append(10.0 * math.log10(255.0 ** 2 / max(mse, 1e-12)))
        check(min(psnrs) >= 35.0, f"phase8e {w}x{h}: PSNR {min(psnrs):.2f}")
        log(f"phase8e {w}x{h}: {len(poses)} frames over loopback; JPEG "
            f"{sum(map(len, frames)) / len(frames) / 1024:.0f} KiB; served vs "
            f"render_view PSNR min {min(psnrs):.2f} dB; launches {launches} "
            f"{tag}")


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
    to the whole-frame backward's slots (K3)."""
    import torch

    from luisacomputegaussiansplatting_tpu_torch.ops.rasterize import rasterize_backward, rasterize_forward
    from luisacomputegaussiansplatting_tpu_torch.ops.rasterize_ref import rasterize_backward_reference, rasterize_reference

    w, h = cam.width, cam.height
    _proj, (gx, gy), binned, payload = bin_and_payload(scene, cam, cfg)
    on_card = payload.is_cuda
    rows = -(-gy // P9_BANDS)
    fields = ("mx", "my", "ca", "cb", "cc", "op", "r", "g", "b")
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
                check_fields(tag, "d_payload", dk.t(), dp.t(), fields,
                             rows=keep)
        log(f"phase9a {blend}: {P9_BANDS} bands of {rows} tile rows, K2 and "
            "K3 at each band's offset equal the whole frame's bits and "
            "their plain versions")


def p9_frame(shard, cam, mesh, cfg, scfg):
    """One sharded forward + backward frame (loss = the sum of the rank's
    band, so the ranks' losses add up to the image sum): (band, aux, the
    shard's five gradients)."""
    import torch

    from luisacomputegaussiansplatting_tpu_torch.parallel.render_sharded import render_sharded

    band, aux = render_sharded(*shard, cam, mesh, cfg=cfg, scfg=scfg)
    grads = torch.autograd.grad(band.sum(), shard)
    return band, aux, grads


def check_sharded_k1_k4(scene, cam, cfg, scfg, n):
    """K1 at the sharded frame's shapes (the band-padded grid) bit for bit
    against the plain expansion, and K4 f32 on its stream's ids (the
    tile-sorted local entries, stably sorted by id) with rows of the
    frame's size within SUM_TOL of its plain version."""
    import torch

    from luisacomputegaussiansplatting_tpu_torch.ops.projection import project_gaussians
    from luisacomputegaussiansplatting_tpu_torch.ops.segsum import segment_sum_kernel, segment_sum_reference
    from luisacomputegaussiansplatting_tpu_torch.parallel.render_sharded import band_layout

    lay = band_layout(cam.width, cam.height, cfg, 1)
    nt = lay.tiles_per_dev
    l_loc = scfg.max_pairs_local
    with torch.no_grad():
        proj = project_gaussians(scene.means, scene.scales, scene.quats, cam,
                                 cfg)
        k, _ = compare_expansion(proj, lay.grid_x, nt, l_loc,
                                 cull_opacity(scene, cfg), cfg.tile_wh, cfg)
        _t, order = torch.sort(k[0], stable=False)
        gid = k[2][order]
        key = torch.where(gid >= 0, gid, torch.full_like(gid, n))
        sorted_key, perm = torch.sort(key, stable=True)
        gen = torch.Generator(device=gid.device).manual_seed(9)
        rows = torch.randn((gid.shape[0], 9), generator=gen,
                           device=gid.device)[perm]
        got = segment_sum_kernel(sorted_key, rows, n, "f32")
        want = segment_sum_reference(sorted_key, rows, n, "f32")
        _, rel = check_sums("phase9b segsum f32", got, want)
    log(f"phase9b: K1 at the band-padded grid ({nt} tiles, max_pairs_local "
        f"{l_loc}, AABB slots {int(k[3])}) identical to plain; K4 f32 on the "
        f"frame's ids max|d|/max|sum| {rel:.2e}, rows summed "
        f"{int((sorted_key < n).sum())}")


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
    round. Returns (losses, overflow seen, launches of the first step, the
    round's counters)."""
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
    losses, over, first = [], False, None
    for i in range(steps):
        reset_launches()
        if i == 0:
            (state, dstate, loss, ov), _ = backward_scatter_check(
                f"{tag} step 0", lambda: step(state, dstate, views, padded))
        else:
            state, dstate, loss, ov = step(state, dstate, views, padded)
        losses.append(float(loss))
        over = over or bool(ov)
        if i == 0:
            first = read_launches()
    gen = torch.Generator(device=dev).manual_seed(0)
    _p, opt, dstate, info = densify_sharded(
        state.params, opt, dstate, gen, 3.0, DensifyConfig(), mesh)
    log(f"{tag}: losses {' '.join(f'{v:.6f}' for v in losses)}; densify "
        f"round: +{int(info.n_cloned)} cloned +{int(info.n_split)} split "
        f"-{int(info.n_pruned)} pruned")
    return losses, over, first, info


def phase9b(scene, cam, cfg, dev, tmp):
    """World size 1 in this process (NCCL on the card): the sharded frame
    against the single-device frame and its launches, K1 and K4 at its
    shapes against their plain versions; then sharded training on a 1x1
    mesh and a sharded densify round. Returns the frame's image and
    gradients for 9c."""
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
        reset_launches()
        band, aux, grads = p9_frame(leaves, cam, mesh, cfg, scfg)
        sync(dev)
        check_launches("phase9b sharded frame", read_launches(), expand=1,
                       rasterize_mxu=1, rasterize_backward_mxu=1,
                       segsum_f32=1, sh_forward=1, sh_backward=1,
                       projection_forward=1, projection_backward=1)
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

        check_sharded_k1_k4(scene, cam, cfg, scfg, n)
        ref = {"image": image.cpu(),
               "grads": [g.detach().cpu() for g in grads],
               "num_rendered": int(aux.num_rendered)}
        del leaves, grads

        # training on a 1x1 mesh, then a sharded densify round
        mesh2 = make_mesh((1, 1), ("data", "gs"), device=dev.type)
        losses, over, first, _info = p9_train(
            "phase9b training (1x1 mesh)", mesh2, [cam], scene, cfg, scfg,
            dev, P9_STEPS)
        check_launches("phase9b training step", first, expand=1,
                       rasterize_mxu=1, rasterize_backward_mxu=1,
                       segsum_f32=1, sh_forward=1, sh_backward=1,
                       projection_forward=1, projection_backward=1, adam=1)
        check(not over, "phase9b training: overflow")
        check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
              "phase9b training: the loss did not fall")
    finally:
        dist.destroy_process_group()
    return ref


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
        reset_launches()
        band, aux, grads = p9_frame(shard, cam, mesh, cfg, scfg)
        launches = read_launches()
        image = gather_image(band, mesh, cam.width, cam.height)
        group = mesh.get_group("gs")
        full = []
        for gr in grads:
            parts = [torch.empty_like(gr) for _ in range(P9_RANKS)]
            dist.all_gather(parts, gr.contiguous(), group=group)
            full.append(torch.cat(parts).cpu())
        if rank == 0:
            torch.save({"image": image.cpu(), "grads": full,
                        "overflow": bool(aux.overflow),
                        "num_rendered": int(aux.num_rendered),
                        "launches": launches},
                       os.path.join(tmp, "p9c_frame.pt"))
        del band, grads, full, shard
        mesh2 = make_mesh((2, P9_RANKS // 2), ("data", "gs"), device=dev.type)
        cams = ring_cameras(cam, 2)
        losses, over, first, _info = p9_train(
            f"phase9c training rank {rank} (2x2 mesh)", mesh2, cams, scene,
            cfg, scfg, dev, P9_STEPS)
        if rank == 0:
            with open(os.path.join(tmp, "p9c_train.json"), "w") as f:
                json.dump({"losses": losses, "overflow": over,
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
        f"{ref['num_rendered']}); overflow {got['overflow']}; rank 0 "
        f"launches {got['launches']}")
    check(not got["overflow"], "phase9c: overflow")
    check(img_d <= 2e-5, "phase9c: the image differs from 9b's")
    names = ("means", "scales", "quats", "opacities", "sh")
    for name, a, b in zip(names, got["grads"], ref["grads"]):
        check_fields("phase9c", "gradient", a.reshape(-1, 1),
                     b.reshape(-1, 1), [name])
    with open(os.path.join(tmp, "p9c_train.json")) as f:
        tr = json.load(f)
    log(f"phase9c training (2x2 mesh, rank 0): losses "
        f"{' '.join(f'{v:.6f}' for v in tr['losses'])}; launches of the "
        f"first step {tr['launches']}")
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
    phase9a(scene, cam, cfg)
    with tempfile.TemporaryDirectory() as tmp:
        ref = phase9b(scene, cam, cfg, dev, tmp)
        del scene
        t1 = time.perf_counter()
        phase9c(ref, dev, tmp)
    log(f"phase9: 9a+9b {t1 - t0:.1f} s, 9c {time.perf_counter() - t1:.1f} s "
        f"({card})")


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
    kernel launches recorded, each densify round's gradient quantiles, step
    P10_PROFILE_STEP profiled (on the card it must run no
    select_backward); then the four kernels against their plain versions
    on the trained state and training view 0. Returns the run's numbers
    for the report."""
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
    # two views a step: K1, K2 vpu, K3 vpu and K4 f32 twice every step, K7
    # once; the final view-0 render adds one K1 and one K2
    per_step = dict(expand=2, rasterize_vpu=2, rasterize_backward_vpu=2,
                    segsum_f32=2, sh_forward=2, sh_backward=2,
                    projection_forward=2, projection_backward=2, adam=1)
    check(len(steps.launches) == iters,
          f"phase10 train: {len(steps.launches)} steps")
    want = {k: per_step.get(k, 0) for k in total}
    bad = [i + 1 for i, got in enumerate(steps.launches) if got != want]
    check(not bad, f"phase10 train: steps {bad[:10]} launched other than "
                   f"{per_step}")
    check_launches("phase10 train", total, expand=2 * iters + 1,
                   rasterize_vpu=2 * iters + 1,
                   rasterize_backward_vpu=2 * iters, segsum_f32=2 * iters,
                   sh_forward=2 * iters + 1, sh_backward=2 * iters,
                   projection_forward=2 * iters + 1,
                   projection_backward=2 * iters, adam=iters)
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
    log(f"phase10 train: {iters} steps (2 views of {res}x{res} a step, "
        f"capacity {capacity}) in {secs:.2f} s {tag}")
    shown = " ".join(f"{k}:{v:.5f}" for k, v in loss.items()
                     if k % 500 == 0 or k == 50)
    log(f"phase10 train: loss {shown}; final {final[1]}, view-0 train PSNR "
        f"{final[2]} dB, SSIM {final[3]} {tag}")
    log(f"phase10 train: densify trajectory (actives) {actives}; final "
        f"{n_final}; checkpoints {ckpts} {tag}")
    for r, p in zip(rnds, rounds.rounds):
        q = p["quantiles"]
        log(f"phase10 round at {r[0]}: +{r[1]} cloned +{r[2]} split "
            f"-{r[3]} pruned -> {r[4]}; avg NDC grad of "
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
    if prof is not None and dev.type == "cuda":
        check(prof.busy_ms is not None and prof.busy_ms > 0,
              "phase10 profile: no device time recorded")
        check(select_backward_ms(prof) == 0,
              f"phase10 profile: step {P10_PROFILE_STEP} ran select_backward")
    return dict(seconds=secs, actives=actives, final_active=n_final,
                final_loss=float(final[1]), view0_train_psnr=float(final[2]),
                checkpoints=ckpts,
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


def diff_frame_record(scene, cam, cfg, dev):
    """The differentiable frame of phases 5 and 6 (loss = image sum over a
    zero background, backward to the five groups and the background)
    through the tree's ``render_aux``: digests of the image and the six
    gradients."""
    import torch

    from luisacomputegaussiansplatting_tpu_torch.ops.render import render_aux

    leaves = grad_leaves(scene)
    bg = torch.zeros(3, device=dev, requires_grad=True)
    img, _aux = render_aux(*leaves, cam, bg_color=bg, cfg=cfg)
    grads = torch.autograd.grad(img.sum(), [*leaves, bg])
    out = {"image": tensor_digest(img)}
    out.update({name: tensor_digest(g) for name, g in zip(GRAD_NAMES, grads)})
    return out


def batched_record(dev, grads_file=None):
    """Phase 7's first batched step (B = 4) from its start through the
    tree's package: digests of the six groups' gradients and of the
    accumulated ``grad_sum``. With ``grads_file``, the first tree run saves
    those gradients there and each later one gives each group's max |diff|
    over the saved max |value|."""
    import torch

    _cfg, _cams, views, targets, state, _opt, dstate, bstep = \
        batched_setup(dev)
    state, dstate, _loss, overflow = bstep(state, dstate, views, targets)
    check(not bool(overflow), "compare: the batched step overflows")
    groups = dict(zip(state.params._fields,
                      (p.grad for p in state.params)))
    groups["grad_sum"] = dstate.grad_sum
    out = {"digests": {k: tensor_digest(v) for k, v in groups.items()}}
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
    return out


def tree_record(dev, grads_file=None):
    """K2's and K3's digests (K3 on a seeded residual) on phase 3's frame
    (strict: vpu, no cull) and phase 6's (production: mxu, the cull), the
    differentiable frame's digests on each (``diff_frame_record``), and
    phase 7's batched step (``batched_record``), through whichever port
    package is first on ``sys.path``: ``--compare ROOT`` runs it on the
    tree at ROOT, so that two trees are held to the same bits by the same
    code."""
    import torch

    import bench_cuda
    from luisacomputegaussiansplatting_tpu_torch.ops.rasterize import rasterize_backward, rasterize_forward

    out = {}
    for frame in ("strict", "production"):
        if frame == "strict":
            scene, cam, cfg = headline(dev)
            _proj, (gx, _gy), b, payload = bin_and_payload(scene, cam, cfg,
                                                           expansion="xla")
        else:
            scene, cam, cfg, _ = bench_cuda.scene_camera_config("headline",
                                                                dev)
            _proj, (gx, _gy), b, payload = bin_and_payload(scene, cam, cfg)
        with torch.no_grad():
            color, trans = rasterize_forward(payload, b.tile_starts,
                                             b.tile_counts, gx, cam.width,
                                             cam.height, cfg)
            residual = random_residual(color, trans, 9)
            d_payload = rasterize_backward(payload, b.tile_starts,
                                           b.tile_counts, residual, gx,
                                           cam.width, cam.height, cfg)
            # K3's digest over the slots the ranges cover (the rest is
            # never written)
            used = d_payload[:, :used_slots(b)].contiguous()
            out[frame] = {"k2_digest": blend_digest(color, trans),
                          "k3_digest": blend_digest(used, used[:, :0])}
        del _proj, b, payload, color, trans, residual, d_payload, used
        out[frame]["diff_frame"] = diff_frame_record(scene, cam, cfg, dev)
        del scene
    out["batched"] = batched_record(dev, grads_file)
    return out


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if (argv[:1] == ["--compare"] and len(argv) in (2, 4)
            and argv[2:3] in ([], ["--grads"])):
        # the digests only, from the port package of the tree at argv[1]
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
        record += phase_sh(dev)
        record += phase_projection(dev)
        record += phase_adam(dev)
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
        phase9(dev, card)
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
