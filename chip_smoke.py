#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from ``luisacomputegaussiansplatting_tpu_torch/
csrc``, holds each against its plain PyTorch version, and drives the port's
forward render path end to end:

  0. the card (nvidia-smi name and power limit), torch/CUDA versions and the
     kernel build time;
  1. kernels against plain versions at test scale: a 20K-gaussian random
     scene at 320x240 over tile 16, 32 and 32x16, both pack modes, cull off
     and on — the expansion kernel must equal the plain expansion bit for
     bit, the blend kernel must agree with the plain rasterizer within the
     tolerance below;
  2. the render CLI in-process on a 200K-gaussian scene at 1600x1063;
  3. the full slice: a 2M-gaussian random scene at 1920x1080 through
     ``render_aux`` with the strict-parity config, re-run stage by stage with
     the plain versions, and timed.

Blend tolerance: max |diff| <= 5e-4 on colour and T, except at most 1e-5 of
the pixels (transmittance-stop flips), which stay <= 2e-2.

Every failed check exits non-zero; with no CUDA device it fails at once. The
last line of standard output is one JSON object naming the device; the line
before it is the per-kernel JSON record.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import time

TOL = 5e-4
FLIP_TOL = 2e-2
FLIP_SHARE = 1e-5
ROOT = os.path.dirname(os.path.abspath(__file__))


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
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


def phase0():
    import torch

    from luisacomputegaussiansplatting_tpu_torch.ops import expand, rasterize

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    log(f"card: {smi[0]}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    for k in (expand.KERNEL, rasterize.KERNEL):
        k.lib()
        built = "cached" if k.build_seconds is None else f"{k.build_seconds:.2f} s"
        log(f"kernel {k.name}: built ({built})")
    log(f"kernel build total: {time.perf_counter() - t0:.2f} s")
    return smi[0]


def phase1(dev):
    import torch

    from luisacomputegaussiansplatting_tpu_torch import RenderConfig, look_at_camera, random_scene
    from luisacomputegaussiansplatting_tpu_torch.ops.binning import bin_gaussians, bin_gaussians_nopack
    from luisacomputegaussiansplatting_tpu_torch.ops.projection import project_gaussians, tile_grid
    from luisacomputegaussiansplatting_tpu_torch.ops.rasterize import rasterize_forward
    from luisacomputegaussiansplatting_tpu_torch.ops.rasterize_ref import rasterize_reference
    from luisacomputegaussiansplatting_tpu_torch.ops.render import build_payload
    from luisacomputegaussiansplatting_tpu_torch.ops.sh_eval import compute_colors

    w, h = 320, 240
    scene = random_scene(20_000, seed=1, device=dev)
    cam = look_at_camera((3.0, -2.5, 2.0), (0, 0, 0), (0, 0, 1), fov=70.0,
                         width=w, height=h)
    for tile, tile_h in ((16, None), (32, None), (32, 16)):
        for pack in ("chunk", "none"):
            for cull in (False, True):
                tag = f"phase1 tile={tile}x{tile_h or tile} pack={pack} cull={cull}"
                cfg = RenderConfig(max_pairs=2_000_000, tile=tile,
                                   tile_h=tile_h, pack_mode=pack,
                                   tile_cull=cull)
                with torch.no_grad():
                    proj = project_gaussians(scene.means, scene.scales,
                                             scene.quats, cam, cfg)
                    gx, gy = tile_grid(w, h, cfg.tile_wh)
                    cull_op = scene.opacities if cull else None
                    k, _ = compare_expansion(proj, gx, gx * gy, cfg.max_pairs,
                                             cull_op, cfg.tile_wh, cfg)
                    binner = bin_gaussians if pack == "chunk" else bin_gaussians_nopack
                    args = (proj, gx, gy, cfg.max_pairs, cull_op, cfg.tile_wh,
                            cfg.alpha_min)
                    bk = binner(*args, expansion="auto")
                    bp = binner(*args, expansion="xla")
                    for f in bk._fields:
                        check(torch.equal(getattr(bk, f), getattr(bp, f)),
                              f"{tag}: binning {f} differs kernel vs plain")
                    check(not bool(bk.overflow), f"{tag}: overflow")
                    colors = compute_colors(scene.means, scene.sh,
                                            cam.position)
                    payload = build_payload(proj, colors, scene.opacities, bk)
                    ck, tk = rasterize_forward(payload, bk.tile_starts,
                                               bk.tile_counts, gx, w, h, cfg)
                    cp, tp = rasterize_reference(payload, bk.tile_starts,
                                                 bk.tile_counts, gx, w, h, cfg)
                    torch.cuda.synchronize()
                log(f"{tag}: expansion identical, total={int(k[3])} "
                    f"num_rendered={int(bk.num_rendered)}")
                check_blend(tag, *blend_diff(ck, tk, cp, tp, gx, gy, w, h,
                                             cfg.tile_wh))


def phase2():
    from luisacomputegaussiansplatting_tpu_torch.apps import render_cli

    out_dir = os.path.join(ROOT, "build", "chip_smoke")
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = render_cli.main([
            "--synthetic", "200000", "--res", "1600x1063", "--exp_N", "3",
            "--max-pairs", "16000000", "--out", out_dir,
        ])
    for line in out.getvalue().splitlines():
        log(f"phase2 cli: {line}")
    check(rc == 0, f"render_cli returned {rc}")
    check("overflow" not in err.getvalue(), f"render_cli: {err.getvalue()}")
    check("num_rendered:" in out.getvalue() and "rep_ms:" in out.getvalue(),
          "render_cli printed no num_rendered / rep_ms line")


def phase3(dev):
    import torch

    from luisacomputegaussiansplatting_tpu_torch import RenderConfig, look_at_camera, random_scene
    from luisacomputegaussiansplatting_tpu_torch.ops import expand, rasterize
    from luisacomputegaussiansplatting_tpu_torch.ops.binning import bin_gaussians, expand_entries
    from luisacomputegaussiansplatting_tpu_torch.ops.expand import expand_entries_kernel
    from luisacomputegaussiansplatting_tpu_torch.ops.projection import project_gaussians, tile_grid
    from luisacomputegaussiansplatting_tpu_torch.ops.rasterize import rasterize_forward
    from luisacomputegaussiansplatting_tpu_torch.ops.rasterize_ref import rasterize_reference
    from luisacomputegaussiansplatting_tpu_torch.ops.render import build_payload, render_aux
    from luisacomputegaussiansplatting_tpu_torch.ops.sh_eval import compute_colors

    w, h = 1920, 1080
    cfg = RenderConfig(max_pairs=16_000_000)
    # numpy-RNG realisation of the JAX bench.py headline scene (bench.py
    # draws it with jax.random: same distributions, other numbers)
    scene = random_scene(2_000_000, seed=0, extent=3.0,
                         scale_range=(0.004, 0.02), device=dev)
    cam = look_at_camera((3.5, -3.0, 2.2), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0),
                         fov=65.0, width=w, height=h)
    args = scene.render_args()

    with torch.no_grad():
        # the main path, with the launch counts taken over exactly this run
        expand.KERNEL.launches = 0
        rasterize.KERNEL.launches = 0
        img, aux = render_aux(*args, cam, cfg=cfg)
        torch.cuda.synchronize()
        launches = {"expand": expand.KERNEL.launches,
                    "rasterize": rasterize.KERNEL.launches}
        log(f"phase3: main-path launches {launches}")
        check(all(v > 0 for v in launches.values()),
              "a kernel of the main path was never launched")
        check(not bool(aux.overflow), "phase3: overflow")
        check(tuple(img.shape) == (3, h, w), f"image shape {tuple(img.shape)}")
        check(bool(torch.isfinite(img).all()), "non-finite image")
        num_rendered = int(aux.num_rendered)
        check(num_rendered > 0, "nothing rendered")

        # the stages again, kernel against plain, on the same card
        colors = compute_colors(scene.means, scene.sh, cam.position)
        proj = project_gaussians(scene.means, scene.scales, scene.quats, cam,
                                 cfg)
        gx, gy = tile_grid(w, h, cfg.tile_wh)
        nt = gx * gy
        k, k1_err = compare_expansion(proj, gx, nt, cfg.max_pairs, None,
                                      cfg.tile_wh, cfg)
        aabb_total = int(k[3])
        bargs = (proj, gx, gy, cfg.max_pairs, None, cfg.tile_wh, cfg.alpha_min)
        bk = bin_gaussians(*bargs, expansion="auto")
        bp = bin_gaussians(*bargs, expansion="xla")
        for f in bk._fields:
            check(torch.equal(getattr(bk, f), getattr(bp, f)),
                  f"phase3: binning {f} differs kernel vs plain")
        check(int(bk.num_rendered) == num_rendered,
              "phase3: num_rendered differs from the main path")
        payload = build_payload(proj, colors, scene.opacities, bp)
        ck, tk = rasterize_forward(payload, bp.tile_starts, bp.tile_counts,
                                   gx, w, h, cfg)
        cp, tp = rasterize_reference(payload, bp.tile_starts, bp.tile_counts,
                                     gx, w, h, cfg)
        torch.cuda.synchronize()
        blend = blend_diff(ck, tk, cp, tp, gx, gy, w, h, cfg.tile_wh)
        check_blend("phase3", *blend)
        # the main-path image against the all-plain one
        from luisacomputegaussiansplatting_tpu_torch.ops.render import _tiles_to_image

        img_p, t_p = _tiles_to_image(cp, tp, gx, gy, w, h, cfg.tile_wh)
        d = torch.maximum((img - img_p).abs().amax(dim=0),
                          (aux.transmittance - t_p).abs())
        check_blend("phase3 frame", float(d.max()), int((d > TOL).sum()),
                    w * h)

        reps = 5
        k1_ms = cuda_ms(lambda: expand_entries_kernel(
            proj, gx, nt, cfg.max_pairs, None, cfg.tile_wh, cfg.alpha_min), reps)
        k1_plain = cuda_ms(lambda: expand_entries(
            proj, gx, nt, cfg.max_pairs, None, cfg.tile_wh, cfg.alpha_min), reps)
        k2_ms = cuda_ms(lambda: rasterize_forward(
            payload, bp.tile_starts, bp.tile_counts, gx, w, h, cfg), reps)
        k2_plain = cuda_ms(lambda: rasterize_reference(
            payload, bp.tile_starts, bp.tile_counts, gx, w, h, cfg), 2)

        render_aux(*args, cam, cfg=cfg)  # warm-up
        frames = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            render_aux(*args, cam, cfg=cfg)
            end.record()
            torch.cuda.synchronize()
            frames.append(start.elapsed_time(end))
        peak = torch.cuda.max_memory_allocated() / 2**30

    frame_ms = statistics.median(frames)
    log(f"phase3: 2M gaussians 1920x1080 strict-parity: aabb_total={aabb_total} "
        f"num_rendered={num_rendered} capacity={payload.shape[1]}")
    log(f"phase3: frame_ms median of 5 = {frame_ms:.3f} "
        f"(all: {' '.join(f'{v:.3f}' for v in frames)}); peak mem {peak:.2f} GiB")
    log(f"phase3: expansion kernel {k1_ms:.3f} ms vs plain {k1_plain:.3f} ms; "
        f"blend kernel {k2_ms:.3f} ms vs plain {k2_plain:.3f} ms")
    pkg = "luisacomputegaussiansplatting_tpu_torch/csrc"
    return {"kernels": [
        {"name": "expand_entries", "route": "cuda",
         "source": f"{pkg}/expand.cu",
         "replaces": "luisacomputegaussiansplatting_tpu/ops/expand_pallas.py:137",
         "launches": launches["expand"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "rasterize_forward", "route": "cuda",
         "source": f"{pkg}/rasterize.cu",
         "replaces": "luisacomputegaussiansplatting_tpu/ops/rasterize_pallas.py:282",
         "launches": launches["rasterize"], "max_abs_err": blend[0],
         "ms": k2_ms, "plain_ms": k2_plain},
    ]}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    t0 = time.perf_counter()
    try:
        card = phase0()
        phase1(dev)
        phase2()
        record = phase3(dev)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    log(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
