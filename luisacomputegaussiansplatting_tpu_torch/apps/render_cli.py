"""Render CLI — the PyTorch counterpart of the reference app
(app/main.cpp:35-343) and of the JAX package's ``apps/render_cli.py``:

    python -m luisacomputegaussiansplatting_tpu_torch.apps.render_cli \
        --ply scene.ply --res 1600x1063 --out out --world colmap --exp_N 10

Same flags as the JAX CLI, except ``--device`` (default ``cuda``; fails if
no GPU is present, CPU runs pass ``--device cpu``) in place of
``--platform``. Camera defaults are the reference's garden pose
(main.cpp:191-197).

``--shard`` under ``torchrun`` splits the gaussians and the frame's tile
rows over the ranks (``parallel/render_sharded.py``; NCCL on the card, gloo
with ``--device cpu``); rank 0 prints and writes the PNG. With one process
it renders on one device, as the JAX CLI does with one device:

    torchrun --nproc-per-node 4 -m \
        luisacomputegaussiansplatting_tpu_torch.apps.render_cli \
        --shard --device cpu --synthetic 20000 --res 320x240 --out out
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from ..config import RenderConfig
from ..io.ply import load_ply
from ..io.synthetic import random_scene
from ..ops.render import render_aux
from ..parallel.mesh import join_process_group, make_mesh
from ..parallel.render_sharded import gather_image, render_sharded
from ..utils.camera import look_at_camera
from ..utils.device import resolve_device
from ..utils.image import write_png


def parse_vec3(s: str):
    v = [float(x) for x in s.replace(",", " ").split()]
    if len(v) != 3:
        raise argparse.ArgumentTypeError(f"expected 3 floats, got {s!r}")
    return tuple(v)


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ply", type=str, default=None, help="3DGS .ply scene")
    p.add_argument("--synthetic", type=int, default=None,
                   help="render a synthetic random scene with N gaussians")
    p.add_argument("--res", type=str, default="1600x1063", help="WxH")
    p.add_argument("--out", type=str, default="out")
    p.add_argument("--world", choices=["colmap", "blender"], default="colmap")
    p.add_argument("--exp_N", type=int, default=1, help="timed repetitions")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cuda, cuda:1, cpu)")
    p.add_argument("--cam-pos", type=parse_vec3, default=(-3.0, -0.5, 3.3))
    p.add_argument("--cam-target", type=parse_vec3, default=(0.0, 3.0, 0.5))
    p.add_argument("--fov", type=float, default=60.0)
    p.add_argument("--bg", type=parse_vec3, default=(0.0, 0.0, 0.0))
    p.add_argument("--sh-degree", type=int, default=3)
    p.add_argument("--max-pairs", type=int, default=8_000_000)
    p.add_argument("--shard", action="store_true",
                   help="shard gaussians+tiles over the ranks of torchrun")
    p.add_argument("--ewa", choices=["inria", "lcgs"], default="inria")
    p.add_argument("--rect", choices=["inria", "lcgs"], default="inria",
                   help="tile-rect clamp convention; 'lcgs' reproduces the "
                        "reference's module.cpp:29-35 binning exactly")
    p.add_argument("--projection", choices=["focal", "ndc"], default="focal",
                   help="EWA Jacobian variant: 'focal' (reference default) "
                        "or 'ndc' (shad_project_gs, rescale-later)")
    p.add_argument("--tile", type=int, default=16, choices=[16, 32],
                   help="rasterizer tile edge")
    p.add_argument("--tile-h", type=int, default=None,
                   help="tile height (rectangular tiles; default square)")
    p.add_argument("--pack", choices=["chunk", "none"], default="chunk",
                   help="'none' skips range repacking")
    p.add_argument("--tight-radius", action="store_true",
                   help="shrink splat radii to the exact alpha_min reach")
    p.add_argument("--tile-cull", action="store_true",
                   help="exact ellipse-tile cull inside the expansion")
    p.add_argument("--sort", choices=["2key", "fused"], default="2key",
                   help="entry-sort keys")
    p.add_argument("--payload", choices=["f32", "bf16"], default="f32",
                   help="per-entry payload precision")
    p.add_argument("--blend", choices=["vpu", "mxu"], default="vpu",
                   help="conic-quadratic evaluation in the blend kernels: "
                        "'mxu' evaluates a tile-local pixel polynomial with "
                        "ln(opacity) folded in and a 1e-3 guard band "
                        "(deviations ~1e-4, far below 1/255; see "
                        "RenderConfig.blend_quad)")
    p.add_argument("--save-raw", type=str, default=None,
                   help="also save the float (3,H,W) frame as .npy")
    return p


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    args = build_parser().parse_args(argv)
    rank, world, dev, started = (join_process_group(args.device)
                                 if args.shard else (0, 1, args.device, False))
    try:
        return _render(args, resolve_device(dev), rank, world)
    finally:
        if started:
            torch.distributed.destroy_process_group()


def _render(args, dev: torch.device, rank: int, world: int) -> int:
    say = print if rank == 0 else (lambda *a, **k: None)
    if world > 1 and dev.type == "cuda":
        torch.cuda.set_device(dev)  # the rank's card (cuda:LOCAL_RANK)
    w, h = (int(x) for x in args.res.split("x"))
    if args.ply:
        scene = load_ply(args.ply, device=dev)
        name = os.path.splitext(os.path.basename(args.ply))[0]
    elif args.synthetic:
        scene = random_scene(args.synthetic, seed=0, device=dev)
        name = f"synthetic{args.synthetic}"
    else:
        say("error: --ply or --synthetic required", file=sys.stderr)
        return 2

    # world-up convention (reference main.cpp:193-202)
    world_up = (0.0, -1.0, -1.0) if args.world == "colmap" else (0.0, 0.0, 1.0)
    cam = look_at_camera(args.cam_pos, args.cam_target, world_up,
                         fov=args.fov, width=w, height=h)
    cfg = RenderConfig(max_pairs=args.max_pairs, tile=args.tile,
                       tile_h=args.tile_h, pack_mode=args.pack,
                       rect_mode=args.rect, payload_dtype=args.payload,
                       sort_mode=args.sort, tight_radius=args.tight_radius,
                       tile_cull=args.tile_cull, blend_quad=args.blend,
                       use_focal=args.projection == "focal")
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    say(f"num_gaussians: {scene.num_gaussians}")
    say(f"rendering {w}x{h} on {dev} ({where}, {world} rank(s))")

    if world > 1:
        # the gaussians padded to whole shards, rank r's rows its shard
        mesh = make_mesh((world,), ("gs",), device=dev.type)
        scene = scene.pad_to(-(-scene.num_gaussians // world) * world)
        p = scene.num_gaussians // world
        shard = [x[rank * p:(rank + 1) * p] for x in scene.render_args()]

        def frame():  # (band, aux); the bands are gathered at the end
            return render_sharded(*shard, cam, mesh, bg_color=args.bg,
                                  cfg=cfg, sh_degree=args.sh_degree)
    else:
        def frame():
            return render_aux(*scene.render_args(), cam, bg_color=args.bg,
                              cfg=cfg, sh_degree=args.sh_degree,
                              ewa_mode=args.ewa)

    with torch.no_grad():
        img, aux = frame()  # first frame: kernel build and warm-up
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(args.exp_N):
            img, aux = frame()
        _sync(dev)
        dt = time.perf_counter() - t0
        per = []
        if args.exp_N > 1:
            for _ in range(min(args.exp_N, 3)):
                t1 = time.perf_counter()
                frame()
                _sync(dev)
                per.append((time.perf_counter() - t1) * 1e3)

    if world > 1:
        img = gather_image(img, mesh, w, h)
    say(f"num_rendered: {int(aux.num_rendered)}")
    if bool(aux.overflow):
        say("WARNING: pair capacity overflow — raise --max-pairs",
            file=sys.stderr)
    fps = args.exp_N / dt if dt > 0 else float("inf")
    say(f"exp time: {dt * 1000:.2f} ms  fps: {fps:.2f} (N={args.exp_N})")
    say(f"pixels/s: {w * h * fps:.3e}")
    if per:
        # each repetition timed on its own, synchronised
        say("rep_ms:", " ".join(f"{v:.1f}" for v in per))
    if rank != 0:
        return 0

    os.makedirs(args.out, exist_ok=True)
    out_path = os.path.join(args.out, f"{name}_{dev.type}.png")
    img_np = img.detach().cpu().numpy()
    write_png(out_path, img_np)
    print(f"result saved in {out_path}")
    if args.save_raw:
        np.save(args.save_raw, img_np.astype(np.float32))
        print(f"raw frame saved in {args.save_raw}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
