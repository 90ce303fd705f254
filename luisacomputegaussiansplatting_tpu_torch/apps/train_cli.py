"""3DGS training CLI: the PyTorch counterpart of the JAX package's
``apps/train_cli.py`` (the capability the reference roadmap left unchecked,
"Support Training without python binding", doc/roadmap.md:4).

Trains a gaussian scene against a multi-view dataset with the graphdeco
recipe: per-group Adam, (1-w) L1 + w D-SSIM loss, adaptive density control
(clone/split/prune + opacity resets) at a static capacity, periodic
checkpoints, and a final graphdeco-compatible PLY export.

    # self-supervised smoke run (targets rendered from a synthetic scene):
    python -m luisacomputegaussiansplatting_tpu_torch.apps.train_cli \\
        --synthetic-gt 4000 --views 24 --res 256x256 --iters 800 \\
        --capacity 20000 --out /tmp/fit

    # NeRF-synthetic (lego/chair) or COLMAP (bicycle/garden):
    python -m ... --nerf-synthetic /data/lego --iters 30000 ...
    python -m ... --colmap /data/bicycle --downscale 4 ...

Same flags as the JAX CLI, except ``--device`` (default ``cuda``; fails if
no GPU is present, CPU runs pass ``--device cpu``) in place of
``--platform``.

``--shard`` under ``torchrun`` trains on a (data, gs) mesh of the ranks
(``parallel/train_sharded.py``): ``--mesh DATAxGS`` (default 2 x n/2 when
the rank count n is even), per-rank capacities ``--max-pairs-local`` and
``--exchange-capacity``; the gaussian capacity is rounded up to a multiple
of the gs axis. Rank 0 alone logs, writes the checkpoints (of the gathered
state) and exports; a resumed rank takes its rows. With one process it
trains on one device, as the JAX CLI does with one device:

    torchrun --nproc-per-node 4 -m \
        luisacomputegaussiansplatting_tpu_torch.apps.train_cli --shard \
        --mesh 2x2 --device cpu --synthetic-gt 300 --res 64x48 ...

The init points and the view choice come from the same numpy generator
calls, in the same order, as the JAX CLI's; the split noise comes from a
``torch.Generator`` on the device seeded with ``--seed`` (the JAX CLI splits
a PRNG key). The loss and the overflow flag stay on the device and are read
only at ``--log-every``, ``--eval-every`` and the end.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import os
import sys
import time

import numpy as np
import torch

from ..config import CHUNK, RenderConfig
from ..io.dataset import (
    load_colmap,
    load_colmap_points3d,
    load_nerf_synthetic,
    synthetic_multiview,
)
from ..io.ply import load_ply, save_ply
from ..io.synthetic import random_scene
from ..models.checkpoint import CheckpointManager
from ..models.densify import (
    DensifyConfig,
    DensifySchedule,
    densify_step,
    density_control,
    init_densify_state,
)
from ..models.gaussians import GaussianScene, pad_params_to, params_from_numpy
from ..models.losses import ssim
from ..models.trainer import (
    TrainConfig,
    TrainState,
    init_train_state,
    make_batched_train_step,
    make_densify_train_step,
)
from ..ops.render import render_view
from ..parallel.mesh import join_process_group, make_mesh
from ..parallel.render_sharded import ShardedRenderConfig, derive_exchange_capacity
from ..parallel.train_sharded import (
    densify_sharded,
    gather_shards,
    make_sharded_train_step,
    take_rows,
)
from ..utils.camera import CameraView
from ..utils.device import resolve_device
from ..utils.image import write_png


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--synthetic-gt", type=int, default=None,
                     help="fit against views rendered from a random scene with N gaussians")
    src.add_argument("--nerf-synthetic", type=str, default=None,
                     help="NeRF-blender dataset root (transforms_train.json)")
    src.add_argument("--colmap", type=str, default=None,
                     help="COLMAP dataset root (sparse/0 + images/)")
    p.add_argument("--init-ply", type=str, default=None,
                   help="initialise from a 3DGS .ply instead of random points")
    p.add_argument("--downscale", type=int, default=1,
                   help="integer downscale of COLMAP images")
    p.add_argument("--init-points", type=int, default=2000,
                   help="random init point count (no --init-ply)")
    p.add_argument("--capacity", type=int, default=50_000,
                   help="static gaussian capacity (densification headroom)")
    p.add_argument("--views", type=int, default=24, help="synthetic-gt view count")
    p.add_argument("--res", type=str, default="256x256", help="synthetic-gt resolution")
    p.add_argument("--iters", type=int, default=2000)
    p.add_argument("--max-pairs", type=int, default=1_000_000)
    p.add_argument("--tile", type=int, default=16, choices=[16, 32])
    p.add_argument("--tile-h", type=int, default=None,
                   help="tile height (rectangular tiles; default square)")
    p.add_argument("--pack", choices=["chunk", "none"], default="none",
                   help="rasterizer range layout; 'none' is faster and the "
                        "training default")
    p.add_argument("--payload", choices=["f32", "bf16"], default="f32",
                   help="payload-gather precision (see render_cli --payload)")
    p.add_argument("--blend", choices=["vpu", "mxu"], default="vpu",
                   help="blend-kernel quadratic path (see "
                        "RenderConfig.blend_quad)")
    p.add_argument("--sort", choices=["2key", "fused"], default="2key",
                   help="entry-sort key layout (see render_cli --sort)")
    p.add_argument("--grad-reduce", choices=["ride", "rowgather"],
                   default="ride",
                   help="accepted for parity with the JAX CLI; both run one "
                        "path (see RenderConfig.grad_reduce_method)")
    p.add_argument("--grad-reduce-dtype", choices=["f32", "bf16"],
                   default="f32",
                   help="per-entry gradient rows round to bf16 before the "
                        "per-gaussian reduction; the sums stay f32 (see "
                        "RenderConfig.grad_reduce_dtype)")
    p.add_argument("--tight-radius", action="store_true",
                   help="exact alpha_min splat radii (see render_cli)")
    p.add_argument("--tile-cull", action="store_true",
                   help="in-kernel exact ellipse-tile cull (see render_cli)")
    p.add_argument("--sh-degree", type=int, default=3)
    p.add_argument("--sh-upgrade-every", type=int, default=1000,
                   help="raise the active SH degree by one every N iters "
                        "(graphdeco oneupSHdegree); 0 = full degree always")
    p.add_argument("--views-per-step", type=int, default=1,
                   help="views rendered per optimiser step (one backward "
                        "over the mean loss)")
    p.add_argument("--densify-from", type=int, default=100)
    p.add_argument("--densify-until", type=int, default=None,
                   help="default iters // 2")
    p.add_argument("--densify-interval", type=int, default=100)
    p.add_argument("--opacity-reset-interval", type=int, default=0,
                   help="0 disables (graphdeco: 3000)")
    p.add_argument("--grad-threshold", type=float, default=2e-4,
                   help="densify grad threshold in graphdeco's NDC-scaled "
                        "units (their default 2e-4; resolution-independent)")
    p.add_argument("--shard", action="store_true",
                   help="view data-parallelism x gaussian/tile sharding on "
                        "a (data, gs) mesh of the ranks of torchrun")
    p.add_argument("--mesh", type=str, default=None,
                   help="DATAxGS device mesh shape (with --shard)")
    p.add_argument("--max-pairs-local", type=int, default=None,
                   help="per-device expansion capacity (with --shard)")
    p.add_argument("--exchange-capacity", type=int, default=None,
                   help="per (src,dst)-device bucket capacity (with --shard)")
    p.add_argument("--ckpt-every", type=int, default=0, help="0 disables")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--out", type=str, default="out_train")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cuda, cuda:1, cpu)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--eval-every", type=int, default=0, help="0 disables")
    p.add_argument("--bg", type=str, default="black", choices=["black", "white"])
    return p


def psnr(a, b):
    mse = float(np.mean((np.asarray(a) - np.asarray(b)) ** 2))
    return -10.0 * np.log10(max(mse, 1e-10))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _init_params(args, data, rng, dev):
    """The starting gaussians (raw parameters on ``dev``): a PLY, the COLMAP
    sparse points (graphdeco's init) or random points in the scene volume."""
    colmap_pts = None
    if args.colmap and not args.init_ply:
        try:
            colmap_pts = load_colmap_points3d(args.colmap)
        except FileNotFoundError:
            pass
    k = (args.sh_degree + 1) ** 2
    if args.init_ply:
        return load_ply(args.init_ply, device=dev).to_params()
    if colmap_pts is not None:
        # graphdeco init (scene/gaussian_model.create_from_pcd): means at
        # the COLMAP sparse points, SH DC from point colour, scales =
        # log(mean 3-NN distance), opacity = inverse_sigmoid(0.1)
        from scipy.spatial import cKDTree

        from ..utils.sh import sh_from_color

        t0 = time.perf_counter()
        xyz, rgb = colmap_pts
        if xyz.shape[0] > args.capacity // 2:
            sel = rng.choice(xyz.shape[0], args.capacity // 2, replace=False)
            xyz, rgb = xyz[sel], rgb[sel]
        d, _ = cKDTree(xyz).query(xyz, k=min(4, xyz.shape[0]), workers=-1)
        nn = np.sqrt(np.clip((d[:, 1:] ** 2).mean(axis=1), 1e-14, None))
        n0 = xyz.shape[0]
        quats = np.zeros((n0, 4), np.float32)
        quats[:, 3] = 1.0
        params = params_from_numpy(
            xyz, np.log(nn)[:, None].repeat(3, 1), quats,
            np.full((n0,), float(np.log(0.1 / 0.9)), np.float32),
            np.asarray(sh_from_color(rgb))[:, None, :],
            np.zeros((n0, k - 1, 3), np.float32), dev)
        print(f"init from COLMAP points3D: {n0} points (k-NN scales in "
              f"{time.perf_counter() - t0:.3f} s)")
        return params
    # random points in the scene volume, dim + semi-transparent
    n0 = args.init_points
    pts = rng.uniform(-1, 1, (n0, 3)).astype(np.float32) * data.scene_extent * 0.7
    quats = np.zeros((n0, 4), np.float32)
    quats[:, 3] = 1.0
    return params_from_numpy(
        pts, np.full((n0, 3), np.log(0.05 * data.scene_extent), np.float32),
        quats, np.full((n0,), -2.0, np.float32),
        rng.normal(0, 0.3, (n0, 1, 3)), np.zeros((n0, k - 1, 3), np.float32),
        dev)


def density_schedule(args) -> DensifySchedule:
    """The CLI's density control: after iteration i (1-based), a round for
    ``--densify-from`` < i <= ``--densify-until`` (default ``--iters`` //
    2) at multiples of ``--densify-interval``, an opacity reset at
    multiples of ``--opacity-reset-interval`` up to the same end; no size
    prunes."""
    densify_until = args.densify_until or args.iters // 2
    return DensifySchedule(
        start=args.densify_from, stop=densify_until + 1,
        interval=args.densify_interval,
        reset_interval=args.opacity_reset_interval, size_prune_after=None)


def _mesh_shape(args, world: int):
    """(n_data, n_gs) of ``--mesh``, or the JAX CLI's default: 2 x n/2 when
    the rank count n is even."""
    if args.mesh:
        n_data, n_gs = (int(x) for x in args.mesh.split("x"))
        return n_data, n_gs
    n_data = 2 if world % 2 == 0 else 1
    return n_data, world // n_data


def _round_chunk(x: int) -> int:
    return -(-x // CHUNK) * CHUNK


def main(argv=None):
    args = build_parser().parse_args(argv)
    rank, world, dev, started = (join_process_group(args.device)
                                 if args.shard else (0, 1, args.device, False))
    try:
        return _train(args, resolve_device(dev), rank, world)
    finally:
        if started:
            torch.distributed.destroy_process_group()


def _train(args, dev: torch.device, rank: int, world: int) -> int:
    say = print if rank == 0 else (lambda *a, **k: None)
    if world > 1 and dev.type == "cuda":
        torch.cuda.set_device(dev)  # the rank's card (cuda:LOCAL_RANK)
    os.makedirs(args.out, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    # ---- dataset --------------------------------------------------------
    if args.synthetic_gt:
        w, h = (int(x) for x in args.res.split("x"))
        gt = random_scene(args.synthetic_gt, seed=args.seed + 1,
                          extent=1.5, scale_range=(0.02, 0.08), device=dev)
        data = synthetic_multiview(
            gt, n_views=args.views, width=w, height=h, radius=4.0,
            cfg=RenderConfig(max_pairs=args.max_pairs),
            sh_degree=args.sh_degree, device=dev,
        )
        name = f"syntheticgt{args.synthetic_gt}"
    elif args.nerf_synthetic:
        data = load_nerf_synthetic(
            args.nerf_synthetic, white_background=args.bg == "white"
        )
        name = os.path.basename(os.path.normpath(args.nerf_synthetic))
    else:
        data = load_colmap(args.colmap, downscale=args.downscale)
        name = os.path.basename(os.path.normpath(args.colmap))
    width, height = data.cameras[0].width, data.cameras[0].height
    say(f"dataset: {len(data)} views at {width}x{height}, "
        f"extent {data.scene_extent:.2f}")

    # ---- the (data, gs) mesh of the ranks --------------------------------
    mesh = None
    if world > 1:
        n_data, n_gs = _mesh_shape(args, world)
        if n_data * n_gs != world:
            say(f"error: mesh {args.mesh} != {world} devices", file=sys.stderr)
            return 2
        mesh = make_mesh((n_data, n_gs), ("data", "gs"), device=dev.type)
        args.capacity = -(-args.capacity // n_gs) * n_gs  # shardable
        say(f"mesh: {n_data} data x {n_gs} gs devices")
    elif args.shard:
        say("--shard requested but only one device; running single-chip")

    # ---- init -----------------------------------------------------------
    params = _init_params(args, data, rng, dev)
    n0 = params.means.shape[0]
    params = pad_params_to(params, args.capacity)
    dstate = init_densify_state(n0, args.capacity, device=dev)
    if mesh is not None:  # this rank's rows of the gs axis
        p_shard = args.capacity // n_gs
        mine = slice(mesh.get_local_rank("gs") * p_shard,
                     (mesh.get_local_rank("gs") + 1) * p_shard)
        params = type(params)(*(x[mine] for x in params))
        dstate = type(dstate)(*(x[mine].clone() for x in dstate))
    # graphdeco's spatial_lr_scale: position lr endpoints scale with the
    # scene extent (their cameras_extent)
    tc = TrainConfig(spatial_lr_scale=float(data.scene_extent))
    state, opt = init_train_state(params, tc)
    del params
    say(f"init: {n0} gaussians, capacity {args.capacity}")

    cfg = RenderConfig(max_pairs=args.max_pairs, tile=args.tile,
                       tile_h=args.tile_h, pack_mode=args.pack,
                       payload_dtype=args.payload, sort_mode=args.sort,
                       grad_reduce_method=args.grad_reduce,
                       grad_reduce_dtype=args.grad_reduce_dtype,
                       tight_radius=args.tight_radius,
                       tile_cull=args.tile_cull,
                       blend_quad=args.blend)
    scfg = None
    if mesh is not None:
        mpl = _round_chunk(args.max_pairs_local
                           or max(args.max_pairs // n_gs, CHUNK))
        # the skew-derived default; overflow still doubles it below
        bcap = _round_chunk(args.exchange_capacity
                            or derive_exchange_capacity(mpl, n_gs))
        scfg = ShardedRenderConfig(max_pairs_local=mpl,
                                   exchange_capacity=bcap)
    bg = (1.0, 1.0, 1.0) if args.bg == "white" else (0.0, 0.0, 0.0)
    dcfg = DensifyConfig(grad_threshold=args.grad_threshold)

    # one step function per active SH degree (graphdeco raises the degree
    # during training); each closes over cfg, so grow_capacity drops them
    _step_cache = {}

    def step_for_degree(deg: int):
        if deg not in _step_cache:
            if mesh is not None:
                step, _opt, pad_t = make_sharded_train_step(
                    opt, mesh, width, height, cfg=cfg, scfg=scfg,
                    sh_degree=deg, tc=tc, bg_color=bg, densify=True)
                _step_cache[deg] = (step, pad_t)
            else:
                make = (make_batched_train_step if args.views_per_step > 1
                        else make_densify_train_step)
                _step_cache[deg] = make(opt, width, height, cfg=cfg,
                                        sh_degree=deg, tc=tc, bg_color=bg)
        return _step_cache[deg]

    def grow_capacity():
        """Render-pair overflow: double the static capacities and rebuild
        the steps (the reference grows its temp buffers x2,
        gs_tile_splatter/impl.cpp:31-61, but here on a *detected* overflow
        instead of silently corrupting past L, app/main.cpp:245)."""
        nonlocal cfg, scfg
        cfg = dataclasses.replace(cfg, max_pairs=cfg.max_pairs * 2)
        if scfg is not None:
            scfg = ShardedRenderConfig(
                max_pairs_local=scfg.max_pairs_local * 2,
                exchange_capacity=scfg.exchange_capacity * 2,
            )
        _step_cache.clear()
        say(f"[overflow] raising max_pairs to {cfg.max_pairs} and "
            "recompiling (entries were dropped this interval)",
            file=sys.stderr)

    def whole():
        """(parameters, Adam, DensifyState) of every gaussian: the gathered
        shards on a mesh (a collective: every rank calls it)."""
        if mesh is None:
            return state.params, opt, dstate
        return gather_shards(state.params, opt, dstate, mesh)

    def num_active() -> int:
        n = dstate.num_active
        if mesh is not None:
            torch.distributed.all_reduce(n, group=mesh.get_group("gs"))
        return int(n)

    ckpt = None
    start_iter = 0
    if args.ckpt_every:
        ckpt = CheckpointManager(os.path.join(args.out, "ckpt"))
        if args.resume:
            # the parameters, Adam's moments and the densify state are
            # written in place (on a mesh into the gathered state, whose
            # rows each rank then takes); the step comes back as a number
            full_p, full_opt, full_d = whole()
            latest, (restored, full_opt, full_d) = ckpt.restore_latest(
                (TrainState(full_p, 0), full_opt, full_d))
            if latest is not None:
                if mesh is not None:
                    dstate = take_rows(state.params, opt, restored.params,
                                       full_opt, full_d, mesh)
                else:
                    dstate = full_d
                state = TrainState(state.params, restored.step)
                start_iter = latest
                say(f"resumed from step {latest}")

    views = [c.to_view(dev) for c in data.cameras]
    targets = [torch.from_numpy(t).to(dev) for t in data.targets]
    schedule = density_schedule(args)
    round_fn = (functools.partial(densify_sharded, mesh=mesh)
                if mesh is not None else densify_step)

    def eval_render(view):
        params, _o, d = whole()
        with torch.no_grad():
            scene = params.activate()
            img, _ = render_view(*scene.render_args(), view, width, height,
                                 bg, cfg, args.sh_degree, active_mask=d.active)
        return img

    def stacked(vis):
        return (CameraView(*(torch.stack(x) for x in
                             zip(*(views[v] for v in vis)))),
                torch.stack([targets[v] for v in vis]))

    t0 = time.perf_counter()
    last_loss = float("nan")
    loss = None
    # sticky overflow flag, kept on the device: read only at log lines
    ov_acc = torch.zeros((), dtype=torch.bool, device=dev)
    for it in range(start_iter, args.iters):
        if args.sh_upgrade_every > 0:
            deg = min(args.sh_degree, it // args.sh_upgrade_every)
        else:
            deg = args.sh_degree
        step_fn = step_for_degree(deg)
        if mesh is not None:
            step_s, pad_t = step_fn
            nv = n_data * args.views_per_step
            v_batch, t_batch = stacked(rng.choice(len(data), size=nv,
                                                  replace=nv > len(data)))
            state, dstate, loss, overflow = step_s(state, dstate, v_batch,
                                                   pad_t(t_batch))
        elif args.views_per_step > 1:
            v_batch, t_batch = stacked(rng.choice(
                len(data),
                size=args.views_per_step,
                replace=args.views_per_step > len(data),
            ))
            state, dstate, loss, overflow = step_fn(state, dstate, v_batch,
                                                    t_batch)
        else:
            vi = int(rng.integers(0, len(data)))
            state, dstate, loss, aux = step_fn(state, dstate, views[vi],
                                               targets[vi])
            overflow = aux.overflow
        ov_acc = torch.logical_or(ov_acc, overflow)

        opt, dstate, dinfo = density_control(
            it + 1, schedule, state.params, opt, dstate, gen,
            data.scene_extent, dcfg, round_fn)
        if dinfo is not None:
            n_act = num_active()
            say(
                f"[{it+1}] densify: +{int(dinfo.n_cloned)} cloned "
                f"+{int(dinfo.n_split)} split -{int(dinfo.n_pruned)} pruned "
                f"-> {n_act} active",
                file=sys.stderr,
            )
            if bool(dinfo.overflow):
                say(f"[{it+1}] WARNING: capacity full, children dropped",
                    file=sys.stderr)

        if (it + 1) % args.log_every == 0:
            last_loss = float(loss)
            n_act = num_active()
            dt = time.perf_counter() - t0
            say(
                f"[{it+1}/{args.iters}] loss {last_loss:.5f}  "
                f"active {n_act}  {(it + 1 - start_iter) / dt:.1f} it/s",
                flush=True,
            )
            if bool(ov_acc):  # render-pair overflow: entries were dropped
                grow_capacity()
                ov_acc = torch.zeros((), dtype=torch.bool, device=dev)
        if args.eval_every and (it + 1) % args.eval_every == 0:
            img = eval_render(views[0])
            s_val = float(ssim(torch.clamp(img, 0, 1), targets[0]))
            say(
                f"  eval view0 PSNR "
                f"{psnr(img.cpu().numpy(), data.targets[0]):.2f} dB  "
                f"SSIM {s_val:.4f}"
            )
        if ckpt and (it + 1) % args.ckpt_every == 0:
            _sync(dev)
            t1 = time.perf_counter()
            full_p, full_opt, full_d = whole()
            if rank == 0:
                ckpt.save(it + 1, (TrainState(full_p, state.step), full_opt,
                                   full_d))
            say(f"  checkpoint {it + 1} saved in "
                f"{time.perf_counter() - t1:.3f} s")

    if bool(ov_acc):
        grow_capacity()  # report the tail-interval overflow loudly
    if loss is not None:
        last_loss = float(loss)  # covers runs shorter than log_every

    # ---- export ---------------------------------------------------------
    full_p, _o, full_d = whole()
    img = eval_render(views[0])
    if rank != 0:
        return 0
    _sync(dev)
    t1 = time.perf_counter()
    with torch.no_grad():
        active = full_d.active
        packed = GaussianScene(*(x[active] for x in full_p.activate()))
        out_ply = os.path.join(args.out, f"{name}_trained.ply")
        save_ply(packed, out_ply)
    say(f"saved {packed.num_gaussians} gaussians to {out_ply} "
        f"({time.perf_counter() - t1:.3f} s)")

    final_psnr = psnr(img.cpu().numpy(), data.targets[0])
    final_ssim = float(ssim(torch.clamp(img, 0, 1), targets[0]))
    write_png(os.path.join(args.out, f"{name}_view0.png"), img,
              flip_vertical=False)
    write_png(os.path.join(args.out, f"{name}_view0_target.png"),
              data.targets[0], flip_vertical=False)
    say(
        f"final: loss {last_loss:.5f}, view0 PSNR {final_psnr:.2f} dB, "
        f"SSIM {final_ssim:.4f}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
