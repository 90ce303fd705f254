"""Real-scene end-to-end proof (port of the JAX package's
``scripts/real_scene_proof.py``): the closest achievable analog of
rendering the reference's released scenes, which are not available here
(reference README.md:25-29 release downloads).

Pipeline (every stage runs the port's user-facing surfaces):

  1. gen    — build a detailed procedural gaussian scene (the "ground
              truth" model), export it through ``io/ply.py`` (graphdeco
              PLY), reload it with the native loader, and check that the
              PLY round trip renders alike at the reference app resolution
              1600x1063 (app/main.cpp:38). Then render a NeRF-blender
              dataset from it at 800x800 (the lego resolution):
              transforms_train.json + PNGs, read back by
              ``io.dataset.load_nerf_synthetic``.
  2. train  — run the port's training CLI on that dataset
              (``apps/train_cli.py --nerf-synthetic``).
  3. eval   — load the trained PLY, render held-out poses at 1600x1063
              and score PSNR/SSIM against the ground-truth renders.
  4. parity — render the trained PLY through the port's render CLI at
              the strict-parity settings, once on ``--device`` and once
              on the CPU, and compare the two float frames.

Usage:
  python -m luisacomputegaussiansplatting_tpu_torch.scripts.real_scene_proof \\
      {gen,train,eval,parity} [--root DIR] [--quick] [--device cpu]

Same stages, flags and report keys as the JAX script, except ``--device``
(default ``cuda``; fails if no GPU is present) in place of ``--platform``.
``--quick`` sets the small sizes only; it does not move the run to the
CPU (pass ``--device cpu`` for that). Results land in
``<root>/proof_report.json``, one entry per stage; the paths in it are
relative to ``<root>``.
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
import shlex
import subprocess
import sys
import tempfile

import numpy as np
import torch

from ..config import RenderConfig
from ..io.dataset import load_nerf_synthetic
from ..io.ply import load_ply, save_ply
from ..models.gaussians import GaussianScene, from_numpy
from ..models.losses import psnr, ssim
from ..ops.render import render_view
from ..utils.camera import look_at_camera
from ..utils.device import resolve_device
from ..utils.sh import sh_from_color

REF_W, REF_H = 1600, 1063  # reference app default (app/main.cpp:38)
DATA_RES = 800  # NeRF-blender lego resolution
FOV_Y = 50.0
N_TRAIN, N_EVAL = 40, 4
# the repository root: the render CLI runs from there as a module
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def make_gt_scene(quick=False, device="cuda") -> GaussianScene:
    """Detailed procedural model: a bumpy sphere, a torus, a checkered
    ground disc — tens of thousands of crisp view-dependent gaussians, on
    ``device``. The draws are the JAX script's, in its order."""
    rng = np.random.default_rng(7)
    k = 0.12 if quick else 1.0
    pts, cols, scl = [], [], []

    # bumpy sphere (radius modulated by spherical harmonics-ish ripples)
    n = int(24000 * k)
    u, v = rng.uniform(0, 2 * np.pi, n), np.arccos(rng.uniform(-1, 1, n))
    r = 0.9 + 0.08 * np.sin(6 * u) * np.sin(5 * v)
    sp = np.stack(
        [r * np.sin(v) * np.cos(u), r * np.sin(v) * np.sin(u), r * np.cos(v)],
        axis=1,
    ) + np.array([0.0, 0.0, 0.9])
    pts.append(sp)
    cols.append(
        np.stack(
            [0.5 + 0.5 * np.sin(3 * u), 0.5 + 0.5 * np.cos(4 * v),
             0.6 + 0.4 * np.sin(u + v)], axis=1,
        )
    )
    scl.append(np.full((n, 3), 0.035))

    # torus
    n = int(20000 * k)
    u, v = rng.uniform(0, 2 * np.pi, n), rng.uniform(0, 2 * np.pi, n)
    R, rr = 1.7, 0.35
    tor = np.stack(
        [(R + rr * np.cos(v)) * np.cos(u), (R + rr * np.cos(v)) * np.sin(u),
         rr * np.sin(v) + 0.45], axis=1,
    )
    pts.append(tor)
    cols.append(
        np.stack(
            [0.8 + 0.2 * np.cos(7 * u), 0.3 + 0.2 * np.sin(9 * v),
             0.25 + 0.1 * np.cos(u)], axis=1,
        )
    )
    scl.append(np.full((n, 3), 0.03))

    # checkered ground disc
    n = int(26000 * k)
    rad = 3.2 * np.sqrt(rng.uniform(0, 1, n))
    th = rng.uniform(0, 2 * np.pi, n)
    gnd = np.stack([rad * np.cos(th), rad * np.sin(th), np.zeros(n)], axis=1)
    checker = ((np.floor(gnd[:, 0] / 0.4) + np.floor(gnd[:, 1] / 0.4)) % 2)
    pts.append(gnd)
    cols.append(
        np.stack([0.15 + 0.7 * checker, 0.15 + 0.7 * checker,
                  0.2 + 0.6 * checker], axis=1)
    )
    gs = np.full((n, 3), 0.05)
    gs[:, 2] = 0.01  # flat
    scl.append(gs)

    means = np.concatenate(pts).astype(np.float32)
    base = np.clip(np.concatenate(cols), 0.0, 1.0).astype(np.float32)
    scales = np.concatenate(scl).astype(np.float32)
    m = means.shape[0]
    quats = rng.normal(size=(m, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    opac = rng.uniform(0.75, 0.98, m).astype(np.float32)

    sh = np.zeros((m, 16, 3), np.float32)
    sh[:, 0, :] = sh_from_color(base)
    # mild view dependence on the degree-1 bands
    sh[:, 1:4, :] = rng.normal(0, 0.06, (m, 3, 3)).astype(np.float32)
    return from_numpy(means, scales, quats, opac, sh, device)


def camera_ring(n, height=1.6, radius=4.2, width=DATA_RES, height_px=None,
                phase=0.0):
    """Cameras on a ring looking at the scene centre, plus their NeRF
    camera-to-world matrices (OpenGL: x right, y up, z backward; float64).
    ``phase`` rotates the ring's azimuths (the interp rig interleaves its
    middle ring between the eval azimuths)."""
    height_px = height_px or width
    cams, c2ws = [], []
    for i in range(n):
        a = 2 * np.pi * i / n + phase
        pos = np.array([radius * np.cos(a), radius * np.sin(a), height])
        cam = look_at_camera(
            tuple(pos), (0.0, 0.0, 0.5), (0.0, 0.0, 1.0),
            fov=FOV_Y, width=width, height=height_px,
        )
        c2w = np.eye(4)
        c2w[:3, 0] = np.asarray(cam.right, np.float64)
        c2w[:3, 1] = np.asarray(cam.up, np.float64)
        c2w[:3, 2] = -np.asarray(cam.front, np.float64)
        c2w[:3, 3] = pos
        cams.append(cam)
        c2ws.append(c2w)
    return cams, c2ws


def render_batch(scene, cams, cfg):
    """Each camera's (3, H, W) float32 render as numpy, on the scene's
    device."""
    dev = scene.means.device
    w, h = cams[0].width, cams[0].height
    out = []
    with torch.no_grad():
        for c in cams:
            img, _ = render_view(*scene.render_args(), c.to_view(dev), w, h,
                                 cfg=cfg)
            out.append(img.cpu().numpy())
            print(".", end="", file=sys.stderr, flush=True)
    print("", file=sys.stderr)
    return out


def save_png(img_chw, path):
    """Write a (3, H, W) float image as an 8-bit PNG, rows flipped and
    rounded (``utils/image.write_png`` truncates; the dataset's targets
    keep the JAX script's rounding)."""
    from PIL import Image

    # renderer rows are bottom-up; PNG rows top-down (reference flip,
    # app/main.cpp:322-337)
    arr = np.clip(np.transpose(img_chw, (1, 2, 0))[::-1], 0, 1)
    Image.fromarray((arr * 255 + 0.5).astype(np.uint8)).save(path)


def stage_gen(root, quick, device="cuda", views=None, dres=None,
              rig="interp"):
    dev = resolve_device(device)
    os.makedirs(os.path.join(root, "train"), exist_ok=True)
    scene = make_gt_scene(quick, dev)
    print(f"gt scene: {scene.num_gaussians} gaussians", file=sys.stderr)
    save_ply(scene, os.path.join(root, "gt.ply"))
    reloaded = load_ply(os.path.join(root, "gt.ply"), device=dev)

    # --- PLY round-trip render check at the reference resolution -------
    res_w, res_h = (400, 266) if quick else (REF_W, REF_H)
    cfg_ref = RenderConfig(max_pairs=300_000 if quick else 6_000_000)
    eval_cams, _ = camera_ring(
        N_EVAL, height=2.2, radius=4.6, width=res_w, height_px=res_h
    )
    gt_imgs = render_batch(scene, eval_cams, cfg_ref)
    rt_imgs = render_batch(reloaded, eval_cams, cfg_ref)
    mad = float(np.mean([np.abs(a - b).max()
                         for a, b in zip(gt_imgs, rt_imgs)]))
    print(f"PLY round-trip render MAD @ {res_w}x{res_h}: {mad:.3e}",
          file=sys.stderr)
    for i, img in enumerate(gt_imgs):
        np.save(os.path.join(root, f"gt_eval_{i}.npy"),
                img.astype(np.float16))
        save_png(img, os.path.join(root, f"gt_eval_{i}.png"))

    # --- NeRF-blender dataset ------------------------------------------
    # rig="bracket": two rings bracketing the eval ring's height (2.2) but
    # not its radius (4.6 > both), so eval poses extrapolate and cap the
    # held-out PSNR whatever the trainer does. rig="interp" (default):
    # three rings, the middle one at the eval ring's height and radius
    # with its azimuths offset by half a camera spacing, so every eval
    # pose interpolates its neighbours in azimuth and sits inside the
    # rig's height/radius hull: the score measures the trainer.
    dres = dres or (200 if quick else DATA_RES)
    cfg_data = RenderConfig(max_pairs=200_000 if quick else 4_000_000)
    n_views = views or (N_TRAIN if not quick else 6)
    if rig == "bracket":
        cams_lo, c2w_lo = camera_ring(
            -(-n_views // 2), height=1.4, radius=4.2, width=dres
        )
        cams_hi, c2w_hi = camera_ring(
            n_views // 2, height=2.8, radius=4.4, width=dres
        )
        cams = cams_lo + cams_hi
        c2ws = c2w_lo + c2w_hi
    else:
        n_mid = n_views // 3
        n_lo = -(-(n_views - n_mid) // 2)
        n_hi = n_views - n_mid - n_lo
        cams_lo, c2w_lo = camera_ring(
            n_lo, height=1.4, radius=4.2, width=dres
        )
        # phase = 0.5 rad: 0.5/pi is irrational, so no training azimuth
        # 2*pi*i/n + 0.5 can equal an eval azimuth k*pi/2, and no eval
        # pose coincides with a training pose
        cams_mid, c2w_mid = camera_ring(
            n_mid, height=2.2, radius=4.6, width=dres, phase=0.5,
        )
        cams_hi, c2w_hi = camera_ring(
            n_hi, height=2.8, radius=4.4, width=dres
        )
        cams = cams_lo + cams_mid + cams_hi
        c2ws = c2w_lo + c2w_mid + c2w_hi
    imgs = render_batch(scene, cams, cfg_data)
    frames = []
    for i, (img, c2w) in enumerate(zip(imgs, c2ws)):
        save_png(img, os.path.join(root, "train", f"r_{i}.png"))
        frames.append(
            {"file_path": f"train/r_{i}", "transform_matrix": c2w.tolist()}
        )
    fov_x = 2 * math.atan(math.tan(math.radians(FOV_Y) / 2))  # square
    with open(os.path.join(root, "transforms_train.json"), "w") as f:
        json.dump({"camera_angle_x": fov_x, "frames": frames}, f)

    # loader round trip: poses and pixels survive the format
    ds = load_nerf_synthetic(root, max_views=1)
    cam0 = ds.cameras[0]
    if not np.allclose(cam0.front, cams[0].front, atol=1e-6):
        raise RuntimeError("pose mismatch")
    pix_err = float(np.abs(ds.targets[0] - imgs[0]).max())
    if not pix_err < 1.5 / 255.0:
        raise RuntimeError(f"pixel round-trip error {pix_err}")
    report(root, "gen", {
        "gt_gaussians": int(scene.num_gaussians),
        "ply_roundtrip_render_mad": mad,
        "dataset_views": len(frames),
        "dataset_res": dres,
        "eval_res": [res_w, res_h],
        "png_roundtrip_err": pix_err,
        "rig": rig,
    })
    print("gen ok", file=sys.stderr)


def stage_train(root, quick, device="cuda", iters=None, capacity=None,
                init_points=None, densify_interval=None, extra=()):
    """The port's train CLI on the dataset, with the JAX script's argv
    (``--device`` in place of ``--platform``)."""
    from ..apps.train_cli import main as train_main

    argv = [
        "--nerf-synthetic", root,
        "--iters", str(iters or (300 if quick else 4000)),
        "--capacity", str(capacity or (20000 if quick else 200000)),
        "--init-points", str(init_points or (4000 if quick else 30000)),
        "--max-pairs", "300000" if quick else "4000000",
        "--tile", "32", "--pack", "none",
        "--densify-interval", str(densify_interval or 150),
        "--sh-upgrade-every", "100" if quick else "1000",
        "--views-per-step", "2",
        "--out", os.path.join(root, "fit"),
        "--log-every", "50",
        "--device", str(device),
        *extra,
    ]
    rc = train_main(argv)
    if rc:
        raise RuntimeError(f"train_cli returned {rc}")
    report(root, "train", {"train_argv": argv})


def _trained_ply(root):
    plys = sorted(glob.glob(os.path.join(root, "fit", "*.ply")))
    return plys[-1] if plys else None


def stage_eval(root, quick, device="cuda"):
    dev = resolve_device(device)
    ply = _trained_ply(root)
    if ply is None:
        raise FileNotFoundError(f"no trained PLY under {root}/fit")
    trained = load_ply(ply, device=dev)
    print(f"trained model: {trained.num_gaussians} gaussians ({ply})",
          file=sys.stderr)

    with open(os.path.join(root, "proof_report.json")) as f:
        res_w, res_h = json.load(f)["gen"]["eval_res"]
    cfg = RenderConfig(max_pairs=300_000 if quick else 6_000_000)
    eval_cams, _ = camera_ring(
        N_EVAL, height=2.2, radius=4.6, width=res_w, height_px=res_h
    )
    imgs = render_batch(trained, eval_cams, cfg)
    ps, ss = [], []
    # SSIM's convolutions at full float32, as the JAX package computes them
    # (cuDNN would take TF32)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for i, img in enumerate(imgs):
            gt = np.load(os.path.join(root, f"gt_eval_{i}.npy"))
            a = torch.from_numpy(img).to(dev)
            b = torch.from_numpy(gt.astype(np.float32)).to(dev)
            ps.append(float(psnr(a, b)))
            ss.append(float(ssim(a, b)))
            save_png(img, os.path.join(root, f"trained_eval_{i}.png"))
    print(f"eval @ {res_w}x{res_h}: PSNR {np.mean(ps):.2f} dB "
          f"(per-view {['%.1f' % p for p in ps]}), SSIM {np.mean(ss):.4f}",
          file=sys.stderr)
    report(root, "eval", {
        "trained_gaussians": int(trained.num_gaussians),
        "psnr_mean": float(np.mean(ps)), "psnr_per_view": ps,
        "ssim_mean": float(np.mean(ss)),
    })


def stage_parity(root, quick, device="cuda"):
    """Strict-parity full-resolution render of the trained model through
    the port's render CLI (the user-facing path): tile 16, 2-key sort, f32
    payload, chunk pack, ``--ewa lcgs`` at the reference app's 1600x1063
    (app/main.cpp:38), once on ``device`` ("dev") and once on the CPU
    ("cpu"), each in its own process; the two float frames are compared."""
    ply = _trained_ply(root) or os.path.join(root, "gt.ply")
    res = "400x266" if quick else f"{REF_W}x{REF_H}"
    # one eval-ring pose (camera_ring(height=2.2, radius=4.6), i = 0)
    base = [
        sys.executable, "-u", "-m",
        "luisacomputegaussiansplatting_tpu_torch.apps.render_cli",
        "--ply", ply, "--res", res, "--world", "blender",
        "--cam-pos", "4.6,0,2.2", "--cam-target", "0,0,0.5",
        "--fov", str(FOV_Y), "--tile", "16", "--sort", "2key",
        "--payload", "f32", "--pack", "chunk", "--ewa", "lcgs",
        "--max-pairs", "300000" if quick else "6000000",
        "--exp_N", "3", "--out", os.path.join(root, "parity"),
    ]
    outs = {}
    for key, dev in (("dev", str(device)), ("cpu", "cpu")):
        raw = os.path.join(root, f"parity_{key}.npy")
        argv = base + ["--save-raw", raw, "--device", dev]
        r = subprocess.run(argv, capture_output=True, text=True, cwd=_REPO)
        print(r.stdout + r.stderr[-500:], file=sys.stderr)
        if r.returncode != 0:
            raise RuntimeError(f"render_cli failed on {dev}")
        lines = r.stdout.splitlines()
        fps = [ln for ln in lines if "fps:" in ln]
        # rep_ms: each repetition timed on its own, synchronised (printed
        # for exp_N > 1)
        reps = [ln for ln in lines if ln.startswith("rep_ms:")]
        rendered = [int(ln.split()[1]) for ln in lines
                    if ln.startswith("num_rendered:")]
        outs[key] = {"raw": raw, "fps_line": fps[-1] if fps else "",
                     "rep_ms": reps[-1] if reps else "",
                     "num_rendered": rendered[-1]}
    a = np.load(outs["dev"]["raw"])
    b = np.load(outs["cpu"]["raw"])
    mad = float(np.abs(a - b).max())
    mean_ad = float(np.abs(a - b).mean())
    print(f"parity {device}-vs-cpu @ {res}: max|diff|={mad:.3e} "
          f"mean={mean_ad:.3e}", file=sys.stderr)
    report(root, "parity", {
        "ply": ply, "res": res,
        **{k: v["fps_line"] for k, v in outs.items()},
        **{f"{k}_rep_ms": v["rep_ms"] for k, v in outs.items()},
        **{f"{k}_num_rendered": v["num_rendered"] for k, v in outs.items()},
        "max_abs_diff": mad, "mean_abs_diff": mean_ad,
    })


def _root_relative(x, root):
    """``x`` (a string, or a list or dict of them) with every path under
    ``root`` made relative to it, so a report moves with its directory."""
    if isinstance(x, dict):
        return {k: _root_relative(v, root) for k, v in x.items()}
    if isinstance(x, list):
        return [_root_relative(v, root) for v in x]
    if isinstance(x, str) and (x == root or x.startswith(root + os.sep)):
        return os.path.relpath(x, root)
    return x


def report(root, stage, data):
    path = os.path.join(root, "proof_report.json")
    rep = {}
    if os.path.exists(path):
        with open(path) as f:
            rep = json.load(f)
    rep[stage] = _root_relative(data, root)
    with open(path, "w") as f:
        json.dump(rep, f, indent=1)


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("stage", choices=["gen", "train", "eval", "parity"])
    ap.add_argument("--root",
                    default=os.path.join(tempfile.gettempdir(), "proofscene"))
    ap.add_argument("--quick", action="store_true",
                    help="small sizes (the device stays --device's)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cuda:1, cpu)")
    # per-stage overrides of the quick/full presets
    ap.add_argument("--views", type=int, default=None)
    ap.add_argument("--data-res", type=int, default=None)
    ap.add_argument("--rig", choices=["interp", "bracket"], default="interp",
                    help="training-pose rig: interp (eval poses inside the "
                         "hull) or bracket (two rings, eval poses outside)")
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--capacity", type=int, default=None)
    ap.add_argument("--init-points", type=int, default=None)
    ap.add_argument("--densify-interval", type=int, default=None)
    ap.add_argument("--train-extra", default="",
                    help="extra args appended to the train CLI "
                         "(one shell-quoted string, e.g. "
                         "'--ckpt-every 250 --resume')")
    return ap


def main(argv=None):
    a = build_parser().parse_args(argv)
    # absolute: the parity stage's render CLI runs from the repository root
    a.root = os.path.abspath(a.root)
    if a.stage == "gen":
        stage_gen(a.root, a.quick, a.device, views=a.views, dres=a.data_res,
                  rig=a.rig)
    elif a.stage == "train":
        stage_train(a.root, a.quick, a.device, iters=a.iters,
                    capacity=a.capacity, init_points=a.init_points,
                    densify_interval=a.densify_interval,
                    extra=tuple(shlex.split(a.train_extra)))
    elif a.stage == "parity":
        stage_parity(a.root, a.quick, a.device)
    else:
        stage_eval(a.root, a.quick, a.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
