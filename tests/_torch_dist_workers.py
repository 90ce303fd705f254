"""Rank functions of the port's multi-process tests (not collected: the name
does not match ``test_*``).

A test calls :func:`run`, which spawns ``world`` processes on the CPU, each
in a gloo process group started from a ``file://`` store in the test's
temporary directory (so concurrent test workers never share a port), runs
one of the functions below on every rank and returns what each rank
returned. The children import this module, which imports torch, numpy and
the port only: never jax, which the test modules load through
``conftest.py``.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from luisacomputegaussiansplatting_tpu_torch.config import RenderConfig
from luisacomputegaussiansplatting_tpu_torch.io.synthetic import random_scene
from luisacomputegaussiansplatting_tpu_torch.models.densify import (
    DensifyConfig,
    DensifyState,
    densify_round,
    init_densify_state,
)
from luisacomputegaussiansplatting_tpu_torch.models.gaussians import GaussianParams
from luisacomputegaussiansplatting_tpu_torch.models.trainer import init_train_state
from luisacomputegaussiansplatting_tpu_torch.parallel.mesh import make_mesh
from luisacomputegaussiansplatting_tpu_torch.parallel.render_sharded import (
    ShardedRenderConfig,
    band_layout,
    gather_image,
    render_sharded,
)
from luisacomputegaussiansplatting_tpu_torch.parallel.train_sharded import (
    densify_sharded,
    make_sharded_train_step,
)
from luisacomputegaussiansplatting_tpu_torch.utils.camera import CameraView, look_at_camera
from luisacomputegaussiansplatting_tpu_torch.utils.profiling import backward_events, scatter_ops


def _entry(rank, fn, world, init_file, out_dir, kwargs):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        result = fn(rank, world, **kwargs)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


class Ranks:
    """``world`` spawned gloo ranks running ``fn(rank, world, **kwargs)``;
    :meth:`results` waits for them (the caller may work meanwhile) and
    returns what each rank returned (picklable, numpy arrays)."""

    def __init__(self, fn, world: int, tmp_path, **kwargs):
        self.world = world
        self.out_dir = os.path.join(str(tmp_path), f"ranks_{fn.__name__}")
        os.makedirs(self.out_dir, exist_ok=True)
        init_file = os.path.join(self.out_dir, "store")
        self.context = mp.start_processes(
            _entry, args=(fn, world, init_file, self.out_dir, kwargs),
            nprocs=world, join=False, start_method="spawn")
        self._results = None

    def results(self):
        if self._results is None:
            while not self.context.join():  # raises if a rank failed
                pass
            self._results = []
            for r in range(self.world):
                path = os.path.join(self.out_dir, f"rank{r}.pkl")
                with open(path, "rb") as f:
                    self._results.append(pickle.load(f))
        return self._results


def run(fn, world: int, tmp_path, **kwargs):
    """Run ``fn(rank, world, **kwargs)`` on ``world`` spawned gloo ranks and
    return the list of their results."""
    return Ranks(fn, world, tmp_path, **kwargs).results()


def _np(x):
    return x.detach().cpu().numpy()


def _gather_rows(x, group=None):
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def camera(eye=(3.0, -2.5, 2.0), width=64, height=64, fov=70.0):
    return look_at_camera(eye, (0, 0, 0), (0, 0, 1), fov=fov, width=width,
                          height=height)


def profiled(fn):
    """``fn()`` under the profiler: (its result, the scatter ops of the
    backwards it ran, the autograd Functions those evaluated)."""
    with torch.profiler.profile(record_shapes=True) as prof:
        out = fn()
    functions = sorted({e.name.split(": ", 1)[1] for e in prof.events()
                        if e.name.startswith("autograd::engine::")})
    return out, scatter_ops(backward_events(prof)), functions


def render_cases(rank, world, cases):
    """Each case: a scene (n, seed, scale_range), camera (eye, width,
    height), RenderConfig and ShardedRenderConfig kwargs, background, and
    with ``wimg_seed`` the gradients of sum(image * w) for the five groups;
    with ``profile`` the scatter ops its backward ran. Rank 0's result
    holds the assembled image and the gathered gradients."""
    mesh = make_mesh((world,), ("gs",), device="cpu")
    out = []
    for case in cases:
        scene = random_scene(case["n"], seed=case["seed"],
                             scale_range=case.get("scale_range", (0.01, 0.15)),
                             device="cpu")
        p = scene.num_gaussians // world
        shard = [x[rank * p:(rank + 1) * p].clone() for x in scene.render_args()]
        cam = camera(width=case.get("width", 64), height=case.get("height", 64))
        cfg = RenderConfig(**case["cfg"])
        scfg = ShardedRenderConfig(**case["scfg"])
        res = {}
        grads = case.get("wimg_seed") is not None
        if grads:
            for x in shard:
                x.requires_grad_(True)
        band, aux = render_sharded(*shard, cam, mesh, cfg=cfg, scfg=scfg,
                                   bg_color=case.get("bg", (0.0, 0.0, 0.0)))
        res["image"] = _np(gather_image(band, mesh, cam.width, cam.height))
        res["overflow"] = bool(aux.overflow)
        res["num_rendered"] = int(aux.num_rendered)
        res["band_shape"] = tuple(band.shape)
        if grads:
            lay = band_layout(cam.width, cam.height, cfg, world)
            w = np.random.default_rng(case["wimg_seed"]).normal(
                size=(3, cam.height, cam.width)).astype(np.float32)
            wpad = torch.zeros((3, lay.band_h * world, lay.w_pad))
            wpad[:, :cam.height, :cam.width] = torch.from_numpy(w)
            wband = wpad[:, rank * lay.band_h:(rank + 1) * lay.band_h]
            loss = torch.sum(band * wband)
            if case.get("profile"):
                _, res["scatter_ops"], _ = profiled(loss.backward)
            else:
                loss.backward()
            res["grads"] = [_np(_gather_rows(x.grad)) for x in shard]
        out.append(res)
    return out


def _stack_views(cams, dev="cpu"):
    views = [c.to_view(dev) for c in cams]
    return CameraView(*(torch.stack(x) for x in zip(*views)))


def _start_params(case):
    """Raw parameters of the training cases: the scene's, moved away from
    the optimum where the case says so."""
    scene = random_scene(case["n"], seed=case["seed"], device="cpu")
    params = scene.to_params()
    if case.get("perturb_seed") is not None:
        rng = np.random.default_rng(case["perturb_seed"])
        params = params._replace(
            means=params.means + torch.from_numpy(
                rng.normal(0, 0.03, tuple(params.means.shape)).astype(np.float32)),
            opacity_logits=params.opacity_logits - 0.5)
    return params


def train_targets(case):
    """(V, 3, H, W) uniform targets of a training case, from its seed (made
    in each rank: a spawned rank's arguments stay small)."""
    return np.random.default_rng(case["target_seed"]).uniform(
        0, 1, (len(case["eyes"]), 3, case["height"], case["width"])
    ).astype(np.float32)


def train_cases(rank, world, cases):
    """Each case: a (data, gs) mesh shape, a scene, the views' eyes and
    the targets' seed, ``steps`` sharded steps with or without densify (and
    inactive rows where ``active_every`` says). Rank 0 returns the losses,
    overflows, the gathered parameters, Adam moments and densify
    statistics after the steps; with ``profile`` every rank returns the
    scatter ops of its first step's backward and the autograd Functions
    that backward evaluated."""
    out = []
    for case in cases:
        mesh = make_mesh(case["mesh"], ("data", "gs"), device="cpu")
        n_gs = case["mesh"][1]
        gs_group = mesh.get_group("gs")
        g = mesh.get_local_rank("gs")
        full = _start_params(case)
        p = full.means.shape[0] // n_gs
        mine = GaussianParams(*(x[g * p:(g + 1) * p] for x in full))
        state, opt = init_train_state(mine)
        w, h = case["width"], case["height"]
        cfg = RenderConfig(**case["cfg"])
        scfg = ShardedRenderConfig(**case["scfg"])
        densify = case.get("densify", False)
        step_fn, opt, pad_targets = make_sharded_train_step(
            opt, mesh, w, h, cfg=cfg, scfg=scfg, densify=densify)
        views = _stack_views([camera(e, w, h) for e in case["eyes"]])
        targets = pad_targets(torch.from_numpy(train_targets(case)))
        dstate = None
        if densify:
            n = full.means.shape[0]
            d_full = init_densify_state(n, n, device="cpu")
            every = case.get("active_every", 1)
            d_full = d_full._replace(active=torch.arange(n) % every == 0)
            dstate = DensifyState(*(x[g * p:(g + 1) * p] for x in d_full))
        losses, overflows, res = [], [], {}
        for i in range(case["steps"]):
            args = ((state, dstate, views, targets) if densify
                    else (state, views, targets))
            if i == 0 and case.get("profile"):
                got, res["scatter_ops"], res["functions"] = profiled(
                    lambda: step_fn(*args))
            else:
                got = step_fn(*args)
            if densify:
                state, dstate, loss, ov = got
            else:
                state, loss, ov = got
            losses.append(float(loss))
            overflows.append(bool(ov))
        res.update(losses=losses, overflows=overflows,
                   params=[_np(_gather_rows(x.detach(), gs_group))
                           for x in state.params],
                   exp_avg=[_np(_gather_rows(opt.state[x]["exp_avg"],
                                             gs_group))
                            for x in state.params])
        if densify:
            res["dstate"] = [_np(_gather_rows(x.to(torch.int32)
                                              if x.dtype == torch.bool else x,
                                              gs_group))
                             for x in dstate]
        out.append(res)
    return out


def densify_case(rank, world, n, cap, seed, noise_seed, extent, threshold):
    """One sharded densify round (1-D gs mesh over the world) from a state
    with accumulated statistics and Adam moments, against the
    single-device round on the same state and noise. Returns both."""
    mesh = make_mesh((world,), ("gs",), device="cpu")
    rng = np.random.default_rng(seed)
    full = GaussianParams(
        means=torch.from_numpy(rng.normal(0, 1, (cap, 3)).astype(np.float32)),
        log_scales=torch.from_numpy(
            np.log(rng.uniform(0.001, 0.05, (cap, 3))).astype(np.float32)),
        quats=torch.from_numpy(rng.normal(size=(cap, 4)).astype(np.float32)),
        opacity_logits=torch.from_numpy(
            rng.normal(0, 2, (cap,)).astype(np.float32)),
        sh_dc=torch.from_numpy(rng.normal(0, 1, (cap, 1, 3)).astype(np.float32)),
        sh_rest=torch.from_numpy(
            rng.normal(0, 0.1, (cap, 15, 3)).astype(np.float32)),
    )
    d_full = DensifyState(
        grad_sum=torch.from_numpy(rng.uniform(0, 2 * threshold, cap)
                                  .astype(np.float32)),
        count=torch.from_numpy(rng.integers(0, 3, cap).astype(np.float32)),
        max_radii=torch.from_numpy(rng.integers(0, 9, cap).astype(np.int32)),
        active=torch.arange(cap) < n,
    )
    grads = [torch.from_numpy(rng.normal(size=tuple(x.shape))
                              .astype(np.float32)) for x in full]
    cfg = DensifyConfig(grad_threshold=threshold)

    def adam_with_moments(params, rows):
        state, opt = init_train_state(params)
        for x, gr in zip(state.params, grads):
            x.grad = gr[rows].clone()
        opt.step()  # one step: moments in every row
        return state, opt

    # the single-device round on the whole state, with the noise the
    # sharded ranks draw from the same seed
    ref_state, ref_opt = adam_with_moments(full, slice(None))
    gen = torch.Generator().manual_seed(noise_seed)
    noise = torch.randn((cap, cfg.split_children, 3), generator=gen)
    ref_p, ref_opt, ref_d, ref_info = densify_round(
        ref_state.params, ref_opt, d_full, noise, extent, cfg)

    p = cap // world
    mine = slice(rank * p, (rank + 1) * p)
    state, opt = adam_with_moments(GaussianParams(*(x[mine] for x in full)),
                                   mine)
    dstate = DensifyState(*(x[mine] for x in d_full))
    gen = torch.Generator().manual_seed(noise_seed)
    params, opt, dstate, info = densify_sharded(
        state.params, opt, dstate, gen, extent, cfg, mesh)
    got = {
        "params": [_np(_gather_rows(x.detach())) for x in params],
        "moments": [_np(_gather_rows(opt.state[x][k]))
                    for x in params for k in ("exp_avg", "exp_avg_sq")],
        "dstate": [_np(_gather_rows(x.to(torch.int32)
                                    if x.dtype == torch.bool else x))
                   for x in dstate],
        "info": [int(x) for x in info],
    }
    want = {
        "params": [_np(x) for x in ref_p],
        "moments": [_np(ref_opt.state[x][k])
                    for x in ref_p for k in ("exp_avg", "exp_avg_sq")],
        "dstate": [_np(x.to(torch.int32) if x.dtype == torch.bool else x)
                   for x in ref_d],
        "info": [int(x) for x in ref_info],
    }
    return got, want


def cli_main(rank, world, module, argv):
    """``main(argv)`` of one of the port's apps on every rank (the process
    group already started, as ``torchrun`` would have it); returns its exit
    code. The argv's ``{rank}`` is replaced by the rank."""
    import contextlib
    import importlib
    import io

    mod = importlib.import_module(
        f"luisacomputegaussiansplatting_tpu_torch.apps.{module}")
    buf, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        code = mod.main([a.format(rank=rank) for a in argv])
    return {"code": code, "stdout": buf.getvalue(), "stderr": err.getvalue()}
