"""The sharded training step: view data-parallelism x gaussian and tile
sharding on a (data, gs) mesh (port of ``parallel/train_sharded.py``).

Layout, per rank (data d, gs g):

  * the parameters and their Adam moments: gs shard g (rows
    [g * P, (g + 1) * P) of the global gaussians), the same on every data
    rank;
  * the views: the step takes the whole view batch V and the band-padded
    targets (``pad_targets``); data rank d renders views
    [d * V / n_data, (d + 1) * V / n_data), gs rank g their band g;
  * forward and backward: ``render_sharded``'s exchange over the gs group;
    the photometric sums are all-reduced over the world for the loss; each
    data group's gradients (the gradient of the mean loss over its views)
    are averaged over the data group, which gives the gradient of the mean
    over all V views, and each rank's Adam steps its own shard;
  * the loss: the full 3DGS (1 - w) L1 + w D-SSIM. SSIM's 11x11 window
    crosses band seams, so each rank swaps a 5-row halo with its band
    neighbours (an all-to-all; the backward swaps the halo's gradient
    back) and blurs the extended band; the cropped SSIM map is the
    single-device map (a band at the image border sees the zero padding of
    the single-device convolution).

Densification of a sharded state (:func:`densify_sharded`) gathers the gs
shards, runs the single-device round on every rank with the same noise and
keeps the rank's rows.

Unlike the JAX package, whose psum transposes to a psum and leaves its
sharded gradients n_gs times the gradient of the mean loss (and the densify
statistics n_data * n_gs times the single-device ones), this step's
gradients and statistics are those of the single-device batched step
(``models/trainer.make_batched_train_step``); Adam's update does not see a
constant factor, so the parameters agree.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..config import RenderConfig
from ..models.densify import (
    DensifyConfig,
    DensifyState,
    densify_step,
    ndc_grad_norm,
)
from ..models.gaussians import GaussianParams
from ..models.losses import ssim_map
from ..models.trainer import TrainConfig, TrainState, make_optimizer, optimizer_step
from ..utils.camera import CameraView
from .render_sharded import (
    ShardedRenderConfig,
    _render_shard,
    _validate_sharded_cfg,
    band_layout,
    resolve_capacity,
)

#: SSIM window half-width: the rows of halo a band needs from a neighbour
_HALO = 5


def _axis(mesh, axis: str):
    """(process group, this rank's index, size) of a mesh axis."""
    return (mesh.get_group(axis), mesh.get_local_rank(axis),
            mesh.size(mesh.mesh_dim_names.index(axis)))


def _swap_with_neighbours(to_prev, to_next, group, rank: int, n: int):
    """Send ``to_prev`` to group rank - 1 and ``to_next`` to rank + 1;
    returns (from_prev, from_next), zeros where there is no neighbour. One
    all-to-all over the group (the exchange's collective: a halo is a few
    rows, and one collective type keeps every backend on the path)."""
    zeros = torch.zeros_like(to_prev)
    if n == 1:
        return zeros, zeros
    send = to_prev.new_zeros((n, 2) + tuple(to_prev.shape))
    if rank > 0:
        send[rank - 1, 0] = to_prev  # the previous rank's from_next
    if rank < n - 1:
        send[rank + 1, 1] = to_next  # the next rank's from_prev
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return (recv[rank - 1, 1] if rank > 0 else zeros,
            recv[rank + 1, 0] if rank < n - 1 else zeros)


class _BandHalos(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank, n, halo):
        ctx.args = (group, rank, n, halo)
        up, down = _swap_with_neighbours(x[:, :halo], x[:, -halo:], group,
                                         rank, n)
        return torch.cat([up, x, down], dim=1)

    @staticmethod
    def backward(ctx, d_ext):
        group, rank, n, halo = ctx.args
        d_x = d_ext[:, halo:-halo].clone()
        # the halo rows' gradients belong to the neighbours' edge rows
        d_first, d_last = _swap_with_neighbours(
            d_ext[:, :halo], d_ext[:, -halo:], group, rank, n)
        d_x[:, :halo] += d_first
        d_x[:, -halo:] += d_last
        return d_x, None, None, None, None


def exchange_band_halos(x, group, rank: int, n: int, halo: int = _HALO):
    """(C, band_h, W) -> (C, band_h + 2 halo, W): band g with the last
    ``halo`` rows of band g - 1 above and the first of band g + 1 below;
    the edge bands get zeros, the single-device convolution's padding.
    Differentiable: the backward returns the halo rows' gradients."""
    return _BandHalos.apply(x, group, rank, n, halo)


def _band_photometric_sums(band, target_band, rank: int, group, n_gs: int,
                           band_h: int, width: int, height: int):
    """(L1 sum, SSIM sum) of one band against its target band over the
    pixels inside the image; divided by 3 H W after the all-reduce they are
    the single-device means."""
    # one halo swap for prediction and target stacked on the channels
    ext = exchange_band_halos(torch.cat([band, target_band]), group, rank,
                              n_gs)
    smap = ssim_map(ext[:3], ext[3:])[:, _HALO:_HALO + band_h, :]
    dev = band.device
    rows = rank * band_h + torch.arange(band_h, device=dev)
    cols = torch.arange(band.shape[2], device=dev)
    mask = ((rows < height)[:, None] & (cols < width)[None, :]).to(
        torch.float32)[None]
    l1_sum = torch.sum(torch.abs(band - target_band) * mask)
    return l1_sum, torch.sum(smap * mask)


def make_sharded_train_step(opt: torch.optim.Adam, mesh, width: int,
                            height: int, cfg: RenderConfig = RenderConfig(),
                            scfg: ShardedRenderConfig = ShardedRenderConfig(),
                            sh_degree: int = 3,
                            tc: TrainConfig = TrainConfig(),
                            bg_color=(0.0, 0.0, 0.0),
                            data_axis: str = "data", gs_axis: str = "gs",
                            ewa_mode: str = "inria", densify: bool = False):
    """Build (step_fn, opt, pad_targets) for the (data, gs) mesh step.

    ``opt`` is the Adam that ``models/trainer.init_train_state`` made over
    this rank's parameter shard.

    step_fn(state, views, targets) -> (state, loss, overflow), or with
    ``densify=True`` step_fn(state, dstate, views, targets) -> (state,
    dstate, loss, overflow): ``views`` a CameraView stacked over all V views
    (V divisible by the data axis), ``targets`` (V, 3, H_pad, W_pad) from
    ``pad_targets``; ``dstate`` the rank's shard of the DensifyState, whose
    statistics accumulate as in the single-device batched step. ``loss``
    and ``overflow`` are the whole mesh's, the same on every rank.
    """
    data_group, d_rank, n_data = _axis(mesh, data_axis)
    gs_group, g_rank, n_gs = _axis(mesh, gs_axis)
    scfg = resolve_capacity(scfg, n_gs)
    _validate_sharded_cfg(cfg, scfg)
    lay = band_layout(width, height, cfg, n_gs)
    w = tc.ssim_weight

    def step(state: TrainState, dstate, views: CameraView, targets):
        params = state.params
        dev = params.means.device
        n_views = targets.shape[0]
        if n_views % n_data:
            raise ValueError(f"{n_views} views over {n_data} data ranks")
        v_loc = n_views // n_data
        p_shard = params.means.shape[0]
        bg = torch.as_tensor(bg_color, dtype=torch.float32, device=dev)
        rows = slice(g_rank * lay.band_h, (g_rank + 1) * lay.band_h)
        # a probe per view, as in the single-device batched step
        probe = (torch.zeros((v_loc, p_shard, 2), dtype=torch.float32,
                             device=dev, requires_grad=True)
                 if densify else None)
        probes = probe.unbind(0) if densify else None
        scene = params.activate()
        l1 = ss = 0.0
        radii, overflow = [], []
        for i in range(v_loc):
            v = d_rank * v_loc + i
            band, aux, r = _render_shard(
                scene.means, scene.scales, scene.quats, scene.opacities,
                scene.sh, CameraView(*(x[v] for x in views)), bg,
                group=gs_group, rank=g_rank, ndev=n_gs, p_shard=p_shard,
                layout=lay, width=width, height=height, sh_degree=sh_degree,
                cfg=cfg, scfg=scfg, ewa_mode=ewa_mode,
                active_mask=dstate.active if densify else None,
                means2d_probe=probes[i] if densify else None)
            l1_v, ss_v = _band_photometric_sums(
                band, targets[v, :, rows, :], g_rank, gs_group, n_gs,
                lay.band_h, width, height)
            l1, ss = l1 + l1_v, ss + ss_v
            radii.append(r)
            overflow.append(aux.overflow)
        # the data group's mean loss over its views, less the constant w
        denom = 3.0 * height * width
        local = ((1.0 - w) * l1 - w * ss) / (denom * v_loc)
        opt.zero_grad(set_to_none=True)
        local.backward()
        grads = [p.grad for p in params if p.grad is not None]
        if n_data > 1 and grads:
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=data_group)
            flat /= n_data
            for g, new in zip(grads, torch.split(flat, [g.numel()
                                                        for g in grads])):
                g.copy_(new.reshape(g.shape))
        optimizer_step(opt, tc, state.step)

        sums = torch.stack([l1.detach(), ss.detach()])
        dist.all_reduce(sums)  # the whole world: every band of every view
        loss = ((1.0 - w) * sums[0] / (denom * n_views)
                + w * (1.0 - sums[1] / (denom * n_views)))
        new_state = TrainState(params, state.step + 1)
        any_over = torch.stack(overflow).any().to(torch.int32).reshape(1)
        if not densify:
            if n_data > 1:
                dist.all_reduce(any_over, op=dist.ReduceOp.MAX,
                                group=data_group)
            return new_state, loss, any_over[0] > 0

        radii = torch.stack(radii)  # (v_loc, p_shard)
        visible = radii > 0
        # probe.grad[i] is view i's gradient / v_loc (the loss is the mean)
        g_norm = ndc_grad_norm(probe.grad * float(v_loc), width, height)
        add = torch.stack([
            torch.sum(torch.where(visible, g_norm, 0.0), dim=0),
            torch.sum(visible, dim=0).to(torch.float32)])
        top = torch.cat([torch.amax(radii, dim=0).to(torch.int32), any_over])
        if n_data > 1:
            dist.all_reduce(add, group=data_group)
            dist.all_reduce(top, op=dist.ReduceOp.MAX, group=data_group)
        dstate = DensifyState(
            grad_sum=dstate.grad_sum + add[0],
            count=dstate.count + add[1],
            max_radii=torch.maximum(dstate.max_radii, top[:-1]),
            active=dstate.active,
        )
        return new_state, dstate, loss, top[-1] > 0

    if densify:
        step_fn = step
    else:
        def step_fn(state, views, targets):
            return step(state, None, views, targets)

    def pad_targets(targets):
        """(V, 3, H, W) -> the band- and tile-aligned (V, 3, band_h * n_gs,
        w_pad), zeros outside the image."""
        out = targets.new_zeros((targets.shape[0], 3, lay.band_h * n_gs,
                                 lay.w_pad))
        out[:, :, :height, :width] = targets
        return out

    return step_fn, opt, pad_targets


def _gather_rows(x, group):
    """The rows of every rank of ``group``, in rank order."""
    n = dist.get_world_size(group)
    y = x.detach().contiguous()
    if x.dtype == torch.bool:  # gloo gathers no bool
        y = y.to(torch.uint8)
    parts = [torch.empty_like(y) for _ in range(n)]
    dist.all_gather(parts, y, group=group)
    return torch.cat(parts).to(x.dtype)


def gather_shards(params: GaussianParams, opt: torch.optim.Adam,
                  dstate: DensifyState | None, mesh, gs_axis: str = "gs"):
    """The whole state from the gs group's shards (a collective): (the
    parameters, an Adam over them holding the gathered moments, the
    DensifyState or None), every row of the global gaussians in order."""
    group = mesh.get_group(gs_axis)
    full = GaussianParams(*(_gather_rows(p, group) for p in params))
    full_opt = make_optimizer(full)
    by_name = {g["name"]: g["params"][0] for g in opt.param_groups}
    for g in full_opt.param_groups:
        st = opt.state.get(by_name[g["name"]], {})
        if st:
            full_opt.state[g["params"][0]] = {
                "step": st["step"].clone(),
                "exp_avg": _gather_rows(st["exp_avg"], group),
                "exp_avg_sq": _gather_rows(st["exp_avg_sq"], group),
            }
    full_d = (None if dstate is None
              else DensifyState(*(_gather_rows(x, group) for x in dstate)))
    return full, full_opt, full_d


def take_rows(params: GaussianParams, opt: torch.optim.Adam,
              full: GaussianParams, full_opt: torch.optim.Adam,
              full_d: DensifyState | None, mesh, gs_axis: str = "gs"):
    """The inverse of :func:`gather_shards`: this rank's rows of a whole
    state written into its parameter tensors and its Adam, in place.
    Returns its shard of ``full_d`` (or None)."""
    g_rank = mesh.get_local_rank(gs_axis)
    p_shard = params.means.shape[0]
    mine = slice(g_rank * p_shard, (g_rank + 1) * p_shard)
    by_name = {g["name"]: g["params"][0] for g in opt.param_groups}
    with torch.no_grad():
        for p, f in zip(params, full):
            p.copy_(f[mine])
            p.grad = None
        for g in full_opt.param_groups:
            st = full_opt.state.get(g["params"][0], {})
            if st:
                opt.state[by_name[g["name"]]] = {
                    "step": st["step"].clone(),
                    "exp_avg": st["exp_avg"][mine].clone(),
                    "exp_avg_sq": st["exp_avg_sq"][mine].clone(),
                }
    return (None if full_d is None
            else DensifyState(*(x[mine].clone() for x in full_d)))


def densify_sharded(params: GaussianParams, opt: torch.optim.Adam,
                    dstate: DensifyState, generator: torch.Generator,
                    scene_extent: float, cfg: DensifyConfig, mesh,
                    gs_axis: str = "gs"):
    """One densify round of a gs-sharded state: the shards of the
    parameters, of both Adam moments and of the DensifyState are gathered
    over the gs group, every rank runs ``models/densify.densify_step`` on
    the whole state with its own ``generator`` (seeded alike on every rank,
    so the split noise is the same), and keeps its rows. The round's global
    argsort and cumsum need the whole state; the result equals the
    single-device round by construction.

    Returns (params, opt, dstate, info) as ``densify_step`` does: the rank's
    parameter tensors and Adam moments rewritten in place with its rows of
    the round's, its shard of the new DensifyState and the round's
    counters.
    """
    full, full_opt, full_d = gather_shards(params, opt, dstate, mesh, gs_axis)
    full, full_opt, new_d, info = densify_step(full, full_opt, full_d,
                                               generator, scene_extent, cfg)
    dstate = take_rows(params, opt, full, full_opt, new_d, mesh, gs_axis)
    return params, opt, dstate, info
