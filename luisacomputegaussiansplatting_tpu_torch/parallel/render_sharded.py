"""Sharded differentiable rendering: gaussians and tiles split over the ranks
of a process group (port of ``parallel/render_sharded.py``).

The reference has no distributed path (one Device and one Stream,
app/main.cpp:162-163). Each rank of the "gs" axis of a mesh runs this
module's code on its own shard of the gaussians:

  * SH colours, projection and the expansion (K1) on the rank's shard, over
    the tile grid padded to whole bands;
  * the frame's tile rows are split into bands, rank g owning rows
    [g * rows_per_dev, (g + 1) * rows_per_dev); the rank sorts its entries
    by tile alone, so the entries of each owner are one contiguous slice;
  * two all-to-alls over the group move the payload buckets and their
    (tile, global gid, depth) metadata to the owners;
  * the owner merges by (tile, depth, global gid), which is the
    single-device stable (tile, depth) order entry for entry, packs the
    ranges and blends its band with K2 at its first global tile
    (``tile_offset``).

Under autograd the backward blend (K3) runs on the band, the reverse
all-to-all returns each entry's gradient to the rank that owns its
gaussian, and the sorted segment-sum (K4) reduces it per gaussian
(``parallel/exchange_vjp.py``): each gaussian lives on one rank, so its
parameter gradients need no all-reduce.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.distributed as dist

from ..config import CHUNK, RenderConfig
from ..ops.binning import expand_entries_auto, pack_ranges, pack_slot_inverse
from ..ops.projection import project_gaussians, tile_grid
from ..ops.rasterize import rasterize_tiles
from ..ops.rasterize_ref import FIELDS
from ..ops.render import _selection_opacity, payload_table
from ..ops.sh_eval import compute_colors
from ..utils.camera import Camera, CameraView
from ..utils.profiling import span
from .exchange_vjp import (
    all_to_all,
    exchange_rows,
    pack_gather,
    permute_rows,
    slice_buckets,
    slice_rows,
    take_table_rows,
)

_INT32_MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class ShardedRenderConfig:
    """Static capacities of the exchange (all per rank)."""

    #: expansion capacity per rank (entries its gaussians emit).
    max_pairs_local: int = 1_000_000
    #: bucket capacity per (source, destination) rank pair. ``None``
    #: derives it from max_pairs_local (see derive_exchange_capacity).
    exchange_capacity: int | None = None
    #: skew headroom of the derivation: a bucket may hold up to
    #: ``skew * max_pairs_local / ndev`` entries before it overflows (the
    #: JAX package measured a (source, destination) skew <= 2.4 at up to 16
    #: devices on its 6M-gaussian scene). Overflow is flagged
    #: (ShardAux.overflow) and train_cli doubles both capacities on it.
    exchange_skew: float = 3.0


class ShardAux(NamedTuple):
    overflow: torch.Tensor  # () bool: a capacity was exceeded on any rank
    num_rendered: torch.Tensor  # () int32: entries over the group's ranks


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def derive_exchange_capacity(max_pairs_local: int, ndev: int,
                             skew: float = 3.0) -> int:
    """Bucket capacity such that a rank's exchange buffer holds
    ``skew * max_pairs_local`` rows: an even split of the tiles fills a
    bucket to max_pairs_local / ndev. Always a multiple of CHUNK, at least
    CHUNK."""
    even = -(-max_pairs_local // ndev)
    return max(_round_up(int(even * skew), CHUNK), CHUNK)


def _validate_sharded_cfg(cfg: RenderConfig, scfg: ShardedRenderConfig):
    """Reject configurations that would mis-render instead of failing."""
    if cfg.pack_mode not in ("chunk", "none"):
        raise ValueError(f"unknown pack_mode: {cfg.pack_mode!r}")
    if scfg.exchange_capacity % CHUNK:
        raise ValueError(
            f"exchange_capacity {scfg.exchange_capacity} must be a multiple "
            f"of CHUNK={CHUNK} (the rasterizer reads CHUNK-aligned slices)"
        )
    if cfg.rasterizer != "pallas":
        raise ValueError("the sharded path supports rasterizer='pallas' only")
    if cfg.max_pairs_sorted is not None:
        raise ValueError(
            "max_pairs_sorted is a single-chip option; sharded capacities "
            "are set via ShardedRenderConfig"
        )
    if cfg.sort_mode != "2key":
        raise ValueError(
            "sort_mode is a single-chip option: the sharded path already "
            "uses a 1-key unstable local sort + exact 3-key receiver merge "
            "(strictly cheaper than the fused single-chip key); pass the "
            "default '2key'"
        )
    if cfg.grad_reduce_method != "ride":
        raise ValueError(
            "grad_reduce_method is a single-chip option; the sharded "
            "backward reduces through its own exchange path — pass the "
            "default 'ride'"
        )


def resolve_capacity(scfg: ShardedRenderConfig,
                     ndev: int) -> ShardedRenderConfig:
    """``scfg`` with its exchange capacity derived where it is None."""
    if scfg.exchange_capacity is not None:
        return scfg
    return dataclasses.replace(scfg, exchange_capacity=derive_exchange_capacity(
        scfg.max_pairs_local, ndev, scfg.exchange_skew))


class BandLayout(NamedTuple):
    """How a frame's tile grid splits into the bands of ``ndev`` ranks."""

    grid_x: int
    grid_y: int
    rows_per_dev: int  # tile rows a band
    tiles_per_dev: int
    band_h: int  # pixel rows a band
    w_pad: int  # pixel columns of the tile grid


def band_layout(width: int, height: int, cfg: RenderConfig,
                ndev: int) -> BandLayout:
    grid_x, grid_y = tile_grid(width, height, cfg.tile_wh)
    rows = -(-grid_y // ndev)
    tw, th = cfg.tile_wh
    return BandLayout(grid_x, grid_y, rows, rows * grid_x, rows * th,
                      grid_x * tw)


def merge_order(ltile, depth, gid):
    """The permutation that sorts entries by (ltile, depth, gid): the JAX
    package's 3-key ``lax.sort``, built from two sorts. ``gid`` is unique
    among the entries whose order matters (a gaussian emits one entry a
    tile), so an unstable sort by gid, then a stable sort by the 64-bit
    (ltile << 32 | depth bits) key, orders ties of (ltile, depth) by gid.
    Depths are >= 0 or +inf, whose bit patterns order as their values."""
    by_gid = torch.sort(gid).indices
    dbits = depth.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    key = (ltile.to(torch.int64) << 32) | dbits
    return by_gid[torch.sort(key[by_gid], stable=True).indices]


def _buckets(pf, sorted_tile, sorted_gid, sorted_depth, *, rank: int,
             ndev: int, p_shard: int, tiles_per_dev: int, bcap: int):
    """The (ndev, bcap, 9) payload buckets by owner and their (ndev, bcap,
    3) metadata (tile, global gid, depth bits; empty slots -1, -1, +inf);
    and whether a bucket overflowed."""
    dev = pf.device
    bounds = torch.arange(ndev + 1, dtype=torch.int32, device=dev) \
        * tiles_per_dev
    cuts = torch.searchsorted(sorted_tile.to(torch.int32).contiguous(),
                              bounds, right=False, out_int32=True)
    gid_global = torch.where(sorted_gid >= 0, sorted_gid + rank * p_shard,
                             torch.full_like(sorted_gid, -1))
    meta = torch.stack([
        sorted_tile.to(torch.int32), gid_global.to(torch.int32),
        sorted_depth.contiguous().view(torch.int32),
    ], dim=1)
    empty = torch.tensor([-1, -1, 0x7F800000], dtype=torch.int32, device=dev)
    return (slice_buckets(pf, cuts, bcap), slice_rows(meta, cuts, bcap, empty),
            torch.any(cuts[1:] - cuts[:-1] > bcap))


def _merge(recv_pf, recv_meta, *, rank: int, tiles_per_dev: int):
    """The owner's merge of what it received: (entries in (local tile,
    depth, global gid) order, their local tiles (sentinel tiles_per_dev for
    empty slots))."""
    recv_gid = recv_meta[:, 1]
    invalid = recv_gid < 0
    ltile = torch.where(invalid, tiles_per_dev,
                        recv_meta[:, 0] - rank * tiles_per_dev)
    depth = torch.where(invalid, float("inf"),
                        recv_meta[:, 2].contiguous().view(torch.float32))
    perm = merge_order(ltile, depth, torch.where(invalid, _INT32_MAX,
                                                 recv_gid))
    return (permute_rows(recv_pf, perm),
            ltile[perm].to(torch.int32).contiguous())


def _pack(s_pf, s_ltile, *, pack_mode: str, tiles_per_dev: int,
          capacity: int):
    """(9, capacity') field-major payload and the tiles' ranges of the
    merged stream: CHUNK-packed ranges ("chunk"), or the ranges as they lie
    with a CHUNK tail of zeros ("none")."""
    if pack_mode == "chunk":
        cap_loc = _round_up(capacity + tiles_per_dev * CHUNK, CHUNK)
        src, in_range, _slot_tile, starts, counts = pack_ranges(
            s_ltile, tiles_per_dev, cap_loc)
        slot_of_entry = pack_slot_inverse(s_ltile, starts, tiles_per_dev,
                                          cap_loc)
        cols = pack_gather(s_pf, src, in_range, slot_of_entry)
    else:
        tids = torch.arange(tiles_per_dev, dtype=torch.int32,
                            device=s_pf.device)
        starts = torch.searchsorted(s_ltile, tids, right=False,
                                    out_int32=True)
        counts = torch.searchsorted(s_ltile, tids, right=True,
                                    out_int32=True) - starts
        cols = torch.cat([s_pf, s_pf.new_zeros((CHUNK, FIELDS))])
    return cols.t().contiguous(), starts, counts


def _render_shard(means3d, scales, quats, opacities, sh_coeffs,
                  cam_view: CameraView, bg, *, group, rank: int, ndev: int,
                  p_shard: int, layout: BandLayout, width: int, height: int,
                  sh_degree: int, cfg: RenderConfig,
                  scfg: ShardedRenderConfig, ewa_mode: str = "inria",
                  active_mask=None, means2d_probe=None):
    """One rank's part of a sharded frame: its gaussian shard in, its band
    out. Returns (band (3, band_h, w_pad) with the background, ShardAux,
    radii (p_shard,)); ``active_mask`` and ``means2d_probe`` are the
    training hooks of ``ops/projection.project_gaussians``. The stages are
    ranges named ``render_sharded.<stage>`` while a profiler records
    (``utils/profiling.span``)."""
    tiles_per_dev = layout.tiles_per_dev
    l_loc, bcap = scfg.max_pairs_local, scfg.exchange_capacity

    with span("render_sharded.local"):
        colors = compute_colors(means3d, sh_coeffs, cam_view.position,
                                sh_degree)
        proj = project_gaussians(
            means3d, scales, quats, cam_view, cfg, ewa_mode=ewa_mode,
            width=width, height=height, active_mask=active_mask,
            means2d_probe=means2d_probe,
            opacities=_selection_opacity(opacities, cfg) if cfg.tight_radius
            else None,
        )
        cull_op = _selection_opacity(opacities, cfg) if cfg.tile_cull \
            else None
        tile_id, depth, gid, total = expand_entries_auto(
            proj, layout.grid_x, tiles_per_dev * ndev, l_loc, cull_op,
            cfg.tile_wh, cfg.alpha_min, cfg.expansion,
        )
        # by tile only: the owner (tile // tiles_per_dev) is monotone in
        # the tile, so each owner's entries are one contiguous slice; the
        # merge restores the full order, so no stable or depth-keyed sort
        sorted_tile, order = torch.sort(tile_id, stable=False)
        sorted_gid = gid[order]
        table = payload_table(proj, colors, opacities)  # (p_shard, 9)
        pf = take_table_rows(table, sorted_gid, cfg.grad_reduce_dtype)
    with span("render_sharded.bucket"):
        # the blend order is not differentiated
        send_pf, send_meta, over = _buckets(
            pf, sorted_tile, sorted_gid, depth[order].detach(), rank=rank,
            ndev=ndev, p_shard=p_shard, tiles_per_dev=tiles_per_dev,
            bcap=bcap)
    with span("render_sharded.all_to_all"):
        recv_pf = exchange_rows(send_pf, group, cfg.payload_dtype,
                                cfg.grad_reduce_dtype)
        recv_meta = all_to_all(send_meta, group)
    with span("render_sharded.merge"):
        s_pf, s_ltile = _merge(recv_pf.reshape(ndev * bcap, FIELDS),
                               recv_meta.reshape(ndev * bcap, 3), rank=rank,
                               tiles_per_dev=tiles_per_dev)
    with span("render_sharded.pack"):
        payload, starts, counts = _pack(
            s_pf, s_ltile, pack_mode=cfg.pack_mode,
            tiles_per_dev=tiles_per_dev, capacity=ndev * bcap)
    with span("render_sharded.blend"):
        color, trans = rasterize_tiles(payload, starts, counts, layout.grid_x,
                                       width, height, cfg,
                                       tile_offset=rank * tiles_per_dev)
        tw, th = cfg.tile_wh
        rows, gx = layout.rows_per_dev, layout.grid_x
        c = color.reshape(rows, gx, th, tw, 3).permute(4, 0, 2, 1, 3)
        c = c.reshape(3, layout.band_h, layout.w_pad)
        t = trans.reshape(rows, gx, th, tw).permute(0, 2, 1, 3)
        t = t.reshape(layout.band_h, layout.w_pad)
        band = c + bg[:, None, None] * t[None]

    sums = torch.stack([torch.clamp(total, max=l_loc).to(torch.int64),
                        ((total > l_loc) | over).to(torch.int64)])
    dist.all_reduce(sums, group=group)
    aux = ShardAux(overflow=sums[1] > 0, num_rendered=sums[0].to(torch.int32))
    return band, aux, proj.radius


def render_sharded(means3d, scales, quats_xyzw, opacities, sh_coeffs,
                   camera: "Camera | CameraView", mesh, axis: str = "gs",
                   width: int | None = None, height: int | None = None,
                   bg_color=(0.0, 0.0, 0.0),
                   cfg: RenderConfig = RenderConfig(),
                   scfg: ShardedRenderConfig = ShardedRenderConfig(),
                   sh_degree: int = 3, ewa_mode: str = "inria"):
    """Render one view with the gaussians and the tiles split over the
    ``axis`` ranks of ``mesh`` (``parallel/mesh.make_mesh``). Every rank of
    the axis calls it with its own shard of the activated gaussians (the
    same number of rows on every rank: pad with ``GaussianScene.pad_to``);
    rank g's shard holds the global gaussians [g * P, (g + 1) * P).

    Supports every RenderConfig the single-device path does (tile 16/32,
    pack_mode chunk/none, tile_cull, tight_radius, bf16 payload and
    gradient reduction, blend_quad vpu/mxu) apart from the single-device
    options ``_validate_sharded_cfg`` rejects.

    Returns (band (3, band_h, w_pad), ShardAux): the rank's band of tile
    rows, background included; :func:`gather_image` assembles the frame.
    """
    if isinstance(camera, Camera):
        width, height = camera.width, camera.height
        camera = camera.to_view(means3d.device)
    group = mesh.get_group(axis)
    ndev = mesh.size(mesh.mesh_dim_names.index(axis))
    rank = mesh.get_local_rank(axis)
    scfg = resolve_capacity(scfg, ndev)
    _validate_sharded_cfg(cfg, scfg)
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=means3d.device)
    band, aux, _radii = _render_shard(
        means3d, scales, quats_xyzw, opacities, sh_coeffs, camera, bg,
        group=group, rank=rank, ndev=ndev, p_shard=means3d.shape[0],
        layout=band_layout(width, height, cfg, ndev), width=width,
        height=height, sh_degree=sh_degree, cfg=cfg, scfg=scfg,
        ewa_mode=ewa_mode)
    return band, aux


def gather_image(band, mesh, width: int, height: int, axis: str = "gs"):
    """The whole (3, H, W) frame on every rank of ``axis``: the bands of
    :func:`render_sharded` all-gathered in rank order and cropped (not
    differentiable)."""
    group = mesh.get_group(axis)
    bands = [torch.empty_like(band) for _ in range(dist.get_world_size(group))]
    dist.all_gather(bands, band.detach().contiguous(), group=group)
    return torch.cat(bands, dim=1)[:, :height, :width]
