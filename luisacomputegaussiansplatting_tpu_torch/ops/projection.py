"""Gaussian preprocessing: world -> screen, conic, tile rects (port of
``ops/projection.py``).

One plain differentiable torch stage covering the reference's GSProjector
forward (lcgs/src/gs_projector/shader.cpp:82-139) and the analytic half of
shad_allocate_tiles (lcgs/src/gs_tile_splatter/shader.cpp:102-163).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import TILE, RenderConfig
from ..utils.camera import Camera, CameraView
from ..utils.gaussian import (
    clamp_to_frustum_comps,
    conic_and_radius_comps,
    covariance_3d_elems,
    ewa_project_cov_comps,
    view_rotate_cov_elems,
)
from ..utils.packing import stack_cols, unstack_cols
from ..utils.transform import ndc2pix


class ProjectedGaussians(NamedTuple):
    """Per-gaussian screen-space quantities (all shape (N, ...))."""

    means2d: torch.Tensor  # (N, 2) float32 pixel-space centres
    depth: torch.Tensor  # (N,) float32 view-space z
    conic: torch.Tensor  # (N, 3) float32 inverse 2D covariance (A, B, C)
    radius: torch.Tensor  # (N,) int32 splat radius in pixels (0 = culled)
    rect_min: torch.Tensor  # (N, 2) int32 inclusive tile-rect min (x, y)
    rect_max: torch.Tensor  # (N, 2) int32 exclusive tile-rect max (x, y)
    tiles_touched: torch.Tensor  # (N,) int32 tiles overlapped
    valid: torch.Tensor  # (N,) bool: survives the near cull, touches tiles


def _tile_wh(tile) -> tuple:
    """Normalise an int (square) or (w, h) tile spec."""
    if isinstance(tile, tuple):
        return tile
    return tile, tile


def tile_grid(width: int, height: int, tile=TILE,
              tile_h: int | None = None) -> tuple:
    """(grid_x, grid_y) tile counts for an image size."""
    tw, th = _tile_wh(tile)
    th = tile_h or th
    return (width + tw - 1) // tw, (height + th - 1) // th


def _tile_rect(means2d, radius, grid_x: int, grid_y: int, mode: str,
               tile=TILE):
    """Tile rectangle [min, max) covered by a splat disc. "lcgs" clamps the
    exclusive max to grid - 1 (reference lcgs/src/module.cpp:29-35), "inria"
    to grid like the graphdeco rasterizer."""
    tw, th = _tile_wh(tile)
    r = radius.to(torch.float32)
    lo_x = torch.floor((means2d[..., 0] - r) / tw).to(torch.int32)
    lo_y = torch.floor((means2d[..., 1] - r) / th).to(torch.int32)
    hi_x = torch.floor((means2d[..., 0] + r + tw - 1) / tw).to(torch.int32)
    hi_y = torch.floor((means2d[..., 1] + r + th - 1) / th).to(torch.int32)
    if mode == "lcgs":
        max_hi, may_hi = grid_x - 1, grid_y - 1
    elif mode == "inria":
        max_hi, may_hi = grid_x, grid_y
    else:
        raise ValueError(f"unknown rect_mode: {mode!r}")
    rect_min = torch.stack(
        [torch.clamp(lo_x, 0, grid_x - 1), torch.clamp(lo_y, 0, grid_y - 1)],
        dim=-1,
    )
    rect_max = torch.stack(
        [torch.clamp(hi_x, 0, max_hi), torch.clamp(hi_y, 0, may_hi)], dim=-1
    )
    return rect_min, rect_max


def project_gaussians(means3d, scales, quats_xyzw, camera, cfg=RenderConfig(),
                      scale_modifier: float = 1.0, ewa_mode: str = "inria",
                      width: int | None = None, height: int | None = None,
                      active_mask=None, means2d_probe=None,
                      opacities=None) -> ProjectedGaussians:
    """Project gaussians to screen space and compute their tile rects.

    Args:
      means3d, scales, quats_xyzw: (N, 3), (N, 3) activated, (N, 4) unit.
      camera: a ``Camera`` (moved to the device of ``means3d``) or a
        ``CameraView`` (then ``width``/``height`` are required).
      active_mask: optional (N,) bool; False rows get radius 0.
      means2d_probe: optional (N, 2) zeros added to the pixel centres; its
        gradient is the screen-space positional gradient.
      opacities: (N,) activated opacities, read only with
        ``cfg.tight_radius`` (radius shrinks to the exact alpha_min reach).
    """
    if isinstance(camera, Camera):
        width, height = camera.width, camera.height
        camera = camera.to_view(means3d.device)
    if width is None or height is None:
        raise ValueError("width/height are required with a CameraView")
    if not isinstance(camera, CameraView):
        raise TypeError(f"expected Camera or CameraView, got {type(camera)}")
    view = camera.view
    view3 = view[:3, :3]
    tan_fovx, tan_fovy = camera.tan_fovx, camera.tan_fovy
    focal_x = width / (2.0 * tan_fovx)
    focal_y = height / (2.0 * tan_fovy)

    # per-gaussian math on (N,) columns; they cross in and out through
    # utils/packing.py, as in the JAX package
    mx, my, mz = unstack_cols(means3d)
    px = mx * view3[0, 0] + my * view3[0, 1] + mz * view3[0, 2] + view[0, 3]
    py = mx * view3[1, 0] + my * view3[1, 1] + mz * view3[1, 2] + view[1, 3]
    depth = mx * view3[2, 0] + my * view3[2, 1] + mz * view3[2, 2] + view[2, 3]
    in_front = depth >= cfg.near

    # NDC with the reference's +1e-6 on w (gs_projector/shader.cpp:116)
    safe_z = torch.where(in_front, depth, torch.ones_like(depth))
    inv_w = 1.0 / (safe_z + cfg.w_eps)
    pix_x = ndc2pix(px / tan_fovx * inv_w, width)
    pix_y = ndc2pix(py / tan_fovy * inv_w, height)
    if means2d_probe is not None:
        prx, pry = unstack_cols(means2d_probe)
        pix_x = pix_x + prx
        pix_y = pix_y + pry
    means2d = stack_cols(pix_x, pix_y)

    sx, sy, sz = unstack_cols(scales)
    if scale_modifier != 1.0:
        sx, sy, sz = (sx * scale_modifier, sy * scale_modifier,
                      sz * scale_modifier)
    cov3d = covariance_3d_elems((sx, sy, sz), unstack_cols(quats_xyzw))
    sigma_view = view_rotate_cov_elems(cov3d, view3, ewa_mode)
    tx, ty, tz = clamp_to_frustum_comps(px, py, safe_z, tan_fovx, tan_fovy,
                                        cfg.frustum_clamp)
    if cfg.use_focal:
        a, b, c = ewa_project_cov_comps(sigma_view, tx, ty, tz, focal_x,
                                        focal_y)
    else:
        # shad_project_gs (gs_projector/shader.cpp:18-80): unit-focal J
        # rescaled to NDC units, then allocate_tiles' pixel rescale
        # (gs_tile_splatter/shader.cpp:132-138) with its H*W/4 cov.z factor
        a, b, c = ewa_project_cov_comps(sigma_view, tx, ty, tz, 1.0, 1.0)
        a = a * (1.0 / (tan_fovx * tan_fovx))
        b = b * (1.0 / (tan_fovx * tan_fovy))
        c = c * (1.0 / (tan_fovy * tan_fovy))
        a = a * (width * width * 0.25)
        b = b * (width * height * 0.25)
        c = c * (height * width * 0.25)
    tight_sigma = None
    if cfg.tight_radius and opacities is not None:
        o = opacities.detach().reshape(-1)
        tight_sigma = torch.sqrt(torch.clamp(
            2.0 * torch.log(torch.clamp(o, min=1e-12)
                            / o.new_full((), cfg.alpha_min)),
            min=0.0,
        ))
        tight_sigma = torch.where(o > cfg.alpha_min, tight_sigma,
                                  torch.zeros_like(tight_sigma))
    (ca, cb, cc), radius = conic_and_radius_comps(
        a, b, c, cfg.lowpass, cfg.radius_sigma, cfg.det_eps, tight_sigma
    )
    conic = stack_cols(ca, cb, cc)
    zero = torch.zeros_like(radius)
    radius = torch.where(in_front, radius, zero)
    if active_mask is not None:
        radius = torch.where(active_mask, radius, zero)

    grid_x, grid_y = tile_grid(width, height, cfg.tile_wh)
    rect_min, rect_max = _tile_rect(means2d.detach(), radius, grid_x, grid_y,
                                    cfg.rect_mode, cfg.tile_wh)
    tiles_touched = (
        torch.clamp(rect_max[:, 0] - rect_min[:, 0], min=0)
        * torch.clamp(rect_max[:, 1] - rect_min[:, 1], min=0)
    )
    tiles_touched = torch.where(radius > 0, tiles_touched,
                                torch.zeros_like(tiles_touched))
    tiles_touched = tiles_touched.to(torch.int32)
    return ProjectedGaussians(
        means2d=means2d,
        depth=depth,
        conic=conic,
        radius=radius,
        rect_min=rect_min,
        rect_max=rect_max,
        tiles_touched=tiles_touched,
        valid=tiles_touched > 0,
    )
