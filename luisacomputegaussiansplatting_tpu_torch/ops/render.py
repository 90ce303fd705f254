"""End-to-end render of one view (port of ``ops/render.py``).

The reference's per-frame path (app/main.cpp:266-308: SHProcessor,
GSProjector, GSTileSplatter) as plain torch stages around the CUDA kernels:
SH colours (kernel) -> projection and tile rects (kernel) -> expansion
(kernel) -> sort and ranges -> payload gather -> forward blend (kernel) ->
image and background. Under autograd the backward runs the backward blend
(kernel), the segment-sum of the payload gradients per gaussian (kernel),
then the projection's and the SH colours' backward kernels (K6, K5).
Capacities are static, as in the JAX package, and overflow is reported
rather than resized, so both packages produce the same entry streams.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import TILE, RenderConfig
from ..utils.camera import Camera, CameraView
from ..utils.packing import stack_cols, unstack_cols
from ..utils.profiling import close, mark, span
from .binning import bin_gaussians, bin_gaussians_nopack
from .projection import ProjectedGaussians, _tile_wh, project_gaussians, tile_grid
from .rasterize import rasterize_tiles
from .rasterize_ref import FIELDS, rasterize_reference
from .segsum import reduce_fields_by_id
from .sh_eval import compute_colors


class RenderAux(NamedTuple):
    """Side outputs of a render (diagnostics, densification statistics)."""

    radii: torch.Tensor  # (N,) int32 splat radius (0 = culled)
    transmittance: torch.Tensor  # (H, W) final per-pixel transmittance
    num_rendered: torch.Tensor  # () int32 entries blended
    overflow: torch.Tensor  # () bool capacity exceeded
    means2d: torch.Tensor  # (N, 2) pixel-space centres


def _selection_opacity(opacities, cfg: RenderConfig):
    """Opacity as the entry-selection stages (tight radius, tile cull) must
    see it: the bf16-rounded value when the payload carries bf16, so that
    selection and blend decide alpha >= alpha_min on the same number."""
    if cfg.payload_dtype == "bf16":
        return opacities.to(torch.bfloat16).to(torch.float32)
    return opacities


def payload_table(proj: ProjectedGaussians, colors, opacities):
    """(N, 9) float32 per-gaussian payload rows in the kernel's field order:
    mean x, mean y, conic a, b, c, opacity, r, g, b (differentiable)."""
    mx, my = unstack_cols(proj.means2d)
    ca, cb, cc = unstack_cols(proj.conic)
    r, g, b = unstack_cols(colors)
    table = stack_cols(mx, my, ca, cb, cc, opacities.reshape(-1), r, g,
                       b).to(torch.float32)
    assert table.shape[1] == FIELDS
    return table


class _GatherPayload(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, entry_gid, payload_dtype, reduce_dtype,
                reduce_method):
        if payload_dtype not in ("f32", "bf16"):
            raise ValueError(f"unknown payload_dtype: {payload_dtype!r}")
        valid = entry_gid >= 0
        rows = table[torch.clamp(entry_gid, min=0).to(torch.int64)]
        if payload_dtype == "bf16":
            rows = torch.cat(
                [rows[:, :5],
                 rows[:, 5:].to(torch.bfloat16).to(torch.float32)],
                dim=1,
            )
        # a scalar zero: a zeros_like here was a third payload-sized buffer
        # at the frame's peak of device memory
        rows = torch.where(valid[:, None], rows, 0.0)
        ctx.save_for_backward(entry_gid)
        ctx.n_rows = table.shape[0]
        ctx.reduce = (reduce_dtype, reduce_method)
        return rows.t().contiguous()

    @staticmethod
    def backward(ctx, d_payload):
        (entry_gid,) = ctx.saved_tensors
        d_table = reduce_fields_by_id(entry_gid, d_payload.contiguous(),
                                      ctx.n_rows, *ctx.reduce)
        return d_table, None, None, None, None


def gather_payload(table, entry_gid, payload_dtype: str = "f32",
                   reduce_dtype: str = "f32", reduce_method: str = "ride"):
    """(N, 9) table + (capacity,) gids -> (9, capacity) field-major payload;
    padding slots (gid < 0) are all zero. With ``payload_dtype="bf16"``
    opacity and rgb are rounded to bf16 values (round to nearest even), the
    rounding the JAX package's packed gather applies.

    The backward sums the per-entry payload gradients per gaussian with the
    segment-sum (``ops/segsum.py``; padding slots are dropped, never added
    into gaussian 0). As in the JAX package's custom VJP, the bf16 rounding
    passes the gradient through unrounded; ``reduce_dtype="bf16"`` rounds
    it inside the reduction instead.
    """
    return _GatherPayload.apply(table, entry_gid, payload_dtype,
                                reduce_dtype, reduce_method)


def build_payload(proj, colors, opacities, binned, reduce_dtype="f32",
                  payload_dtype="f32", reduce_method="ride"):
    """The (9, capacity) payload of a binning result (differentiable); the
    arguments after ``binned`` are those of the JAX package's
    ``build_payload``."""
    table = payload_table(proj, colors, opacities)
    return gather_payload(table, binned.entry_gid, payload_dtype,
                          reduce_dtype, reduce_method)


def _tiles_to_image(color, trans, grid_x: int, grid_y: int, width: int,
                    height: int, tile=TILE):
    """(num_tiles, tile_w*tile_h, C) tiles -> ((C, H, W) colour, (H, W) T)."""
    tw, th = _tile_wh(tile)

    def reshape(x):
        c = x.shape[2]
        x = x.reshape(grid_y, grid_x, th, tw, c)
        x = x.permute(4, 0, 2, 1, 3).reshape(c, grid_y * th, grid_x * tw)
        return x[:, :height, :width]

    # squeeze, not [0]: its backward is a view, not a zero-filled buffer
    return reshape(color), reshape(trans).squeeze(0)


class RenderStages(NamedTuple):
    """What a view's stages before the blend produce."""

    proj: ProjectedGaussians
    grid: tuple  # (grid_x, grid_y) tiles
    binned: object  # BinnedGaussians or NoPackBinned
    payload: torch.Tensor  # (9, capacity) field-major payload
    colors: torch.Tensor  # (N, 3) SH colours
    cull_op: object  # the opacity the tile cull read, or None


def render_stages(means3d, scales, quats_xyzw, opacities, sh_coeffs,
                  cam_view: CameraView, width: int, height: int,
                  cfg: RenderConfig = RenderConfig(), sh_degree: int = 3,
                  scale_modifier: float = 1.0, ewa_mode: str = "inria",
                  active_mask=None, means2d_probe=None) -> RenderStages:
    """The stages of :func:`render_view` up to the blend: SH colours,
    projection, binning and the payload gather (differentiable), each in
    its ``render_view.<stage>`` range (``utils/profiling.py``)."""
    with span("render_view.sh"):
        colors = mark("render_view.sh", compute_colors(
            means3d, sh_coeffs, cam_view.position, sh_degree))
    with span("render_view.project"):
        proj = mark("render_view.project", project_gaussians(
            means3d, scales, quats_xyzw, cam_view, cfg, scale_modifier,
            ewa_mode, width=width, height=height, active_mask=active_mask,
            means2d_probe=means2d_probe,
            opacities=_selection_opacity(opacities, cfg) if cfg.tight_radius
            else None,
        ))
        # the opacity the tile cull reads, rounded as projection's is
        cull_op = _selection_opacity(opacities, cfg) if cfg.tile_cull else None
    grid_x, grid_y = tile_grid(width, height, cfg.tile_wh)
    binner = {"chunk": bin_gaussians, "none": bin_gaussians_nopack}[cfg.pack_mode]
    binned = binner(proj, grid_x, grid_y, cfg.max_pairs, cull_op, cfg.tile_wh,
                    cfg.alpha_min, cfg.expansion, cfg.max_pairs_sorted,
                    cfg.interpret, cfg.sort_mode)
    with span("render_view.pack"):
        table = mark("render_view.pack",
                     payload_table(proj, colors, opacities))
    with span("render_view.gather"):
        payload = mark("render_view.gather", gather_payload(
            table, binned.entry_gid, cfg.payload_dtype,
            cfg.grad_reduce_dtype, cfg.grad_reduce_method))
    return RenderStages(proj, (grid_x, grid_y), binned, payload, colors,
                        cull_op)


def render_view(means3d, scales, quats_xyzw, opacities, sh_coeffs,
                cam_view: CameraView, width: int, height: int,
                bg_color=(0.0, 0.0, 0.0), cfg: RenderConfig = RenderConfig(),
                sh_degree: int = 3, scale_modifier: float = 1.0,
                ewa_mode: str = "inria", active_mask=None,
                means2d_probe=None):
    """Render with a tensor CameraView on the device of ``means3d``.

    Returns (image (3, H, W), RenderAux). While a profiler records, the
    call is the range ``render_view`` and each stage ``render_view.<stage>``
    (sh, project, expand, sort, pack, gather, blend, compose), and under
    autograd the backward of each stage runs under
    ``render_view.<stage>.backward`` (``utils/profiling.py``)."""
    with span("render_view"):
        # the backward's ranges end at the inputs; not at the probe, the
        # caller's leaf for reading dL/d means2d, whose gradient is
        # projection's
        (means3d, scales, quats_xyzw, opacities, sh_coeffs, cam_view,
         bg_color) = close((means3d, scales, quats_xyzw, opacities,
                            sh_coeffs, cam_view, bg_color))
        proj, (grid_x, grid_y), binned, payload, _, _ = render_stages(
            means3d, scales, quats_xyzw, opacities, sh_coeffs, cam_view,
            width, height, cfg, sh_degree, scale_modifier, ewa_mode,
            active_mask, means2d_probe)

        with span("render_view.blend"):
            if cfg.rasterizer == "pallas":
                color, trans = rasterize_tiles(
                    payload, binned.tile_starts, binned.tile_counts, grid_x,
                    width, height, cfg)
            else:  # "jnp": the plain version on every device
                color, trans = rasterize_reference(
                    payload, binned.tile_starts, binned.tile_counts, grid_x,
                    width, height, cfg)
            color, trans = mark("render_view.blend", (color, trans))

        with span("render_view.compose"):
            img_c, img_t = _tiles_to_image(color, trans, grid_x, grid_y,
                                           width, height, cfg.tile_wh)
            bg = torch.as_tensor(bg_color, dtype=torch.float32,
                                 device=img_c.device)
            image = img_c + bg[:, None, None] * img_t[None, :, :]
            image, img_t = mark("render_view.compose", (image, img_t))
        aux = RenderAux(
            radii=proj.radius,
            transmittance=img_t,
            num_rendered=binned.num_rendered,
            overflow=binned.overflow,
            means2d=proj.means2d,
        )
        return image, aux


def render_aux(means3d, scales, quats_xyzw, opacities, sh_coeffs,
               camera: Camera, bg_color=(0.0, 0.0, 0.0),
               cfg: RenderConfig = RenderConfig(), sh_degree: int = 3,
               scale_modifier: float = 1.0, ewa_mode: str = "inria"):
    """Render a view on the device of ``means3d``; returns
    (image (3, H, W), RenderAux).

    All gaussian inputs are activated: means (N, 3), scales (N, 3),
    unit quaternions (N, 4) x, y, z, w, opacities (N,), SH (N, K, 3).
    """
    return render_view(
        means3d, scales, quats_xyzw, opacities, sh_coeffs,
        camera.to_view(means3d.device), camera.width, camera.height,
        bg_color, cfg, sh_degree, scale_modifier, ewa_mode,
    )


def render(means3d, scales, quats_xyzw, opacities, sh_coeffs, camera: Camera,
           bg_color=(0.0, 0.0, 0.0), cfg: RenderConfig = RenderConfig(),
           sh_degree: int = 3, scale_modifier: float = 1.0,
           ewa_mode: str = "inria"):
    """Like :func:`render_aux` but returns only the (3, H, W) image."""
    image, _ = render_aux(means3d, scales, quats_xyzw, opacities, sh_coeffs,
                          camera, bg_color, cfg, sh_degree, scale_modifier,
                          ewa_mode)
    return image
