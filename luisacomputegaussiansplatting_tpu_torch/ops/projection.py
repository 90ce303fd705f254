"""Gaussian preprocessing: world -> screen, conic, tile rects (port of
``ops/projection.py``).

One differentiable stage covering the reference's GSProjector forward
(lcgs/src/gs_projector/shader.cpp:82-139) and the analytic half of
shad_allocate_tiles (lcgs/src/gs_tile_splatter/shader.cpp:102-163).

On CUDA tensors the stage is the hand-written kernel pair
``csrc/projection.cu`` (K6): one launch forward, one backward, the forward
equal to the plain version bit for bit (radius, the rects and tiles_touched
feed binning). It replaces no TPU kernel (the JAX package's version is plain
``jnp`` code that XLA fuses); torch's eager ops cannot fuse this layer, and
the plain version costs about 330 launches forward and 410 backward. The
backward also gives the camera's gradient where the view or a tangent
requires grad (a pose optimised through the render): each gaussian's share,
summed by torch. CPU tensors take the plain version,
:func:`project_gaussians_reference`, which the JAX-parity tests hold; the
card holds the kernels to it.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .._build import KernelLib, require_cuda_tensors
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


class _Params(ctypes.Structure):
    """``Params`` of ``csrc/projection.cu``: the image, the tile grid and
    the RenderConfig constants the kernels read, passed by value."""

    _fields_ = [
        ("n", ctypes.c_int64),
        *((f, ctypes.c_int) for f in (
            "width", "height", "tile_w", "tile_h", "grid_x", "grid_y",
            "max_x", "max_y", "ewa_lcgs", "use_focal")),
        *((f, ctypes.c_float) for f in (
            "near", "w_eps", "frustum_clamp", "lowpass", "radius_sigma",
            "det_eps", "alpha_min", "scale_modifier", "nf_a", "nf_b",
            "nf_c")),
    ]


_p, _i64 = ctypes.c_void_p, ctypes.c_int64
_params_p = ctypes.POINTER(_Params)

#: launches are counted per direction (``KERNEL.variant_launches``)
KERNEL = KernelLib("projection", {
    "projection_forward_launch": (ctypes.c_int, [_params_p, *[_p] * 18]),
    "projection_backward_launch": (
        ctypes.c_int,
        [_params_p, *[_p] * 7, _i64, _i64, _p, _i64, _i64, *[_p] * 5],
    ),
}, variants=("forward", "backward"))


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


def _camera_view(camera, device, width, height):
    """(CameraView, width, height) of a ``Camera`` or a ``CameraView``."""
    if isinstance(camera, Camera):
        width, height = camera.width, camera.height
        camera = camera.to_view(device)
    if width is None or height is None:
        raise ValueError("width/height are required with a CameraView")
    if not isinstance(camera, CameraView):
        raise TypeError(f"expected Camera or CameraView, got {type(camera)}")
    return camera, width, height


def project_gaussians_reference(means3d, scales, quats_xyzw, camera,
                                cfg=RenderConfig(),
                                scale_modifier: float = 1.0,
                                ewa_mode: str = "inria",
                                width: int | None = None,
                                height: int | None = None, active_mask=None,
                                means2d_probe=None,
                                opacities=None) -> ProjectedGaussians:
    """The plain version of :func:`project_gaussians` in torch ops, on any
    device, differentiable also in the camera."""
    camera, width, height = _camera_view(camera, means3d.device, width,
                                         height)
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


def _params(n: int, cfg: RenderConfig, width: int, height: int,
            scale_modifier: float, ewa_mode: str) -> _Params:
    """The kernels' ``Params``; Python floats become float32 as torch casts
    a scalar operand of a float32 op."""
    if ewa_mode not in ("inria", "lcgs"):
        raise ValueError(f"unknown ewa_mode: {ewa_mode!r}")
    tw, th = cfg.tile_wh
    grid_x, grid_y = tile_grid(width, height, cfg.tile_wh)
    inria = cfg.rect_mode == "inria"
    return _Params(
        n, width, height, tw, th, grid_x, grid_y,
        grid_x if inria else grid_x - 1, grid_y if inria else grid_y - 1,
        ewa_mode == "lcgs", cfg.use_focal, cfg.near, cfg.w_eps,
        cfg.frustum_clamp, cfg.lowpass, cfg.radius_sigma, cfg.det_eps,
        cfg.alpha_min, scale_modifier, width * width * 0.25,
        width * height * 0.25, height * width * 0.25)


def _check(fn: str, means3d, scales, quats_xyzw, view, tan_fovx, tan_fovy,
           params: _Params, means2d_probe=None, opacities=None,
           active_mask=None) -> None:
    """What the kernels take; raises before anything is built."""
    n = means3d.shape[0]
    if params.n != n:
        raise ValueError(f"{fn}: params are for {params.n} gaussians, "
                         f"got {n}")
    given = {"means3d": (means3d, (n, 3)), "scales": (scales, (n, 3)),
             "quats_xyzw": (quats_xyzw, (n, 4)), "view": (view, (4, 4)),
             "tan_fovx": (tan_fovx, ()), "tan_fovy": (tan_fovy, ()),
             "means2d_probe": (means2d_probe, (n, 2)),
             "opacities": (opacities, (n,)),
             "active_mask": (active_mask, (n,))}
    tensors = []
    for name, (t, shape) in given.items():
        if t is None:
            continue
        dtype = torch.bool if name == "active_mask" else torch.float32
        if t.dtype != dtype:
            raise ValueError(f"{fn}: {name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{fn}: {name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        tensors.append(t)
    require_cuda_tensors(fn, *tensors)


def _ptr(t):
    return None if t is None else t.data_ptr()


def projection_forward_kernel(means3d, scales, quats_xyzw, view, tan_fovx,
                              tan_fovy, params: _Params, means2d_probe=None,
                              opacities=None,
                              active_mask=None) -> ProjectedGaussians:
    """Launch K6's forward on contiguous CUDA tensors: means3d (N, 3),
    scales (N, 3), quats_xyzw (N, 4), view (4, 4) and the 0-dim tangents,
    read on the device, all float32; optionally the (N, 2) probe, the (N,)
    opacities of the tight radius and the (N,) bool active mask."""
    _check("projection_forward_kernel", means3d, scales, quats_xyzw, view,
           tan_fovx, tan_fovy, params, means2d_probe, opacities,
           active_mask)
    n, dev = means3d.shape[0], means3d.device
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    out = ProjectedGaussians(
        means2d=torch.empty((n, 2), **f32), depth=torch.empty((n,), **f32),
        conic=torch.empty((n, 3), **f32), radius=torch.empty((n,), **i32),
        rect_min=torch.empty((n, 2), **i32),
        rect_max=torch.empty((n, 2), **i32),
        tiles_touched=torch.empty((n,), **i32),
        valid=torch.empty((n,), dtype=torch.bool, device=dev))
    if n == 0:
        return out
    lib = KERNEL.lib()
    with torch.cuda.device(dev):
        err = lib.projection_forward_launch(
            ctypes.byref(params), means3d.data_ptr(), scales.data_ptr(),
            quats_xyzw.data_ptr(), _ptr(means2d_probe), _ptr(opacities),
            _ptr(active_mask), view.data_ptr(), tan_fovx.data_ptr(),
            tan_fovy.data_ptr(), *(t.data_ptr() for t in out),
            torch.cuda.current_stream(dev).cuda_stream)
    KERNEL.check(err, "projection_forward_launch")
    KERNEL.launched("forward")
    return out


def _cotangent(fn: str, d, shape, dev):
    """(pointer, stride 0, stride 1) of an optional float32 (N, K)
    cotangent of any strides."""
    if d is None:
        return None, 0, 0
    if tuple(d.shape) != shape or d.dtype != torch.float32 or d.device != dev:
        raise ValueError(f"{fn}: a cotangent must be {shape} float32 on {dev}")
    return d.data_ptr(), *d.stride()


def projection_backward_kernel(means3d, scales, quats_xyzw, view, tan_fovx,
                               tan_fovy, params: _Params, d_means2d=None,
                               d_conic=None, camera: bool = False):
    """Launch K6's backward: (d means3d (N, 3), d scales (N, 3), d quats
    (N, 4), camera terms) from the forward's inputs and the float32
    cotangents of the centres (N, 2) and conics (N, 3), each of any strides
    or None for zero. With ``camera`` the terms are each gaussian's share of
    the camera's gradient, (14, N): rows 0-2 of d view row-major, d tan_fovx,
    d tan_fovy; else None."""
    fn = "projection_backward_kernel"
    _check(fn, means3d, scales, quats_xyzw, view, tan_fovx, tan_fovy, params)
    n, dev = means3d.shape[0], means3d.device
    dm = _cotangent(fn, d_means2d, (n, 2), dev)
    dc = _cotangent(fn, d_conic, (n, 3), dev)
    grads = (torch.empty_like(means3d), torch.empty_like(scales),
             torch.empty_like(quats_xyzw),
             means3d.new_empty((14, n)) if camera else None)
    if n == 0:
        return grads
    lib = KERNEL.lib()
    with torch.cuda.device(dev):
        err = lib.projection_backward_launch(
            ctypes.byref(params), means3d.data_ptr(), scales.data_ptr(),
            quats_xyzw.data_ptr(), view.data_ptr(), tan_fovx.data_ptr(),
            tan_fovy.data_ptr(), *dm, *dc, *(_ptr(g) for g in grads),
            torch.cuda.current_stream(dev).cuda_stream)
    KERNEL.check(err, "projection_backward_launch")
    KERNEL.launched("backward")
    return grads


class _Project(torch.autograd.Function):
    """K6 forward and backward; saves nothing but its inputs. The depth
    takes no gradient (the render path detaches it); the camera's gradient
    is the sum of the kernel's per-gaussian terms."""

    @staticmethod
    def forward(ctx, means3d, scales, quats_xyzw, means2d_probe, view,
                tan_fovx, tan_fovy, opacities, active_mask, params):
        ctx.set_materialize_grads(False)
        ctx.params = params
        ctx.save_for_backward(means3d, scales, quats_xyzw, view, tan_fovx,
                              tan_fovy)
        out = projection_forward_kernel(means3d, scales, quats_xyzw, view,
                                        tan_fovx, tan_fovy, params,
                                        means2d_probe, opacities, active_mask)
        ctx.mark_non_differentiable(out.depth, *out[3:])
        return tuple(out)

    @staticmethod
    def backward(ctx, d_means2d, _d_depth, d_conic, *_ints):
        need = ctx.needs_input_grad
        grads = (None,) * 3
        cam = (None,) * 3
        camera = any(need[4:7])
        if ((any(need[:3]) or camera)
                and not (d_means2d is None and d_conic is None)):
            *grads, terms = projection_backward_kernel(
                *ctx.saved_tensors, ctx.params, d_means2d, d_conic, camera)
            grads = tuple(g if w else None for g, w in zip(grads, need))
            if camera:
                s = terms.sum(1)
                cam = (F.pad(s[:12].view(3, 4), (0, 0, 0, 1)), s[12], s[13])
                cam = tuple(c if w else None for c, w in zip(cam, need[4:7]))
        # the probe is added to the centres: its gradient is theirs
        return (*grads, d_means2d if need[3] else None, *cam, None, None,
                None)


def project_gaussians(means3d, scales, quats_xyzw, camera, cfg=RenderConfig(),
                      scale_modifier: float = 1.0, ewa_mode: str = "inria",
                      width: int | None = None, height: int | None = None,
                      active_mask=None, means2d_probe=None,
                      opacities=None) -> ProjectedGaussians:
    """Project gaussians to screen space and compute their tile rects: K6
    on CUDA tensors, the plain version on CPU tensors. On CUDA tensors the
    depth takes no gradient; the view and tangents take one where they
    require it (a pose optimised through the render).

    Args:
      means3d, scales, quats_xyzw: (N, 3), (N, 3) activated, (N, 4) unit.
      camera: a ``Camera`` (moved to the device of ``means3d``) or a
        ``CameraView`` (then ``width``/``height`` are required).
      active_mask: optional (N,) bool; False rows get radius 0.
      means2d_probe: optional (N, 2) zeros added to the pixel centres; its
        gradient is the screen-space positional gradient.
      opacities: (N,) activated opacities, read only with
        ``cfg.tight_radius`` (radius shrinks to the exact alpha_min reach;
        no gradient flows to them).
    """
    dev = means3d.device
    camera, width, height = _camera_view(camera, dev, width, height)
    cam = (camera.view, camera.tan_fovx, camera.tan_fovy)
    if dev.type == "cpu":
        return project_gaussians_reference(
            means3d, scales, quats_xyzw, camera, cfg, scale_modifier,
            ewa_mode, width, height, active_mask, means2d_probe, opacities)
    if cfg.tight_radius and opacities is not None:
        opacities = opacities.detach().reshape(-1).contiguous()
    else:
        opacities = None
    params = _params(means3d.shape[0], cfg, width, height, scale_modifier,
                     ewa_mode)
    out = _Project.apply(
        means3d.contiguous(), scales.contiguous(), quats_xyzw.contiguous(),
        None if means2d_probe is None else means2d_probe.contiguous(),
        *(t.contiguous() for t in cam), opacities,
        None if active_mask is None else active_mask.contiguous(), params)
    return ProjectedGaussians(*out)
