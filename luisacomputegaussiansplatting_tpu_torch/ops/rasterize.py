"""Tile rasterizer with hand-written CUDA kernels (counterpart of
``ops/rasterize_pallas.py``): the forward blend (``csrc/rasterize.cu``) and
the backward blend (``csrc/rasterize_backward.cu``).

For CUDA tensors ``rasterize_forward`` and ``rasterize_backward`` launch
their kernels, in the ``cfg.blend_quad`` mode ("vpu" or "mxu", one kernel
each with the mode as a launch argument); CPU tensors run the plain versions
of ``rasterize_ref``. Each kernel counts its launches per mode
(``KERNEL.variant_launches``).
``rasterize_tiles`` is the autograd Function of the pair: its backward turns
the cotangents into the residual [dL/dC, dL/dT, C_final, T_final] and
returns the per-entry payload gradient.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .._build import KernelLib, require_cuda_tensors
from ..config import POWER_GUARD, RenderConfig
from .rasterize_ref import FIELDS, rasterize_backward_reference, rasterize_reference

_p, _i, _i64, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float

BLEND_QUADS = ("vpu", "mxu")

KERNEL = KernelLib("rasterize", {
    "rasterize_forward_launch": (
        ctypes.c_int,
        [_p, _i64, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _i, _i, _i,
         _f, _f, _f, _f, _p, _p, _p],
    ),
}, variants=BLEND_QUADS)

BACKWARD_KERNEL = KernelLib("rasterize_backward", {
    "rasterize_backward_launch": (
        ctypes.c_int,
        [_p, _i64, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _i, _i, _f, _f,
         _f, _f, _p, _p],
    ),
}, variants=BLEND_QUADS)

#: one block per tile, at most one thread per pixel
MAX_TILE_PIXELS = 1024
#: pixels a thread of the backward kernel may own (its template instances)
BACKWARD_PIXELS_PER_THREAD = (4, 2, 1)
#: pixels a thread of the forward kernel may own (its template instances)
FORWARD_PIXELS_PER_THREAD = (2, 1)
#: a warp's P groups of 32 pixels as (columns, rows) of 8x4 boxes, in order
#: of preference (the first that tiles the tile's boxes)
_WARP_REGIONS = {2: ((1, 2), (2, 1)), 1: ((1, 1),)}


def forward_launch_shape(tile_w: int, tile_h: int) -> tuple:
    """(threads a block, pixels a thread) of the forward kernel for a tile:
    two pixels a thread where that makes at least four whole warps, else one
    pixel a thread on the tile's pixel count rounded up to whole warps (the
    faster of the kernel's two instances at tile 16 and 32 on the H100,
    PERF.md). Any tile of 1 to ``MAX_TILE_PIXELS`` pixels is taken."""
    pix = tile_w * tile_h
    if tile_w < 1 or tile_h < 1 or pix > MAX_TILE_PIXELS:
        raise ValueError(f"tile {tile_w}x{tile_h}: the forward kernel takes "
                         f"1 to {MAX_TILE_PIXELS} pixels")
    if pix % 64 == 0 and pix // 2 >= 128:
        return pix // 2, 2
    return -(-pix // 32) * 32, 1


def forward_pixel_map(tile_w: int, tile_h: int,
                      pixels_per_thread: int) -> torch.Tensor:
    """(threads, P) int32: the tile-local pixel (y * tile_w + x) of each
    thread's P pixels, -1 where a pad lane has none.

    The pixels come in groups of 32, one a lane; the P pixels of a thread
    lie in the P groups of its warp (lane l of slot i of warp w is in group
    w * P + i). Where the tile is whole 8x4 boxes, a group is one box (lane
    l at (l % 8, l // 8)) and a warp's P boxes are a compact region
    (``_WARP_REGIONS``: 8x8 pixels at P = 2, or 16x4), the regions
    row by row over the tile; otherwise group g is pixels [32 g, 32 g + 32)
    in row order."""
    per = pixels_per_thread
    pix = tile_w * tile_h
    if per not in FORWARD_PIXELS_PER_THREAD or (per > 1 and pix % (32 * per)):
        raise ValueError(f"tile {tile_w}x{tile_h}: {per} pixels a thread do "
                         "not make whole warps")
    n_groups = -(-pix // 32)
    warps = -(-n_groups // per)
    w = torch.arange(warps)[:, None, None]
    i = torch.arange(per)[None, :, None]
    lane = torch.arange(32)[None, None, :]
    bw, bh = tile_w // 8, tile_h // 4
    regions = [(rw, rh) for rw, rh in _WARP_REGIONS[per]
               if tile_w % 8 == 0 and tile_h % 4 == 0
               and bw % rw == 0 and bh % rh == 0]
    if regions:
        rw, rh = regions[0]
        box_x = (w % (bw // rw)) * rw + i % rw
        box_y = (w // (bw // rw)) * rh + i // rw
        pixel = (box_y * 4 + lane // 8) * tile_w + box_x * 8 + lane % 8
    else:
        pixel = (w * per + i) * 32 + lane
        pixel = torch.where(pixel < pix, pixel, -1)
    # (warps, P, 32) -> (threads, P)
    return pixel.permute(0, 2, 1).reshape(warps * 32, per).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _device_pixel_map(tile_w: int, tile_h: int, pixels_per_thread: int, dev):
    """``forward_pixel_map`` on ``dev``, copied once per tile and device
    (the kernel only reads it)."""
    return forward_pixel_map(tile_w, tile_h, pixels_per_thread).to(dev)


def backward_launch_shape(tile_w: int, tile_h: int) -> tuple:
    """(threads a block, pixels a thread) of the backward kernel for a tile:
    the most pixels a thread (4 or 2) that leave the block at least four
    whole warps, else one pixel a thread (the fastest choice at tile 16 and
    32 on the H100, PERF.md). The tile must have a multiple of 32 pixels,
    at most ``MAX_TILE_PIXELS``."""
    pix = tile_w * tile_h
    if tile_w < 1 or tile_h < 1 or pix % 32 or pix > MAX_TILE_PIXELS:
        raise ValueError(f"tile {tile_w}x{tile_h}: the backward kernel needs "
                         f"a multiple of 32 pixels, at most {MAX_TILE_PIXELS}")
    for per_thread in BACKWARD_PIXELS_PER_THREAD[:-1]:
        if pix % (32 * per_thread) == 0 and pix // per_thread >= 128:
            return pix // per_thread, per_thread
    return pix, 1


def _check_launch_args(fn: str, payload, tile_starts, tile_counts,
                       cfg: RenderConfig):
    """Validate the kernels' common arguments; returns (tile_w, tile_h)."""
    tw, th = cfg.tile_wh
    if tw * th > MAX_TILE_PIXELS:
        raise ValueError(f"tile {tw}x{th} has more than {MAX_TILE_PIXELS} pixels")
    num_tiles = tile_starts.shape[0]
    require_cuda_tensors(fn, payload, tile_starts, tile_counts)
    if payload.dtype != torch.float32 or payload.dim() != 2 \
            or payload.shape[0] != FIELDS:
        raise ValueError(
            f"payload must be ({FIELDS}, capacity) float32, got "
            f"{tuple(payload.shape)} {payload.dtype}")
    for name, t in (("tile_starts", tile_starts), ("tile_counts", tile_counts)):
        if t.dtype != torch.int32 or t.shape != (num_tiles,):
            raise ValueError(f"{name} must be ({num_tiles},) int32")
    return tw, th


def _mxu(cfg: RenderConfig) -> int:
    """The kernels' mode argument: 1 for blend_quad="mxu", 0 for "vpu"
    (``RenderConfig`` admits no other value)."""
    return int(cfg.blend_quad == "mxu")


def _check_offset(tile_offset: int, num_tiles: int, grid_x: int):
    """The band's global tiles [tile_offset, tile_offset + num_tiles) must
    have int32 indices: the kernels compute their origins in int."""
    if tile_offset < 0 or tile_offset + num_tiles > 2**31 - 1:
        raise ValueError(f"tile_offset {tile_offset} out of range")


def rasterize_forward(payload, tile_starts, tile_counts, grid_x: int,
                      width: int, height: int, cfg: RenderConfig,
                      tile_offset: int = 0):
    """Blend each tile's entries [start, start + count) of the (9, capacity)
    float32 field-major payload (rows: mean x, mean y, conic a, b, c,
    opacity, r, g, b). Local tile i lies at global tile ``tile_offset + i``
    of the ``grid_x``-wide grid (a host integer: a band of a sharded frame
    passes its first global tile).

    Returns (color (num_tiles, pix, 3), transmittance (num_tiles, pix, 1)),
    pix = tile_w * tile_h; T is the value after the last applied entry and
    0 for pixels past the image edge.
    """
    if payload.device.type == "cpu":
        return rasterize_reference(payload, tile_starts, tile_counts, grid_x,
                                   width, height, cfg, tile_offset)
    return _launch_forward(payload, tile_starts, tile_counts, grid_x, width,
                           height, cfg, forward_launch_shape(*cfg.tile_wh)[1],
                           tile_offset)


def _launch_forward(payload, tile_starts, tile_counts, grid_x: int,
                    width: int, height: int, cfg: RenderConfig,
                    pixels_per_thread: int, tile_offset: int = 0):
    """``rasterize_forward``'s launch with a given number of pixels a
    thread (``chip_smoke.py`` times the other choice with it). The blocks
    take the tiles in descending order of their entry counts (a
    ``torch.argsort``), so the longest tiles do not start in the last
    wave."""
    tw, th = _check_launch_args("rasterize_forward", payload, tile_starts,
                                tile_counts, cfg)
    pix = tw * th
    num_tiles = tile_starts.shape[0]
    _check_offset(tile_offset, num_tiles, grid_x)
    dev = payload.device
    pixel_map = _device_pixel_map(tw, th, pixels_per_thread, dev)
    order = torch.argsort(tile_counts, descending=True)
    color = torch.empty((num_tiles, pix, 3), dtype=torch.float32, device=dev)
    trans = torch.empty((num_tiles, pix, 1), dtype=torch.float32, device=dev)
    if num_tiles == 0:
        return color, trans
    lib = KERNEL.lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rasterize_forward_launch(
            payload.data_ptr(), payload.shape[1], tile_starts.data_ptr(),
            tile_counts.data_ptr(), pixel_map.data_ptr(), order.data_ptr(),
            num_tiles,
            pixel_map.shape[0], pixels_per_thread, grid_x, tile_offset, width,
            height, tw, th, _mxu(cfg), cfg.alpha_max, cfg.alpha_min,
            cfg.transmittance_eps, POWER_GUARD, color.data_ptr(),
            trans.data_ptr(), stream,
        )
    KERNEL.check(err, "rasterize_forward_launch")
    KERNEL.launched(cfg.blend_quad)
    return color, trans


def rasterize_backward(payload, tile_starts, tile_counts, residual,
                       grid_x: int, width: int, height: int,
                       cfg: RenderConfig, tile_offset: int = 0):
    """Per-entry gradients of the payload fields.

    Args:
      residual: (num_tiles, tile_w*tile_h, 8) float32 per pixel: [dL/dC rgb,
        dL/dT, C_final rgb, T_final].
      tile_offset: the global index of local tile 0 (see
        :func:`rasterize_forward`).

    Returns (9, capacity) float32, laid out as the payload. Entries in a
    tile's range that were clamped at alpha_max, not applied or behind a
    pixel's stop, and chunk padding, get zeros. Slots outside every range
    hold garbage on CUDA (the plain version zeros them), as in the JAX
    package: callers drop entries with gid < 0, which get no gradient.
    """
    if payload.device.type == "cpu":
        return rasterize_backward_reference(payload, tile_starts, tile_counts,
                                            residual, grid_x, width, height,
                                            cfg, tile_offset)
    return _launch_backward(payload, tile_starts, tile_counts, residual,
                            grid_x, width, height, cfg,
                            backward_launch_shape(*cfg.tile_wh)[1],
                            tile_offset)


def _launch_backward(payload, tile_starts, tile_counts, residual,
                     grid_x: int, width: int, height: int, cfg: RenderConfig,
                     pixels_per_thread: int, tile_offset: int = 0):
    """``rasterize_backward``'s launch with a given number of pixels a
    thread (``chip_smoke.py`` times the other choices with it)."""
    tw, th = _check_launch_args("rasterize_backward", payload, tile_starts,
                                tile_counts, cfg)
    pix = tw * th
    num_tiles = tile_starts.shape[0]
    _check_offset(tile_offset, num_tiles, grid_x)
    if pixels_per_thread not in BACKWARD_PIXELS_PER_THREAD \
            or pix % (32 * pixels_per_thread):
        raise ValueError(f"tile {tw}x{th}: {pixels_per_thread} pixels a "
                         "thread do not make whole warps")
    require_cuda_tensors("rasterize_backward", payload, residual)
    if residual.dtype != torch.float32 or residual.shape != (num_tiles, pix, 8):
        raise ValueError(f"residual must be ({num_tiles}, {pix}, 8) float32")
    dev = payload.device
    grads = torch.empty_like(payload)
    if num_tiles == 0:
        return grads.zero_()
    lib = BACKWARD_KERNEL.lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rasterize_backward_launch(
            payload.data_ptr(), payload.shape[1], tile_starts.data_ptr(),
            tile_counts.data_ptr(), residual.data_ptr(), num_tiles, grid_x,
            tile_offset, width, height, tw, th, pixels_per_thread, _mxu(cfg),
            cfg.alpha_max, cfg.alpha_min, cfg.transmittance_eps, POWER_GUARD,
            grads.data_ptr(), stream,
        )
    BACKWARD_KERNEL.check(err, "rasterize_backward_launch")
    BACKWARD_KERNEL.launched(cfg.blend_quad)
    return grads


def make_residual(d_color, d_trans, color, trans):
    """(num_tiles, pix, 8) [dL/dC, dL/dT, C_final, T_final]; a missing
    cotangent (None) is zero."""
    if d_color is None:
        d_color = torch.zeros_like(color)
    if d_trans is None:
        d_trans = torch.zeros_like(trans)
    return torch.cat([d_color, d_trans, color, trans], dim=2).contiguous()


class _RasterizeTiles(torch.autograd.Function):
    @staticmethod
    def forward(ctx, payload, tile_starts, tile_counts, grid_x, width, height,
                cfg, tile_offset):
        color, trans = rasterize_forward(payload, tile_starts, tile_counts,
                                         grid_x, width, height, cfg,
                                         tile_offset)
        ctx.save_for_backward(payload, tile_starts, tile_counts, color, trans)
        ctx.args = (grid_x, width, height, cfg, tile_offset)
        return color, trans

    @staticmethod
    def backward(ctx, d_color, d_trans):
        payload, tile_starts, tile_counts, color, trans = ctx.saved_tensors
        residual = make_residual(d_color, d_trans, color, trans)
        d_payload = rasterize_backward(payload, tile_starts, tile_counts,
                                       residual, *ctx.args)
        return d_payload, None, None, None, None, None, None, None


def rasterize_tiles(payload, tile_starts, tile_counts, grid_x: int,
                    width: int, height: int, cfg: RenderConfig,
                    tile_offset: int = 0):
    """Differentiable tile rasterization; gradients flow to ``payload`` only
    (the ranges are structural), and only its slots inside a tile's range
    get a defined one (see :func:`rasterize_backward`). ``tile_offset`` is
    the global index of local tile 0 (see :func:`rasterize_forward`).

    Returns (color (num_tiles, pix, 3), transmittance (num_tiles, pix, 1)).
    """
    return _RasterizeTiles.apply(payload, tile_starts, tile_counts, grid_x,
                                 width, height, cfg, int(tile_offset))
