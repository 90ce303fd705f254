"""Tile rasterizer with the hand-written CUDA kernel (counterpart of
``ops/rasterize_pallas.py``), forward only.

``rasterize_forward`` launches ``csrc/rasterize.cu`` for CUDA tensors and
runs the plain version (``rasterize_ref.rasterize_reference``) for CPU
tensors. ``rasterize_tiles`` wraps it in an autograd Function whose backward
raises: the backward blend kernel is not ported yet, and a silent zero
gradient would be worse than an error.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import KernelLib, require_cuda_tensors
from ..config import RenderConfig
from .rasterize_ref import FIELDS, rasterize_reference

_p, _i, _i64, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float

KERNEL = KernelLib("rasterize", {
    "rasterize_forward_launch": (
        ctypes.c_int,
        [_p, _i64, _p, _p, _i, _i, _i, _i, _i, _i, _f, _f, _f, _p, _p, _p],
    ),
})

#: one thread per pixel of a tile, one block per tile
MAX_TILE_PIXELS = 1024


def rasterize_forward(payload, tile_starts, tile_counts, grid_x: int,
                      width: int, height: int, cfg: RenderConfig):
    """Blend each tile's entries [start, start + count) of the (9, capacity)
    float32 field-major payload (rows: mean x, mean y, conic a, b, c,
    opacity, r, g, b).

    Returns (color (num_tiles, pix, 3), transmittance (num_tiles, pix, 1)),
    pix = tile_w * tile_h; T is the value after the last applied entry and
    0 for pixels past the image edge.
    """
    if cfg.blend_quad != "vpu":
        raise NotImplementedError(
            f"blend_quad={cfg.blend_quad!r} is not yet ported; use 'vpu'"
        )
    if payload.device.type == "cpu":
        return rasterize_reference(payload, tile_starts, tile_counts, grid_x,
                                   width, height, cfg)
    tw, th = cfg.tile_wh
    pix = tw * th
    if pix > MAX_TILE_PIXELS:
        raise ValueError(f"tile {tw}x{th} has more than {MAX_TILE_PIXELS} pixels")
    num_tiles = tile_starts.shape[0]
    require_cuda_tensors("rasterize_forward", payload, tile_starts, tile_counts)
    if payload.dtype != torch.float32 or payload.dim() != 2 \
            or payload.shape[0] != FIELDS:
        raise ValueError(
            f"payload must be ({FIELDS}, capacity) float32, got "
            f"{tuple(payload.shape)} {payload.dtype}")
    for name, t in (("tile_starts", tile_starts), ("tile_counts", tile_counts)):
        if t.dtype != torch.int32 or t.shape != (num_tiles,):
            raise ValueError(f"{name} must be ({num_tiles},) int32")

    dev = payload.device
    color = torch.empty((num_tiles, pix, 3), dtype=torch.float32, device=dev)
    trans = torch.empty((num_tiles, pix, 1), dtype=torch.float32, device=dev)
    if num_tiles == 0:
        return color, trans
    lib = KERNEL.lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rasterize_forward_launch(
            payload.data_ptr(), payload.shape[1], tile_starts.data_ptr(),
            tile_counts.data_ptr(), num_tiles, grid_x, width, height, tw, th,
            cfg.alpha_max, cfg.alpha_min, cfg.transmittance_eps,
            color.data_ptr(), trans.data_ptr(), stream,
        )
    KERNEL.check(err, "rasterize_forward_launch")
    KERNEL.launches += 1
    return color, trans


class _RasterizeTiles(torch.autograd.Function):
    @staticmethod
    def forward(ctx, payload, tile_starts, tile_counts, grid_x, width, height,
                cfg):
        return rasterize_forward(payload, tile_starts, tile_counts, grid_x,
                                 width, height, cfg)

    @staticmethod
    def backward(ctx, d_color, d_trans):
        raise NotImplementedError(
            "rasterize_tiles has no backward yet: the backward blend kernel "
            "(ROADMAP.md queue B, item 2) is not ported"
        )


def rasterize_tiles(payload, tile_starts, tile_counts, grid_x: int,
                    width: int, height: int, cfg: RenderConfig):
    """Tile rasterization as an autograd Function (forward only for now).

    Returns (color (num_tiles, pix, 3), transmittance (num_tiles, pix, 1)).
    """
    return _RasterizeTiles.apply(payload, tile_starts, tile_counts, grid_x,
                                 width, height, cfg)
