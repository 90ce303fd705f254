"""Tile-rect expansion with the hand-written CUDA kernel (counterpart of
``ops/expand_pallas.py``).

``expand_entries_kernel`` has the contract of ``binning.expand_entries``:
for every output slot below ``max_pairs`` the owning gaussian (slots are laid
out at the exclusive cumsum of ``tiles_touched``), its tile (y-outer,
x-inner over the rect), depth and gid, with the optional exact ellipse-tile
cull; invalid slots are (num_tiles, +inf, -1). On a CUDA tensor it launches
``csrc/expand.cu`` and its output equals the plain version bit for bit; on a
CPU tensor it runs the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import KernelLib, require_cuda_tensors
from .projection import _tile_wh

_p, _i, _i64, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float

KERNEL = KernelLib("expand", {
    "expand_entries_launch": (
        ctypes.c_int,
        [_p, _p, _p, _p, _p, _p, _p, _p, _i64, _i64, _i, _i, _i, _i, _f,
         _p, _p, _p, _p, _p],
    ),
})


def ellipse_tile_reaches(mx, my, ca, cb, cc, op, x0, x1, y0, y1, alpha_min):
    """Can any pixel centre of the box [x0,x1]x[y0,y1] receive
    alpha = op * exp(-q) >= alpha_min? The minimum of the convex quadratic
    q(d) = 0.5 d^T conic d over the box is 0 if the mean is inside, else the
    best of the four edge-constrained minimisers. ``csrc/expand.cu`` repeats
    this op for op; keep the two in step."""
    inside = (mx >= x0) & (mx <= x1) & (my >= y0) & (my <= y1)

    def q(dx, dy):
        return 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy

    def edge_x(xe):
        dx = xe - mx
        ys = torch.clamp(my - (cb / torch.clamp(cc, min=1e-12)) * dx, y0, y1)
        return q(dx, ys - my)

    def edge_y(ye):
        dy = ye - my
        xs = torch.clamp(mx - (cb / torch.clamp(ca, min=1e-12)) * dy, x0, x1)
        return q(xs - mx, dy)

    edges = torch.minimum(
        torch.minimum(edge_x(x0), edge_x(x1)),
        torch.minimum(edge_y(y0), edge_y(y1)),
    )
    q_min = torch.where(inside, torch.zeros_like(edges), edges)
    # alpha >= alpha_min  <=>  q <= log(op / alpha_min); the divisor is a
    # device tensor: torch turns division by a Python scalar on the GPU
    # into a multiplication by its reciprocal, which rounds differently
    return q_min <= torch.log(
        torch.clamp(op, min=1e-12) / op.new_full((), alpha_min)
    )


INT32_MAX = 2**31 - 1


def prefix_sums(tiles_touched):
    """(int32 counts, their int64 inclusive cumsum, their () float32 sum):
    the torch ops of the slot layout, which the plain expansion
    (``saturated_ends``) and the kernel's launch share so that both see the
    same bits."""
    counts = tiles_touched.to(torch.int32)
    return (counts, torch.cumsum(counts, 0, dtype=torch.int64),
            torch.sum(counts.to(torch.float32)))


def saturated_ends(tiles_touched):
    """(int64 inclusive cumsum of tiles_touched, () int64 total).

    The total is pinned to 2^31 - 1 where an f32 re-sum reaches it, exactly
    as the JAX package guards its int32 cumsum (binning._saturate_total), so
    both packages raise ``overflow`` on the same scenes. ``csrc/expand.cu``
    computes the same total from the same cumsum and sum."""
    _, ends, total_f = prefix_sums(tiles_touched)
    total = ends[-1] if ends.shape[0] > 0 else ends.new_zeros(())
    total = torch.where(total_f >= float(INT32_MAX),
                        total.new_full((), INT32_MAX), total)
    return ends, torch.clamp(total, max=INT32_MAX)


def expand_entries_kernel(proj, grid_x: int, num_tiles: int, max_pairs: int,
                          opacities=None, tile=16,
                          alpha_min: float = 1.0 / 255.0):
    """Returns (tile_id int32, depth f32, gid int32) of shape (max_pairs,)
    and the () int64 saturated total. CPU tensors take the plain version."""
    if proj.depth.device.type == "cpu":
        from .binning import expand_entries

        return expand_entries(proj, grid_x, num_tiles, max_pairs, opacities,
                              tile, alpha_min)
    _, ends, total_f = prefix_sums(proj.tiles_touched)
    return _launch_expand(ends, total_f, proj, grid_x, num_tiles, max_pairs,
                          opacities, tile, alpha_min)


def _launch_expand(ends, total_f, proj, grid_x: int, num_tiles: int,
                   max_pairs: int, opacities, tile, alpha_min: float):
    """``expand_entries_kernel``'s launch on the output of ``prefix_sums``
    (``chip_smoke.py`` times the two apart); the kernel saturates the total
    as ``saturated_ends`` does. ``max_pairs`` is at most 2^31 - 33 (the
    kernel's slots are int32)."""
    if not 0 <= max_pairs <= INT32_MAX - 32:
        raise ValueError(f"expand_entries_kernel: max_pairs {max_pairs} is "
                         f"not in [0, {INT32_MAX - 32}]")
    tw, th = _tile_wh(tile)
    rect_min = proj.rect_min.detach().to(torch.int32).contiguous()
    rect_max = proj.rect_max.detach().to(torch.int32).contiguous()
    depth = proj.depth.detach().to(torch.float32).contiguous()
    tensors = [ends, total_f, rect_min, rect_max, depth]
    cull = opacities is not None
    if cull:
        means2d = proj.means2d.detach().to(torch.float32).contiguous()
        conic = proj.conic.detach().to(torch.float32).contiguous()
        op = opacities.detach().reshape(-1).to(torch.float32).contiguous()
        tensors += [means2d, conic, op]
    require_cuda_tensors("expand_entries_kernel", *tensors)
    p = depth.shape[0]
    for t, shape in ((rect_min, (p, 2)), (rect_max, (p, 2)), (ends, (p,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"expand_entries_kernel: shape {tuple(t.shape)} != {shape}")
    if cull and (means2d.shape != (p, 2) or conic.shape != (p, 3)
                 or op.shape != (p,)):
        raise ValueError("expand_entries_kernel: cull inputs do not match P")

    dev = depth.device
    out_tile = torch.empty((max_pairs,), dtype=torch.int32, device=dev)
    out_depth = torch.empty((max_pairs,), dtype=torch.float32, device=dev)
    out_gid = torch.empty((max_pairs,), dtype=torch.int32, device=dev)
    total = torch.empty((), dtype=torch.int64, device=dev)
    lib = KERNEL.lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.expand_entries_launch(
            ends.data_ptr(), total_f.data_ptr(), rect_min.data_ptr(),
            rect_max.data_ptr(), depth.data_ptr(),
            means2d.data_ptr() if cull else None,
            conic.data_ptr() if cull else None,
            op.data_ptr() if cull else None,
            p, max_pairs, grid_x, num_tiles, tw, th, alpha_min,
            out_tile.data_ptr(), out_depth.data_ptr(), out_gid.data_ptr(),
            total.data_ptr(), stream,
        )
    KERNEL.check(err, "expand_entries_launch")
    KERNEL.launched()
    return out_tile, out_depth, out_gid, total
