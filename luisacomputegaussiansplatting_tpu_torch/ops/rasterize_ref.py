"""The plain PyTorch rasterizer, forward and backward (port of
``ops/rasterize_ref.py``; the backward is the plain version of the backward
blend kernel).

Blend rules of the reference (lcgs/src/gs_tile_splatter/shader.cpp:249-274):
alpha = min(alpha_max, op * exp(power)); an entry is skipped when power > 0
or alpha < alpha_min; a pixel stops, without applying the entry, once its
transmittance would fall below transmittance_eps, and stays stopped.
Front-to-back blending is written as a cumulative log-transmittance
S_j = sum_{k<=j} log1p(-alpha_k) over each tile's range, so "stop at j*" is
the per-entry predicate exp(S_j) >= eps.

``blend_quad="mxu"`` evaluates alpha as the JAX kernels' ``_chunk_blend``
does (ops/rasterize_pallas.py:204-227): power' = power + ln(opacity) as a
polynomial in the tile-local pixel (xl, yl) with per-entry coefficients,
alpha = exp(power'), and the entry is kept while power' <= ln(opacity) +
POWER_GUARD in place of power <= 0. Everything after alpha is shared.

Unlike the JAX version (one global (entries, pix) matrix and a global
cumsum), tiles are processed in batches whose (tiles x longest range x
pixels) work tensor stays under a fixed element budget, so the card can run
it at full frame size as the reference the CUDA kernel is held against.
The scan runs per tile, sequentially along the entries.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import POWER_GUARD, RenderConfig

FIELDS = 9  # payload rows: mean x, mean y, conic a, b, c, opacity, r, g, b

#: elements of one (tiles, entries, pixels) work tensor per batch; a batch
#: holds about fifteen such tensors at once
BATCH_ELEMENTS = {"cuda": 1 << 24, "cpu": 1 << 21}


class TilePixels(NamedTuple):
    """The pixels of a batch of B tiles: float32 global coordinates and the
    initial transmittance (B, pix), and each tile's origin (B, 1)."""

    px: torch.Tensor
    py: torch.Tensor
    t0: torch.Tensor  # 1 inside the image, 0 past its edge
    x0: torch.Tensor  # tile column * tile_w
    y0: torch.Tensor  # tile row * tile_h


def tile_pixel_coords(tiles, grid_x: int, width: int, height: int,
                      tile_w: int, tile_h: int,
                      tile_offset: int = 0) -> TilePixels:
    """The pixels of ``tiles``, pixel p at (p % tile_w, p // tile_w) of its
    tile; pixels past the image edge start at T = 0 (the reference's
    ``inside`` predicate). Local tile i is global tile ``tile_offset + i``
    (a band of a sharded frame, ``parallel/render_sharded.py``)."""
    p = torch.arange(tile_w * tile_h, device=tiles.device)
    tiles = tiles.to(torch.int64) + tile_offset
    x0 = (tiles % grid_x)[:, None] * tile_w
    y0 = (tiles // grid_x)[:, None] * tile_h
    ix = x0 + p % tile_w
    iy = y0 + p // tile_w
    t0 = ((ix < width) & (iy < height)).to(torch.float32)
    f32 = torch.float32
    return TilePixels(ix.to(f32), iy.to(f32), t0, x0.to(f32), y0.to(f32))


class _Replay(NamedTuple):
    """The forward blend of a batch of B tiles over its n longest range, as
    (B, n) and (B, n, pix) tensors."""

    f: torch.Tensor  # (9, B, n) payload fields of the entries
    in_range: torch.Tensor  # (B, n) entry inside its tile's range
    idx: torch.Tensor  # (B, n) entry's payload slot (0 outside the range)
    dx: torch.Tensor  # (B, n, pix) mean x - pixel x
    dy: torch.Tensor
    g: torch.Tensor | None  # vpu: exp(power) where power <= 0; mxu: None
    raw: torch.Tensor  # alpha before the alpha_max clamp
    alpha: torch.Tensor  # 0 where not live
    live: torch.Tensor  # power test passed, alpha >= alpha_min, in range
    t_after: torch.Tensor  # transmittance after the entry
    t_before: torch.Tensor
    applied: torch.Tensor  # live and not past the pixel's stop
    w: torch.Tensor  # blend weight t_before * alpha where applied


def _mxu_alpha(f, pixels: TilePixels):
    """(raw alpha, power test) of blend_quad="mxu": the JAX kernels'
    tile-local polynomial with ln(opacity) folded into its constant term,
    in the op order the CUDA kernels repeat (csrc/blend_mxu.cuh)."""
    mx, my, ca, cb, cc, op = (f[i][:, :, None] for i in range(6))
    mxl = mx - pixels.x0[:, :, None]  # (B, n, 1) tile-local means
    myl = my - pixels.y0[:, :, None]
    # the clamp keeps padding (opacity 0) finite: alpha ~ 1e-30
    ln_op = torch.log(torch.clamp(op, min=1e-30))
    a0 = -0.5 * (ca * mxl * mxl + cc * myl * myl) - cb * mxl * myl + ln_op
    bx = ca * mxl + cb * myl
    by = cc * myl + cb * mxl
    xl = (pixels.px - pixels.x0)[:, None, :]  # (B, 1, pix), exact
    yl = (pixels.py - pixels.y0)[:, None, :]
    powerp = (a0 + bx * xl + by * yl + (-0.5 * ca) * (xl * xl)
              + (-0.5 * cc) * (yl * yl) + (-cb) * (xl * yl))
    return torch.exp(powerp), powerp <= ln_op + POWER_GUARD


def replay(payload, starts, counts, pixels: TilePixels, cfg: RenderConfig):
    """Replay the blend of a batch of tiles: payload (9, capacity),
    starts/counts (B,) int64, the tiles' pixels. Differentiable; the
    backward and the kernels' pair counts read it too."""
    px, py, t0 = pixels.px, pixels.py, pixels.t0
    n = int(counts.max()) if counts.numel() else 0
    j = torch.arange(n, device=payload.device)
    in_range = j[None, :] < counts[:, None]  # (B, n)
    idx = torch.where(in_range, starts[:, None] + j[None, :],
                      torch.zeros_like(starts)[:, None])
    f = payload[:, idx]  # (9, B, n)
    mx, my, ca, cb, cc, op = (f[i][:, :, None] for i in range(6))

    dx = mx - px[:, None, :]  # (B, n, pix)
    dy = my - py[:, None, :]
    if cfg.blend_quad == "mxu":
        g = None
        raw, pow_ok = _mxu_alpha(f, pixels)
    else:
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        # power > 0 is never live; the clamp keeps exp (and its gradient)
        # finite
        g = torch.exp(torch.clamp(power, max=0.0))
        raw = op * g
        pow_ok = power <= 0.0
    alpha = torch.clamp(raw, max=cfg.alpha_max)
    live = pow_ok & (alpha >= cfg.alpha_min) & in_range[:, :, None]
    alpha = torch.where(live, alpha, torch.zeros_like(alpha))

    log1ma = torch.log1p(-alpha)
    s_inc = torch.cumsum(log1ma, dim=1)  # per tile, along its entries
    t_after = t0[:, None, :] * torch.exp(s_inc)
    t_before = t_after / (1.0 - alpha)
    applied = (t_after >= cfg.transmittance_eps) & (alpha > 0.0)
    w = torch.where(applied, t_before * alpha, torch.zeros_like(alpha))
    return _Replay(f, in_range, idx, dx, dy, g, raw, alpha, live, t_after,
                   t_before, applied, w)


def _blend_batch(payload, starts, counts, pixels: TilePixels,
                 cfg: RenderConfig):
    """Blend a batch of B tiles: payload (9, capacity), starts/counts (B,)
    int64 on the device, the tiles' pixels. Returns ((B, pix, 3) colour,
    (B, pix) transmittance)."""
    b, pix = pixels.px.shape
    t0 = pixels.t0
    if not counts.numel() or int(counts.max()) == 0:
        return t0.new_zeros((b, pix, 3)), t0.clone()
    r = replay(payload, starts, counts, pixels, cfg)
    color = torch.stack(
        [torch.sum(r.w * r.f[6 + c][:, :, None], dim=1) for c in range(3)],
        dim=-1,
    )
    # the chain is monotone, so the last applied value is the minimum
    t_fin = torch.where(r.applied, r.t_after,
                        t0[:, None, :].expand_as(r.t_after))
    return color, torch.amin(t_fin, dim=1)


def _tile_batches(tile_counts, pix: int, device, budget_share: int = 1):
    """Tile indices in batches, longest ranges first (so each batch pads
    little), each batch's (tiles x longest range x pixels) work tensor under
    the element budget; one host read of the counts sizes the batches."""
    counts = tile_counts.to(torch.int64)
    num_tiles = counts.shape[0]
    order = torch.argsort(counts, descending=True, stable=True)
    counts_host = counts[order].cpu().tolist()
    budget = BATCH_ELEMENTS.get(device.type, BATCH_ELEMENTS["cpu"]) // budget_share
    done = 0
    while done < num_tiles:
        longest = max(counts_host[done], 1)
        b = max(1, min(num_tiles - done, budget // (longest * pix)))
        yield order[done:done + b]
        done += b


def rasterize_reference(payload, tile_starts, tile_counts, grid_x: int,
                        width: int, height: int, cfg: RenderConfig,
                        tile_offset: int = 0):
    """Blend every tile's range [start, start + count) of the (9, capacity)
    field-major payload. Works for both pack modes: "chunk" padding entries
    carry opacity 0 and never contribute. Local tile i lies at global tile
    ``tile_offset + i`` of the ``grid_x``-wide grid.

    Returns (color (num_tiles, pix, 3), transmittance (num_tiles, pix, 1))
    with pix = tile_w * tile_h. Plain differentiable torch.
    """
    tw, th = cfg.tile_wh
    pix = tw * th
    num_tiles = tile_starts.shape[0]
    dev = payload.device
    starts = tile_starts.to(torch.int64)
    counts = tile_counts.to(torch.int64)
    order, colors, trans = [], [], []
    for sel in _tile_batches(tile_counts, pix, dev):
        pixels = tile_pixel_coords(sel, grid_x, width, height, tw, th,
                                   tile_offset)
        c, t = _blend_batch(payload, starts[sel], counts[sel], pixels, cfg)
        order.append(sel)
        colors.append(c)
        trans.append(t)
    color = torch.empty((num_tiles, pix, 3), dtype=torch.float32, device=dev)
    t_out = torch.empty((num_tiles, pix), dtype=torch.float32, device=dev)
    if num_tiles:
        order = torch.cat(order)
        color = color.index_copy(0, order, torch.cat(colors))
        t_out = t_out.index_copy(0, order, torch.cat(trans))
    return color, t_out[:, :, None]


def _backward_batch(payload, starts, counts, res, pixels: TilePixels,
                    cfg: RenderConfig):
    """Per-entry gradients of a batch of B tiles: residual ``res`` (B, pix,
    8) = [dL/dC rgb, dL/dT, C_final rgb, T_final]. Returns ((B, n, 9)
    gradients, the replay)."""
    r = replay(payload, starts, counts, pixels, cfg)
    ca, cb, cc = (r.f[i][:, :, None] for i in (2, 3, 4))
    grad = res[:, None, :, 0:3]  # (B, 1, pix, 3) dL/dC
    b = sum(r.f[6 + c][:, :, None] * grad[..., c] for c in range(3))
    cg_total = (res[:, :, 4:7] * res[:, :, 0:3]).sum(-1)[:, None, :]
    tail = (res[:, :, 7] * res[:, :, 3])[:, None, :]
    # the TPU kernel's suffix identity: the entries behind j carry
    # dot(C_final, G) - sum_{k<=j} w_k b_k
    suffix = cg_total - torch.cumsum(r.w * b, dim=1)
    d_alpha = r.t_before * b - (suffix + tail) / (1.0 - r.alpha)
    d_alpha = torch.where(r.applied & (r.raw <= cfg.alpha_max), d_alpha,
                          torch.zeros_like(d_alpha))
    d_pow = d_alpha * r.alpha  # alpha = op * g where not clamped
    if r.g is None:
        # mxu forms no exp(power): sum_p d_alpha g = sum_p d_pow / op, as the
        # JAX kernel takes it (rasterize_pallas.py:643-644)
        op = r.f[5]
        d_op = torch.where(op > 0.0,
                           d_pow.sum(2) / torch.where(op > 0.0, op, 1.0), 0.0)
    else:
        d_op = (d_alpha * r.g).sum(2)
    # the geometry gradients per pixel in global coordinates (the
    # tile-local mxl - xl equals dx up to rounding)
    dx, dy = r.dx, r.dy
    out = torch.stack([
        -(d_pow * (ca * dx + cb * dy)).sum(2),
        -(d_pow * (cc * dy + cb * dx)).sum(2),
        -0.5 * (d_pow * dx * dx).sum(2),
        -(d_pow * dx * dy).sum(2),
        -0.5 * (d_pow * dy * dy).sum(2),
        d_op,
        *(torch.einsum("bnp,bp->bn", r.w, res[:, :, c]) for c in range(3)),
    ], dim=-1)
    return out, r


def rasterize_backward_reference(payload, tile_starts, tile_counts, residual,
                                 grid_x: int, width: int, height: int,
                                 cfg: RenderConfig, tile_offset: int = 0):
    """The plain backward blend: per-entry gradients (9, capacity) of the
    payload fields from the per-pixel ``residual`` (num_tiles, pix, 8) =
    [dL/dC rgb, dL/dT, C_final rgb, T_final]; ``tile_offset`` as in
    :func:`rasterize_reference`.

    The same tile batches as :func:`rasterize_reference`, with no autograd
    graph (autograd through the forward would keep every (entry, pixel)
    pair); only per-entry sums are kept. Entries that were clamped at
    ``alpha_max``, not applied or past the pixel's stop get zero, and so do
    slots outside every range.
    """
    tw, th = cfg.tile_wh
    pix = tw * th
    dev = payload.device
    starts = tile_starts.to(torch.int64)
    counts = tile_counts.to(torch.int64)
    grads = torch.zeros((FIELDS, payload.shape[1]), dtype=torch.float32,
                        device=dev)
    with torch.no_grad():
        # about twice the forward's live tensors per batch: half the budget
        for sel in _tile_batches(tile_counts, pix, dev, budget_share=2):
            pixels = tile_pixel_coords(sel, grid_x, width, height, tw, th,
                                       tile_offset)
            g, r = _backward_batch(payload, starts[sel], counts[sel],
                                   residual[sel], pixels, cfg)
            grads[:, r.idx[r.in_range]] = g[r.in_range].t()
    return grads
