"""The plain PyTorch rasterizer (port of ``ops/rasterize_ref.py``).

Blend rules of the reference (lcgs/src/gs_tile_splatter/shader.cpp:249-274):
alpha = min(alpha_max, op * exp(power)); an entry is skipped when power > 0
or alpha < alpha_min; a pixel stops, without applying the entry, once its
transmittance would fall below transmittance_eps, and stays stopped.
Front-to-back blending is written as a cumulative log-transmittance
S_j = sum_{k<=j} log1p(-alpha_k) over each tile's range, so "stop at j*" is
the per-entry predicate exp(S_j) >= eps.

Unlike the JAX version (one global (entries, pix) matrix and a global
cumsum), tiles are processed in batches whose (tiles x longest range x
pixels) work tensor stays under a fixed element budget, so the card can run
it at full frame size as the reference the CUDA kernel is held against.
The scan runs per tile, sequentially along the entries.
"""

from __future__ import annotations

import torch

from ..config import RenderConfig

FIELDS = 9  # payload rows: mean x, mean y, conic a, b, c, opacity, r, g, b

#: elements of one (tiles, entries, pixels) work tensor per batch; a batch
#: holds about fifteen such tensors at once
BATCH_ELEMENTS = {"cuda": 1 << 24, "cpu": 1 << 21}


def tile_pixel_coords(tiles, grid_x: int, width: int, height: int,
                      tile_w: int, tile_h: int):
    """(px, py, t0) of shape (len(tiles), tile_w*tile_h): float32 global pixel
    coordinates and the initial transmittance (1 inside the image, 0 for
    pixels past its edge — the reference's ``inside`` predicate)."""
    p = torch.arange(tile_w * tile_h, device=tiles.device)
    tiles = tiles.to(torch.int64)
    ix = (tiles % grid_x)[:, None] * tile_w + p % tile_w
    iy = (tiles // grid_x)[:, None] * tile_h + p // tile_w
    t0 = ((ix < width) & (iy < height)).to(torch.float32)
    return ix.to(torch.float32), iy.to(torch.float32), t0


def _blend_batch(payload, starts, counts, px, py, t0, cfg: RenderConfig):
    """Blend a batch of B tiles: payload (9, capacity), starts/counts (B,)
    int64 on the device, pixel coords (B, pix). Returns ((B, pix, 3) colour,
    (B, pix) transmittance)."""
    n = int(counts.max()) if counts.numel() else 0
    b, pix = px.shape
    if n == 0:
        return px.new_zeros((b, pix, 3)), t0.clone()
    j = torch.arange(n, device=payload.device)
    in_range = j[None, :] < counts[:, None]  # (B, n)
    idx = torch.where(in_range, starts[:, None] + j[None, :],
                      torch.zeros_like(starts)[:, None])
    f = payload[:, idx]  # (9, B, n)
    mx, my, ca, cb, cc, op = (f[i][:, :, None] for i in range(6))

    dx = mx - px[:, None, :]  # (B, n, pix)
    dy = my - py[:, None, :]
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    alpha = torch.clamp(op * torch.exp(power), max=cfg.alpha_max)
    live = (power <= 0.0) & (alpha >= cfg.alpha_min) & in_range[:, :, None]
    alpha = torch.where(live, alpha, torch.zeros_like(alpha))

    log1ma = torch.log1p(-alpha)
    s_inc = torch.cumsum(log1ma, dim=1)  # per tile, along its entries
    t_after = t0[:, None, :] * torch.exp(s_inc)
    t_before = t_after / (1.0 - alpha)
    applied = (t_after >= cfg.transmittance_eps) & (alpha > 0.0)
    w = torch.where(applied, t_before * alpha, torch.zeros_like(alpha))

    color = torch.stack(
        [torch.sum(w * f[6 + c][:, :, None], dim=1) for c in range(3)], dim=-1
    )
    # the chain is monotone, so the last applied value is the minimum
    t_fin = torch.where(applied, t_after, t0[:, None, :].expand_as(t_after))
    return color, torch.amin(t_fin, dim=1)


def rasterize_reference(payload, tile_starts, tile_counts, grid_x: int,
                        width: int, height: int, cfg: RenderConfig):
    """Blend every tile's range [start, start + count) of the (9, capacity)
    field-major payload. Works for both pack modes: "chunk" padding entries
    carry opacity 0 and never contribute.

    Returns (color (num_tiles, pix, 3), transmittance (num_tiles, pix, 1))
    with pix = tile_w * tile_h. Plain differentiable torch.
    """
    tw, th = cfg.tile_wh
    pix = tw * th
    num_tiles = tile_starts.shape[0]
    dev = payload.device
    starts = tile_starts.to(torch.int64)
    counts = tile_counts.to(torch.int64)
    # longest ranges first, so each batch pads little; one host read of
    # the counts sizes the batches
    order = torch.argsort(counts, descending=True, stable=True)
    counts_host = counts[order].cpu().tolist()

    budget = BATCH_ELEMENTS.get(dev.type, BATCH_ELEMENTS["cpu"])
    colors, trans, done = [], [], 0
    while done < num_tiles:
        longest = max(counts_host[done], 1)
        b = max(1, min(num_tiles - done, budget // (longest * pix)))
        sel = order[done:done + b]
        px, py, t0 = tile_pixel_coords(sel, grid_x, width, height, tw, th)
        c, t = _blend_batch(payload, starts[sel], counts[sel], px, py, t0, cfg)
        colors.append(c)
        trans.append(t)
        done += b
    color = torch.empty((num_tiles, pix, 3), dtype=torch.float32, device=dev)
    t_out = torch.empty((num_tiles, pix), dtype=torch.float32, device=dev)
    if num_tiles:
        color = color.index_copy(0, order, torch.cat(colors))
        t_out = t_out.index_copy(0, order, torch.cat(trans))
    return color, t_out[:, :, None]
