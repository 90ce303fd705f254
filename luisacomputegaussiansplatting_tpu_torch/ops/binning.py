"""Tile binning: gaussians -> (tile, depth)-sorted splat entries (port of
``ops/binning.py``).

The reference's four stages (lcgs/src/gs_tile_splatter/impl.cpp:87-156):
tiles_touched counts, an inclusive scan, the variable-fanout key scatter
(shad_copy_with_keys) and a 64-bit radix sort over (tile << 32 | depth bits)
keys, then range detection. Here the expansion is the CUDA kernel of
``ops/expand.py`` on the GPU (its plain version, :func:`expand_entries`, on
the CPU); the sort is ``torch.sort`` on the reference's own 64-bit key; the
capacities are static and overflow is flagged, exactly as in the JAX package,
so entry streams compare slot for slot.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import CHUNK
from ..utils.profiling import count, span
from .expand import ellipse_tile_reaches, expand_entries_kernel, saturated_ends
from .projection import ProjectedGaussians, _tile_wh


class BinnedGaussians(NamedTuple):
    """Entries sorted by (tile, depth), each tile's range padded to CHUNK.

    ``entry_gid[i] == -1`` marks padding; ``tile_starts`` are CHUNK-aligned
    and ``tile_counts`` multiples of CHUNK."""

    entry_gid: torch.Tensor  # (capacity,) int32
    entry_tile: torch.Tensor  # (capacity,) int32, -1 = pad
    tile_starts: torch.Tensor  # (num_tiles,) int32
    tile_counts: torch.Tensor  # (num_tiles,) int32
    num_rendered: torch.Tensor  # () int32 entries kept after cull and trim
    overflow: torch.Tensor  # () bool: AABB slots exceeded max_pairs


class NoPackBinned(NamedTuple):
    """Entries sorted by (tile, depth) with raw ranges; ``entry_gid`` is the
    sorted gid stream plus CHUNK slots of -1 tail padding."""

    entry_gid: torch.Tensor  # (max_pairs + CHUNK,) int32
    entry_tile: torch.Tensor  # (max_pairs + CHUNK,) int32
    tile_starts: torch.Tensor  # (num_tiles,) int32 (not aligned)
    tile_counts: torch.Tensor  # (num_tiles,) int32 (not padded)
    num_rendered: torch.Tensor  # () int32
    overflow: torch.Tensor  # () bool


def forward_fill_ids(starts, valid, capacity: int):
    """slot -> source row: scatter row ids at their start offsets (rows with
    ``valid`` False, or starting at or past ``capacity``, are dropped) and
    forward-fill with an inclusive cummax."""
    n = starts.shape[0]
    dev = starts.device
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    idx = torch.where(valid & (starts < capacity), starts.to(torch.int64),
                      torch.full_like(starts, capacity, dtype=torch.int64))
    heads = torch.zeros((capacity + 1,), dtype=torch.int32, device=dev)
    heads.scatter_reduce_(0, idx, ids, reduce="amax")
    return torch.cummax(heads[:capacity], 0).values


def expand_entries(proj: ProjectedGaussians, grid_x: int, num_tiles: int,
                   max_pairs: int, opacities=None, tile=16,
                   alpha_min: float = 1.0 / 255.0):
    """The plain expansion: one entry per touched tile of each gaussian.

    Returns (tile_id int32, depth f32, gid int32) of shape (max_pairs,) and
    the () int64 saturated total; invalid slots are (num_tiles, +inf, -1).
    Emission order within a gaussian is y-outer/x-inner (reference
    gs_tile_splatter/shader.cpp:55-67). With ``opacities``, entries whose
    tile cannot receive alpha >= alpha_min anywhere are invalidated
    (``expand.ellipse_tile_reaches``). All per-slot lookups are one row
    gather from a packed int32 table.
    """
    tw, th = _tile_wh(tile)
    dev = proj.depth.device
    ends, total = saturated_ends(proj.tiles_touched)
    counts = proj.tiles_touched.to(torch.int64)
    starts = ends - counts
    int32_max = 2**31 - 1

    def fbits(x):
        return x.detach().to(torch.float32).contiguous().view(torch.int32)

    rect_min = proj.rect_min.to(torch.int32)
    rect_max = proj.rect_max.to(torch.int32)
    # only slots < min(total, max_pairs) <= 2^31 - 1 are valid, and their
    # owners start below them: clamping keeps the table int32
    cols = [
        torch.clamp(starts, max=int32_max).to(torch.int32),
        rect_min[:, 0],
        rect_min[:, 1],
        torch.clamp(rect_max[:, 0] - rect_min[:, 0], min=1),
        fbits(proj.depth),
    ]
    if opacities is not None:
        cols += [fbits(proj.means2d[:, 0]), fbits(proj.means2d[:, 1]),
                 fbits(proj.conic[:, 0]), fbits(proj.conic[:, 1]),
                 fbits(proj.conic[:, 2]), fbits(opacities.reshape(-1))]
    table = torch.stack(cols, dim=1)  # (P, 5 or 11) int32

    slot_gid = forward_fill_ids(starts, proj.valid, max_pairs)
    slot = torch.arange(max_pairs, dtype=torch.int32, device=dev)
    slot_valid = slot < torch.clamp(total, max=max_pairs)

    if table.shape[0] == 0:  # no gaussians: a dummy row, every slot invalid
        table = torch.zeros((1, table.shape[1]), dtype=torch.int32, device=dev)
        table[:, 3] = 1
    g = table[slot_gid.to(torch.int64)]  # (L, K): the one row gather
    local = slot - g[:, 0]
    rect_w = g[:, 3]
    tile_x = g[:, 1] + torch.remainder(local, rect_w)
    tile_y = g[:, 2] + torch.div(local, rect_w, rounding_mode="floor")

    if opacities is not None:
        def f32(col):
            return g[:, col].contiguous().view(torch.float32)

        x0 = (tile_x * tw).to(torch.float32)
        x1 = x0 + (tw - 1)
        y0 = (tile_y * th).to(torch.float32)
        y1 = y0 + (th - 1)
        slot_valid = slot_valid & ellipse_tile_reaches(
            f32(5), f32(6), f32(7), f32(8), f32(9), f32(10),
            x0, x1, y0, y1, alpha_min,
        )

    tile_id = torch.where(slot_valid, tile_x + tile_y * grid_x,
                          torch.full_like(tile_x, num_tiles))
    depth = torch.where(slot_valid, g[:, 4].contiguous().view(torch.float32),
                        torch.full((max_pairs,), float("inf"), device=dev))
    gid = torch.where(slot_valid, slot_gid, torch.full_like(slot_gid, -1))
    return tile_id, depth, gid, total


def expand_entries_auto(proj: ProjectedGaussians, grid_x: int, num_tiles: int,
                        max_pairs: int, opacities=None, tile: int = 16,
                        alpha_min: float = 1.0 / 255.0,
                        expansion: str = "auto", interpret=None):
    """"auto"/"pallas": the CUDA kernel for GPU tensors (``ops/expand.py``,
    the plain version for CPU tensors); "xla": the plain version on every
    device. ``interpret`` is accepted for parity and ignored."""
    if expansion not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown expansion mode: {expansion!r}")
    if expansion == "xla":
        return expand_entries(proj, grid_x, num_tiles, max_pairs, opacities,
                              tile, alpha_min)
    return expand_entries_kernel(proj, grid_x, num_tiles, max_pairs,
                                 opacities, tile, alpha_min)


def pack_ranges(sorted_tile, num_tiles: int, capacity: int):
    """CHUNK-pad each tile's sorted range.

    Returns (src, in_range, slot_tile, tile_starts, tile_counts): per output
    slot its index into the sorted stream, whether it holds an entry (False
    = padding) and its owning tile; per tile its CHUNK-aligned start and
    padded length (int32).
    """
    dev = sorted_tile.device
    sorted_tile = sorted_tile.to(torch.int32).contiguous()
    tids = torch.arange(num_tiles, dtype=torch.int32, device=dev)
    range_start = torch.searchsorted(sorted_tile, tids, right=False)
    range_end = torch.searchsorted(sorted_tile, tids, right=True)
    tile_len = range_end - range_start

    padded_len = (tile_len + CHUNK - 1) // CHUNK * CHUNK
    padded_end = torch.cumsum(padded_len, 0)
    padded_start = padded_end - padded_len

    slot = torch.arange(capacity, dtype=torch.int64, device=dev)
    # owner of each slot: the first tile whose padded range ends past it (a
    # binary search; torch.cummax, the JAX package's forward fill, takes
    # ~45 ms at 17M slots on an H100). Slots past the last range keep the
    # last non-empty tile, as the forward fill does.
    tids64 = tids.to(torch.int64)
    last = torch.amax(torch.where(padded_len > 0, tids64,
                                  torch.zeros_like(tids64)))
    slot_tile = torch.minimum(
        torch.searchsorted(padded_end, slot, right=True), last
    ).to(torch.int32)
    table = torch.stack([padded_start, tile_len, range_start], dim=1)
    t = table[slot_tile.to(torch.int64)]  # (capacity, 3)
    local = slot - t[:, 0]
    in_range = (local < t[:, 1]) & (slot < padded_end[-1])
    src = torch.clamp(t[:, 2] + local, 0, sorted_tile.shape[0] - 1)
    return (src, in_range, slot_tile, padded_start.to(torch.int32),
            padded_len.to(torch.int32))


def pack_slot_inverse(sorted_tile, tile_starts, num_tiles: int, capacity: int):
    """Closed-form inverse of :func:`pack_ranges`' slot assignment: entry k
    of the ascending ``sorted_tile`` (tile t < num_tiles) sits at slot
    ``tile_starts[t] + k - range_start[t]``, since each tile's range is
    copied contiguously from its CHUNK-aligned padded start; entries with a
    sentinel tile (>= num_tiles) map to ``capacity``. Beside
    ``pack_ranges`` so that the layout and its inverse change together; the
    sharded backward (``parallel/exchange_vjp.py``) turns the pack gather's
    VJP into one row gather with it.

    Returns (L,) int32 slots.
    """
    dev = sorted_tile.device
    sorted_tile = sorted_tile.to(torch.int32).contiguous()
    tids = torch.arange(num_tiles, dtype=torch.int32, device=dev)
    range_start = torch.searchsorted(sorted_tile, tids, right=False,
                                     out_int32=True)
    k = torch.arange(sorted_tile.shape[0], dtype=torch.int32, device=dev)
    t_safe = torch.clamp(sorted_tile, 0, num_tiles - 1).to(torch.int64)
    # one row gather from the (T, 2) table over the entry stream
    table = torch.stack([tile_starts.to(torch.int32), range_start], dim=1)
    t = table[t_safe]
    return torch.where(sorted_tile < num_tiles, t[:, 0] + (k - t[:, 1]),
                       torch.full_like(k, capacity))


def _sort_entries(tile_id, depth, gid, num_tiles: int, sort_mode: str):
    """Sort entries by (tile, depth) -> (sorted_tile, sorted_gid).

    "2key": one stable sort on the reference's 64-bit key
    (tile << 32) | float_bits(depth) (gs_tile_splatter/shader.cpp:59-62):
    valid depths are >= near > 0 and invalid entries are (num_tiles, +inf),
    so bit order is value order and ties keep slot order.

    "fused": the JAX package's single 32-bit key, built bit for bit (tile
    in the top tb = bit_length(num_tiles + 1) bits, the depth's bit pattern
    quantised to the low 32 - tb), held in int64; falls back to "2key" when
    fewer than 12 depth bits remain.
    """
    tile64 = tile_id.to(torch.int64)
    dbits = depth.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    if sort_mode == "fused":
        db = 32 - (num_tiles + 1).bit_length()
        if db >= 12:
            dq = (dbits >> (31 - db)) & ((1 << db) - 1)
            key = ((tile64 << db) & 0xFFFFFFFF) | dq
            skey, order = torch.sort(key, stable=True)
            return (skey >> db).to(torch.int32), gid[order]
        sort_mode = "2key"
    if sort_mode != "2key":
        raise ValueError(f"unknown sort_mode: {sort_mode!r}")
    _, order = torch.sort((tile64 << 32) | dbits, stable=True)
    return tile_id[order], gid[order]


def _round_up_chunk(x: int) -> int:
    return (x + CHUNK - 1) // CHUNK * CHUNK


def _num_retained(sorted_tile, num_tiles: int):
    """Entries that survive into the rasterized stream (after cull and
    trim): valid entries have tile ids < num_tiles and sort first."""
    key = torch.tensor([num_tiles], dtype=torch.int32, device=sorted_tile.device)
    return torch.searchsorted(sorted_tile.to(torch.int32).contiguous(), key,
                              out_int32=True)[0]


def _expand_and_sort(proj, grid_x, num_tiles, max_pairs, opacities, tile,
                     alpha_min, expansion, max_sorted, sort_mode):
    """Expansion + sort + the optional post-sort trim; returns
    (sorted_tile, sorted_gid, overflow, the () saturated slot total)."""
    with span("render_view.expand"):
        tile_id, depth, gid, total = expand_entries_auto(
            proj, grid_x, num_tiles, max_pairs, opacities, tile, alpha_min,
            expansion,
        )
        overflow = total > max_pairs
    with span("render_view.sort"):
        sorted_tile, sorted_gid = _sort_entries(tile_id, depth, gid,
                                                num_tiles, sort_mode)
        # skip the trim when CHUNK rounding reaches max_pairs (as the JAX
        # package)
        if max_sorted is not None and _round_up_chunk(max_sorted) < max_pairs:
            cap = _round_up_chunk(max_sorted)
            overflow = overflow | (sorted_gid[cap] >= 0)  # a valid entry cut off
            sorted_tile = sorted_tile[:cap]
            sorted_gid = sorted_gid[:cap]
    return sorted_tile, sorted_gid, overflow, total


def _count_entries(total, num_rendered):
    """The binning counters: AABB slots before the cull, entries kept."""
    count("binning.aabb_slots", total)
    count("binning.kept_entries", num_rendered)


def bin_gaussians_nopack(proj: ProjectedGaussians, grid_x: int, grid_y: int,
                         max_pairs: int, opacities=None, tile: int = 16,
                         alpha_min: float = 1.0 / 255.0,
                         expansion: str = "auto",
                         max_sorted: int | None = None, interpret=None,
                         sort_mode: str = "2key") -> NoPackBinned:
    """Expand and sort; ranges stay unpadded (``pack_mode="none"``)."""
    num_tiles = grid_x * grid_y
    sorted_tile, sorted_gid, overflow, total = _expand_and_sort(
        proj, grid_x, num_tiles, max_pairs, opacities, tile, alpha_min,
        expansion, max_sorted, sort_mode,
    )
    with span("render_view.sort"):
        dev = sorted_tile.device
        sorted_tile = sorted_tile.contiguous()
        tids = torch.arange(num_tiles, dtype=torch.int32, device=dev)
        start = torch.searchsorted(sorted_tile, tids, right=False,
                                   out_int32=True)
        end = torch.searchsorted(sorted_tile, tids, right=True,
                                 out_int32=True)
        pad = torch.full((CHUNK,), -1, dtype=torch.int32, device=dev)
        binned = NoPackBinned(
            entry_gid=torch.cat([sorted_gid, pad]),
            entry_tile=torch.cat([sorted_tile,
                                  torch.full_like(pad, num_tiles)]),
            tile_starts=start,
            tile_counts=end - start,
            num_rendered=_num_retained(sorted_tile, num_tiles),
            overflow=overflow,
        )
    _count_entries(total, binned.num_rendered)
    return binned


def bin_gaussians(proj: ProjectedGaussians, grid_x: int, grid_y: int,
                  max_pairs: int, opacities=None, tile: int = 16,
                  alpha_min: float = 1.0 / 255.0, expansion: str = "auto",
                  max_sorted: int | None = None, interpret=None,
                  sort_mode: str = "2key") -> BinnedGaussians:
    """Expand, sort and CHUNK-pack entries; capacity is
    ``eff_pairs + num_tiles * CHUNK`` (eff_pairs = max_pairs, or the
    trimmed size)."""
    num_tiles = grid_x * grid_y
    sorted_tile, sorted_gid, overflow, total = _expand_and_sort(
        proj, grid_x, num_tiles, max_pairs, opacities, tile, alpha_min,
        expansion, max_sorted, sort_mode,
    )
    with span("render_view.sort"):
        capacity = sorted_tile.shape[0] + num_tiles * CHUNK
        src, in_range, slot_tile, tile_starts, tile_counts = pack_ranges(
            sorted_tile, num_tiles, capacity
        )
        entry_gid = torch.where(in_range, sorted_gid[src],
                                torch.full_like(slot_tile, -1))
        entry_tile = torch.where(in_range, slot_tile,
                                 torch.full_like(slot_tile, -1))
        binned = BinnedGaussians(
            entry_gid=entry_gid,
            entry_tile=entry_tile,
            tile_starts=tile_starts,
            tile_counts=tile_counts,
            num_rendered=_num_retained(sorted_tile, num_tiles),
            overflow=overflow,
        )
    _count_entries(total, binned.num_rendered)
    return binned
