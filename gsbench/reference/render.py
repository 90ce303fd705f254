"""The plain reference render: SH colours, projection, tile binning, the
payload gather and the front-to-back blend, forward and backward, in plain
PyTorch.

It follows the published 3DGS pipeline (Kerbl et al. 2023; the LuisaCompute
reference renderer's stages) as the program under test states it: the
same constants, the same entry order (tile, then depth), the same blend
rules (alpha = min(alpha_max, opacity * exp(power)), skipped below
alpha_min or for power > 0, a pixel stops once its transmittance would
fall below transmittance_eps). The arithmetic is written in the order of
the program's own plain versions, frozen here, so that a sound run agrees
to rounding. It imports nothing of the program.

``precision="bf16"`` is the control: every per-gaussian stage's output and
the payload are rounded to bfloat16, the precision one step below the
float32 that the configurations state.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

FIELDS = 9  # payload rows: mean x, mean y, conic a, b, c, opacity, r, g, b
CHUNK = 128  # tail padding of the unpacked entry stream
POWER_GUARD = 1e-3
INT32_MAX = 2**31 - 1
#: elements of one (tiles, entries, pixels) work tensor per blend batch
BATCH_ELEMENTS = {"cuda": 1 << 26, "cpu": 1 << 21}

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


class RenderSettings(NamedTuple):
    """The render settings of a configuration file, with the constants of
    the 3DGS pipeline."""

    tile: int
    max_pairs: int
    max_pairs_sorted: int | None
    tile_cull: bool
    sort_mode: str
    payload_dtype: str
    grad_reduce_dtype: str
    blend_quad: str
    near: float = 0.2
    lowpass: float = 0.3
    radius_sigma: float = 3.0
    alpha_max: float = 0.99
    alpha_min: float = 1.0 / 255.0
    transmittance_eps: float = 1e-4
    frustum_clamp: float = 1.3
    w_eps: float = 1e-6
    det_eps: float = 1e-6

    @classmethod
    def from_config(cls, rc: dict) -> "RenderSettings":
        if rc.get("pack_mode", "chunk") != "none":
            raise ValueError("the reference renders pack_mode='none' only")
        for key in ("tight_radius",):
            if rc.get(key):
                raise ValueError(f"the reference does not render {key}")
        if rc.get("rect_mode", "inria") != "inria":
            raise ValueError("the reference renders rect_mode='inria' only")
        return cls(tile=rc.get("tile", 16), max_pairs=rc["max_pairs"],
                   max_pairs_sorted=rc.get("max_pairs_sorted"),
                   tile_cull=rc.get("tile_cull", False),
                   sort_mode=rc.get("sort_mode", "2key"),
                   payload_dtype=rc.get("payload_dtype", "f32"),
                   grad_reduce_dtype=rc.get("grad_reduce_dtype", "f32"),
                   blend_quad=rc.get("blend_quad", "vpu"))


class View(NamedTuple):
    """A camera as float32 tensors: world->view (4, 4), position (3,),
    tan of the half fields of view ()."""

    view: torch.Tensor
    position: torch.Tensor
    tan_fovx: torch.Tensor
    tan_fovy: torch.Tensor


def bf16(x):
    """x rounded to bfloat16 values (round to nearest even), as float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def activate(means, log_scales, quats, opacity_logits, sh_dc, sh_rest):
    """Raw parameters -> (means, scales, unit quaternions, opacities, SH)."""
    qx, qy, qz, qw = quats.unbind(1)
    inv = torch.rsqrt(qx * qx + qy * qy + qz * qz + qw * qw)
    q = torch.stack([qx * inv, qy * inv, qz * inv, qw * inv], 1)
    return (means, torch.exp(log_scales), q, torch.sigmoid(opacity_logits),
            torch.cat([sh_dc, sh_rest], dim=1))


def sh_colors(means, sh, cam_pos, degree: int = 3):
    """(N, 3) RGB = clamp(sum_k Y_k(dir) sh_k + 0.5, 0, 1) for the unit
    direction from the camera to each mean."""
    mx, my, mz = means.unbind(1)
    dx, dy, dz = mx - cam_pos[0], my - cam_pos[1], mz - cam_pos[2]
    inv = 1.0 / torch.clamp(torch.sqrt(dx * dx + dy * dy + dz * dz), min=1e-12)
    x, y, z = dx * inv, dy * inv, dz * inv
    basis = [SH_C0 * torch.ones_like(x)]
    if degree >= 1:
        basis += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, zx = x * y, y * z, z * x
        basis += [SH_C2[0] * xy, SH_C2[1] * yz,
                  SH_C2[2] * (2.0 * zz - xx - yy), SH_C2[3] * zx,
                  SH_C2[4] * (xx - yy)]
    if degree >= 3:
        basis += [SH_C3[0] * y * (3.0 * xx - yy), SH_C3[1] * xy * z,
                  SH_C3[2] * y * (4.0 * zz - xx - yy),
                  SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
                  SH_C3[4] * x * (4.0 * zz - xx - yy),
                  SH_C3[5] * z * (xx - yy),
                  SH_C3[6] * x * (xx - 3.0 * yy)]
    n, k_tot = sh.shape[0], sh.shape[1]
    coeffs = sh.reshape(n, k_tot * 3).unbind(1)
    chans = []
    for c in range(3):
        acc = 0.5
        for i in range(len(basis)):
            acc = acc + basis[i] * coeffs[i * 3 + c]
        chans.append(torch.clamp(acc, 0.0, 1.0))
    return torch.stack(chans, 1)


def tile_grid(width: int, height: int, tile: int):
    return (width + tile - 1) // tile, (height + tile - 1) // tile


class Projected(NamedTuple):
    means2d: torch.Tensor  # (N, 2)
    depth: torch.Tensor  # (N,)
    conic: torch.Tensor  # (N, 3)
    radius: torch.Tensor  # (N,) int32
    rect_min: torch.Tensor  # (N, 2) int32
    rect_max: torch.Tensor  # (N, 2) int32
    tiles_touched: torch.Tensor  # (N,) int32
    valid: torch.Tensor  # (N,) bool


def project(means, scales, quats, cam: View, width: int, height: int,
            rs: RenderSettings) -> Projected:
    """World -> pixel centres, view depth, the EWA conic (focal-scaled
    Jacobian, V Sigma V^T, low-pass 0.3), the 3-sigma radius and the tile
    rectangle (the graphdeco clamp to the grid)."""
    view = cam.view
    v = view[:3, :3]
    tan_fovx, tan_fovy = cam.tan_fovx, cam.tan_fovy
    focal_x = width / (2.0 * tan_fovx)
    focal_y = height / (2.0 * tan_fovy)
    mx, my, mz = means.unbind(1)
    px = mx * v[0, 0] + my * v[0, 1] + mz * v[0, 2] + view[0, 3]
    py = mx * v[1, 0] + my * v[1, 1] + mz * v[1, 2] + view[1, 3]
    depth = mx * v[2, 0] + my * v[2, 1] + mz * v[2, 2] + view[2, 3]
    in_front = depth >= rs.near
    safe_z = torch.where(in_front, depth, torch.ones_like(depth))
    inv_w = 1.0 / (safe_z + rs.w_eps)
    pix_x = ((px / tan_fovx * inv_w + 1.0) * width - 1.0) * 0.5
    pix_y = ((py / tan_fovy * inv_w + 1.0) * height - 1.0) * 0.5
    means2d = torch.stack([pix_x, pix_y], 1)

    # Sigma = R S S^T R^T
    sx, sy, sz = scales.unbind(1)
    qx, qy, qz, qw = quats.unbind(1)
    r = [[1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw),
          2 * (qx * qz + qy * qw)],
         [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz),
          2 * (qy * qz - qx * qw)],
         [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw),
          1 - 2 * (qx * qx + qy * qy)]]
    s = (sx, sy, sz)
    m = [[r[i][j] * s[j] for j in range(3)] for i in range(3)]
    cov = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for k in range(i, 3):
            cov[i][k] = cov[k][i] = sum(m[i][j] * m[k][j] for j in range(3))
    # V Sigma V^T
    vv = [[v[i, j] for j in range(3)] for i in range(3)]
    tmp = [[sum(vv[i][j] * cov[j][k] for j in range(3)) for k in range(3)]
           for i in range(3)]
    sig = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for l in range(i, 3):
            sig[i][l] = sig[l][i] = sum(tmp[i][k] * vv[l][k] for k in range(3))
    # the linearisation point clamped into the widened frustum
    lim_x = rs.frustum_clamp * tan_fovx
    lim_y = rs.frustum_clamp * tan_fovy
    tx = torch.clamp(px / safe_z, -lim_x, lim_x) * safe_z
    ty = torch.clamp(py / safe_z, -lim_y, lim_y) * safe_z
    tz = safe_z
    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    j00 = focal_x * inv_z
    j02 = -focal_x * tx * inv_z2
    j11 = focal_y * inv_z
    j12 = -focal_y * ty * inv_z2
    s00, s01, s02 = sig[0][0], sig[0][1], sig[0][2]
    s11, s12, s22 = sig[1][1], sig[1][2], sig[2][2]
    a = j00 * (j00 * s00 + j02 * s02) + j02 * (j00 * s02 + j02 * s22)
    b = j00 * (j11 * s01 + j12 * s02) + j02 * (j11 * s12 + j12 * s22)
    c = j11 * (j11 * s11 + j12 * s12) + j12 * (j11 * s12 + j12 * s22)
    # low-pass, invert, 3-sigma radius
    a = a + rs.lowpass
    c = c + rs.lowpass
    det = a * c - b * b
    inv_det = 1.0 / (det + rs.det_eps)
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], 1)
    mid = 0.5 * (a + c)
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(rs.radius_sigma * torch.sqrt(mid + disc)).to(torch.int32)
    radius = torch.where(in_front, radius, torch.zeros_like(radius))

    grid_x, grid_y = tile_grid(width, height, rs.tile)
    t = rs.tile
    m2 = means2d.detach()
    rf = radius.to(torch.float32)
    lo_x = torch.floor((m2[:, 0] - rf) / t).to(torch.int32)
    lo_y = torch.floor((m2[:, 1] - rf) / t).to(torch.int32)
    hi_x = torch.floor((m2[:, 0] + rf + t - 1) / t).to(torch.int32)
    hi_y = torch.floor((m2[:, 1] + rf + t - 1) / t).to(torch.int32)
    rect_min = torch.stack([torch.clamp(lo_x, 0, grid_x - 1),
                            torch.clamp(lo_y, 0, grid_y - 1)], -1)
    rect_max = torch.stack([torch.clamp(hi_x, 0, grid_x),
                            torch.clamp(hi_y, 0, grid_y)], -1)
    touched = (torch.clamp(rect_max[:, 0] - rect_min[:, 0], min=0)
               * torch.clamp(rect_max[:, 1] - rect_min[:, 1], min=0))
    touched = torch.where(radius > 0, touched,
                          torch.zeros_like(touched)).to(torch.int32)
    return Projected(means2d, depth, conic, radius, rect_min, rect_max,
                     touched, touched > 0)


def tile_reaches(mx, my, ca, cb, cc, op, x0, x1, y0, y1, alpha_min):
    """Can any pixel centre of the box [x0,x1]x[y0,y1] receive
    op * exp(-q) >= alpha_min? q's minimum over the box is 0 with the mean
    inside, else the least of the four edge-constrained minimisers."""
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

    edges = torch.minimum(torch.minimum(edge_x(x0), edge_x(x1)),
                          torch.minimum(edge_y(y0), edge_y(y1)))
    q_min = torch.where(inside, torch.zeros_like(edges), edges)
    # the divisor is a device tensor: a Python scalar divisor is turned
    # into a multiplication by its reciprocal on the GPU
    return q_min <= torch.log(torch.clamp(op, min=1e-12)
                              / op.new_full((), alpha_min))


class Binned(NamedTuple):
    entry_gid: torch.Tensor  # (L + CHUNK,) int32, -1 = none
    tile_starts: torch.Tensor  # (T,) int32
    tile_counts: torch.Tensor  # (T,) int32
    num_rendered: int  # entries kept after the cull and the trim
    overflow: bool  # a slot or a kept entry past its capacity
    aabb: int  # slots of the rectangles before the cull (saturated)


def expand(p: Projected, grid_x: int, num_tiles: int, max_pairs: int,
           opacities, tile: int, alpha_min: float):
    """One entry per touched tile of each gaussian, y-outer x-inner over its
    rectangle, at the exclusive prefix sum of the counts; with
    ``opacities`` the entries whose tile no pixel of can reach alpha_min
    are dropped. Returns (tile id, depth, gid, saturated total); dropped
    and unused slots are (num_tiles, +inf, -1)."""
    dev = p.depth.device
    counts = p.tiles_touched.to(torch.int32)
    ends = torch.cumsum(counts, 0, dtype=torch.int64)
    total_f = torch.sum(counts.to(torch.float32))
    total = ends[-1] if ends.shape[0] else ends.new_zeros(())
    total = torch.where(total_f >= float(INT32_MAX),
                        total.new_full((), INT32_MAX), total)
    total = torch.clamp(total, max=INT32_MAX)
    starts = ends - counts.to(torch.int64)
    slot = torch.arange(max_pairs, dtype=torch.int64, device=dev)
    # the owner of a slot: the first gaussian whose range ends past it
    owner = torch.clamp(torch.searchsorted(ends, slot, right=True),
                        max=max(p.depth.shape[0] - 1, 0))
    slot_valid = slot < torch.clamp(total, max=max_pairs)
    local = slot - starts[owner]
    rect_min = p.rect_min[owner].to(torch.int64)
    rect_w = torch.clamp(p.rect_max[owner, 0].to(torch.int64)
                         - rect_min[:, 0], min=1)
    tile_x = rect_min[:, 0] + torch.remainder(local, rect_w)
    tile_y = rect_min[:, 1] + torch.div(local, rect_w, rounding_mode="floor")
    if opacities is not None:
        m2, cn = p.means2d.detach(), p.conic.detach()
        x0 = (tile_x * tile).to(torch.float32)
        y0 = (tile_y * tile).to(torch.float32)
        slot_valid = slot_valid & tile_reaches(
            m2[owner, 0], m2[owner, 1], cn[owner, 0], cn[owner, 1],
            cn[owner, 2], opacities.detach().reshape(-1)[owner],
            x0, x0 + (tile - 1), y0, y0 + (tile - 1), alpha_min)
    tile_id = torch.where(slot_valid, tile_x + tile_y * grid_x,
                          torch.full_like(tile_x, num_tiles)).to(torch.int32)
    depth = torch.where(slot_valid, p.depth.detach()[owner],
                        torch.full((max_pairs,), float("inf"), device=dev))
    gid = torch.where(slot_valid, owner,
                      torch.full_like(owner, -1)).to(torch.int32)
    return tile_id, depth, gid, total


def sort_entries(tile_id, depth, gid, num_tiles: int, sort_mode: str):
    """(tile, depth) order: "2key" sorts the 64-bit key (tile << 32 |
    depth bits); "fused" one key of the tile in the top bit_length(T + 1)
    bits and the depth bits quantised below (2key with under 12 left)."""
    tile64 = tile_id.to(torch.int64)
    dbits = depth.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    if sort_mode == "fused":
        db = 32 - (num_tiles + 1).bit_length()
        if db >= 12:
            dq = (dbits >> (31 - db)) & ((1 << db) - 1)
            key = ((tile64 << db) & 0xFFFFFFFF) | dq
            skey, order = torch.sort(key, stable=True)
            return (skey >> db).to(torch.int32), gid[order]
    elif sort_mode != "2key":
        raise ValueError(f"unknown sort_mode {sort_mode!r}")
    _, order = torch.sort((tile64 << 32) | dbits, stable=True)
    return tile_id[order], gid[order]


def bin_entries(p: Projected, grid_x: int, grid_y: int, rs: RenderSettings,
                cull_opacity) -> Binned:
    """Expansion, sort, the optional trim to ``max_pairs_sorted`` (rounded
    up to CHUNK) and each tile's raw range."""
    num_tiles = grid_x * grid_y
    tile_id, depth, gid, total = expand(
        p, grid_x, num_tiles, rs.max_pairs,
        cull_opacity if rs.tile_cull else None, rs.tile, rs.alpha_min)
    overflow = bool(total > rs.max_pairs)
    s_tile, s_gid = sort_entries(tile_id, depth, gid, num_tiles, rs.sort_mode)
    if rs.max_pairs_sorted is not None:
        cap = -(-rs.max_pairs_sorted // CHUNK) * CHUNK
        if cap < rs.max_pairs:
            overflow = overflow or bool(s_gid[cap] >= 0)
            s_tile, s_gid = s_tile[:cap], s_gid[:cap]
    s_tile = s_tile.contiguous()
    tids = torch.arange(num_tiles, dtype=torch.int32, device=s_tile.device)
    start = torch.searchsorted(s_tile, tids, right=False, out_int32=True)
    end = torch.searchsorted(s_tile, tids, right=True, out_int32=True)
    kept = int(torch.searchsorted(
        s_tile, torch.tensor([num_tiles], dtype=torch.int32,
                             device=s_tile.device))[0])
    pad = torch.full((CHUNK,), -1, dtype=torch.int32, device=s_tile.device)
    return Binned(torch.cat([s_gid, pad]), start, end - start, kept, overflow,
                  int(torch.clamp(total, max=rs.max_pairs)))


def segment_sum(ids, rows, n_out: int, dtype: str):
    """(L,) ids, (L, cols) rows -> (n_out, cols) float32 sums by
    ``index_add_``; ids outside [0, n_out) dropped; "bf16" rounds every
    row value before it is added."""
    keep = (ids >= 0) & (ids < n_out)
    key = torch.where(keep, ids, torch.full_like(ids, n_out)).to(torch.int64)
    if dtype == "bf16":
        rows = bf16(rows)
    vals = torch.where(keep[:, None], rows, torch.zeros((), device=rows.device))
    out = torch.zeros((n_out + 1, rows.shape[1]), dtype=torch.float32,
                      device=rows.device)
    return out.index_add_(0, key, vals.to(torch.float32))[:n_out]


class _Gather(torch.autograd.Function):
    """(N, 9) table, entry gids -> (9, L) payload (bf16 opacity and colour
    with payload "bf16"); the backward sums the entries' gradients per
    gaussian, passing the payload's rounding straight through."""

    @staticmethod
    def forward(ctx, table, gid, payload_dtype, reduce_dtype):
        valid = gid >= 0
        rows = table[torch.clamp(gid, min=0).to(torch.int64)]
        if payload_dtype == "bf16":
            rows = torch.cat([rows[:, :5], bf16(rows[:, 5:])], dim=1)
        rows = torch.where(valid[:, None], rows, torch.zeros_like(rows))
        ctx.save_for_backward(gid)
        ctx.n = table.shape[0]
        ctx.reduce_dtype = reduce_dtype
        return rows.t().contiguous()

    @staticmethod
    def backward(ctx, d_payload):
        (gid,) = ctx.saved_tensors
        return (segment_sum(gid, d_payload.t(), ctx.n, ctx.reduce_dtype),
                None, None, None)


class TilePixels(NamedTuple):
    px: torch.Tensor  # (B, pix) float32 global pixel x
    py: torch.Tensor
    t0: torch.Tensor  # 1 inside the image, 0 past its edge
    x0: torch.Tensor  # (B, 1) tile origin
    y0: torch.Tensor


def tile_pixels(tiles, grid_x, width, height, tile) -> TilePixels:
    p = torch.arange(tile * tile, device=tiles.device)
    tiles = tiles.to(torch.int64)
    x0 = (tiles % grid_x)[:, None] * tile
    y0 = (tiles // grid_x)[:, None] * tile
    ix = x0 + p % tile
    iy = y0 + p // tile
    t0 = ((ix < width) & (iy < height)).to(torch.float32)
    f32 = torch.float32
    return TilePixels(ix.to(f32), iy.to(f32), t0, x0.to(f32), y0.to(f32))


class Replay(NamedTuple):
    f: torch.Tensor  # (9, B, n)
    in_range: torch.Tensor  # (B, n)
    idx: torch.Tensor  # (B, n)
    dx: torch.Tensor  # (B, n, pix)
    dy: torch.Tensor
    g: torch.Tensor | None
    raw: torch.Tensor
    alpha: torch.Tensor
    t_after: torch.Tensor
    t_before: torch.Tensor
    applied: torch.Tensor
    w: torch.Tensor


def replay(payload, starts, counts, px: TilePixels, rs: RenderSettings):
    """The blend of a batch of tiles over its longest range, every (entry,
    pixel) pair as a (B, n, pix) tensor."""
    n = int(counts.max()) if counts.numel() else 0
    j = torch.arange(n, device=payload.device)
    in_range = j[None, :] < counts[:, None]
    idx = torch.where(in_range, starts[:, None] + j[None, :],
                      torch.zeros_like(starts)[:, None])
    f = payload[:, idx]
    mx, my, ca, cb, cc, op = (f[i][:, :, None] for i in range(6))
    dx = mx - px.px[:, None, :]
    dy = my - px.py[:, None, :]
    if rs.blend_quad == "mxu":
        # power + ln(opacity) as a polynomial in the tile-local pixel
        g = None
        mxl = mx - px.x0[:, :, None]
        myl = my - px.y0[:, :, None]
        ln_op = torch.log(torch.clamp(op, min=1e-30))
        a0 = -0.5 * (ca * mxl * mxl + cc * myl * myl) - cb * mxl * myl + ln_op
        bx = ca * mxl + cb * myl
        by = cc * myl + cb * mxl
        xl = (px.px - px.x0)[:, None, :]
        yl = (px.py - px.y0)[:, None, :]
        powerp = (a0 + bx * xl + by * yl + (-0.5 * ca) * (xl * xl)
                  + (-0.5 * cc) * (yl * yl) + (-cb) * (xl * yl))
        raw = torch.exp(powerp)
        pow_ok = powerp <= ln_op + POWER_GUARD
    else:
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        g = torch.exp(torch.clamp(power, max=0.0))
        raw = op * g
        pow_ok = power <= 0.0
    alpha = torch.clamp(raw, max=rs.alpha_max)
    live = pow_ok & (alpha >= rs.alpha_min) & in_range[:, :, None]
    alpha = torch.where(live, alpha, torch.zeros_like(alpha))
    s_inc = torch.cumsum(torch.log1p(-alpha), dim=1)
    t_after = px.t0[:, None, :] * torch.exp(s_inc)
    t_before = t_after / (1.0 - alpha)
    applied = (t_after >= rs.transmittance_eps) & (alpha > 0.0)
    w = torch.where(applied, t_before * alpha, torch.zeros_like(alpha))
    return Replay(f, in_range, idx, dx, dy, g, raw, alpha, t_after, t_before,
                  applied, w)


def tile_batches(tile_counts, pix: int, device, share: int = 1):
    """Tiles in batches, longest ranges first, each batch's (tiles x longest
    range x pixels) tensor under the element budget."""
    counts = tile_counts.to(torch.int64)
    order = torch.argsort(counts, descending=True, stable=True)
    host = counts[order].cpu().tolist()
    budget = BATCH_ELEMENTS.get(device.type, BATCH_ELEMENTS["cpu"]) // share
    done = 0
    while done < len(host):
        b = max(1, min(len(host) - done, budget // (max(host[done], 1) * pix)))
        yield order[done:done + b]
        done += b


def blend_forward(payload, starts, counts, grid_x, width, height,
                  rs: RenderSettings):
    """((T, pix, 3) colour, (T, pix, 1) final transmittance)."""
    t = rs.tile
    pix = t * t
    dev = payload.device
    num_tiles = starts.shape[0]
    st, ct = starts.to(torch.int64), counts.to(torch.int64)
    color = torch.zeros((num_tiles, pix, 3), dtype=torch.float32, device=dev)
    trans = torch.zeros((num_tiles, pix), dtype=torch.float32, device=dev)
    for sel in tile_batches(counts, pix, dev):
        px = tile_pixels(sel, grid_x, width, height, t)
        if int(ct[sel].max()) == 0:
            color[sel] = 0.0
            trans[sel] = px.t0
            continue
        r = replay(payload, st[sel], ct[sel], px, rs)
        color[sel] = torch.stack(
            [torch.sum(r.w * r.f[6 + c][:, :, None], dim=1) for c in range(3)],
            dim=-1)
        t_fin = torch.where(r.applied, r.t_after,
                            px.t0[:, None, :].expand_as(r.t_after))
        trans[sel] = torch.amin(t_fin, dim=1)
    return color, trans[:, :, None]


def blend_backward(payload, starts, counts, residual, grid_x, width, height,
                   rs: RenderSettings):
    """(9, L) per-entry gradients from the per-pixel residual (T, pix, 8) =
    [dL/dC, dL/dT, C_final, T_final]; entries clamped at alpha_max, not
    applied or behind a pixel's stop get none."""
    t = rs.tile
    pix = t * t
    dev = payload.device
    st, ct = starts.to(torch.int64), counts.to(torch.int64)
    grads = torch.zeros((FIELDS, payload.shape[1]), dtype=torch.float32,
                        device=dev)
    for sel in tile_batches(counts, pix, dev, share=2):
        if int(ct[sel].max()) == 0:
            continue
        px = tile_pixels(sel, grid_x, width, height, t)
        r = replay(payload, st[sel], ct[sel], px, rs)
        res = residual[sel]
        ca, cb, cc = (r.f[i][:, :, None] for i in (2, 3, 4))
        grad = res[:, None, :, 0:3]
        b = sum(r.f[6 + c][:, :, None] * grad[..., c] for c in range(3))
        cg_total = (res[:, :, 4:7] * res[:, :, 0:3]).sum(-1)[:, None, :]
        tail = (res[:, :, 7] * res[:, :, 3])[:, None, :]
        suffix = cg_total - torch.cumsum(r.w * b, dim=1)
        d_alpha = r.t_before * b - (suffix + tail) / (1.0 - r.alpha)
        d_alpha = torch.where(r.applied & (r.raw <= rs.alpha_max), d_alpha,
                              torch.zeros_like(d_alpha))
        d_pow = d_alpha * r.alpha
        if r.g is None:
            op = r.f[5]
            d_op = torch.where(op > 0.0, d_pow.sum(2)
                               / torch.where(op > 0.0, op, 1.0), 0.0)
        else:
            d_op = (d_alpha * r.g).sum(2)
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
        grads[:, r.idx[r.in_range]] = out[r.in_range].t()
    return grads


class _Blend(torch.autograd.Function):
    @staticmethod
    def forward(ctx, payload, starts, counts, grid_x, width, height, rs):
        color, trans = blend_forward(payload, starts, counts, grid_x, width,
                                     height, rs)
        ctx.save_for_backward(payload, starts, counts, color, trans)
        ctx.args = (grid_x, width, height, rs)
        return color, trans

    @staticmethod
    def backward(ctx, d_color, d_trans):
        payload, starts, counts, color, trans = ctx.saved_tensors
        if d_color is None:
            d_color = torch.zeros_like(color)
        if d_trans is None:
            d_trans = torch.zeros_like(trans)
        res = torch.cat([d_color, d_trans, color, trans], dim=2).contiguous()
        return (blend_backward(payload, starts, counts, res, *ctx.args),
                None, None, None, None, None, None)


def tiles_to_image(x, grid_x, grid_y, width, height, tile):
    """(T, pix, C) -> (C, H, W)."""
    c = x.shape[2]
    x = x.reshape(grid_y, grid_x, tile, tile, c)
    x = x.permute(4, 0, 2, 1, 3).reshape(c, grid_y * tile, grid_x * tile)
    return x[:, :height, :width]


class Frame(NamedTuple):
    image: torch.Tensor  # (3, H, W)
    means2d: torch.Tensor  # (N, 2), differentiable
    radius: torch.Tensor  # (N,) int32
    binned: Binned
    payload: torch.Tensor  # (9, L)


def render(raw, cam: View, width: int, height: int, bg, rs: RenderSettings,
           sh_degree: int = 3, precision: str = "f32") -> Frame:
    """Render raw parameters (means, log-scales, quaternions, opacity
    logits, SH dc, SH rest) from ``cam``; differentiable in the parameters
    and in the returned ``means2d``."""
    rnd = bf16 if precision == "bf16" else (lambda x: x)
    means, scales, quats, opac, sh = (rnd(x) for x in activate(*raw))
    colors = rnd(sh_colors(means, sh, cam.position, sh_degree))
    p = project(means, scales, quats, cam, width, height, rs)
    if precision == "bf16":
        p = p._replace(means2d=rnd(p.means2d), depth=rnd(p.depth),
                       conic=rnd(p.conic))
    grid_x, grid_y = tile_grid(width, height, rs.tile)
    sel_op = bf16(opac) if rs.payload_dtype == "bf16" else opac
    with torch.no_grad():
        binned = bin_entries(p, grid_x, grid_y, rs, sel_op)
    mx, my = p.means2d.unbind(1)
    ca, cb, cc = p.conic.unbind(1)
    r, g, b = colors.unbind(1)
    table = torch.stack([mx, my, ca, cb, cc, opac.reshape(-1), r, g, b], 1)
    payload = _Gather.apply(table, binned.entry_gid,
                            "bf16" if precision == "bf16" else rs.payload_dtype,
                            rs.grad_reduce_dtype)
    color, trans = _Blend.apply(payload, binned.tile_starts,
                                binned.tile_counts, grid_x, width, height, rs)
    img_c = tiles_to_image(color, grid_x, grid_y, width, height, rs.tile)
    img_t = tiles_to_image(trans, grid_x, grid_y, width, height,
                           rs.tile).squeeze(0)
    bg = torch.as_tensor(bg, dtype=torch.float32, device=img_c.device)
    image = img_c + bg[:, None, None] * img_t[None, :, :]
    return Frame(image, p.means2d, p.radius, binned, payload)


def pair_counts(payload, binned: Binned, grid_x, width, height,
                rs: RenderSettings):
    """(evaluated, applied) (entry, pixel) pairs of the blend: each
    in-image pixel against its tile's entries up to and including the one
    at which it stops, and of those the pairs it applies."""
    t = rs.tile
    st = binned.tile_starts.to(torch.int64)
    ct = binned.tile_counts.to(torch.int64)
    evaluated = applied = 0
    with torch.no_grad():
        for sel in tile_batches(binned.tile_counts, t * t, payload.device):
            if int(ct[sel].max()) == 0:
                continue
            px = tile_pixels(sel, grid_x, width, height, t)
            r = replay(payload, st[sel], ct[sel], px, rs)
            ok = r.t_after >= rs.transmittance_eps
            real = (r.in_range & (r.f[5] > 0))[:, :, None]
            stopped = ~ok[:, -1, :]
            per_pixel = (ok & real).sum(1) + stopped.to(torch.int64)
            evaluated += int((per_pixel * (px.t0 > 0)).sum())
            applied += int(r.applied.sum())
    return evaluated, applied


def to_uint8_hwc(image):
    """(3, H, W) -> (H, W, 3) uint8 as a viewer delivers it: clamped to
    [0, 1], rows flipped upright, times 255 and truncated."""
    hwc = torch.clamp(image, 0.0, 1.0).permute(1, 2, 0).flip(0)
    return (hwc * 255.0).to(torch.uint8)


def look_at(position, target, up, fov_y_deg: float, width: int, height: int,
            device) -> View:
    """The camera at ``position`` looking at ``target``: rows right, up and
    front of the world->view matrix (view-space +z looks forward), built
    in float64 and handed over as float32."""
    import numpy as np

    pos = np.asarray(position, np.float64)
    front = np.asarray(target, np.float64) - pos
    front /= np.linalg.norm(front)
    right = np.cross(front, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    upv = np.cross(right, front)
    upv /= np.linalg.norm(upv)
    rot = np.stack([right, upv, front])
    view = np.eye(4)
    view[:3, :3] = rot
    view[:3, 3] = -rot @ pos
    tan_y = math.tan(math.radians(fov_y_deg) * 0.5)
    f32 = dict(dtype=torch.float32, device=device)
    return View(torch.tensor(view, **f32), torch.tensor(pos, **f32),
                torch.tensor(tan_y * width / height, **f32),
                torch.tensor(tan_y, **f32))
