"""PyTorch port: the scatter-free autograd Functions of the sharded exchange
(``parallel/exchange_vjp.py``), ``pack_slot_inverse``, the receiver's merge
order and the blend kernels' tile offset, against the JAX package.

Single process. Each exchange piece against autograd of plain indexing on
the same rows (values equal, gradients within 1e-6) and against the JAX
custom VJP (the JAX package's ``tests/test_exchange_vjp.py`` cases); the
bf16 legs of the exchange against the JAX package's bf16 packing round
trips, exactly. ``pack_slot_inverse`` and the merge order equal JAX's
entry for entry. ``rasterize_tiles`` with a nonzero ``tile_offset`` (a band
of the frame) against JAX's ``rasterize_tiles(..., tile_offset=...)`` in
interpret mode: colour and T within 2e-5 (vpu) or 5e-4 (mxu,
``tests/test_torch_rasterize.py``), the payload gradient per field within
1e-4 (vpu) or 1e-3 (mxu) of the field's max (``tests/test_torch_backward.py``).
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from luisacomputegaussiansplatting_tpu import config as jcfg
from luisacomputegaussiansplatting_tpu.io.synthetic import random_scene as jrandom_scene
from luisacomputegaussiansplatting_tpu.ops import binning as jbin
from luisacomputegaussiansplatting_tpu.ops import rasterize_pallas as jrp
from luisacomputegaussiansplatting_tpu.ops.binning import bin_gaussians
from luisacomputegaussiansplatting_tpu.ops.projection import project_gaussians, tile_grid
from luisacomputegaussiansplatting_tpu.ops.render import _pack_table7, _unpack_rows7
from luisacomputegaussiansplatting_tpu.ops.render import build_payload
from luisacomputegaussiansplatting_tpu.ops.sh_eval import compute_colors
from luisacomputegaussiansplatting_tpu.parallel import exchange_vjp as jx
from luisacomputegaussiansplatting_tpu.utils.camera import look_at_camera as jlook
from luisacomputegaussiansplatting_tpu_torch import config as pcfg
from luisacomputegaussiansplatting_tpu_torch.ops import rasterize as pr
from luisacomputegaussiansplatting_tpu_torch.ops.binning import pack_ranges, pack_slot_inverse
from luisacomputegaussiansplatting_tpu_torch.parallel import exchange_vjp as px
from luisacomputegaussiansplatting_tpu_torch.parallel.render_sharded import merge_order

torch.set_num_threads(2)


def t(x):
    return torch.from_numpy(np.array(x))


def rand(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def check_piece(port_fn, plain_fn, jax_fn, rows, seed=1):
    """Values of the port's Function equal plain indexing and the JAX
    function; gradients of sum(out * w) equal autograd of plain indexing
    (1e-6) and the JAX custom VJP (1e-6)."""
    x = t(rows).requires_grad_(True)
    y = t(rows).requires_grad_(True)
    out, ref = port_fn(x), plain_fn(y)
    want = np.asarray(jax_fn(jnp.asarray(rows)))
    np.testing.assert_array_equal(out.detach().numpy(), ref.detach().numpy())
    np.testing.assert_array_equal(out.detach().numpy(), want)
    w = rand(tuple(out.shape), seed)
    torch.sum(out * t(w)).backward()
    torch.sum(ref * t(w)).backward()
    g_jax = jax.grad(lambda r: jnp.sum(jax_fn(r) * w))(jnp.asarray(rows))
    np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(), atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_jax), atol=1e-6)


GID = np.array([0, 5, 5, -1, 12, 3, 5, -1, 0], np.int32)
CUTS = np.array([0, 3, 3, 11, 15], np.int32)  # bucket 2 overflows bcap 6
BCAP = 6


@pytest.mark.parametrize("grad_dtype", ["f32", "bf16"])
def test_take_table_rows(grad_dtype):
    gid = t(GID)

    def plain(tab):
        return torch.where(gid[:, None] >= 0, tab[torch.clamp(gid, min=0).long()],
                           0.0)

    if grad_dtype == "bf16":
        # the JAX function rounds the cotangent rows to bf16 inside its VJP
        x = t(rand((13, 9))).requires_grad_(True)
        out = px.take_table_rows(x, gid, "bf16")
        w = rand(tuple(out.shape), 1)
        torch.sum(out * t(w)).backward()
        g = jax.grad(lambda r: jnp.sum(jx.take_table_rows(
            r, jnp.asarray(GID), "bf16") * w))(jnp.asarray(rand((13, 9))))
        np.testing.assert_array_equal(x.grad.numpy(), np.asarray(g))
        return
    check_piece(lambda r: px.take_table_rows(r, gid), plain,
                lambda r: jx.take_table_rows(r, jnp.asarray(GID)),
                rand((13, 9)))


def test_slice_buckets():
    cuts = t(CUTS)

    def plain(r):
        j = torch.arange(BCAP)[None, :]
        src = torch.clamp(cuts[:-1, None].long() + j, 0, r.shape[0] - 1)
        valid = j < (cuts[1:] - cuts[:-1])[:, None]
        return torch.where(valid[..., None], r[src], 0.0)

    check_piece(lambda r: px.slice_buckets(r, cuts, BCAP), plain,
                lambda r: jx.slice_buckets(r, jnp.asarray(CUTS), BCAP),
                rand((20, 4), 2))


def test_permute_rows():
    perm = np.random.default_rng(4).permutation(17)
    check_piece(lambda r: px.permute_rows(r, t(perm)),
                lambda r: r[t(perm)],
                lambda r: jx.permute_rows(r, jnp.asarray(perm, jnp.int32)),
                rand((17, 5), 3))


def test_pack_gather_and_slot_inverse():
    """pack_slot_inverse equals JAX's on sorted tiles with a sentinel tail;
    the pack gather's values and gradients as for the other pieces."""
    s_tile = np.array([0, 0, 0, 1, 2, 2, 2, 2, 2, 4, 4, 4], np.int32)
    n_tiles, cap = 4, 3 * pcfg.CHUNK + 24
    src, in_range, _st, starts, _cnt = pack_ranges(t(s_tile), n_tiles, cap)
    slot = pack_slot_inverse(t(s_tile), starts, n_tiles, cap)
    j_src, j_in, _jst, j_starts, _jc = jbin.pack_ranges(
        jnp.asarray(s_tile), n_tiles, cap)
    want = jbin.pack_slot_inverse(jnp.asarray(s_tile), j_starts, n_tiles, cap)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(want))
    assert slot.dtype == torch.int32 and (slot.numpy()[-3:] == cap).all()
    # every in-range slot is the inverse of its entry
    k = src[in_range].long()
    np.testing.assert_array_equal(slot[k].numpy(),
                                  torch.nonzero(in_range)[:, 0].numpy())
    check_piece(lambda r: px.pack_gather(r, src, in_range, slot),
                lambda r: torch.where(in_range[:, None], r[src.long()], 0.0),
                lambda r: jx.pack_gather(r, j_src, j_in, want),
                rand((12, 3), 5))


@pytest.mark.parametrize("seed", [0, 1])
def test_pack_slot_inverse_matches_jax_on_random_streams(seed):
    rng = np.random.default_rng(seed)
    n_tiles = 9
    s_tile = np.sort(rng.integers(0, n_tiles + 2, 300)).astype(np.int32)
    cap = 300 + n_tiles * pcfg.CHUNK
    _s, _i, _t, starts, _c = pack_ranges(t(s_tile), n_tiles, cap)
    _js, _ji, _jt, j_starts, _jc = jbin.pack_ranges(jnp.asarray(s_tile),
                                                    n_tiles, cap)
    np.testing.assert_array_equal(starts.numpy(), np.asarray(j_starts))
    np.testing.assert_array_equal(
        pack_slot_inverse(t(s_tile), starts, n_tiles, cap).numpy(),
        np.asarray(jbin.pack_slot_inverse(jnp.asarray(s_tile), j_starts,
                                          n_tiles, cap)))


def test_bucket_inverse_roundtrip():
    idx, valid = px._bucket_inverse(t(CUTS), 20, BCAP)
    j_idx, j_valid = jx._bucket_inverse(jnp.asarray(CUTS), 20, BCAP)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(j_valid))
    np.testing.assert_array_equal(idx.numpy()[valid.numpy()],
                                  np.asarray(j_idx)[np.asarray(j_valid)])
    for i in range(20):
        assigned = [(d, i - CUTS[d]) for d in range(4)
                    if CUTS[d] <= i < CUTS[d + 1] and i - CUTS[d] < BCAP]
        if assigned:
            d, b = assigned[0]
            assert valid[i] and idx[i] == d * BCAP + b, i
        else:
            assert not valid[i], i


def test_invperm():
    perm = np.random.default_rng(7).permutation(33).astype(np.int32)
    inv = px._invperm(t(perm)).numpy()
    np.testing.assert_array_equal(perm[inv], np.arange(33))
    np.testing.assert_array_equal(inv, np.asarray(jx._invperm(jnp.asarray(perm))))


def test_merge_order_matches_jax_three_key_sort():
    """The receiver's (tile, depth, gid) order from two torch sorts equals
    ``lax.sort`` on three keys, entry for entry: depth ties across gids,
    invalid entries (sentinel tile, +inf, INT32_MAX) at the end."""
    rng = np.random.default_rng(3)
    m, n_tiles = 400, 6
    tile = rng.integers(0, n_tiles, m).astype(np.int32)
    gid = rng.permutation(10 * m)[:m].astype(np.int32)
    depth = rng.choice(np.float32([0.5, 1.0, 2.5, 3.0]), m)  # many ties
    bad = rng.random(m) < 0.2
    tile[bad], depth[bad], gid[bad] = n_tiles, np.inf, 2**31 - 1
    perm = merge_order(t(tile), t(depth), t(gid)).numpy()
    *_, want = jax.lax.sort((jnp.asarray(tile), jnp.asarray(depth),
                             jnp.asarray(gid), jnp.arange(m, dtype=jnp.int32)),
                            num_keys=3, is_stable=False)
    want = np.asarray(want)
    ok = ~bad[want]  # the invalid entries' order among themselves is free
    np.testing.assert_array_equal(perm[ok], want[ok])
    assert bad[perm[~ok]].all()


@pytest.fixture
def gloo_world_of_one(tmp_path):
    """A one-rank gloo process group (a ``file://`` store in tmp_path)."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    yield dist.group.WORLD
    dist.destroy_process_group()


def test_exchange_bf16_legs_match_jax_packing(gloo_world_of_one):
    """payload_dtype="bf16" rounds opacity and rgb (columns 5-8) of the
    payload to bf16 on the way out, as the JAX package's 7-column packing
    does; grad_dtype="bf16" rounds every cotangent column on the way back,
    as its 5-column packing does. Both exactly; f32 moves the bits as they
    are."""
    rows = rand((1, 11, 9), 8) * 3.0
    table = jnp.asarray(rows[0])
    want_fwd = np.asarray(_unpack_rows7(_pack_table7(table)))
    want_bwd = np.asarray(jx._unpack_rows_bf16(jx._pack_rows_bf16(table), 9))
    for payload, grad in (("bf16", "bf16"), ("f32", "f32"), ("bf16", "f32")):
        x = t(rows).requires_grad_(True)
        out = px.exchange_rows(x, gloo_world_of_one, payload, grad)
        np.testing.assert_array_equal(
            out.detach().numpy()[0], want_fwd if payload == "bf16" else rows[0])
        out.backward(t(rows))
        np.testing.assert_array_equal(
            x.grad.numpy()[0], want_bwd if grad == "bf16" else rows[0])


def band_case(tile, blend, seed):
    """The JAX pipeline's payload and ranges of a 64x64 frame, its tile grid
    and its entry gids, as numpy."""
    kw = dict(max_pairs=20_000, tile=tile, blend_quad=blend)
    cfg = jcfg.RenderConfig(**kw)
    cam = jlook((3.0, -2.5, 2.0), (0, 0, 0), (0, 0, 1), fov=70.0, width=64,
                height=64)
    gx, gy = tile_grid(64, 64, cfg.tile_wh)

    def run(m, s, q, o, sh):
        colors = compute_colors(m, sh, cam.position, 3)
        proj = project_gaussians(m, s, q, cam, cfg)
        binned = bin_gaussians(proj, gx, gy, cfg.max_pairs, None, cfg.tile_wh)
        return (build_payload(proj, colors, o, binned), binned.tile_starts,
                binned.tile_counts, binned.entry_gid)

    out = jax.jit(run)(*jrandom_scene(96, seed=seed).render_args())
    return kw, cfg, gx, gy, [np.asarray(x) for x in out]


@pytest.mark.parametrize("tile,blend", [(16, "vpu"), (16, "mxu"),
                                        (32, "vpu"), (32, "mxu")])
def test_rasterize_tiles_tile_offset_matches_jax(tile, blend):
    """A band of tile rows (the last ones; at tile 16 the third row too)
    rasterized on its own ranges with its first global tile as the offset:
    forward and payload gradient against JAX's kernels with the same
    offset, and the port's band equal to its whole-frame blend's tiles."""
    kw, cfg, gx, gy, (payload, starts, counts, gid) = band_case(tile, blend, 21)
    lo, hi = (gy - 1) * gx, gy * gx
    if tile == 16:
        lo = 2 * gx
    atol, gtol = (5e-4, 1e-3) if blend == "mxu" else (2e-5, 1e-4)
    j_args = (jnp.asarray(starts[lo:hi]), jnp.asarray(counts[lo:hi]), gx, 64,
              64, cfg)
    (jc, jt), vjp = jax.vjp(
        lambda p: jrp.rasterize_tiles(p, *j_args,
                                      tile_offset=jnp.asarray([lo], jnp.int32)),
        jnp.asarray(payload))
    d_color = rand(tuple(jc.shape), tile)
    d_trans = rand(tuple(jt.shape), tile + 1)
    (j_dp,) = vjp((jnp.asarray(d_color), jnp.asarray(d_trans)))

    pcf = pcfg.RenderConfig(**kw)
    p = t(payload[:9]).requires_grad_(True)
    pc, ptr = pr.rasterize_tiles(p, t(starts[lo:hi]), t(counts[lo:hi]), gx, 64,
                                 64, pcf, tile_offset=lo)
    np.testing.assert_allclose(pc.detach().numpy(), np.asarray(jc), atol=atol)
    np.testing.assert_allclose(ptr.detach().numpy(), np.asarray(jt), atol=atol)
    assert np.asarray(jc).max() > 0.05  # the band is drawn
    full_c, full_t = pr.rasterize_tiles(t(payload[:9]), t(starts), t(counts),
                                        gx, 64, 64, pcf)
    np.testing.assert_array_equal(pc.detach().numpy(), full_c[lo:hi].numpy())
    np.testing.assert_array_equal(ptr.detach().numpy(), full_t[lo:hi].numpy())

    torch.autograd.backward((pc, ptr), (t(d_color), t(d_trans)))
    band_slots = np.zeros(payload.shape[1], bool)
    for s, c in zip(starts[lo:hi], counts[lo:hi]):
        band_slots[s:s + c] = True
    keep = band_slots & (gid >= 0)
    got, want = p.grad.numpy()[:, keep], np.asarray(j_dp)[:9, keep]
    assert keep.sum() > 0 and np.isfinite(got).all()
    for f in range(9):
        scale = np.abs(want[f]).max() + 1e-30
        np.testing.assert_allclose(got[f] / scale, want[f] / scale, atol=gtol,
                                   err_msg=f"field {f}")
    assert not p.grad.numpy()[:, ~band_slots].any()  # other tiles untouched
