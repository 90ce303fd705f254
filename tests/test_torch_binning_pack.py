"""PyTorch port: the sort, the CHUNK packing and the whole binning stage
against the JAX package, exactly (the JAX expansion runs its Pallas kernel
in interpret mode; see test_torch_binning.py for the shared inputs)."""

import jax
import numpy as np
import pytest
import torch

from luisacomputegaussiansplatting_tpu import config as jcfg
from luisacomputegaussiansplatting_tpu.ops import binning as jb
from luisacomputegaussiansplatting_tpu_torch.ops import binning as pb
from test_torch_binning import TILES, assert_same, grid, jax_expand, projected, roomy

torch.set_num_threads(2)


@pytest.mark.parametrize("tile_key", list(TILES))
@pytest.mark.parametrize("sort_mode", ["2key", "fused"])
def test_sort_and_pack_match_jax(tile_key, sort_mode):
    jproj, pproj, op = projected(tile_key)
    tile = TILES[tile_key]
    gx, _, nt = grid(tile)
    tid, dep, gid, _ = jax_expand(tile_key, roomy(tile_key), True)
    js_tile, js_gid = (np.asarray(x) for x in jax.jit(
        lambda *a: jb._sort_entries(*a, nt, sort_mode))(tid, dep, gid))
    ps_tile, ps_gid = pb._sort_entries(*(torch.from_numpy(np.array(x))
                                         for x in (tid, dep, gid)), nt, sort_mode)
    assert_same(ps_tile, js_tile, "sorted tile")
    if sort_mode == "2key":
        assert_same(ps_gid, js_gid, "sorted gid")
    else:
        # JAX's fused sort is unstable: same key stream, and within each run
        # of equal keys the same gids
        db = 32 - (nt + 1).bit_length()
        jdepth = np.asarray(jproj.depth, np.float32)

        def keyed(st, sg):
            st, sg = np.asarray(st).astype(np.uint64), np.asarray(sg)
            d = np.where(sg >= 0, jdepth[np.maximum(sg, 0)], np.inf)
            bits = d.astype(np.float32).view(np.uint32).astype(np.uint64)
            return (st << db) | ((bits >> (31 - db)) & ((1 << db) - 1)), sg

        kj, gj = keyed(js_tile, js_gid)
        kp, gp = keyed(ps_tile, ps_gid)
        assert_same(kp, kj, "fused key stream")
        assert np.all(np.diff(kp.astype(np.int64)) >= 0)
        oj, op_ = np.lexsort((gj, kj)), np.lexsort((gp, kp))
        assert_same(gp[op_], gj[oj], "gids within equal-key runs")
    cap = js_tile.shape[0] + nt * jcfg.CHUNK
    jpk = jax.jit(lambda st: jb.pack_ranges(st, nt, cap))(js_tile)
    ppk = pb.pack_ranges(ps_tile, nt, cap)
    for name, a, b in zip(("src", "in_range", "slot_tile", "starts", "counts"),
                          ppk, jpk):
        assert_same(a, b, name)


# The JAX side bins with its plain XLA expansion, except where a case asks
# for its Pallas kernel (interpret mode, ~2 s of compile per case): the
# expansion's parity with that kernel is test_torch_binning.py's subject.
BIN_CASES = [
    ("16", dict(jax_expansion="auto")),
    ("16", dict(tile_cull=True, jax_expansion="auto")),
    ("32", dict(tile_cull=True, max_pairs_sorted=600)),
    ("32x16", dict()),
    ("16", dict(max_pairs_sorted=500)),  # trim cuts valid entries: overflow
    ("16", dict(sort_mode="fused", tile_cull=True)),
]


@pytest.mark.parametrize("pack", ["chunk", "none"])
@pytest.mark.parametrize("tile_key,kw", BIN_CASES)
def test_bin_gaussians_match_jax(tile_key, kw, pack):
    jproj, pproj, op = projected(tile_key)
    tile = TILES[tile_key]
    gx, gy, nt = grid(tile)
    max_pairs = int(jproj.tiles_touched.sum()) + 200
    cull = kw.get("tile_cull", False)
    args = (gx, gy, max_pairs)
    jfun = jb.bin_gaussians if pack == "chunk" else jb.bin_gaussians_nopack
    pfun = pb.bin_gaussians if pack == "chunk" else pb.bin_gaussians_nopack
    opt = dict(tile=tile, max_sorted=kw.get("max_pairs_sorted"),
               sort_mode=kw.get("sort_mode", "2key"))
    jexp = kw.get("jax_expansion", "xla")
    j = jax.jit(lambda pr, o: jfun(pr, *args, o, expansion=jexp, **opt))(
        jproj, op if cull else None)
    p = pfun(pproj, *args, torch.from_numpy(np.array(op)) if cull else None,
             **opt)
    fields = p._fields
    if opt["sort_mode"] == "fused":  # unstable in JAX: gids compared as sets
        fields = [f for f in fields if f != "entry_gid"]
        jg, pg = np.asarray(j.entry_gid), p.entry_gid.numpy()
        et = np.asarray(j.entry_tile)
        for tl in np.unique(et[et >= 0]):
            assert_same(np.sort(pg[et == tl]), np.sort(jg[et == tl]))
    for name in fields:
        assert_same(getattr(p, name), getattr(j, name), name)
    if kw.get("max_pairs_sorted") == 500:
        assert bool(p.overflow)  # the trim cut valid entries
    assert int(p.num_rendered) > 0
