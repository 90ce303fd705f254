"""PyTorch port: binning against the JAX package, exactly.

The JAX side runs ``expand_entries_auto`` as its own tests do on the CPU:
the Pallas expansion kernel in interpret mode. Both packages get the same
projected gaussians (the JAX projection's output as numpy arrays), so every
entry stream, range, ``num_rendered`` and ``overflow`` must be identical.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from luisacomputegaussiansplatting_tpu import config as jcfg
from luisacomputegaussiansplatting_tpu.io.synthetic import random_scene
from luisacomputegaussiansplatting_tpu.ops import binning as jb
from luisacomputegaussiansplatting_tpu.ops.projection import project_gaussians
from luisacomputegaussiansplatting_tpu.utils.camera import look_at_camera
from luisacomputegaussiansplatting_tpu_torch.ops import binning as pb
from luisacomputegaussiansplatting_tpu_torch.ops import expand as pe
from luisacomputegaussiansplatting_tpu_torch.ops.projection import ProjectedGaussians

torch.set_num_threads(2)

W, H = 96, 64
TILES = {"16": 16, "32": 32, "32x16": (32, 16)}


def grid(tile):
    tw, th = tile if isinstance(tile, tuple) else (tile, tile)
    gx, gy = -(-W // tw), -(-H // th)
    return gx, gy, gx * gy


@functools.lru_cache(maxsize=None)
def projected(tile_key, n=300):
    """(jax ProjectedGaussians as numpy, port ProjectedGaussians, opacities)."""
    tile = TILES[tile_key]
    tw, th = tile if isinstance(tile, tuple) else (tile, tile)
    scene = random_scene(n, seed=21, scale_range=(0.02, 0.3))
    cam = look_at_camera((3.2, -2.8, 2.1), (0, 0, 0), (0, 0, 1), fov=70.0,
                         width=W, height=H)
    cfg = jcfg.RenderConfig(tile=tw, tile_h=th if th != tw else None)
    proj = jax.jit(lambda m, s, q: project_gaussians(m, s, q, cam, cfg))(
        scene.means, scene.scales, scene.quats)
    jproj = type(proj)(*(np.asarray(x) for x in proj))
    pproj = ProjectedGaussians(*(torch.from_numpy(np.array(x)) for x in jproj))
    return jproj, pproj, np.asarray(scene.opacities)


def empty_projected():
    jproj, _, op = projected("16")
    zero = type(jproj)(*(x[:0] for x in jproj))
    return zero, ProjectedGaussians(*(torch.from_numpy(np.array(x)) for x in zero)), op[:0]


def assert_same(p, j, what=""):
    p = p.numpy() if isinstance(p, torch.Tensor) else np.asarray(p)
    j = np.asarray(j)
    np.testing.assert_array_equal(p, j, err_msg=what)


@functools.lru_cache(maxsize=None)
def jax_expand(tile_key, max_pairs, cull):
    """JAX expand_entries_auto (Pallas, interpret mode) as numpy arrays."""
    jproj, _, op = projected(tile_key)
    tile = TILES[tile_key]
    gx, _, nt = grid(tile)
    f = jax.jit(lambda pr, o: jb.expand_entries_auto(
        pr, gx, nt, max_pairs, o, tile, 1.0 / 255.0, "auto"))
    return tuple(np.asarray(x) for x in f(jproj, op if cull else None))


def roomy(tile_key):
    return int(projected(tile_key)[0].tiles_touched.sum()) + 700


# max_pairs: roomy, exactly-too-small (overflow), and a tiny capacity
CASES = [(k, cull, mp) for k in TILES for cull in (False, True)
         for mp in ("roomy", "overflow")] + [("16", True, "tiny")]


@pytest.mark.parametrize("tile_key,cull,mp", CASES)
def test_expansion_matches_jax_pallas(tile_key, cull, mp):
    jproj, pproj, op = projected(tile_key)
    tile = TILES[tile_key]
    total = int(jproj.tiles_touched.sum())
    max_pairs = {"roomy": total + 700, "overflow": total - 37, "tiny": 100}[mp]
    pop = torch.from_numpy(np.array(op)) if cull else None
    j = jax_expand(tile_key, max_pairs, cull)
    gx, _, nt = grid(tile)
    for p in (pb.expand_entries(pproj, gx, nt, max_pairs, pop, tile),
              pb.expand_entries_auto(pproj, gx, nt, max_pairs, pop, tile),
              pe.expand_entries_kernel(pproj, gx, nt, max_pairs, pop, tile)):
        for name, a, b in zip(("tile", "depth", "gid", "total"), p, j):
            assert_same(a, b, name)
        assert bool(p[3] > max_pairs) == (mp != "roomy")
    if cull and mp == "roomy":  # the cull really removed entries
        assert int((j[2] >= 0).sum()) < total


def test_expansion_empty_scene():
    jproj, pproj, op = empty_projected()
    gx, _, nt = grid(16)
    f = jax.jit(lambda pr, o: jb.expand_entries_auto(
        pr, gx, nt, 512, o, 16, 1.0 / 255.0, "auto"), static_argnums=())
    for cull in (False, True):
        j = f(jproj, op if cull else None)
        p = pb.expand_entries(pproj, gx, nt, 512,
                              torch.from_numpy(np.array(op)) if cull else None, 16)
        for a, b in zip(p, j):
            assert_same(a, b)
        assert int(p[3]) == 0 and int((p[2] >= 0).sum()) == 0


def test_saturated_total_pins_int32_max():
    counts = torch.full((3,), 2**30, dtype=torch.int32)
    ends, total = pe.saturated_ends(counts)
    assert int(total) == 2**31 - 1 and int(ends[-1]) == 3 * 2**30
    jt = jb._saturate_total(jnp.cumsum(jnp.asarray(counts.numpy()))[-1],
                            jnp.asarray(counts.numpy()))
    assert int(jt) == int(total)


def test_kernel_wrapper_rejects_non_cuda_non_cpu_tensors():
    """A projection that is not on the CPU never takes the plain version:
    the wrapper launches the CUDA kernel or raises."""
    _, pproj, _ = projected("16")
    meta = ProjectedGaussians(*(x.to("meta") for x in pproj))
    with pytest.raises(ValueError, match="CUDA"):
        pe.expand_entries_kernel(meta, 6, 24, 1000)
