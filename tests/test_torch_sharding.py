"""PyTorch port: the gaussian-by-tile sharded render (``parallel/``) on four
gloo ranks on the CPU against the JAX package's ``render_sharded`` on four
of ``conftest.py``'s virtual devices (the render cases of
``tests/test_sharding.py``; the gradients are in
``tests/test_torch_sharding_grads.py``).

One spawn of four ranks renders every case (``_torch_dist_workers``),
while this process runs the JAX side. Images within 2e-5
(``tests/test_sharding.py``), blend_quad="mxu" against JAX's mxu within
5e-4 (``tests/test_torch_rasterize.py``: the two sum the power polynomial
in different orders) and against the port's sharded vpu within 5e-4 (the
JAX suite's mxu-against-vpu bound); ``num_rendered`` equal.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_dist_workers as W
from luisacomputegaussiansplatting_tpu.config import CHUNK
from luisacomputegaussiansplatting_tpu.config import RenderConfig as JConfig
from luisacomputegaussiansplatting_tpu.io.synthetic import random_scene as jrandom_scene
from luisacomputegaussiansplatting_tpu.ops.render import render as jrender
from luisacomputegaussiansplatting_tpu.parallel.mesh import make_mesh as jmesh
from luisacomputegaussiansplatting_tpu.utils.camera import look_at_camera as jlook
from luisacomputegaussiansplatting_tpu_torch.config import RenderConfig
from luisacomputegaussiansplatting_tpu_torch.io.synthetic import random_scene
from luisacomputegaussiansplatting_tpu_torch.ops.render import render_aux
from luisacomputegaussiansplatting_tpu_torch.parallel import mesh as pmesh
from luisacomputegaussiansplatting_tpu_torch.parallel.render_sharded import (
    ShardedRenderConfig,
    _validate_sharded_cfg,
    derive_exchange_capacity,
    render_sharded,
)

# the package's __init__ exports the function under the module's name
jrs = importlib.import_module(
    "luisacomputegaussiansplatting_tpu.parallel.render_sharded")

torch.set_num_threads(2)

WORLD = 4
ATOL = 2e-5
MXU_ATOL = 5e-4
BGS = ((0.0, 0.0, 0.0), (0.2, 0.4, 0.6))
BASE = dict(max_pairs=20_000)
SCFG = dict(max_pairs_local=8192, exchange_capacity=2048)
IMAGES = [(tile, pack) for tile in (16, 32) for pack in ("chunk", "none")]
MXU = dict(max_pairs=20_000, tile=32, pack_mode="none", blend_quad="mxu")
BIG = dict(n=1024, seed=5, scale_range=(0.4, 0.8))


def case(cfg=BASE, scfg=SCFG, **kw):
    return dict(n=96, seed=21, cfg=cfg, scfg=scfg, **kw)


CASES = {
    **{("image", tile, pack, bg): case(dict(BASE, tile=tile, pack_mode=pack),
                                       bg=bg)
       for tile, pack in IMAGES for bg in BGS},
    "uneven": case(height=48),
    "small": dict(BIG, cfg=BASE, scfg=dict(max_pairs_local=8192,
                                           exchange_capacity=128)),
    "grown": dict(BIG, cfg=BASE, scfg=dict(max_pairs_local=8192,
                                           exchange_capacity=128 * 16)),
    "auto": case(scfg=dict(max_pairs_local=8192)),
    "mxu": case(MXU),
    "mxu_vpu": case(dict(MXU, blend_quad="vpu")),
}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks, started once and left running while the JAX side
    compiles."""
    return W.Ranks(W.render_cases, WORLD, tmp_path_factory.mktemp("sharding"),
                   cases=list(CASES.values()))


def port(ranks, key):
    return ranks.results()[0][list(CASES).index(key)]


CAM = jlook((3.0, -2.5, 2.0), (0, 0, 0), (0, 0, 1), fov=70.0, width=64,
            height=64)
JSCFG = jrs.ShardedRenderConfig(**SCFG)


@pytest.fixture(scope="module")
def jscene():
    return jrandom_scene(96, seed=21)


def jax_sharded(scene, cfg, scfg=JSCFG, cam=CAM, bgs=((0.0, 0.0, 0.0),)):
    mesh = jmesh((WORLD,), ("gs",), devices=jax.devices()[:WORLD])
    f = jax.jit(lambda bg, *a: jrs.render_sharded(*a, cam, mesh, cfg=cfg,
                                                  scfg=scfg, bg_color=bg))
    out = []
    for bg in bgs:
        img, aux = f(jnp.asarray(bg, jnp.float32), *scene.render_args())
        out.append((np.asarray(img), bool(aux.overflow),
                    int(aux.num_rendered)))
    return out


@pytest.mark.parametrize("tile,pack", IMAGES)
def test_sharded_render_matches_jax(ranks, jscene, tile, pack):
    """Every (tile, pack_mode) with two background colours: the port's
    four-rank image equals JAX's four-device image; no overflow; the same
    num_rendered (the expansion's entries over the band-padded grid)."""
    want = jax_sharded(jscene, JConfig(**BASE, tile=tile, pack_mode=pack),
                       bgs=BGS)
    for bg, (img, over, n) in zip(BGS, want):
        got = port(ranks, ("image", tile, pack, bg))
        assert got["image"].shape == (3, 64, 64)
        np.testing.assert_allclose(got["image"], img, atol=ATOL)
        assert not got["overflow"] and not over
        assert got["num_rendered"] == n > 0
    assert img.max() > 0.05  # something was drawn


def test_uneven_band_split(ranks, jscene):
    """48 pixel rows are 3 tile rows over 4 ranks: the last band lies past
    the image."""
    want = jax_sharded(jscene, JConfig(**BASE), cam=CAM.resized(64, 48))
    got = port(ranks, "uneven")
    assert got["image"].shape == (3, 48, 64) and got["band_shape"][1] == 16
    np.testing.assert_allclose(got["image"], want[0][0], atol=ATOL)
    assert got["num_rendered"] == want[0][2]


def test_exchange_overflow_flagged_and_recoverable(ranks):
    """A bucket over exchange_capacity raises the overflow flag (as JAX's
    does); sixteen times the capacity clears it and gives the
    single-device image."""
    big = jrandom_scene(**BIG)
    small = jax_sharded(big, JConfig(**BASE),
                        jrs.ShardedRenderConfig(**CASES["small"]["scfg"]))
    assert port(ranks, "small")["overflow"] and small[0][1]
    grown = port(ranks, "grown")
    assert not grown["overflow"]
    want = jax.jit(lambda *a: jrender(*a, CAM, cfg=JConfig(**BASE)))(
        *big.render_args())
    np.testing.assert_allclose(grown["image"], np.asarray(want), atol=ATOL)


def test_exchange_capacity_auto_derivation(ranks):
    """exchange_capacity=None derives JAX's CHUNK-aligned capacity and
    renders as the explicit capacity does."""
    for mpl, ndev, skew in ((8192, 8, 3.0), (1_000_000, 16, 3.0),
                            (100, 8, 1.0), (8192, 4, 3.0)):
        cap = derive_exchange_capacity(mpl, ndev, skew)
        assert cap == jrs.derive_exchange_capacity(mpl, ndev, skew)
        assert cap % CHUNK == 0 and cap >= CHUNK
        assert cap >= -(-mpl // ndev) * skew - CHUNK
    auto = port(ranks, "auto")
    assert not auto["overflow"]
    np.testing.assert_allclose(
        auto["image"], port(ranks, ("image", 16, "chunk", BGS[0]))["image"],
        atol=ATOL)


def test_exchange_capacity_shrinks_with_mesh():
    """The derived bucket capacity shrinks with the mesh while a rank's
    whole buffer (ndev x capacity) stays at ~skew x max_pairs_local."""
    mpl, skew = 1_000_000, 3.0
    caps = {n: derive_exchange_capacity(mpl, n, skew)
            for n in (1, 2, 4, 8, 16, 64, 256)}
    ndevs = sorted(caps)
    for a, b in zip(ndevs, ndevs[1:]):
        assert caps[a] > caps[b]
        assert b * caps[b] >= mpl * skew - CHUNK
        assert b * caps[b] <= mpl * skew + b * CHUNK


@pytest.fixture
def gloo_world_of_one(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    yield pmesh.make_mesh((1,), ("gs",), device="cpu")
    dist.destroy_process_group()


def test_sharded_rejects_bad_configs(gloo_world_of_one):
    """A capacity that is no multiple of CHUNK is rejected by render_sharded
    before any collective; every single-device option the sharded path
    refuses is refused with JAX's message."""
    scene = random_scene(96, seed=21, device="cpu")
    cam = W.camera()
    with pytest.raises(ValueError, match="exchange_capacity"):
        render_sharded(*scene.render_args(), cam, gloo_world_of_one,
                       cfg=RenderConfig(**BASE),
                       scfg=ShardedRenderConfig(max_pairs_local=8192,
                                                exchange_capacity=1000))
    scfg = ShardedRenderConfig(**SCFG)
    for bad in (dict(rasterizer="jnp"), dict(max_pairs_sorted=4096),
                dict(sort_mode="fused"), dict(grad_reduce_method="rowgather")):
        with pytest.raises(ValueError) as ours:
            _validate_sharded_cfg(RenderConfig(**BASE, **bad), scfg)
        with pytest.raises(ValueError) as theirs:
            jrs._validate_sharded_cfg(JConfig(**BASE, **bad), JSCFG)
        assert str(ours.value) == str(theirs.value)


def test_sharded_mxu(ranks, jscene):
    """blend_quad="mxu" through the sharded path: against JAX's sharded mxu
    image, the port's sharded vpu image and its single-device mxu image."""
    got = port(ranks, "mxu")
    assert not got["overflow"]
    want = jax_sharded(jscene, JConfig(**MXU))
    np.testing.assert_allclose(got["image"], want[0][0], atol=MXU_ATOL)
    np.testing.assert_allclose(got["image"], port(ranks, "mxu_vpu")["image"],
                               atol=MXU_ATOL)
    scene = random_scene(96, seed=21, device="cpu")
    single, _ = render_aux(*scene.render_args(), W.camera(),
                           cfg=RenderConfig(**MXU))
    np.testing.assert_allclose(got["image"], single.numpy(), atol=ATOL)
    # the mxu case differs from the vpu case somewhere: the mode took effect
    assert not np.array_equal(got["image"], port(ranks, "mxu_vpu")["image"])


def test_every_rank_assembles_the_frame(ranks):
    """gather_image gives every rank the same frame; the capacity defaults
    are JAX's."""
    res = ranks.results()
    for r in res[1:]:
        np.testing.assert_array_equal(r[0]["image"], res[0][0]["image"])
    assert dataclasses.asdict(ShardedRenderConfig()) == dataclasses.asdict(
        jrs.ShardedRenderConfig())
