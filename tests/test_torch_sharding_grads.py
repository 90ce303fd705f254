"""PyTorch port: gradients through the sharded render (``parallel/``) on four
gloo ranks on the CPU against ``jax.grad`` through the JAX package's
``render_sharded`` on four virtual devices (the gradient cases of
``tests/test_sharding.py``), and the port's analogue of its no-scatter HLO
check: the sharded backward's ``torch.profiler`` trace holds no
``index_add``, ``scatter_add`` or accumulating ``index_put_``.

The loss is sum(image * w), w normal from a seed. Each of the five groups'
gradients within 3e-4 after scaling by the JAX column's max, the images
within 2e-5 (``tests/test_sharding.py``'s tolerances). At tile 32 (the
no-pack case) ``tests/test_sharding.py`` holds means and opacities alone
to 3e-4, and so does this file; there all five groups equal the port's
single-device gradients within 1e-6 (sharding changes no sum), and are
within 1e-3 of JAX's, the bound of the tile-32 production case in
``tests/test_torch_grads.py`` (one scale gradient sits 3.08e-4 from
JAX's, on the single-device port as well). The bf16 cases are in
``tests/test_torch_sharding_bf16.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_workers as W
from luisacomputegaussiansplatting_tpu.config import RenderConfig as JConfig
from luisacomputegaussiansplatting_tpu.io.synthetic import random_scene as jrandom_scene
from luisacomputegaussiansplatting_tpu.parallel.mesh import make_mesh as jmesh
from luisacomputegaussiansplatting_tpu.parallel.render_sharded import (
    ShardedRenderConfig as JShardedRenderConfig,
)
from luisacomputegaussiansplatting_tpu.parallel.render_sharded import (
    render_sharded as jrender_sharded,
)
from luisacomputegaussiansplatting_tpu.utils.camera import look_at_camera as jlook
from luisacomputegaussiansplatting_tpu_torch.config import RenderConfig
from luisacomputegaussiansplatting_tpu_torch.io.synthetic import random_scene
from luisacomputegaussiansplatting_tpu_torch.ops.render import render

torch.set_num_threads(2)

WORLD = 4
SCFG = dict(max_pairs_local=8192, exchange_capacity=2048)
GROUPS = "msqoh"  # means, scales, quats, opacities, sh


def cfg(tile=16, pack="chunk", payload="f32", grad="f32"):
    return dict(max_pairs=20_000, tile=tile, pack_mode=pack,
                payload_dtype=payload, grad_reduce_dtype=grad)


#: (name, RenderConfig kwargs, w seed); every case is profiled. The bf16
#: payload cases are in tests/test_torch_sharding_bf16.py.
GRAD_CASES = {
    "f32": (cfg(), 0),
    "nopack": (cfg(32, "none"), 1),
    "nopack_bf16_reduce": (cfg(32, "none", "f32", "bf16"), 7),
}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases = [dict(n=96, seed=21, cfg=c, scfg=SCFG, wimg_seed=s, profile=True)
             for c, s in GRAD_CASES.values()]
    return W.Ranks(W.render_cases, WORLD, tmp_path_factory.mktemp("grads"),
                   cases=cases)


def port(ranks, name):
    return ranks.results()[0][list(GRAD_CASES).index(name)]


def jax_image_and_grads(name):
    """JAX's four-device image and the five groups' gradients of
    sum(image * w)."""
    kw, seed = GRAD_CASES[name]
    cam = jlook((3.0, -2.5, 2.0), (0, 0, 0), (0, 0, 1), fov=70.0, width=64,
                height=64)
    mesh = jmesh((WORLD,), ("gs",), devices=jax.devices()[:WORLD])
    w = jnp.asarray(np.random.default_rng(seed).normal(size=(3, 64, 64)),
                    jnp.float32)

    def loss(*args):
        img, _ = jrender_sharded(*args, cam, mesh, cfg=JConfig(**kw),
                                 scfg=JShardedRenderConfig(**SCFG))
        return jnp.sum(img * w), img

    (_, img), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3, 4), has_aux=True))(
            *jrandom_scene(96, seed=21).render_args())
    return np.asarray(img), [np.asarray(g) for g in grads]


def single_device_grads(name):
    """The port's single-device gradients of the same loss."""
    kw, seed = GRAD_CASES[name]
    leaves = [x.requires_grad_(True) for x in
              random_scene(96, seed=21, device="cpu").render_args()]
    w = np.random.default_rng(seed).normal(size=(3, 64, 64)).astype(np.float32)
    img = render(*leaves, W.camera(), cfg=RenderConfig(**kw))
    torch.sum(img * torch.from_numpy(w)).backward()
    return [x.grad.numpy() for x in leaves]


def assert_grads_close(got, want, atol=3e-4, groups=GROUPS):
    for name, a, b in zip(GROUPS, got, want):
        if name not in groups:
            continue
        assert np.isfinite(a).all(), name
        scale = np.abs(b).max() + 1e-8
        np.testing.assert_allclose(a / scale, b / scale, atol=atol,
                                   err_msg=name)
        assert np.abs(b).max() > 0, name


@pytest.mark.parametrize("name", ["f32", "nopack"])
def test_sharded_grads_match_jax(ranks, name):
    """The five groups' gradients through the exchange: f32 (tile 16,
    chunk) and no-pack (tile 32)."""
    img, grads = jax_image_and_grads(name)
    got = port(ranks, name)
    np.testing.assert_allclose(got["image"], img, atol=2e-5)
    assert not got["overflow"]
    if GRAD_CASES[name][0]["tile"] == 16:
        assert_grads_close(got["grads"], grads)
        return
    assert_grads_close(got["grads"], grads, groups="mo")
    assert_grads_close(got["grads"], grads, atol=1e-3)
    assert_grads_close(got["grads"], single_device_grads(name), atol=1e-6)


def test_scatter_detector_sees_a_plain_index_backward():
    """The profiler check below finds the accumulating index_put_ that
    autograd of plain indexing runs, and an index_add_."""
    x = torch.randn(10, 3, requires_grad=True)
    idx = torch.tensor([0, 3, 3, 7])
    with torch.profiler.profile(record_shapes=True) as prof:
        x[idx].sum().backward()
        torch.zeros(10, 3).index_add_(0, idx, torch.ones(4, 3))
    found = W._backward_ops(prof)
    assert any("accumulate=True" in n for n in found), found
    assert any("index_add" in n for n in found), found


@pytest.mark.parametrize("name", list(GRAD_CASES))
def test_sharded_backward_has_no_scatter(ranks, name):
    """Every rank's backward, in every pack mode, payload and gradient
    dtype: sorts, row gathers and collectives only."""
    for r in ranks.results():
        res = r[list(GRAD_CASES).index(name)]
        assert res["scatter_ops"] == [], res["scatter_ops"]
