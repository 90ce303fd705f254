"""PyTorch port: the bf16 exchange of the sharded render (``parallel/``) on
four gloo ranks on the CPU against ``jax.grad`` through the JAX package's
``render_sharded`` on four virtual devices (the bf16 cases of
``tests/test_sharding.py``): the payload exchange in both pack modes, whose
images equal JAX's bf16 images, and the bf16 gradient exchange; with the
no-scatter check of ``tests/test_torch_sharding_grads.py`` on each case.

The loss is sum(image * w), w normal from a seed. Each of the five groups'
gradients within 3e-4 after scaling by the JAX column's max, the images
within 2e-5 (``tests/test_sharding.py``'s tolerances); the bf16 gradient
exchange within 2e-2 of the f32 one, that file's bound. At tile 32 (the
bf16-gradient case) ``tests/test_sharding.py`` holds means and opacities
alone to 3e-4, and so does this file; there all five groups equal the
port's single-device gradients within 1e-6 (sharding changes no sum), and
are within 1e-3 of JAX's, the bound of the tile-32 production case in
``tests/test_torch_grads.py`` (one scale gradient sits 3.08e-4 from
JAX's, on the single-device port as well).
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


#: (name, RenderConfig kwargs, w seed); every case is profiled
GRAD_CASES = {
    "bf16_chunk": (cfg(16, "chunk", "bf16"), 3),
    "bf16_none": (cfg(16, "none", "bf16"), 3),
    "bf16_grads": (cfg(32, "none", "bf16", "bf16"), 5),
    "bf16_grads_f32": (cfg(32, "none", "bf16", "f32"), 5),
}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases = [dict(n=96, seed=21, cfg=c, scfg=SCFG, wimg_seed=s, profile=True)
             for c, s in GRAD_CASES.values()]
    return W.Ranks(W.render_cases, WORLD, tmp_path_factory.mktemp("bf16"),
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


@pytest.mark.parametrize("name", ["bf16_chunk", "bf16_none", "bf16_grads"])
def test_sharded_bf16_grads_match_jax(ranks, name):
    """The five groups' gradients through the bf16 payload exchange in
    both pack modes (whose images equal JAX's bf16 images) and the bf16
    gradient exchange."""
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


def test_bf16_grad_exchange_close_to_f32(ranks):
    """grad_reduce_dtype="bf16" rounds the reverse exchange's rows: the
    gradients stay within bf16 rounding of the f32-cotangent exchange, and
    differ from it."""
    a, b = port(ranks, "bf16_grads")["grads"], port(ranks, "bf16_grads_f32")["grads"]
    for name, x, y in zip(GROUPS, a, b):
        scale = np.abs(y).max() + 1e-8
        assert np.abs(x - y).max() / scale < 2e-2, name
    assert any(not np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("name", list(GRAD_CASES))
def test_sharded_bf16_backward_has_no_scatter(ranks, name):
    """Every rank's backward, in every pack mode, payload and gradient
    dtype: sorts, row gathers and collectives only."""
    for r in ranks.results():
        res = r[list(GRAD_CASES).index(name)]
        assert res["scatter_ops"] == [], res["scatter_ops"]
