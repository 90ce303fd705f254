"""PyTorch port: ``tests/test_camera_grads_batch.py`` against the JAX render
(its Pallas kernels in interpret mode).

* Camera-pose gradients against ``jax.grad``: the gradients of the loss with
  respect to the CameraView's view matrix and position, within 2e-4 of
  their max |value| (the tolerance of ``tests/test_torch_grads.py``); one
  gradient step on the view matrix lowers the port's loss.
* A stacked view batch: the port has no vmap; its batched step indexes a
  stacked CameraView view by view (``models/trainer.py``). Each view so
  rendered equals the port's single ``render`` bit for bit and JAX's
  ``jax.vmap`` batch within JAX's atol 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from luisacomputegaussiansplatting_tpu.config import RenderConfig as JConfig
from luisacomputegaussiansplatting_tpu.io.synthetic import random_scene as jrandom_scene
from luisacomputegaussiansplatting_tpu.ops.render import render_view as jrender_view
from luisacomputegaussiansplatting_tpu.utils.camera import look_at_camera as jlook
from luisacomputegaussiansplatting_tpu_torch.config import RenderConfig
from luisacomputegaussiansplatting_tpu_torch.ops.render import render, render_view
from luisacomputegaussiansplatting_tpu_torch.utils.camera import CameraView, look_at_camera

torch.set_num_threads(2)

W = H = 64
KW = dict(max_pairs=30_000)
EYE = ((3.0, -2.5, 2.0), (0, 0, 0), (0, 0, 1))
TARGET_EYE = ((2.8, -2.4, 1.9), (0, 0, 0), (0, 0, 1))


def test_camera_position_gradient():
    args = [np.array(a) for a in jrandom_scene(
        200, seed=11, extent=1.0, scale_range=(0.05, 0.15)).render_args()]

    @jax.jit
    def jimage(view):
        return jrender_view(*map(jnp.asarray, args), view, W, H,
                            cfg=JConfig(**KW))[0]

    jtarget = jimage(jlook(*TARGET_EYE, fov=70.0, width=W, height=H).to_view())
    want = jax.jit(jax.grad(lambda v: jnp.mean((jimage(v) - jtarget) ** 2)))(
        jlook(*EYE, fov=70.0, width=W, height=H).to_view())

    target = torch.from_numpy(np.array(jtarget))
    scene = [torch.from_numpy(a) for a in args]

    def loss(view):
        img, _ = render_view(*scene, view, W, H, cfg=RenderConfig(**KW))
        return torch.mean((img - target) ** 2)

    v0 = look_at_camera(*EYE, fov=70.0, width=W, height=H).to_view("cpu")
    leaves = CameraView(*(x.clone().requires_grad_(True) for x in v0))
    l0 = loss(leaves)
    l0.backward()
    for name in ("view", "position"):
        got = getattr(leaves, name).grad.numpy()
        ref = np.asarray(getattr(want, name))
        assert np.isfinite(got).all() and np.abs(got).max() > 0, name
        scale = np.abs(ref).max()
        np.testing.assert_allclose(got / scale, ref / scale, atol=2e-4,
                                   err_msg=name)
    g = leaves.view.grad
    lr = 1e-2 / (float(g.abs().max()) + 1e-12)
    with torch.no_grad():
        l1 = loss(v0._replace(view=v0.view - lr * g))
    assert float(l1) < float(l0.detach())


def batch_eyes():
    return [((3.0 - 0.8 * i, -2.5 + 0.5 * i, 2.0), (0, 0, 0), (0, 0, 1))
            for i in range(3)]


def test_vmapped_view_batch_matches_sequential():
    args = [np.array(a) for a in jrandom_scene(
        300, seed=12, extent=1.5, scale_range=(0.03, 0.1)).render_args()]
    jviews = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        jlook(*e, fov=70.0, width=W, height=H).to_view() for e in batch_eyes()])
    want = np.asarray(jax.jit(jax.vmap(lambda v: jrender_view(
        *map(jnp.asarray, args), v, W, H, cfg=JConfig(**KW))[0]))(jviews))
    assert want.shape == (3, 3, H, W)

    scene = [torch.from_numpy(a) for a in args]
    cams = [look_at_camera(*e, fov=70.0, width=W, height=H)
            for e in batch_eyes()]
    views = CameraView(*(torch.stack(x)
                         for x in zip(*[c.to_view("cpu") for c in cams])))
    cfg = RenderConfig(**KW)
    for v, cam in enumerate(cams):
        img, _ = render_view(*scene, CameraView(*(x[v] for x in views)), W, H,
                             cfg=cfg)
        assert float(img.sum()) > 0, v
        assert torch.equal(img, render(*scene, cam, cfg=cfg)), v
        np.testing.assert_allclose(img.numpy(), want[v], atol=2e-5,
                                   err_msg=f"view {v}")
