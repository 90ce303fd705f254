"""PyTorch port: camera-pose gradients (``tests/test_camera_grads_batch.py``)
against ``jax.grad`` of the JAX render (its Pallas kernels in interpret
mode). The gradients of the loss with respect to the CameraView's view
matrix and position, within 2e-4 of their max |value| (the tolerance of
``tests/test_torch_grads.py``); one gradient step on the view matrix lowers
the port's loss.
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
from luisacomputegaussiansplatting_tpu_torch.ops.render import render_view
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
