"""PyTorch port: gradients of the whole render with respect to the five
gaussian groups and the background, against ``jax.grad`` of the JAX
``render`` (its Pallas kernels in interpret mode), at the sizes and
tolerances of ``tests/test_grads.py``: 2e-4 of each group's max |grad|;
finite differences of the port's own render; the exact background gradient
(rtol 2e-4); the bf16 gradient reduction within 2e-2 of the f32 one; and
the production configuration of ``bench.py`` (``PROD_KW``) within 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from luisacomputegaussiansplatting_tpu.config import RenderConfig as JConfig
from luisacomputegaussiansplatting_tpu.io.synthetic import random_scene as jrandom_scene
from luisacomputegaussiansplatting_tpu.ops.render import render as jrender
from luisacomputegaussiansplatting_tpu.utils.camera import look_at_camera as jlook
from luisacomputegaussiansplatting_tpu_torch.config import RenderConfig
from luisacomputegaussiansplatting_tpu_torch.ops.render import render, render_aux
from luisacomputegaussiansplatting_tpu_torch.utils.camera import look_at_camera

torch.set_num_threads(2)

EYE = ((2.5, -2.2, 1.8), (0, 0, 0), (0, 0, 1))
W, H = 48, 32
CAM = look_at_camera(*EYE, fov=70.0, width=W, height=H)
JCAM = jlook(*EYE, fov=70.0, width=W, height=H)
N = 40
KW = dict(max_pairs=10_000)
# bench.py's headline config (tile 32, no-pack, cull, post-sort trim, fused
# sort, bf16 payload and reduction, blend_quad="mxu") with capacities sized
# for this scene at bench's ratio of sorted to AABB capacity (3.9M / 4.5M);
# the trim is on (1,300 rounds up to 1,408 < 1,500) and cuts nothing
PROD_KW = dict(max_pairs=1_500, tile=32, pack_mode="none", tile_cull=True,
               max_pairs_sorted=1_300, grad_reduce_dtype="bf16",
               payload_dtype="bf16", sort_mode="fused", blend_quad="mxu")
NAMES = ["means", "scales", "quats", "opacities", "sh", "bg"]
BG = np.array([0.25, 0.5, 0.75], np.float32)
WIMG = np.random.default_rng(0).normal(size=(3, H, W)).astype(np.float32)


def scene_arrays():
    return [np.asarray(a) for a in jrandom_scene(N, seed=13).render_args()]


def jax_grads(kw):
    def loss(*a):
        img = jrender(*a[:5], JCAM, bg_color=a[5], cfg=JConfig(**kw))
        return jnp.sum(img * WIMG)

    g = jax.grad(loss, argnums=tuple(range(6)))(*scene_arrays(), BG)
    return [np.asarray(x) for x in g]


def port_grads(kw):
    leaves = [torch.from_numpy(np.array(a)).requires_grad_()
              for a in scene_arrays() + [BG]]
    img = render(*leaves[:5], CAM, bg_color=leaves[5], cfg=RenderConfig(**kw))
    (img * torch.from_numpy(WIMG)).sum().backward()
    return [x.grad.numpy() for x in leaves]


def assert_scaled_close(port, want, atol, names=NAMES):
    for name, a, b in zip(names, port, want):
        assert np.isfinite(a).all(), name
        scale = np.abs(b).max() + 1e-6
        np.testing.assert_allclose(a / scale, b / scale, atol=atol,
                                   err_msg=name)


@pytest.fixture(scope="module")
def grads():
    return port_grads(KW), jax_grads(KW)


def test_grads_match_jax(grads):
    port, want = grads
    assert_scaled_close(port, want, 2e-4)


def test_grads_nonzero(grads):
    port, _ = grads
    for name, g in zip(NAMES, port):
        assert np.abs(g).max() > 1e-6, name


@pytest.mark.parametrize("argnum", [0, 1, 2, 3, 4])
def test_finite_differences(grads, argnum):
    """Central differences of the port's own render at its largest-|grad|
    coordinates; the render is only piecewise smooth (integer radii, tile
    rects), so a match at any eps of the cascade passes."""
    port, _ = grads
    args = scene_arrays()
    cfg = RenderConfig(**KW)
    flat = port[argnum].reshape(-1)

    def image(a):
        with torch.no_grad():
            return render(*[torch.from_numpy(np.array(x)) for x in a], CAM,
                          bg_color=tuple(BG), cfg=cfg).numpy().astype(np.float64)

    for idx in np.argsort(-np.abs(flat))[:4]:
        an, fds = float(flat[idx]), []
        for eps in (5e-4, 1e-4, 2e-5):
            pert = np.zeros_like(flat)
            pert[idx] = eps
            hi, lo = list(args), list(args)
            hi[argnum] = args[argnum] + pert.reshape(args[argnum].shape)
            lo[argnum] = args[argnum] - pert.reshape(args[argnum].shape)
            fd = float(((image(hi) - image(lo)) * WIMG).sum() / (2 * eps))
            fds.append(fd)
            if abs(fd - an) <= 0.05 * max(abs(an), abs(fd), 1e-3):
                break
        else:
            raise AssertionError(f"argnum {argnum} idx {idx}: fd {fds} vs {an}")


def test_bg_gradient_exact(grads):
    """dL/dbg = sum over pixels of w_img * T."""
    port, _ = grads
    with torch.no_grad():
        _, aux = render_aux(*[torch.from_numpy(np.array(a))
                              for a in scene_arrays()],
                            CAM, bg_color=tuple(BG), cfg=RenderConfig(**KW))
    want = (WIMG * aux.transmittance.numpy()[None]).sum(axis=(1, 2))
    np.testing.assert_allclose(port[5], want, rtol=2e-4)


def test_bf16_grad_reduce_close_to_f32(grads):
    port, _ = grads
    g16 = port_grads(dict(KW, grad_reduce_dtype="bf16"))
    for name, a, b in zip(NAMES[:5], port, g16):
        scale = np.abs(a).max() + 1e-8
        np.testing.assert_allclose(a / scale, b / scale, atol=2e-2,
                                   err_msg=name)
        assert np.abs(b).max() > 0


def test_bf16_payload_gradient_matches_jax():
    """With payload_dtype="bf16" the forward rounds opacity and rgb to bf16;
    the backward passes their gradient through unrounded, as the JAX custom
    VJP does (a cast under autograd would round the gradient to bf16)."""
    kw = dict(KW, payload_dtype="bf16", rasterizer="jnp")
    port, want = port_grads(kw), jax_grads(kw)
    assert_scaled_close([port[3], port[4]], [want[3], want[4]], 1e-5,
                        names=["opacities", "sh"])


def test_production_config_grads_match_jax():
    """All five groups and bg at bench's production config against
    jax.grad, within 1e-3 of each group's max: the per-entry gradients
    differ by the mxu polynomial's rounding (tests/test_torch_backward.py),
    and rounding each row to bf16 before the reduction (one bf16 ulp is
    2^-8 relative) turns a last-bit difference into an ulp where a row lies
    near a rounding boundary (measured: 4.0e-4, sh)."""
    port, want = port_grads(PROD_KW), jax_grads(PROD_KW)
    assert_scaled_close(port, want, 1e-3)
    for name, g in zip(NAMES, port):
        assert np.abs(g).max() > 1e-6, name
