"""PyTorch port: the plain rasterizer against JAX ``rasterize_tiles`` (the
Pallas forward kernel in interpret mode) on identical payloads and ranges,
atol 2e-5 as the JAX suite's own Pallas-vs-jnp test; and the port's
autograd Function against the JAX custom VJP."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from luisacomputegaussiansplatting_tpu import config as jcfg
from luisacomputegaussiansplatting_tpu.io.synthetic import random_scene
from luisacomputegaussiansplatting_tpu.ops import rasterize_pallas as jrp
from luisacomputegaussiansplatting_tpu.ops.binning import bin_gaussians, bin_gaussians_nopack
from luisacomputegaussiansplatting_tpu.ops.projection import project_gaussians, tile_grid
from luisacomputegaussiansplatting_tpu.ops.render import build_payload
from luisacomputegaussiansplatting_tpu.ops.sh_eval import compute_colors
from luisacomputegaussiansplatting_tpu.utils.camera import look_at_camera
from luisacomputegaussiansplatting_tpu_torch import config as pcfg
from luisacomputegaussiansplatting_tpu_torch.ops import rasterize as pr
from luisacomputegaussiansplatting_tpu_torch.ops import rasterize_ref as pref

torch.set_num_threads(2)

ATOL = 2e-5


def t(x):
    return torch.from_numpy(np.array(x))


def jax_inputs(scene, cam, cfg):
    """JAX payload (9, capacity) and ranges as numpy, built by the JAX
    package's own pipeline."""
    def run(m, s, q, o, sh):
        colors = compute_colors(m, sh, cam.position, 3)
        proj = project_gaussians(m, s, q, cam, cfg)
        gx, gy = tile_grid(cam.width, cam.height, cfg.tile_wh)
        binner = bin_gaussians if cfg.pack_mode == "chunk" else bin_gaussians_nopack
        binned = binner(proj, gx, gy, cfg.max_pairs, None, cfg.tile_wh)
        payload = build_payload(proj, colors, o, binned)
        color, trans = jrp.rasterize_tiles(
            payload, binned.tile_starts, binned.tile_counts, gx, cam.width,
            cam.height, cfg)
        return payload[:9], binned.tile_starts, binned.tile_counts, color, trans

    out = jax.jit(run)(*scene.render_args())
    return [np.asarray(x) for x in out]


CASES = [
    ((64, 48), 16, None, "chunk"),
    ((64, 48), 32, None, "chunk"),
    ((96, 64), 32, 16, "none"),
    ((64, 48), 16, None, "none"),
    ((50, 38), 16, None, "chunk"),  # partial edge tiles
]


@pytest.mark.parametrize("res,tile,tile_h,pack", CASES)
def test_plain_rasterizer_matches_jax_pallas(res, tile, tile_h, pack):
    w, h = res
    cam = look_at_camera((3.0, -2.5, 2.0), (0, 0, 0), (0, 0, 1), fov=70.0,
                         width=w, height=h)
    scene = random_scene(120, seed=7)
    kw = dict(max_pairs=20_000, tile=tile, tile_h=tile_h, pack_mode=pack)
    payload, starts, counts, jc, jt = jax_inputs(scene, cam,
                                                 jcfg.RenderConfig(**kw))
    gx, _ = tile_grid(w, h, jcfg.RenderConfig(**kw).tile_wh)
    pc, ptr = pr.rasterize_tiles(t(payload), t(starts), t(counts), gx, w, h,
                                 pcfg.RenderConfig(**kw))
    assert pc.shape == jc.shape and ptr.shape == jt.shape
    np.testing.assert_allclose(pc.numpy(), jc, atol=ATOL)
    np.testing.assert_allclose(ptr.numpy(), jt, atol=ATOL)
    assert jc.max() > 0.05  # something was drawn
    # pixels past the image edge: T = 0 and no colour
    px, py, t0 = pref.tile_pixel_coords(torch.arange(len(starts)), gx, w, h,
                                        *pcfg.RenderConfig(**kw).tile_wh)
    off = (t0 == 0).numpy()
    assert np.all(ptr.numpy()[..., 0][off] == 0)
    assert np.all(pc.numpy()[off] == 0)


def test_saturation_latch_sticky_across_chunks():
    """One 16x16 tile, two CHUNKs: seven alpha=0.5 entries, then an
    alpha=0.99 blocker that would push T below 1e-4 (rejected: the pixel is
    done), then 128 faint entries that must all stay unapplied (the JAX
    suite's tests/test_rasterize.py:288 setup)."""
    chunk = jcfg.CHUNK
    cap = 2 * chunk
    opac = np.zeros(cap, np.float32)
    opac[:7] = 0.5
    opac[7] = 0.99
    opac[chunk:] = 0.02
    payload = np.zeros((jrp.PAYLOAD_ROWS, cap), np.float32)
    payload[0] = payload[1] = 8.0
    payload[2] = payload[4] = 1e-6
    payload[5] = opac
    payload[6:9] = 1.0
    starts, counts = np.array([0], np.int32), np.array([cap], np.int32)
    cfg = jcfg.RenderConfig(max_pairs=cap)
    jc, jt = jrp.rasterize_tiles(jnp.asarray(payload), starts, counts, 1, 16,
                                 16, cfg)
    pc, ptr = pr.rasterize_tiles(t(payload[:9]), t(starts), t(counts), 1, 16,
                                 16, pcfg.RenderConfig(max_pairs=cap))
    np.testing.assert_allclose(ptr.numpy(), 0.5 ** 7, rtol=2e-3)
    np.testing.assert_allclose(ptr.numpy(), np.asarray(jt), atol=1e-6)
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), atol=1e-6)


def test_backward_matches_jax_vjp():
    """The port's rasterize_tiles backward against jax.vjp of the JAX
    rasterize_tiles on the same cotangents, per payload field on the real
    entries (opacity > 0; the JAX kernel leaves padding unwritten), within
    1e-4 of the field's max."""
    scene = random_scene(60, seed=3)
    cam = look_at_camera((3.0, -2.5, 2.0), (0, 0, 0), (0, 0, 1), fov=70.0,
                         width=32, height=32)
    kw = dict(max_pairs=5_000)
    payload, starts, counts, jc, jt = jax_inputs(scene, cam,
                                                 jcfg.RenderConfig(**kw))
    rng = np.random.default_rng(4)
    d_color = rng.normal(size=jc.shape).astype(np.float32)
    d_trans = rng.normal(size=jt.shape).astype(np.float32)
    payload16 = np.zeros((jrp.PAYLOAD_ROWS, payload.shape[1]), np.float32)
    payload16[:9] = payload
    _, vjp = jax.vjp(
        lambda p: jrp.rasterize_tiles(p, starts, counts, 2, 32, 32,
                                      jcfg.RenderConfig(**kw)),
        jnp.asarray(payload16))
    want = np.asarray(vjp((jnp.asarray(d_color), jnp.asarray(d_trans)))[0])[:9]

    x = t(payload).requires_grad_()
    color, trans = pr.rasterize_tiles(x, t(starts), t(counts), 2, 32, 32,
                                      pcfg.RenderConfig(**kw))
    ((color * t(d_color)).sum() + (trans * t(d_trans)).sum()).backward()
    real = payload[5] > 0
    got = x.grad.numpy()
    assert np.isfinite(got).all() and np.all(got[:, ~real] == 0)
    for f in range(9):
        scale = np.abs(want[f, real]).max()
        assert scale > 0
        np.testing.assert_allclose(got[f, real] / scale,
                                   want[f, real] / scale, atol=1e-4,
                                   err_msg=f"field {f}")


def test_mxu_blend_not_ported_raises():
    payload = torch.zeros((9, 128))
    z = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="mxu"):
        pr.rasterize_forward(payload, z, z, 1, 16, 16,
                             pcfg.RenderConfig(blend_quad="mxu"))


def test_wrapper_rejects_non_cuda_non_cpu_tensors():
    """A tensor that is not on the CPU never takes the plain version: the
    wrapper launches the kernel or raises."""
    payload = torch.zeros((9, 128), device="meta")
    z = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        pr.rasterize_forward(payload, z, z, 1, 16, 16, pcfg.RenderConfig())
