"""PyTorch port: the plain rasterizer against JAX ``rasterize_tiles`` (the
Pallas forward kernel in interpret mode) on identical payloads and ranges,
in both blend modes, atol 2e-5 as the JAX suite's own Pallas-vs-jnp test;
the port's mxu image against its vpu image; and the port's autograd
Function against the JAX custom VJP.

The mxu cases are held at atol 5e-4, the JAX suite's bound of mxu against
vpu (tests/test_rasterize.py:384): the JAX kernel sums the eight terms of the
power polynomial in the XLA CPU dot's order, the port in its own, and the
terms cancel (a wide splat centred far from the tile origin has |a0| up to
~3000 against |power'| ~ 1). On these scenes both sit up to ~5e-4 from
power' in float64 and up to 3.3e-4 from each other, so alpha differs by as
much relative (measured: 1.1e-4 on 1 of 12288 values at tile 32).
An alpha_min or stop flip would move a pixel by ~4e-3; these scenes meet
none."""

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
from luisacomputegaussiansplatting_tpu_torch.io import synthetic as psyn
from luisacomputegaussiansplatting_tpu_torch.ops import rasterize as pr
from luisacomputegaussiansplatting_tpu_torch.ops import rasterize_ref as pref
from luisacomputegaussiansplatting_tpu_torch.ops.render import render_aux
from luisacomputegaussiansplatting_tpu_torch.utils.camera import look_at_camera as plook

torch.set_num_threads(2)

ATOL = 2e-5
MXU_ATOL = 5e-4


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
    ((64, 48), 16, None, "chunk", "vpu"),
    ((64, 48), 32, None, "chunk", "vpu"),
    ((96, 64), 32, 16, "none", "vpu"),
    ((64, 48), 16, None, "none", "vpu"),
    ((50, 38), 16, None, "chunk", "vpu"),  # partial edge tiles
    ((64, 48), 16, None, "chunk", "mxu"),
    ((64, 48), 32, None, "none", "mxu"),
    ((96, 64), 32, 16, "none", "mxu"),  # the basis' x over tile_w, y over tile_h
]


@pytest.mark.parametrize("res,tile,tile_h,pack,blend", CASES)
def test_plain_rasterizer_matches_jax_pallas(res, tile, tile_h, pack, blend):
    w, h = res
    cam = look_at_camera((3.0, -2.5, 2.0), (0, 0, 0), (0, 0, 1), fov=70.0,
                         width=w, height=h)
    scene = random_scene(120, seed=7)
    kw = dict(max_pairs=20_000, tile=tile, tile_h=tile_h, pack_mode=pack,
              blend_quad=blend)
    payload, starts, counts, jc, jt = jax_inputs(scene, cam,
                                                 jcfg.RenderConfig(**kw))
    gx, _ = tile_grid(w, h, jcfg.RenderConfig(**kw).tile_wh)
    pc, ptr = pr.rasterize_tiles(t(payload), t(starts), t(counts), gx, w, h,
                                 pcfg.RenderConfig(**kw))
    assert pc.shape == jc.shape and ptr.shape == jt.shape
    atol = MXU_ATOL if blend == "mxu" else ATOL
    np.testing.assert_allclose(pc.numpy(), jc, atol=atol)
    np.testing.assert_allclose(ptr.numpy(), jt, atol=atol)
    assert jc.max() > 0.05  # something was drawn
    # pixels past the image edge: T = 0 and no colour
    t0 = pref.tile_pixel_coords(torch.arange(len(starts)), gx, w, h,
                                *pcfg.RenderConfig(**kw).tile_wh).t0
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


@pytest.mark.parametrize("tile,pack", [(16, "chunk"), (32, "none")])
def test_mxu_image_matches_vpu(tile, pack):
    """The port's blend_quad="mxu" render within 5e-4 of its "vpu" render
    (the bound of tests/test_rasterize.py:384, which this mirrors): the two
    evaluate the same power in another order, and the guard band keeps
    splat centres."""
    # the scene and camera of tests/test_rasterize.py::small_case
    scene = psyn.random_scene(80, seed=7, device="cpu")
    cam = plook((3.0, -2.5, 2.0), (0, 0, 0), (0, 0, 1), fov=70.0, width=64,
                height=48)
    out = {}
    with torch.no_grad():
        for blend in ("vpu", "mxu"):
            cfg = pcfg.RenderConfig(max_pairs=20_000, tile=tile,
                                    pack_mode=pack, blend_quad=blend)
            out[blend] = render_aux(*scene.render_args(), cam,
                                    bg_color=(0.2, 0.3, 0.4), cfg=cfg)
    (img_v, aux_v), (img_m, aux_m) = out["vpu"], out["mxu"]
    assert float((img_v - img_m).abs().max()) < 5e-4
    assert float((aux_v.transmittance - aux_m.transmittance).abs().max()) < 5e-4
    assert float(img_m.max()) > 0.25


def test_wrapper_rejects_non_cuda_non_cpu_tensors():
    """A tensor that is not on the CPU never takes the plain version: the
    wrapper launches the kernel or raises."""
    payload = torch.zeros((9, 128), device="meta")
    z = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        pr.rasterize_forward(payload, z, z, 1, 16, 16, pcfg.RenderConfig())


def accepted_forward_tiles():
    """Every tile the forward kernel takes: 1 to 1024 pixels."""
    return [(w, h) for w in range(1, pr.MAX_TILE_PIXELS + 1)
            for h in range(1, pr.MAX_TILE_PIXELS // w + 1)]


def test_forward_launch_shape_covers_every_accepted_tile():
    """Whole warps, one of the kernel's instances, every pixel once; two
    pixels a thread exactly where that makes four whole warps or more."""
    for w, h in accepted_forward_tiles():
        threads, per = pr.forward_launch_shape(w, h)
        pix = w * h
        assert per in pr.FORWARD_PIXELS_PER_THREAD
        assert threads % 32 == 0 and threads * per <= pr.MAX_TILE_PIXELS
        assert threads * per >= pix > threads * per - 32 * per
        assert per == (2 if pix % 64 == 0 and pix >= 256 else 1)


@pytest.mark.parametrize("tile_w,tile_h,threads,per_thread", [
    (16, 16, 128, 2),
    (32, 32, 512, 2),
    (32, 16, 256, 2),
    (16, 8, 128, 1),
    (8, 4, 32, 1),
    (32, 3, 96, 1),
    (10, 10, 128, 1),
    (1, 1, 32, 1),
])
def test_forward_launch_shape_of_common_tiles(tile_w, tile_h, threads,
                                              per_thread):
    assert pr.forward_launch_shape(tile_w, tile_h) == (threads, per_thread)


@pytest.mark.parametrize("tile_w,tile_h", [(64, 32), (33, 32), (0, 32),
                                           (16, 0)])
def test_forward_launch_shape_rejects_tiles_never_taken(tile_w, tile_h):
    with pytest.raises(ValueError, match="pixels"):
        pr.forward_launch_shape(tile_w, tile_h)


@pytest.mark.parametrize("tile_w,tile_h,per,warp_region", [
    (32, 32, 2, (8, 8)),
    (32, 16, 2, (8, 8)),
    (16, 16, 2, (8, 8)),
    (16, 4, 2, (16, 4)),
    (32, 32, 1, (8, 4)),
    (10, 10, 1, None),
    (32, 3, 1, None),
])
def test_forward_pixel_map_groups_are_compact(tile_w, tile_h, per,
                                              warp_region):
    """Every pixel of the tile exactly once, pad lanes none; a thread's P
    pixels in the P groups of its warp; where the tile is whole 8x4 boxes,
    each group (one slot of a warp's 32 lanes) an 8x4 box and each warp's
    groups one compact region; otherwise 32 pixels in row order."""
    m = pr.forward_pixel_map(tile_w, tile_h, per)
    threads = m.shape[0]
    assert m.dtype == torch.int32 and m.shape == (threads, per)
    assert threads % 32 == 0
    assert sorted(m[m >= 0].tolist()) == list(range(tile_w * tile_h))
    groups = m.reshape(-1, 32, per).permute(0, 2, 1).reshape(-1, 32)
    for g, group in enumerate(groups):
        if warp_region is None:
            want = torch.arange(32 * g, 32 * g + 32)
            want = torch.where(want < tile_w * tile_h, want, -1)
            assert torch.equal(group, want.to(torch.int32))
            continue
        x, y = group % tile_w, group // tile_w
        assert torch.equal(x - x.min(), torch.arange(32) % 8)
        assert torch.equal(y - y.min(), torch.arange(32) // 8)
    if warp_region is None:
        return
    for warp in m.reshape(-1, 32 * per):
        x, y = warp % tile_w, warp // tile_w
        assert (int(x.max() - x.min() + 1), int(y.max() - y.min() + 1)) \
            == warp_region


@pytest.mark.parametrize("tile_w,tile_h,per", [(32, 32, 4), (16, 16, 3),
                                               (10, 10, 2), (32, 3, 2)])
def test_forward_pixel_map_rejects_instances_never_built(tile_w, tile_h, per):
    """Only the kernel's instances (``FORWARD_PIXELS_PER_THREAD``), and two
    pixels a thread only where they make whole warps."""
    with pytest.raises(ValueError, match="whole warps"):
        pr.forward_pixel_map(tile_w, tile_h, per)
