"""PyTorch port: the backward blend against the JAX package's Pallas backward
kernel (interpret mode) on the same payloads, ranges and residuals.

The port's ``rasterize_backward`` takes its plain version on the CPU
(``rasterize_backward_reference``); it is held to the JAX ``d_payload``
field by field, on the entries that hold a gaussian, within 1e-4 x the
field's max |d_payload| (the JAX kernel sums prefixes and pixel moments on
the MXU, the port per pixel and entry: the results are equal up to
rounding); in blend_quad="mxu" within 1e-3 (MXU_TOL below says why). The
saturated-wall scene of ``tests/test_grads.py`` is held at
that test's 2e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from luisacomputegaussiansplatting_tpu import config as jcfg
from luisacomputegaussiansplatting_tpu.io.synthetic import random_scene as jrandom_scene
from luisacomputegaussiansplatting_tpu.ops import rasterize_pallas as jrp
from luisacomputegaussiansplatting_tpu.ops.binning import bin_gaussians, bin_gaussians_nopack
from luisacomputegaussiansplatting_tpu.ops.projection import project_gaussians, tile_grid
from luisacomputegaussiansplatting_tpu.ops.render import build_payload, render as jrender
from luisacomputegaussiansplatting_tpu.ops.sh_eval import compute_colors
from luisacomputegaussiansplatting_tpu.utils.camera import look_at_camera as jlook
from luisacomputegaussiansplatting_tpu_torch import config as pcfg
from luisacomputegaussiansplatting_tpu_torch.ops import rasterize as pr
from luisacomputegaussiansplatting_tpu_torch.ops.render import render
from luisacomputegaussiansplatting_tpu_torch.utils.camera import look_at_camera

torch.set_num_threads(2)

TOL = 1e-4
# blend_quad="mxu": power' is a sum of terms up to ~1e3 that cancel to
# O(1); the port rounds each multiply and add (so its kernels can repeat
# the plain version's decisions), XLA's dot on the CPU fuses them, so the
# two alphas differ by up to ~3e-4 relative and a per-entry gradient by up
# to ~6e-4 of its field's max (measured 5.4e-4 at tile 32; the port's own
# mxu against its vpu 6.4e-4, JAX's 1.1e-4)
MXU_TOL = 1e-3
CAM = ((3.0, -2.5, 2.0), (0, 0, 0), (0, 0, 1))


def t(x):
    return torch.from_numpy(np.array(x))


def jax_backward_case(scene, w, h, cfg, seed):
    """The JAX pipeline's payload, ranges and entry gids, a residual of
    normal cotangents (numpy, ``seed``) with the forward's own C and T, and
    the JAX backward kernel's d_payload; all numpy."""
    cam = jlook(*CAM, fov=70.0, width=w, height=h)
    gx, gy = tile_grid(w, h, cfg.tile_wh)

    def forward(m, s, q, o, sh):
        colors = compute_colors(m, sh, cam.position, 3)
        proj = project_gaussians(m, s, q, cam, cfg)
        binner = bin_gaussians if cfg.pack_mode == "chunk" else bin_gaussians_nopack
        binned = binner(proj, gx, gy, cfg.max_pairs, None, cfg.tile_wh)
        payload = build_payload(proj, colors, o, binned)
        out = jrp.rasterize_forward(payload, binned.tile_starts,
                                    binned.tile_counts, gx, w, h, cfg)
        return payload, binned.tile_starts, binned.tile_counts, \
            binned.entry_gid, out[:, :, 0:3], out[:, :, 3:4]

    payload, starts, counts, gid, color, trans = jax.jit(forward)(
        *scene.render_args())
    rng = np.random.default_rng(seed)
    d_color = rng.normal(size=color.shape).astype(np.float32)
    d_trans = rng.normal(size=trans.shape).astype(np.float32)
    residual = np.concatenate([d_color, d_trans, np.asarray(color),
                               np.asarray(trans)], axis=2)
    d_payload = jrp.rasterize_backward(payload, starts, counts,
                                       jnp.asarray(residual), gx, w, h, cfg)
    return dict(payload=np.asarray(payload)[:9], starts=np.asarray(starts),
                counts=np.asarray(counts), gid=np.asarray(gid),
                residual=residual, d_payload=np.asarray(d_payload)[:9],
                grid_x=gx, d_color=d_color, d_trans=d_trans)


def assert_fields_close(port, want, keep, tol=TOL):
    """Per field, over the entries in ``keep``: |diff| <= tol x max|want|."""
    port, want = np.asarray(port)[:, keep], np.asarray(want)[:, keep]
    assert np.isfinite(port).all()
    for f in range(want.shape[0]):
        scale = np.abs(want[f]).max() + 1e-30
        np.testing.assert_allclose(port[f] / scale, want[f] / scale, atol=tol,
                                   err_msg=f"field {f}")


CASES = [
    (16, None, "chunk"),
    (16, None, "none"),
    (32, None, "chunk"),
    (32, 16, "none"),
]


@pytest.mark.parametrize("tile,tile_h,pack", CASES)
def test_backward_matches_jax_kernel(tile, tile_h, pack):
    kw = dict(max_pairs=10_000, tile=tile, tile_h=tile_h, pack_mode=pack)
    case = jax_backward_case(jrandom_scene(40, seed=13), 48, 32,
                             jcfg.RenderConfig(**kw), seed=tile + len(pack))
    d = pr.rasterize_backward(
        t(case["payload"]), t(case["starts"]), t(case["counts"]),
        t(case["residual"]), case["grid_x"], 48, 32, pcfg.RenderConfig(**kw))
    assert d.shape == case["payload"].shape
    keep = case["gid"] >= 0
    assert_fields_close(d, case["d_payload"], keep)
    # every field received gradient, and no entry without a gaussian did
    assert np.all(np.abs(case["d_payload"][:, keep]).max(axis=1) > 0)
    assert torch.all(d[:, torch.from_numpy(~keep)] == 0)


def test_rasterize_tiles_backward_takes_cotangents():
    """The autograd Function builds the residual from the cotangents (a
    non-contiguous one, and None for T) and returns the backward's
    d_payload."""
    kw = dict(max_pairs=10_000)
    case = jax_backward_case(jrandom_scene(40, seed=13), 48, 32,
                             jcfg.RenderConfig(**kw), seed=5)
    cfg = pcfg.RenderConfig(**kw)
    x = t(case["payload"]).requires_grad_()
    color, trans = pr.rasterize_tiles(x, t(case["starts"]), t(case["counts"]),
                                      case["grid_x"], 48, 32, cfg)
    # a permuted view: the cotangent reaching the Function is not contiguous
    d_color = t(case["d_color"]).permute(2, 0, 1).contiguous().permute(1, 2, 0)
    (color * d_color).sum().backward()
    want = pr.rasterize_backward(
        x.detach(), t(case["starts"]), t(case["counts"]),
        pr.make_residual(t(case["d_color"]), None, color.detach(),
                         trans.detach()),
        case["grid_x"], 48, 32, cfg)
    assert torch.equal(x.grad, want)


def test_backward_early_exit_on_saturated_tile():
    """An opaque wall saturates every tile well before its range ends: the
    entries behind the stop get zero gradient. The port's gradients match
    the JAX kernel path's (2e-3 scaled, as tests/test_grads.py)."""
    scene = jrandom_scene(600, seed=1, extent=0.5, scale_range=(0.2, 0.4))
    scene = scene._replace(opacities=np.full((600,), 0.85, np.float32))
    args = [np.asarray(a) for a in scene.render_args()]
    wimg = np.random.default_rng(2).normal(size=(3, 32, 32)).astype(np.float32)
    eye = ((0, 0, -3.0), (0, 0, 0), (0, 1, 0))
    jcam = jlook(*eye, fov=60.0, width=32, height=32)
    cfg = jcfg.RenderConfig(max_pairs=16_000)
    want = jax.jit(jax.grad(
        lambda *a: jnp.sum(jrender(*a, jcam, cfg=cfg) * wimg),
        argnums=(0, 3)))(*args)
    leaves = [t(a).requires_grad_() for a in args]
    img = render(*leaves, look_at_camera(*eye, fov=60.0, width=32, height=32),
                 cfg=pcfg.RenderConfig(max_pairs=16_000))
    (img * t(wimg)).sum().backward()
    for a, b in zip((leaves[0].grad, leaves[3].grad), want):
        a, b = a.numpy(), np.asarray(b)
        assert np.isfinite(a).all()
        scale = np.abs(b).max() + 1e-8
        np.testing.assert_allclose(a / scale, b / scale, atol=2e-3)


@pytest.mark.parametrize("tile,tile_h,pack", [(32, None, "none"),
                                              (32, 16, "none")])
def test_mxu_backward_matches_jax_kernel(tile, tile_h, pack):
    """blend_quad="mxu": the port's plain backward against the JAX mxu
    backward kernel on a seeded residual, per field within MXU_TOL of the
    field's max: the JAX kernel evaluates power' with an XLA dot, which
    sums the polynomial's terms in another order and rounding than the
    port, so alpha differs by rounding."""
    kw = dict(max_pairs=10_000, tile=tile, tile_h=tile_h, pack_mode=pack,
              blend_quad="mxu")
    case = jax_backward_case(jrandom_scene(40, seed=13), 48, 32,
                             jcfg.RenderConfig(**kw), seed=tile + len(pack))
    d = pr.rasterize_backward(
        t(case["payload"]), t(case["starts"]), t(case["counts"]),
        t(case["residual"]), case["grid_x"], 48, 32, pcfg.RenderConfig(**kw))
    keep = case["gid"] >= 0
    assert_fields_close(d, case["d_payload"], keep, tol=MXU_TOL)
    assert np.all(np.abs(case["d_payload"][:, keep]).max(axis=1) > 0)
    assert torch.all(d[:, torch.from_numpy(~keep)] == 0)


def test_backward_wrapper_rejects_unported_and_non_cpu():
    payload = torch.zeros((9, 128))
    z = torch.zeros(1, dtype=torch.int32)
    res = torch.zeros((1, 256, 8))
    with pytest.raises(ValueError, match="CUDA"):
        pr.rasterize_backward(payload.to("meta"), z.to("meta"), z.to("meta"),
                              res.to("meta"), 1, 16, 16, pcfg.RenderConfig())


def accepted_tiles():
    """Every tile the backward kernel takes: a multiple of 32 pixels, at
    most 1024."""
    return [(w, h) for w in range(1, pr.MAX_TILE_PIXELS + 1)
            for h in range(1, pr.MAX_TILE_PIXELS // w + 1) if (w * h) % 32 == 0]


def test_backward_launch_shape_covers_every_accepted_tile():
    """Whole warps, the kernel's instances (1, 2 or 4 pixels a thread, at
    most 1024 / P threads), four warps or more where a thread takes several
    pixels, and several pixels a thread wherever four warps allow it."""
    tiles = accepted_tiles()
    assert len(tiles) > 100
    for w, h in tiles:
        threads, per_thread = pr.backward_launch_shape(w, h)
        assert per_thread in pr.BACKWARD_PIXELS_PER_THREAD
        assert threads * per_thread == w * h
        assert threads % 32 == 0
        assert threads <= pr.MAX_TILE_PIXELS // per_thread
        assert threads >= 128 or per_thread == 1
        if w * h % 64 == 0 and w * h >= 256:
            assert per_thread > 1


@pytest.mark.parametrize("tile_w,tile_h,threads,per_thread", [
    (16, 16, 128, 2),
    (32, 32, 256, 4),
    (32, 16, 128, 4),
    (16, 8, 128, 1),
    (8, 4, 32, 1),
    (32, 3, 96, 1),
])
def test_backward_launch_shape_of_common_tiles(tile_w, tile_h, threads,
                                               per_thread):
    assert pr.backward_launch_shape(tile_w, tile_h) == (threads, per_thread)


@pytest.mark.parametrize("tile_w,tile_h", [(10, 10), (64, 32), (33, 32),
                                           (0, 32)])
def test_backward_launch_shape_rejects_tiles_never_taken(tile_w, tile_h):
    with pytest.raises(ValueError, match="multiple of 32"):
        pr.backward_launch_shape(tile_w, tile_h)
