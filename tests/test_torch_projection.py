"""PyTorch port: SH colours and projection against the JAX package in every
projection mode. Integer outputs (radius, rects, tiles_touched, valid) must
be identical; float outputs agree to float32 op order (rtol 1e-5)."""

import jax
import numpy as np
import pytest
import torch

from luisacomputegaussiansplatting_tpu import config as jcfg
from luisacomputegaussiansplatting_tpu.io.synthetic import random_scene
from luisacomputegaussiansplatting_tpu.ops import projection as jproj
from luisacomputegaussiansplatting_tpu.ops import sh_eval as jsh
from luisacomputegaussiansplatting_tpu.utils.camera import look_at_camera
from luisacomputegaussiansplatting_tpu_torch import config as pcfg
from luisacomputegaussiansplatting_tpu_torch.ops import projection as pproj
from luisacomputegaussiansplatting_tpu_torch.ops import sh_eval as psh
from luisacomputegaussiansplatting_tpu_torch.utils import camera as pcam

torch.set_num_threads(2)

W, H = 96, 64
CAM_ARGS = ((3.2, -2.8, 2.1), (0, 0, 0), (0, 0, 1))
INT_FIELDS = ("radius", "rect_min", "rect_max", "tiles_touched", "valid")


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def scene():
    s = random_scene(400, seed=11, scale_range=(0.02, 0.3))
    rng = np.random.default_rng(6)
    opac = rng.uniform(0.002, 0.95, 400).astype(np.float32)
    return [np.asarray(x) for x in s._replace(opacities=opac)]


def cams():
    return (look_at_camera(*CAM_ARGS, fov=70.0, width=W, height=H),
            pcam.look_at_camera(*CAM_ARGS, fov=70.0, width=W, height=H))


def assert_proj_equal(p, j):
    for name in p._fields:
        a, b = getattr(p, name).detach().numpy(), np.asarray(getattr(j, name))
        if name in INT_FIELDS:
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6,
                                       err_msg=name)


@pytest.mark.parametrize("degree", [0, 3])
def test_compute_colors(scene, degree):
    means, _, _, _, sh = scene
    jc, pc = cams()
    want = jsh.compute_colors(means, sh, jc.position, degree)
    got = psh.compute_colors(t(means), t(sh), pc.position, degree)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


MODES = [
    dict(),
    dict(use_focal=False),
    dict(rect_mode="lcgs"),
    dict(tile=32),
    dict(tile=32, tile_h=16),
    dict(tight_radius=True),
    dict(tight_radius=True, tile=32, rect_mode="lcgs"),
]


@pytest.mark.parametrize("ewa_mode", ["inria", "lcgs"])
@pytest.mark.parametrize("kw", MODES, ids=[str(m) for m in MODES])
def test_project_gaussians_modes(scene, kw, ewa_mode):
    means, scales, quats, opac, _ = scene
    jc, pc = cams()
    jconf, pconf = jcfg.RenderConfig(**kw), pcfg.RenderConfig(**kw)
    # eager: under jit XLA contracts a*b+c into FMAs, which torch never does
    j = jproj.project_gaussians(means, scales, quats, jc, jconf,
                                ewa_mode=ewa_mode, opacities=opac)
    p = pproj.project_gaussians(t(means), t(scales), t(quats), pc, pconf,
                                ewa_mode=ewa_mode, opacities=t(opac))
    assert_proj_equal(p, j)
    assert int(p.tiles_touched.sum()) > 0


def test_project_active_mask_probe_and_view(scene):
    means, scales, quats, opac, _ = scene
    jc, pc = cams()
    mask = np.arange(len(means)) % 3 != 0
    probe = np.zeros((len(means), 2), np.float32)
    jv = jc.to_view()
    j = jproj.project_gaussians(means, scales, quats, jv, jcfg.RenderConfig(),
                                scale_modifier=1.3, width=W, height=H,
                                active_mask=mask, means2d_probe=probe)
    pv = pc.to_view("cpu")
    p = pproj.project_gaussians(t(means), t(scales), t(quats), pv,
                                pcfg.RenderConfig(), scale_modifier=1.3,
                                width=W, height=H, active_mask=t(mask),
                                means2d_probe=t(probe))
    assert_proj_equal(p, j)
    assert not p.valid.numpy()[~mask].any()


def test_projection_gradients_match_jax(scene):
    means, scales, quats, _, _ = scene
    jc, pc = cams()
    w = np.random.default_rng(8).normal(size=(len(means), 3)).astype(np.float32)

    def jloss(m, s, q):
        pj = jproj.project_gaussians(m, s, q, jc, jcfg.RenderConfig())
        return (pj.conic * w).sum() + pj.means2d.sum()

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(means, scales, quats)
    m, s, q = (t(x).requires_grad_() for x in (means, scales, quats))
    pp = pproj.project_gaussians(m, s, q, pc, pcfg.RenderConfig())
    ((pp.conic * t(w)).sum() + pp.means2d.sum()).backward()
    for a, b in zip((m.grad, s.grad, q.grad), jg):
        b = np.asarray(b)
        scale = np.abs(b).max()
        np.testing.assert_allclose(a.numpy() / scale, b / scale, atol=1e-4)


@pytest.mark.parametrize("tile", [16, (32, 16)])
def test_tile_grid_and_rect(tile):
    assert pproj.tile_grid(1920, 1080, tile) == jproj.tile_grid(1920, 1080, tile)
    rng = np.random.default_rng(1)
    m2 = rng.uniform(-50, 400, (200, 2)).astype(np.float32)
    r = rng.integers(0, 60, 200).astype(np.int32)
    for mode in ("inria", "lcgs"):
        j = jproj._tile_rect(m2, r, 12, 9, mode, tile)
        p = pproj._tile_rect(t(m2), t(r), 12, 9, mode, tile)
        for a, b in zip(p, j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


#: ``tests/test_projection.py``'s near-cull means (z = 0.1 and behind the
#: camera are culled), then two at exactly ``near`` = 0.2, which stay
NEAR_MEANS = np.array([[0, 0, 0.1], [0, 0, 0.25], [0, 0, -2.0], [0, 0, 3.0],
                       [0, 0, 0.2], [0.01, 0.02, 0.2]], np.float32)


def test_near_cull():
    """Gaussians in front of ``near`` or behind the camera get radius 0, no
    tiles and ``valid`` False, as in the JAX package, whose radius,
    tiles_touched and valid the port equals exactly; ``depth >= near``
    keeps the two means at depth 0.2 exactly."""
    n = NEAR_MEANS.shape[0]
    scales = np.full((n, 3), 0.05, np.float32)
    quats = np.tile(np.array([0, 0, 0, 1.0], np.float32), (n, 1))
    eye = ((0, 0, 0), (0, 0, 1), (0, 1, 0))
    j = jproj.project_gaussians(
        NEAR_MEANS, scales, quats,
        look_at_camera(*eye, width=64, height=64), jcfg.RenderConfig())
    p = pproj.project_gaussians(
        t(NEAR_MEANS), t(scales), t(quats),
        pcam.look_at_camera(*eye, width=64, height=64), pcfg.RenderConfig())
    for name in ("radius", "tiles_touched", "valid"):
        np.testing.assert_array_equal(getattr(p, name).numpy(),
                                      np.asarray(getattr(j, name)),
                                      err_msg=name)
    radius = p.radius.numpy()
    assert (radius[[0, 2]] == 0).all() and (radius[[1, 3, 4, 5]] > 0).all()
    assert p.valid.numpy().tolist() == [False, True, False, True, True, True]
    near = np.float32(pcfg.RenderConfig().near)
    np.testing.assert_array_equal(p.depth.numpy()[4:], [near, near])
    np.testing.assert_array_equal(np.asarray(j.depth)[4:], [near, near])
