"""K6, the projection kernel pair (``csrc/projection.cu``), against the plain
version (``ops/projection.py::project_gaussians_reference``).

The unmarked cases run on the CPU: CPU tensors take the plain version and
build nothing (also where the camera takes a gradient), other devices take
the kernels whether or not it does, and the kernel wrappers' checks raise
before any build. Cases marked ``card``
need a CUDA device and skip without one. This file imports no JAX; on the
card run it alone, without the JAX-loading ``conftest.py``:

    python -m pytest tests/test_torch_projection_kernel.py -q --noconftest

Tolerances: the forward equals the plain version bit for bit in all eight
fields (the kernel rounds every op as torch's ops do, in their order); the
gradients lie within GRAD_TOL x each gradient's max |plain value|, since the
kernel chains the derivatives in another order than autograd does. Where a
scene puts gaussians behind the camera with wide footprints, the gradient
of a few rows is ill-conditioned in float32: there the two chains are held
to a float64 evaluation of the plain version instead, the kernel no farther
from it than F64_FACTOR x autograd's float32 chain; so are the rows one by
one, each relative to its own largest value, at three percentiles. The
camera's gradient (the sum of the kernel's per-gaussian terms) is held like
the others.
"""

import importlib

import numpy as np
import pytest
import torch

from luisacomputegaussiansplatting_tpu_torch.config import RenderConfig
from luisacomputegaussiansplatting_tpu_torch.io.synthetic import random_scene
from luisacomputegaussiansplatting_tpu_torch.models import densify
from luisacomputegaussiansplatting_tpu_torch.models import trainer
from luisacomputegaussiansplatting_tpu_torch.models.gaussians import (
    GaussianParams, GaussianScene)
from luisacomputegaussiansplatting_tpu_torch.ops import projection
from luisacomputegaussiansplatting_tpu_torch.utils.camera import (
    CameraView, look_at_camera, look_at_view)

render = importlib.import_module(
    "luisacomputegaussiansplatting_tpu_torch.ops.render")

GRAD_TOL = 1e-5
F64_FACTOR = 2.0
W, H = 96, 64
CAM_ARGS = ((3.2, -2.8, 2.1), (0, 0, 0), (0, 0, 1))

#: tests/test_torch_projection.py's modes
MODES = [
    dict(),
    dict(use_focal=False),
    dict(rect_mode="lcgs"),
    dict(tile=32),
    dict(tile=32, tile_h=16),
    dict(tight_radius=True),
    dict(tight_radius=True, tile=32, rect_mode="lcgs"),
]
MODE_IDS = [str(m) for m in MODES]

#: chip_smoke.py's near cull (z = 0.1 and behind the camera culled, two at
#: exactly ``near`` kept)
NEAR_MEANS = ((0, 0, 0.1), (0, 0, 0.25), (0, 0, -2.0), (0, 0, 3.0),
              (0, 0, 0.2), (0.01, 0.02, 0.2))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def camera():
    return look_at_camera(*CAM_ARGS, fov=70.0, width=W, height=H)


def inputs(n, seed, device, extent=3.0):
    """means, scales, quats, opacities (0.002-0.95, so the tight radius
    culls some) and a probe of zeros."""
    s = random_scene(n, seed=seed, extent=extent, scale_range=(0.02, 0.3),
                     device="cpu")
    rng = np.random.default_rng(seed)
    opac = torch.tensor(rng.uniform(0.002, 0.95, n).astype(np.float32))
    return [t.to(device) for t in (s.means, s.scales, s.quats, opac,
                                   torch.zeros((n, 2)))]


def cotangents(n, seed, device):
    """Cotangents of means2d and conic as the payload's backward hands
    them on: (N, K) views of (K, N) buffers."""
    rng = np.random.default_rng(seed)
    arrays = (rng.normal(size=(2, n)), rng.normal(size=(3, n)))
    return [torch.tensor(a.astype(np.float32), device=device).t()
            for a in arrays]


def run(fn, means, scales, quats, opac, probe, cfg, ewa_mode="inria",
        scale_modifier=1.0, mask=None, grads=None, dtype=torch.float32):
    """(ProjectedGaussians detached, gradients of means, scales, quats and
    probe) of ``fn`` on fresh leaves of ``dtype``; the gradients are those
    of the cotangents ``grads`` (None: no backward)."""
    leaves = [t.detach().to(dtype).requires_grad_(True)
              for t in (means, scales, quats, probe)]
    view = CameraView(*(t.to(dtype)
                        for t in camera().to_view(means.device)))
    p = fn(*leaves[:3], view, cfg, scale_modifier, ewa_mode, W, H,
           active_mask=mask, means2d_probe=leaves[3],
           opacities=opac.to(dtype))
    out = projection.ProjectedGaussians(*(t.detach() for t in p))
    if grads is None:
        return out, None
    torch.autograd.backward([p.means2d, p.conic],
                            [g.to(dtype) for g in grads])
    return out, [t.grad for t in leaves]


def bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def assert_proj_equal(got, want):
    for f in want._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert torch.equal(bits(a), bits(b)), f


def assert_grad_close(got, want, what):
    scale = float(want.abs().max()) if want.numel() else 0.0
    err = float((got - want).abs().max()) if want.numel() else 0.0
    assert err <= GRAD_TOL * scale, f"{what}: {err} > {GRAD_TOL} x {scale}"


GRAD_NAMES = ("d_means", "d_scales", "d_quats", "d_probe")


def test_cpu_tensors_take_the_plain_path():
    """project_gaussians on CPU tensors is the plain version, bit for bit in
    outputs and gradients, with no K6 launch and no build."""
    before = (projection.KERNEL._lib, projection.KERNEL.launches)
    args = inputs(300, 1, "cpu")
    d = cotangents(300, 2, "cpu")
    cfg = RenderConfig(tight_radius=True)
    got = run(projection.project_gaussians, *args, cfg, grads=d)
    want = run(projection.project_gaussians_reference, *args, cfg, grads=d)
    assert_proj_equal(got[0], want[0])
    for g, w in zip(got[1], want[1]):
        assert torch.equal(g, w)
    assert (projection.KERNEL._lib, projection.KERNEL.launches) == before


def test_camera_grad_takes_the_plain_path(monkeypatch):
    """A view or tangent that requires grad takes the plain version on CPU
    tensors, gradients bit for bit with it, and builds nothing; on any other
    device (here meta tensors, which the kernels refuse) it takes the kernel
    path like a camera without a gradient."""

    def no_build():
        raise AssertionError("built")

    monkeypatch.setattr(projection.KERNEL, "lib", no_build)
    launches = projection.KERNEL.launches
    means, scales, quats, _, _ = inputs(64, 3, "cpu")
    d = cotangents(64, 4, "cpu")
    view = camera().to_view("cpu")

    def cam_grads(fn):
        leaves = [t.clone().requires_grad_(True)
                  for t in (view.view, view.tan_fovx, view.tan_fovy)]
        cam = CameraView(leaves[0], view.position, *leaves[1:])
        p = fn(means, scales, quats, cam, width=W, height=H)
        torch.autograd.backward([p.means2d, p.conic], d)
        return [t.grad for t in leaves]

    for g, w in zip(cam_grads(projection.project_gaussians),
                    cam_grads(projection.project_gaussians_reference)):
        assert torch.equal(g, w)
    assert projection.KERNEL.launches == launches
    meta = [t.to("meta") for t in (means, scales, quats)]
    view = camera().to_view("meta")
    for i in range(4):
        leaves = [t.clone().requires_grad_(j == i) for j, t in
                  enumerate((view.view, view.tan_fovx, view.tan_fovy))]
        cam = CameraView(leaves[0], view.position, *leaves[1:])
        with pytest.raises(ValueError, match="CUDA"):
            projection.project_gaussians(*meta, cam, width=W, height=H)


def test_wrapper_checks_raise_before_any_build(monkeypatch):
    """Non-float32 or CPU tensors, wrong shapes, a non-bool mask, params for
    another count, a bad ewa_mode and bad cotangents raise in the wrappers
    before the library is built."""

    def no_build():
        raise AssertionError("built")

    monkeypatch.setattr(projection.KERNEL, "lib", no_build)
    launches = projection.KERNEL.launches
    means, scales, quats, opac, probe = inputs(8, 4, "cpu")
    view = camera().to_view("cpu")
    cam = (view.view, view.tan_fovx, view.tan_fovy)
    prm = projection._params(8, RenderConfig(), W, H, 1.0, "inria")
    fwd = projection.projection_forward_kernel
    bwd = projection.projection_backward_kernel
    meta = [t.to("meta") for t in (means, scales, quats)]
    cases = [
        (lambda: fwd(means.double(), scales, quats, *cam, prm), "float32"),
        (lambda: fwd(means, scales, quats.half(), *cam, prm), "float32"),
        (lambda: fwd(means, scales, quats, *cam, prm), "CUDA"),
        (lambda: fwd(means, scales[:, :2], quats, *cam, prm), "shape"),
        (lambda: fwd(means, scales, quats, view.view[:3], *cam[1:], prm),
         "shape"),
        (lambda: fwd(means, scales, quats, *cam, prm, probe[:4]), "shape"),
        (lambda: fwd(means, scales, quats, *cam, prm,
                     active_mask=torch.ones(8, dtype=torch.uint8)), "bool"),
        (lambda: fwd(means[:4], scales[:4], quats[:4], *cam, prm),
         "params"),
        (lambda: bwd(means, scales, quats, *cam, prm), "CUDA"),
        (lambda: bwd(means, scales, quats.double(), *cam, prm), "float32"),
        (lambda: projection._params(8, RenderConfig(), W, H, 1.0, "ndc"),
         "ewa_mode"),
        (lambda: projection.project_gaussians(*meta, view, width=W,
                                              height=H), "CUDA"),
        (lambda: projection.project_gaussians(*meta, view), "width"),
    ]
    for call, match in cases:
        with pytest.raises(ValueError, match=match):
            call()
    with pytest.raises(ValueError, match="cotangent"):
        projection._cotangent("f", torch.zeros(8, 3), (8, 2),
                              torch.device("cpu"))
    assert projection.KERNEL.launches == launches


def test_params_match_the_config():
    """The kernels' Params carry the grid, the rect clamp of each rect_mode
    and the unit-focal factors the plain version computes."""
    cfg = RenderConfig(tile=32, tile_h=16, rect_mode="lcgs", use_focal=False)
    p = projection._params(5, cfg, 1237, 822, 1.3, "lcgs")
    gx, gy = projection.tile_grid(1237, 822, (32, 16))
    assert (p.n, p.tile_w, p.tile_h, p.grid_x, p.grid_y) == (5, 32, 16, gx,
                                                             gy)
    assert (p.max_x, p.max_y, p.ewa_lcgs, p.use_focal) == (gx - 1, gy - 1,
                                                           1, 0)
    assert p.nf_b == np.float32(1237 * 822 * 0.25)
    assert p.scale_modifier == np.float32(1.3)
    inria = projection._params(5, RenderConfig(), 1237, 822, 1.0, "inria")
    assert (inria.max_x, inria.max_y) == projection.tile_grid(1237, 822, 16)


@pytest.mark.card
@pytest.mark.parametrize("ewa_mode", ["inria", "lcgs"])
@pytest.mark.parametrize("kw", MODES, ids=MODE_IDS)
def test_forward_matches_plain(card, kw, ewa_mode):
    """All eight fields bit for bit in every mode, on a scene in view and on
    one around and behind the camera."""
    cfg = RenderConfig(**kw)
    for n, seed, extent in ((20_000, 5, 3.0), (4099, 6, 8.0)):
        args = inputs(n, seed, card, extent)
        with torch.no_grad():
            got, _ = run(projection.project_gaussians, *args, cfg, ewa_mode)
            want, _ = run(projection.project_gaussians_reference, *args, cfg,
                          ewa_mode)
        assert_proj_equal(got, want)
        assert int(got.tiles_touched.sum()) > 0


@pytest.mark.card
@pytest.mark.parametrize("ewa_mode", ["inria", "lcgs"])
def test_mask_probe_and_scale_modifier(card, ewa_mode):
    """With the active mask, the probe and scale_modifier 1.3: outputs bit
    for bit, masked rows culled, the four gradients within GRAD_TOL (the
    probe's is the centres' cotangent)."""
    n = 5000
    args = inputs(n, 7, card)
    mask = torch.tensor(np.arange(n) % 3 != 0, device=card)
    d = cotangents(n, 8, card)
    cfg = RenderConfig(tight_radius=True)
    kw = dict(ewa_mode=ewa_mode, scale_modifier=1.3, mask=mask, grads=d)
    got = run(projection.project_gaussians, *args, cfg, **kw)
    want = run(projection.project_gaussians_reference, *args, cfg, **kw)
    assert_proj_equal(got[0], want[0])
    assert not bool(got[0].valid[~mask].any())
    for g, w, what in zip(got[1], want[1], GRAD_NAMES):
        assert_grad_close(g, w, what)
    assert torch.equal(got[1][3], d[0])


@pytest.mark.card
def test_near_cull_and_boundaries(card):
    """The near cull's means (z = 0.1 and behind the camera culled, two at
    exactly near kept) bit for bit, and the same radii as the plain version
    on the CPU within 1 (chip_smoke's ceil boundaries)."""
    means = torch.tensor(NEAR_MEANS, dtype=torch.float32)
    n = means.shape[0]
    scales = torch.full((n, 3), 0.05)
    quats = torch.tensor([[0.0, 0.0, 0.0, 1.0]]).repeat(n, 1)
    cam = look_at_camera((0, 0, 0), (0, 0, 1), (0, 1, 0), width=64,
                         height=64)
    with torch.no_grad():
        cpu = projection.project_gaussians(means, scales, quats, cam)
        card_args = [t.to(card) for t in (means, scales, quats)]
        got = projection.project_gaussians(*card_args, cam)
        want = projection.project_gaussians_reference(*card_args, cam)
    assert_proj_equal(got, want)
    assert got.valid.tolist() == [False, True, False, True, True, True]
    assert torch.equal(got.valid.cpu(), cpu.valid)
    assert int((got.radius.cpu() - cpu.radius).abs().max()) <= 1
    near = np.float32(RenderConfig().near)
    assert got.depth[4:].tolist() == [near, near]


@pytest.mark.card
@pytest.mark.parametrize("ewa_mode", ["inria", "lcgs"])
@pytest.mark.parametrize("kw", MODES, ids=MODE_IDS)
def test_gradients_match_plain(card, kw, ewa_mode):
    """d means, d scales, d quats and d probe within GRAD_TOL of autograd
    through the plain version, from strided cotangents of the centres,
    conics and depths."""
    n = 20_000
    args = inputs(n, 9, card)
    d = cotangents(n, 10, card)
    cfg = RenderConfig(**kw)
    got = run(projection.project_gaussians, *args, cfg, ewa_mode, grads=d)
    want = run(projection.project_gaussians_reference, *args, cfg, ewa_mode,
               grads=d)
    for g, w, what in zip(got[1], want[1], GRAD_NAMES):
        assert_grad_close(g, w, what)


@pytest.mark.card
@pytest.mark.parametrize("ewa_mode", ["inria", "lcgs"])
def test_gradients_around_the_camera(card, ewa_mode):
    """Gaussians all around and behind the camera: each gradient of the
    kernel lies no farther from the plain version evaluated in float64 than
    F64_FACTOR x autograd's float32 chain does (plus a rounding's worth of
    the largest value)."""
    n = 4099
    args = inputs(n, 11, card, extent=8.0)
    d = cotangents(n, 12, card)
    cfg = RenderConfig()
    got = run(projection.project_gaussians, *args, cfg, ewa_mode, grads=d)
    want = run(projection.project_gaussians_reference, *args, cfg, ewa_mode,
               grads=d)
    exact = run(projection.project_gaussians_reference, *args, cfg, ewa_mode,
                grads=d, dtype=torch.float64)
    for g, w, x, what in zip(got[1], want[1], exact[1], GRAD_NAMES):
        ulp = float(x.abs().max()) * 2.0 ** -23
        err_k = float((g.double() - x).abs().max())
        err_a = float((w.double() - x).abs().max())
        assert err_k <= F64_FACTOR * err_a + ulp, f"{what}: {err_k} {err_a}"


@pytest.mark.card
@pytest.mark.parametrize("ewa_mode", ["inria", "lcgs"])
@pytest.mark.parametrize("extent", [3.0, 8.0])
def test_gradient_rows_match_float64(card, extent, ewa_mode):
    """Row by row, not only against each gradient's max: every row's error
    relative to that row's largest float64 value, at the median, the 90th
    and the 99th percentile of the rows, no larger for the kernel than
    F64_FACTOR x autograd's float32 chain (a systematic error in small rows
    would show here)."""
    n = 20_000
    args = inputs(n, 17, card, extent)
    d = cotangents(n, 18, card)
    cfg = RenderConfig()
    got = run(projection.project_gaussians, *args, cfg, ewa_mode, grads=d)
    want = run(projection.project_gaussians_reference, *args, cfg, ewa_mode,
               grads=d)
    exact = run(projection.project_gaussians_reference, *args, cfg, ewa_mode,
                grads=d, dtype=torch.float64)
    q = torch.tensor([0.5, 0.9, 0.99], dtype=torch.float64, device=card)
    for g, w, x, what in zip(got[1][:3], want[1][:3], exact[1][:3],
                             GRAD_NAMES):
        row = x.abs().amax(1, keepdim=True) + 1e-30

        def rows(t):
            return ((t.double() - x).abs() / row).amax(1).quantile(q)

        err_k, err_a = rows(g), rows(w)
        assert bool((err_k <= F64_FACTOR * err_a + 2.0 ** -24).all()), (
            f"{what}: {err_k.tolist()} {err_a.tolist()}")


@pytest.mark.card
def test_one_launch_each_way(card):
    args = inputs(5000, 13, card)
    d = cotangents(5000, 14, card)
    projection.KERNEL.reset_launches()
    run(projection.project_gaussians, *args, RenderConfig(), grads=d)
    torch.cuda.synchronize()
    assert projection.KERNEL.variant_launches == {"forward": 1,
                                                   "backward": 1}
    with torch.no_grad():
        run(projection.project_gaussians, *args, RenderConfig())
    assert projection.KERNEL.variant_launches == {"forward": 2,
                                                   "backward": 1}


def small_setup(dev):
    cam = look_at_camera((2.5, -2.2, 1.8), (0, 0, 0), (0, 0, 1), fov=70.0,
                         width=96, height=64)
    scene = random_scene(3000, seed=6, sh_rest_std=0.2, device=dev)
    return cam, cam.to_view(dev), scene, RenderConfig(max_pairs=200_000)


@pytest.mark.card
def test_render_view_matches_plain(card, monkeypatch):
    """A differentiable frame with K6 against the same frame with the plain
    projection: the image and num_rendered bit for bit, the five gradients
    within GRAD_TOL."""
    cam, view, scene, cfg = small_setup(card)

    def frame():
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in scene.render_args()]
        img, aux = render.render_view(*leaves, view, cam.width, cam.height,
                                      cfg=cfg)
        (img * img).sum().backward()
        return img.detach(), aux.num_rendered, [t.grad for t in leaves]

    projection.KERNEL.reset_launches()
    img, num, grads = frame()
    assert projection.KERNEL.variant_launches == {"forward": 1,
                                                   "backward": 1}
    monkeypatch.setattr(render, "project_gaussians",
                        projection.project_gaussians_reference)
    img_p, num_p, grads_p = frame()
    assert torch.equal(img, img_p)
    assert torch.equal(num, num_p)
    for g, w, what in zip(grads, grads_p, GaussianScene._fields):
        assert_grad_close(g, w, what)


@pytest.mark.card
def test_densify_step_matches_plain(card, monkeypatch):
    """One densifying train step with K6 against one with the plain
    projection: the loss bit for bit, the leaves' gradients and the
    densification statistics within GRAD_TOL."""
    cam, view, scene, cfg = small_setup(card)
    gen = torch.Generator(device=card).manual_seed(0)
    target = torch.rand((3, cam.height, cam.width), generator=gen,
                        device=card)
    start = scene.to_params()

    def one_step():
        state, opt = trainer.init_train_state(start)
        step = trainer.make_densify_train_step(opt, cam.width, cam.height,
                                               cfg=cfg)
        n = start.means.shape[0]
        dstate = densify.init_densify_state(n, n, device=card)
        state, dstate, loss, _aux = step(state, dstate, view, target)
        return loss, [p.grad for p in state.params], dstate

    projection.KERNEL.reset_launches()
    loss, grads, dstate = one_step()
    assert projection.KERNEL.variant_launches == {"forward": 1,
                                                   "backward": 1}
    monkeypatch.setattr(render, "project_gaussians",
                        projection.project_gaussians_reference)
    loss_p, grads_p, dstate_p = one_step()
    assert torch.equal(loss, loss_p)
    for g, w, what in zip(grads, grads_p, GaussianParams._fields):
        assert_grad_close(g, w, what)
    for f in dstate._fields:
        got, want = getattr(dstate, f), getattr(dstate_p, f)
        if got.is_floating_point():
            assert_grad_close(got, want, f)
        else:
            assert torch.equal(got, want), f


@pytest.mark.card
@pytest.mark.parametrize("ewa_mode", ["inria", "lcgs"])
@pytest.mark.parametrize("kw", [dict(), dict(use_focal=False),
                                dict(tight_radius=True, tile=32)],
                         ids=["default", "unit_focal", "tight_tile32"])
def test_camera_grad_on_the_card(card, kw, ewa_mode):
    """A pose that takes a gradient through ``look_at_view`` stays on K6 (one
    launch each way, the depth without a gradient): the outputs bit for bit
    and the gradients of the means, scales, quats, position, target and
    tangent within GRAD_TOL of autograd through the plain version on a scene
    in view; on one around and behind the camera, within GRAD_TOL of the
    plain version in float64 or no farther from it than F64_FACTOR x
    autograd's float32 chain."""
    cfg = RenderConfig(**kw)
    names = GRAD_NAMES[:3] + ("position", "target", "tan_fovy")
    for n, seed, extent in ((20_000, 15, 3.0), (4099, 16, 8.0)):
        means, scales, quats, opac, _ = inputs(n, seed, card, extent)
        d = cotangents(n, seed + 1, card)

        def project(fn, dtype=torch.float32):
            pose = [torch.tensor(v, dtype=dtype, device=card)
                    for v in ((3.2, -2.8, 2.1), (0.1, 0.0, -0.2), 0.7)]
            leaves = [t.detach().to(dtype).requires_grad_(True)
                      for t in (means, scales, quats, *pose)]
            up = torch.tensor((0.0, 0.0, 1.0), dtype=dtype, device=card)
            cam = look_at_view(leaves[3], leaves[4], up, leaves[5], W / H)
            p = fn(*leaves[:3], cam, cfg, 1.0, ewa_mode, W, H,
                   opacities=opac.to(dtype))
            torch.autograd.backward([p.means2d, p.conic],
                                    [g.to(dtype) for g in d])
            return p, [t.grad for t in leaves]

        projection.KERNEL.reset_launches()
        got, grads = project(projection.project_gaussians)
        assert projection.KERNEL.variant_launches == {"forward": 1,
                                                       "backward": 1}
        assert not got.depth.requires_grad
        want, grads_p = project(projection.project_gaussians_reference)
        assert_proj_equal(projection.ProjectedGaussians(
            *(t.detach() for t in got)), projection.ProjectedGaussians(
            *(t.detach() for t in want)))
        if extent < 8.0:
            for g, w, what in zip(grads, grads_p, names):
                assert_grad_close(g, w, what)
            continue
        # around the camera: held to the plain version in float64
        _, exact = project(projection.project_gaussians_reference,
                           torch.float64)
        for g, w, x, what in zip(grads, grads_p, exact, names):
            scale = float(x.abs().max())
            err_k = float((g.double() - x).abs().max())
            err_a = float((w.double() - x).abs().max())
            assert (err_k <= GRAD_TOL * scale
                    or err_k <= F64_FACTOR * err_a + scale * 2.0 ** -23), (
                f"{what}: {err_k} {err_a} of {scale}")
