"""K5, the SH colour kernel pair (``csrc/sh.cu``), against the plain version
(``ops/sh_eval.py::compute_colors_reference``).

The unmarked cases run on the CPU: CPU tensors take the plain version and
build nothing, and the kernel wrappers' checks raise before any build.
Cases marked ``card`` need a CUDA device and skip without one. This file
imports no JAX; on the card run it alone, without the JAX-loading
``conftest.py``:

    python -m pytest tests/test_torch_sh_kernel.py -q --noconftest

Tolerances: the colours equal the plain version bit for bit (the kernel
rounds every product and sum as torch's ops do, in their order); the
gradients lie within GRAD_TOL x each gradient's max |plain value|, since
the kernel chains the derivatives in another order than autograd does.
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
from luisacomputegaussiansplatting_tpu_torch.ops import sh_eval
from luisacomputegaussiansplatting_tpu_torch.utils.camera import look_at_camera
from luisacomputegaussiansplatting_tpu_torch.utils.sh import SH_C0, num_sh_coeffs

render = importlib.import_module(
    "luisacomputegaussiansplatting_tpu_torch.ops.render")

GRAD_TOL = 1e-5
CAM = (0.3, -1.2, 2.5)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def inputs(n, k_tot, seed, device, cam=CAM):
    """means, sh (N, k_tot, 3), cam_pos and an RGB cotangent; the sums
    spread over [0, 1] and past both ends, so the clamp masks some."""
    rng = np.random.default_rng(seed)
    arrays = (rng.normal(0.0, 2.0, (n, 3)), rng.normal(0.0, 0.3, (n, k_tot, 3)),
              np.asarray(cam), rng.normal(0.0, 1.0, (n, 3)))
    return [torch.tensor(a, dtype=torch.float32, device=device) for a in arrays]


def fwd_bwd(fn, means, sh, cam, degree, d_rgb, cam_grad=False):
    """(rgb, d_means, d_sh, d_cam) of ``fn`` on fresh leaves."""
    m = means.clone().requires_grad_(True)
    s = sh.clone().requires_grad_(True)
    c = cam.clone().requires_grad_(cam_grad)
    rgb = fn(m, s, c, degree)
    rgb.backward(d_rgb)
    # the plain version leaves a leaf it does not read (the means at degree
    # 0) without a gradient, where the kernel writes zeros
    grads = [None if not t.requires_grad
             else torch.zeros_like(t) if t.grad is None else t.grad
             for t in (m, s, c)]
    return (rgb.detach(), *grads)


def assert_grad_close(got, want, what):
    scale = float(want.abs().max()) if want.numel() else 0.0
    err = float((got - want).abs().max()) if want.numel() else 0.0
    assert err <= GRAD_TOL * scale, f"{what}: {err} > {GRAD_TOL} x {scale}"


def clamp_end_inputs(device):
    """Degree-0 rows whose sums land exactly on 0 and 1, and just past
    each: coefficients s with fl(fl(C0) * s) = -0.5 and 0.5, then those
    two times 1 + 1e-6."""
    c0 = np.float32(SH_C0)

    def exact(target):
        s = np.float32(target / c0)
        for cand in (s, np.nextafter(s, np.float32(0)),
                     np.nextafter(s, np.float32(2 * s))):
            if np.float32(c0 * cand) == np.float32(target):
                return cand
        raise AssertionError(f"no coefficient gives {target}")

    lo, hi = exact(-0.5), exact(0.5)
    past = np.float32(1 + 1e-6)
    coef = np.array([lo, hi, lo * past, hi * past], np.float32)
    sh = np.repeat(coef[:, None, None], 3, axis=2)
    means = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 1]], np.float32)
    t = lambda a: torch.tensor(a, device=device)  # noqa: E731
    return t(means), t(sh), t(np.zeros(3, np.float32)), t(np.ones((4, 3),
                                                                  np.float32))


def test_cpu_tensors_take_the_plain_path():
    """compute_colors on CPU tensors is the plain version, bit for bit in
    colours and gradients, with no K5 launch and no build."""
    before = (sh_eval.KERNEL._lib, sh_eval.KERNEL.launches)
    means, sh, cam, d_rgb = inputs(300, 16, 1, "cpu")
    for degree in range(4):
        got = fwd_bwd(sh_eval.compute_colors, means, sh, cam, degree, d_rgb,
                      cam_grad=True)
        want = fwd_bwd(sh_eval.compute_colors_reference, means, sh, cam,
                       degree, d_rgb, cam_grad=True)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert (sh_eval.KERNEL._lib, sh_eval.KERNEL.launches) == before


def test_wrapper_checks_raise_before_any_build(monkeypatch):
    """Non-float32, CPU or meta tensors, too few coefficients and a bad
    degree raise in the wrappers before the library is built."""

    def no_build():
        raise AssertionError("built")

    monkeypatch.setattr(sh_eval.KERNEL, "lib", no_build)
    launches = sh_eval.KERNEL.launches
    means, sh, cam, d_rgb = inputs(8, 16, 2, "cpu")
    fwd, bwd = sh_eval.sh_forward_kernel, sh_eval.sh_backward_kernel
    cases = [
        (lambda: fwd(means.double(), sh, cam), "float32"),
        (lambda: fwd(means, sh.half(), cam), "float32"),
        (lambda: fwd(means, sh, cam), "CUDA"),
        (lambda: bwd(means, sh, cam, 3, d_rgb), "CUDA"),
        (lambda: bwd(means.double(), sh, cam, 3, d_rgb), "float32"),
        (lambda: fwd(means, sh[:, :9], cam, 3), "16 coefficients"),
        (lambda: fwd(means, sh, cam, 4), "degree"),
        (lambda: fwd(means, sh, cam[:2]), "cam_pos"),
        (lambda: sh_eval.compute_colors(means.to("meta"), sh.to("meta"),
                                        cam.to("meta")), "CUDA"),
    ]
    for call, match in cases:
        with pytest.raises(ValueError, match=match):
            call()
    assert sh_eval.KERNEL.launches == launches


def test_clamp_end_inputs_sit_on_the_ends():
    """The clamp-end rows sum to exactly 0 and 1 (and just past them) on
    the plain version, whose gradient passes at the ends only."""
    means, sh, cam, d_rgb = clamp_end_inputs("cpu")
    m = means.clone().requires_grad_(True)
    s = sh.clone().requires_grad_(True)
    rgb = sh_eval.compute_colors_reference(m, s, cam, 0)
    assert rgb[:, 0].tolist() == [0.0, 1.0, 0.0, 1.0]
    rgb.backward(d_rgb)
    c0 = float(np.float32(SH_C0))
    assert s.grad[:, 0, 0].tolist() == [c0, c0, 0.0, 0.0]


def test_cell_inputs_are_contiguous():
    """compute_colors' .contiguous() copies nothing on the main path: the
    activated scene's means and SH (the train step's and the render loop's
    inputs) are contiguous."""
    scene = random_scene(64, seed=3, device="cpu").to_params().activate()
    assert scene.means.is_contiguous() and scene.sh.is_contiguous()


CASES = [(n, d, k) for n in (0, 1, 127, 4099, 1_000_000) for d in range(4)
         for k in sorted({16, num_sh_coeffs(d)})]


@pytest.mark.card
@pytest.mark.parametrize("n,degree,k_tot", CASES)
def test_kernel_matches_plain(card, n, degree, k_tot):
    """Colours bit for bit; dSH, d means and d cam_pos within GRAD_TOL;
    coefficients past the degree get exact zeros; a transposed cotangent
    is read in place."""
    means, sh, cam, d_rgb = inputs(n, k_tot, 10 + degree, card)
    d_rgb = d_rgb.t().contiguous().t()
    got = fwd_bwd(sh_eval.compute_colors, means, sh, cam, degree, d_rgb,
                  cam_grad=True)
    want = fwd_bwd(sh_eval.compute_colors_reference, means, sh, cam, degree,
                   d_rgb, cam_grad=True)
    assert torch.equal(got[0], want[0])
    for g, w, what in zip(got[1:], want[1:], ("d_means", "d_sh", "d_cam")):
        assert_grad_close(g, w, what)
    k = num_sh_coeffs(degree)
    assert not bool(got[2][:, k:].any()) and not bool(want[2][:, k:].any())


@pytest.mark.card
def test_clamp_ends(card):
    """Sums exactly at 0 and 1 pass the gradient, one step past does not,
    as torch's clamp backward does."""
    means, sh, cam, d_rgb = clamp_end_inputs(card)
    got = fwd_bwd(sh_eval.compute_colors, means, sh, cam, 0, d_rgb)
    want = fwd_bwd(sh_eval.compute_colors_reference, means, sh, cam, 0,
                   d_rgb)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[2], want[2])
    c0 = float(np.float32(SH_C0))
    assert got[2][:, 0, 0].tolist() == [c0, c0, 0.0, 0.0]


@pytest.mark.card
def test_gaussian_at_the_camera(card):
    """A gaussian exactly at the camera: colours equal, d mean NaN as
    autograd's sqrt backward gives it (0 / 0); one inside the 1e-12 clamp
    gets the cotangent times 1e12 along its direction."""
    means, sh, _cam, d_rgb = inputs(64, 16, 4, card)
    cam = torch.zeros(3, device=card)
    means[0] = 0.0
    means[1] = torch.tensor([1e-13, 0.0, 0.0], device=card)
    got = fwd_bwd(sh_eval.compute_colors, means, sh, cam, 3, d_rgb)
    want = fwd_bwd(sh_eval.compute_colors_reference, means, sh, cam, 3,
                   d_rgb)
    assert torch.equal(got[0], want[0])
    assert bool(torch.isnan(got[1][0]).all() & torch.isnan(want[1][0]).all())
    assert float(want[1][1].abs().max()) > 1e10
    assert_grad_close(got[1][1], want[1][1], "d_means at 1e-13")
    assert_grad_close(got[1][2:], want[1][2:], "d_means")
    assert_grad_close(got[2], want[2], "d_sh")


@pytest.mark.card
def test_one_launch_each_way(card):
    means, sh, cam, d_rgb = inputs(5000, 16, 5, card)
    sh_eval.KERNEL.reset_launches()
    fwd_bwd(sh_eval.compute_colors, means, sh, cam, 3, d_rgb)
    torch.cuda.synchronize()
    assert sh_eval.KERNEL.variant_launches == {"forward": 1, "backward": 1}
    with torch.no_grad():
        sh_eval.compute_colors(means, sh, cam, 3)
    assert sh_eval.KERNEL.variant_launches == {"forward": 2, "backward": 1}


def small_setup(dev):
    cam = look_at_camera((2.5, -2.2, 1.8), (0, 0, 0), (0, 0, 1), fov=70.0,
                         width=96, height=64)
    scene = random_scene(3000, seed=6, sh_rest_std=0.2, device=dev)
    return cam, cam.to_view(dev), scene, RenderConfig(max_pairs=200_000)


@pytest.mark.card
def test_render_view_matches_plain(card, monkeypatch):
    """A differentiable frame with K5 against the same frame with the
    plain colours: the image bit for bit, the five gradients within
    GRAD_TOL."""
    cam, view, scene, cfg = small_setup(card)

    def frame():
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in scene.render_args()]
        img, _aux = render.render_view(*leaves, view, cam.width, cam.height,
                                       cfg=cfg)
        (img * img).sum().backward()
        return img.detach(), [t.grad for t in leaves]

    sh_eval.KERNEL.reset_launches()
    img, grads = frame()
    assert sh_eval.KERNEL.variant_launches == {"forward": 1, "backward": 1}
    monkeypatch.setattr(render, "compute_colors",
                        sh_eval.compute_colors_reference)
    img_p, grads_p = frame()
    assert torch.equal(img, img_p)
    for g, w, what in zip(grads, grads_p, GaussianScene._fields):
        assert_grad_close(g, w, what)


@pytest.mark.card
def test_densify_step_matches_plain(card, monkeypatch):
    """One densifying train step with K5 against one with the plain
    colours: the loss bit for bit, the leaves' gradients and the
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

    sh_eval.KERNEL.reset_launches()
    loss, grads, dstate = one_step()
    assert sh_eval.KERNEL.variant_launches == {"forward": 1, "backward": 1}
    monkeypatch.setattr(render, "compute_colors",
                        sh_eval.compute_colors_reference)
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
