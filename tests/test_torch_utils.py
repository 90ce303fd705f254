"""PyTorch port: utils, models and io against the JAX package on the same
numpy inputs (transform, camera, covariance/EWA, SH and their gradients,
image conversion, scene containers, synthetic scenes, PLY)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from luisacomputegaussiansplatting_tpu.io import ply as jply
from luisacomputegaussiansplatting_tpu.io import synthetic as jsyn
from luisacomputegaussiansplatting_tpu.models import gaussians as jgs
from luisacomputegaussiansplatting_tpu.utils import camera as jcam
from luisacomputegaussiansplatting_tpu.utils import gaussian as jga
from luisacomputegaussiansplatting_tpu.utils import image as jimg
from luisacomputegaussiansplatting_tpu.utils import sh as jsh
from luisacomputegaussiansplatting_tpu.utils import transform as jtr
from luisacomputegaussiansplatting_tpu_torch.io import ply as pply
from luisacomputegaussiansplatting_tpu_torch.io import synthetic as psyn
from luisacomputegaussiansplatting_tpu_torch.models import gaussians as pgs
from luisacomputegaussiansplatting_tpu_torch.utils import camera as pcam
from luisacomputegaussiansplatting_tpu_torch.utils import gaussian as pga
from luisacomputegaussiansplatting_tpu_torch.utils import image as pimg
from luisacomputegaussiansplatting_tpu_torch.utils import sh as psh
from luisacomputegaussiansplatting_tpu_torch.utils import transform as ptr

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6  # float32 op-order differences only


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def close(p, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(j), rtol=rtol,
                               atol=atol)


@pytest.fixture(scope="module")
def rng_data():
    rng = np.random.default_rng(3)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return dict(
        q=q,
        q2=rng.normal(size=(64, 4)).astype(np.float32),
        aa=rng.normal(size=(64, 3)).astype(np.float32),
        p=rng.normal(size=(64, 3)).astype(np.float32),
        s=np.exp(rng.uniform(-4, -1, (64, 3))).astype(np.float32),
        dirs=(lambda d: d / np.linalg.norm(d, axis=1, keepdims=True))(
            rng.normal(size=(64, 3))).astype(np.float32),
        sh=rng.normal(0, 0.3, (64, 16, 3)).astype(np.float32),
    )


def test_transforms(rng_data):
    d = rng_data
    v = np.linspace(-1.2, 1.2, 17).astype(np.float32)
    close(ptr.ndc2pix(t(v), 37), jtr.ndc2pix(jnp.asarray(v), 37))
    close(ptr.pix2ndc(t(v * 20), 37), jtr.pix2ndc(jnp.asarray(v * 20), 37))
    close(ptr.rotation_from_quaternion(t(d["q"])),
          jtr.rotation_from_quaternion(d["q"]))
    close(ptr.quaternion_multiply(t(d["q"]), t(d["q2"])),
          jtr.quaternion_multiply(d["q"], d["q2"]))
    close(ptr.rotate_axis_angle(t(d["aa"]), t(d["p"])),
          jtr.rotate_axis_angle(d["aa"], d["p"]), atol=1e-5)
    close(ptr.rotation_from_axis_angle(t(d["aa"])),
          jtr.rotation_from_axis_angle(d["aa"]), atol=1e-5)
    ang = d["aa"][:, 0]
    close(ptr.quaternion_from_axis_angle(t(d["dirs"]), t(ang)),
          jtr.quaternion_from_axis_angle(d["dirs"], ang))


@pytest.mark.parametrize("w,h,fov", [(160, 120, 70.0), (1920, 1080, 65.0)])
def test_camera_matrices(w, h, fov):
    args = ((3.0, -2.5, 2.0), (0.1, 0.2, -0.3), (0, 0, 1))
    jc = jcam.look_at_camera(*args, fov=fov, width=w, height=h)
    pc = pcam.look_at_camera(*args, fov=fov, width=w, height=h)
    assert dataclasses_equal(jc, pc)
    assert (pc.tan_fovx, pc.focal_x, pc.focal_y) == (
        jc.tan_fovx, jc.focal_x, jc.focal_y)
    pv, jv = pc.to_view("cpu"), jc.to_view()
    for a, b in zip(pv, jv):
        close(a, b, rtol=0, atol=0)
    pview, pproj = pcam.camera_matrices(pc, "cpu")
    jview, jproj = jcam.camera_matrices(jc)
    close(pview, jview, rtol=0, atol=0)
    close(pproj, jproj, rtol=0, atol=0)
    lv = pcam.look_at_view(t(args[0]), t(args[1]), t(args[2]),
                           t(pc.tan_fovy), pc.aspect)
    jlv = jcam.look_at_view(args[0], args[1], args[2], jc.tan_fovy, jc.aspect)
    for a, b in zip(lv, jlv):
        close(a, b)


def dataclasses_equal(a, b):
    import dataclasses

    return dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("ewa_mode", ["inria", "lcgs"])
def test_covariance_and_ewa(rng_data, ewa_mode):
    d = rng_data
    cam = jcam.look_at_camera((3.0, -2.5, 2.0), (0, 0, 0), (0, 0, 1),
                              fov=70.0, width=96, height=64)
    view = np.asarray(jcam.view_matrix(cam))
    v3 = view[:3, :3]
    pos = d["p"] * 0.5 + np.array([0, 0, 4], np.float32)
    # stacked forms
    jcov = jga.covariance_3d(d["s"], d["q"])
    pcov = pga.covariance_3d(t(d["s"]), t(d["q"]))
    close(pcov, jcov, atol=1e-7)
    jt = jga.clamp_to_frustum(pos, cam.tan_fovx, cam.tan_fovy)
    pt = pga.clamp_to_frustum(t(pos), cam.tan_fovx, cam.tan_fovy)
    close(pt, jt)
    j2 = jga.ewa_project_cov(jcov, jt, v3, cam.focal_x, cam.focal_y, ewa_mode)
    p2 = pga.ewa_project_cov(pcov, pt, t(v3), cam.focal_x, cam.focal_y,
                             ewa_mode)
    close(p2, j2, rtol=1e-4, atol=1e-4)
    jcon, jrad = jga.conic_and_radius(j2)
    pcon, prad = pga.conic_and_radius(t(np.asarray(j2)))
    close(pcon, jcon)
    np.testing.assert_array_equal(prad.numpy(), np.asarray(jrad))
    # component forms, in the JAX package's op order
    s, q = [d["s"][:, i] for i in range(3)], [d["q"][:, i] for i in range(4)]
    jc3 = jga.covariance_3d_elems(s, q)
    pc3 = pga.covariance_3d_elems([t(x) for x in s], [t(x) for x in q])
    jsv = jga.view_rotate_cov_elems(jc3, jnp.asarray(v3), ewa_mode)
    psv = pga.view_rotate_cov_elems(pc3, t(v3), ewa_mode)
    for i in range(3):
        for k in range(3):
            close(pc3[i][k], jc3[i][k])
            close(psv[i][k], jsv[i][k], atol=1e-7)
    tx, ty, tz = (np.asarray(jt)[:, i] for i in range(3))
    jabc = jga.ewa_project_cov_comps(jsv, tx, ty, tz, cam.focal_x, cam.focal_y)
    pabc = pga.ewa_project_cov_comps(psv, t(tx), t(ty), t(tz), cam.focal_x,
                                     cam.focal_y)
    for a, b in zip(pabc, jabc):
        close(a, b, rtol=1e-4, atol=1e-4)
    op = np.linspace(0.002, 0.99, 64).astype(np.float32)
    tight = np.sqrt(np.maximum(2 * np.log(np.maximum(op, 1e-12) * 255.0), 0))
    tight = np.where(op > 1 / 255, tight, 0).astype(np.float32)
    abc = [np.asarray(x) for x in jabc]
    jcr = jga.conic_and_radius_comps(*abc, tight_sigma=jnp.asarray(tight))
    pcr = pga.conic_and_radius_comps(*(t(x) for x in abc), tight_sigma=t(tight))
    for a, b in zip(pcr[0], jcr[0]):
        close(a, b)
    np.testing.assert_array_equal(pcr[1].numpy(), np.asarray(jcr[1]))


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_sh_basis_and_color(rng_data, degree):
    d = rng_data
    close(psh.sh_basis(t(d["dirs"]), degree), jsh.sh_basis(d["dirs"], degree))
    close(psh.eval_sh_color(t(d["sh"]), t(d["dirs"]), degree),
          jsh.eval_sh_color(d["sh"], d["dirs"], degree))
    colors = np.linspace(0, 1, 12, dtype=np.float32).reshape(4, 3)
    np.testing.assert_array_equal(psh.sh_from_color(colors),
                                  np.asarray(jsh.sh_from_color(colors)))


def test_sh_color_gradient_matches_jax(rng_data):
    d = rng_data
    w = np.random.default_rng(1).normal(size=(64, 3)).astype(np.float32)

    def jloss(sh, dirs):
        return jnp.sum(jsh.eval_sh_color(sh, dirs, 3) * w)

    jg = jax.grad(jloss, argnums=(0, 1))(d["sh"], d["dirs"])
    sh, dirs = t(d["sh"]).requires_grad_(), t(d["dirs"]).requires_grad_()
    (psh.eval_sh_color(sh, dirs, 3) * t(w)).sum().backward()
    close(sh.grad, jg[0], atol=1e-6)
    close(dirs.grad, jg[1], atol=1e-5)


@pytest.mark.parametrize("ewa_mode", ["inria", "lcgs"])
def test_ewa_projection_gradient_matches_jax(rng_data, ewa_mode):
    d = rng_data
    cam = jcam.look_at_camera((3.0, -2.5, 2.0), (0, 0, 0), (0, 0, 1),
                              fov=70.0, width=96, height=64)
    v3 = np.asarray(jcam.view_matrix(cam))[:3, :3]
    pos = d["p"] * 0.5 + np.array([0, 0, 4], np.float32)
    w = np.random.default_rng(2).normal(size=(64, 3)).astype(np.float32)

    def jloss(s, q, p):
        cov = jga.covariance_3d(s, q)
        tt = jga.clamp_to_frustum(p, cam.tan_fovx, cam.tan_fovy)
        c2 = jga.ewa_project_cov(cov, tt, v3, cam.focal_x, cam.focal_y,
                                 ewa_mode)
        con, _ = jga.conic_and_radius(c2)
        return jnp.sum(con * w)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(d["s"], d["q"], pos)
    s, q, p = (t(x).requires_grad_() for x in (d["s"], d["q"], pos))
    cov = pga.covariance_3d(s, q)
    tt = pga.clamp_to_frustum(p, cam.tan_fovx, cam.tan_fovy)
    c2 = pga.ewa_project_cov(cov, tt, t(v3), cam.focal_x, cam.focal_y, ewa_mode)
    con, _ = pga.conic_and_radius(c2)
    (con * t(w)).sum().backward()
    for a, b in zip((s.grad, q.grad, p.grad), jg):
        b = np.asarray(b)
        scale = np.abs(b).max()
        np.testing.assert_allclose(a.numpy() / scale, b / scale, atol=1e-5)


def test_image_conversion_and_png(tmp_path):
    rng = np.random.default_rng(4)
    img = rng.uniform(-0.2, 1.2, (3, 21, 34)).astype(np.float32)
    np.testing.assert_array_equal(pimg.chw_to_png_array(t(img)),
                                  jimg.chw_to_png_array(img))
    path = tmp_path / "x.png"
    pimg.write_png(path, img, use_native=False)
    back = jimg.read_png(path)  # PIL decodes the pure-Python writer's PNG
    want = jimg.chw_to_png_array(img).astype(np.float32) / 255.0
    np.testing.assert_array_equal(back, np.transpose(want, (2, 0, 1)))


def test_scene_containers_match_jax():
    rng = np.random.default_rng(5)
    raw = dict(
        means=rng.normal(size=(10, 3)).astype(np.float32),
        log_scales=rng.normal(-3, 1, (10, 3)).astype(np.float32),
        quats=rng.normal(size=(10, 4)).astype(np.float32),
        opacity_logits=rng.normal(size=(10,)).astype(np.float32),
        sh_dc=rng.normal(size=(10, 1, 3)).astype(np.float32),
        sh_rest=rng.normal(size=(10, 15, 3)).astype(np.float32),
    )
    js = jgs.GaussianParams(**{k: jnp.asarray(v) for k, v in raw.items()}).activate()
    ps = pgs.GaussianParams(**{k: t(v) for k, v in raw.items()}).activate()
    for a, b in zip(ps, js):
        close(a, b)
    for a, b in zip(ps.pad_to(13), js.pad_to(13)):
        close(a, b)
    assert ps.sh_degree == js.sh_degree == 3
    assert len(ps.render_args()) == 5
    fs = pgs.from_numpy(*(np.asarray(x) for x in js), device="cpu")
    for a, b in zip(fs, js):
        close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["random", "cube"])
def test_synthetic_scenes_bit_identical(kind):
    if kind == "random":
        js = jsyn.random_scene(500, seed=9, extent=2.0, scale_range=(0.02, 0.1))
        ps = psyn.random_scene(500, seed=9, extent=2.0, scale_range=(0.02, 0.1),
                               device="cpu")
    else:
        js = jsyn.create_cube_scene(nx=5, scale=0.07, opacity=0.85)
        ps = psyn.create_cube_scene(nx=5, scale=0.07, opacity=0.85,
                                    device="cpu")
    for a, b in zip(ps, js):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("build", ["random_scene", "create_cube_scene",
                                   "load_ply", "projection_matrix"])
def test_builders_default_to_the_card(tmp_path, build):
    """The loaders and builders place what they build on the card unless
    asked for the CPU; without a GPU they raise rather than quietly build
    on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default is honoured, not refused")
    path = tmp_path / "s.ply"
    pply.save_ply(psyn.random_scene(4, seed=2, device="cpu"), path)
    calls = {
        "random_scene": lambda **k: psyn.random_scene(4, seed=2, **k),
        "create_cube_scene": lambda **k: psyn.create_cube_scene(nx=2, **k),
        "load_ply": lambda **k: pply.load_ply(path, **k),
        "projection_matrix": lambda **k: pcam.projection_matrix(0.5, 0.4, **k),
    }
    with pytest.raises(RuntimeError, match='device="cpu"'):
        calls[build]()
    out = calls[build](device="cpu")
    for x in (out if isinstance(out, tuple) else (out,)):
        assert x.device.type == "cpu"


@pytest.mark.parametrize("fmt", ["binary", "ascii"])
def test_ply_round_trip_matches_jax(tmp_path, fmt):
    ps = psyn.random_scene(40, seed=2, device="cpu")
    path = tmp_path / "s.ply"
    pply.save_ply(ps, path, fmt=fmt)
    js = jply.load_ply(str(path), use_native=False)
    back = pply.load_ply(path, device="cpu")
    for a, b, c in zip(back, js, ps):
        close(a, b, atol=1e-6)
        close(a, c.numpy(), rtol=1e-5, atol=1e-6)
    raw = pply.load_ply(path, apply_activations=False, device="cpu")
    jraw = jply.load_ply(str(path), apply_activations=False, use_native=False)
    for a, b in zip(raw, jraw):
        close(a, b, rtol=0, atol=0)
