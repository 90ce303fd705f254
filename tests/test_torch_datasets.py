"""PyTorch port: the dataset loaders (``io/dataset.py``) against the JAX
package's, on the same files.

Each test mirrors one of ``tests/test_datasets.py``'s loader tests: the
fixtures are written to ``tmp_path`` (the COLMAP binary model by that
file's own writer), then both packages load them. Cameras must be equal
field by field, targets bit for bit, ``scene_extent`` and the sparse points
equal. ``synthetic_multiview`` renders with each package's renderer: the
port's targets within BLEND_TOL (5e-4) of JAX's at 64x48.
"""

import json
import math

import numpy as np
import pytest
import torch
from test_datasets import _write_colmap_bin, _write_png

from luisacomputegaussiansplatting_tpu.io import dataset as jds
from luisacomputegaussiansplatting_tpu_torch.io import dataset as pds

torch.set_num_threads(2)

BLEND_TOL = 5e-4


CAMERA_FIELDS = ("position", "front", "up", "right", "fov", "width",
                 "height")


def assert_same_cameras(jcams, pcams):
    assert len(pcams) == len(jcams)
    for jc, pc in zip(jcams, pcams):
        for f in CAMERA_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(pc, f)),
                                          np.asarray(getattr(jc, f)),
                                          err_msg=f)


def assert_same(jdata, pdata):
    """Two datasets equal: cameras field by field, targets bit for bit."""
    assert len(pdata) == len(jdata)
    assert pdata.scene_extent == jdata.scene_extent
    assert_same_cameras(jdata.cameras, pdata.cameras)
    for jt, pt in zip(jdata.targets, pdata.targets):
        assert pt.dtype == np.float32
        np.testing.assert_array_equal(pt, jt)


def both(name, *args, **kw):
    return getattr(jds, name)(*args, **kw), getattr(pds, name)(*args, **kw)


def nerf_fixture(root, w, h, rgba):
    c2w = np.eye(4)
    c2w[2, 3] = 4.0
    meta = {"camera_angle_x": math.radians(60.0),
            "frames": [{"file_path": "./train/r_0",
                        "transform_matrix": c2w.tolist()}]}
    (root / "train").mkdir()
    with open(root / "transforms_train.json", "w") as f:
        json.dump(meta, f)
    _write_png(root / "train" / "r_0.png", rgba)


def colmap_text_fixture(root, w, h, f, img, qvec="1 0 0 0", tvec="0 0 -5"):
    sparse = root / "sparse" / "0"
    sparse.mkdir(parents=True)
    with open(sparse / "cameras.txt", "w") as fh:
        fh.write("# comment\n")
        fh.write(f"1 PINHOLE {w} {h} {f} {f} {w/2} {h/2}\n")
    with open(sparse / "images.txt", "w") as fh:
        fh.write("# comment\n")
        fh.write(f"1 {qvec} {tvec} 1 img0.png\n\n")
    (root / "images").mkdir()
    _write_png(root / "images" / "img0.png", img)


@pytest.mark.parametrize("rig", ["turntable_cameras", "sphere_cameras"])
def test_rigs_match_jax(rig):
    jc, pc = both(rig, 7, target=(0.5, -1.0, 0.2), radius=3.0, fov=50.0,
                  width=64, height=48)
    assert_same_cameras(jc, pc)
    for c in pc:
        front, pos = np.asarray(c.front), np.asarray(c.position)
        to_target = np.asarray((0.5, -1.0, 0.2)) - pos
        np.testing.assert_allclose(front, to_target / np.linalg.norm(to_target),
                                   atol=1e-6)


def test_nerf_synthetic_matches_jax(tmp_path):
    w, h = 20, 16
    rgba = np.zeros((h, w, 4), np.uint8)
    rgba[:, :, 0] = 200
    rgba[:, :, 3] = 128
    nerf_fixture(tmp_path, w, h, rgba)
    jdata, pdata = both("load_nerf_synthetic", str(tmp_path),
                        white_background=True)
    assert_same(jdata, pdata)
    a = 128 / 255.0
    np.testing.assert_allclose(pdata.targets[0][0], (200 / 255) * a + (1 - a),
                               atol=2.5e-3)


def test_colmap_text_matches_jax(tmp_path):
    w, h, f = 32, 24, 30.0
    colmap_text_fixture(tmp_path, w, h, f, np.full((h, w, 3), 80, np.uint8))
    jdata, pdata = both("load_colmap_text", str(tmp_path))
    assert_same(jdata, pdata)
    np.testing.assert_allclose(pdata.cameras[0].position, (0, 0, 5),
                               atol=1e-9)
    np.testing.assert_allclose(pdata.cameras[0].up, (0, -1, 0), atol=1e-9)


def test_synthetic_multiview_matches_jax():
    from luisacomputegaussiansplatting_tpu.config import RenderConfig as JCfg
    from luisacomputegaussiansplatting_tpu.io.synthetic import create_cube_scene as jcube
    from luisacomputegaussiansplatting_tpu_torch.config import RenderConfig as PCfg
    from luisacomputegaussiansplatting_tpu_torch.io.synthetic import create_cube_scene as pcube

    kw = dict(n_views=3, width=64, height=48)
    jdata = jds.synthetic_multiview(jcube(nx=3), cfg=JCfg(max_pairs=30_000),
                                    **kw)
    pdata = pds.synthetic_multiview(pcube(nx=3, device="cpu"),
                                    cfg=PCfg(max_pairs=30_000), device="cpu",
                                    **kw)
    assert_same_cameras(jdata.cameras, pdata.cameras)
    assert pdata.scene_extent == jdata.scene_extent
    for jt, pt in zip(jdata.targets, pdata.targets):
        assert isinstance(pt, np.ndarray) and pt.shape == (3, 48, 64)
        assert pt.dtype == np.float32
        assert np.abs(pt - np.asarray(jt)).max() <= BLEND_TOL
    assert pdata.targets[0].std() > 0.01  # actual content


def test_colmap_binary_matches_jax(tmp_path):
    w, h, f = 32, 24, 30.0
    pts = [((1.0, 2.0, 3.0), (255, 0, 0)), ((-1.0, 0.5, 2.0), (0, 128, 255))]
    _write_colmap_bin(tmp_path, w, h, f, (1, 0, 0, 0), (0, 0, -5), "img0.png",
                      points=pts)
    (tmp_path / "images").mkdir()
    img = np.random.default_rng(3).integers(0, 256, (h, w, 3), np.uint8)
    _write_png(tmp_path / "images" / "img0.png", img)
    jdata, pdata = both("load_colmap", str(tmp_path))
    assert_same(jdata, pdata)
    # the targets are the file's rows bottom-up
    np.testing.assert_array_equal(
        pdata.targets[0], np.transpose(img[::-1], (2, 0, 1)) / np.float32(255))
    (jxyz, jrgb), (pxyz, prgb) = both("load_colmap_points3d", str(tmp_path))
    np.testing.assert_array_equal(pxyz, jxyz)
    np.testing.assert_array_equal(prgb, jrgb)
    assert pxyz.dtype == prgb.dtype == np.float32


@pytest.mark.parametrize("downscale", [1, 2])
def test_colmap_predownscaled_images_dir_matches_jax(tmp_path, downscale):
    """images_2 holds half-size frames under full-size intrinsics; with
    --downscale the loader resizes again (LANCZOS) and rescales fy."""
    w, h, f = 32, 24, 30.0
    _write_colmap_bin(tmp_path, w, h, f, (1, 0, 0, 0), (0, 0, -5), "img0.png")
    (tmp_path / "images_2").mkdir()
    img = np.random.default_rng(4).integers(0, 256, (h // 2, w // 2, 3),
                                            np.uint8)
    _write_png(tmp_path / "images_2" / "img0.png", img)
    jdata, pdata = both("load_colmap", str(tmp_path), images_dir="images_2",
                        downscale=downscale)
    assert_same(jdata, pdata)
    cam = pdata.cameras[0]
    assert (cam.width, cam.height) == (w // 2 // downscale, h // 2 // downscale)


def test_colmap_bin_and_text_models_match_jax(tmp_path):
    w, h, f = 16, 16, 20.0
    qvec = (math.sqrt(0.5), 0.0, 0.0, math.sqrt(0.5))
    tvec = (0.3, -1.2, 4.0)
    img = np.random.default_rng(0).uniform(0, 255, (h, w, 3)).astype(np.uint8)
    root_b = tmp_path / "b"
    root_b.mkdir()
    _write_colmap_bin(root_b, w, h, f, qvec, tvec, "img0.png")
    (root_b / "images").mkdir()
    _write_png(root_b / "images" / "img0.png", img)
    root_t = tmp_path / "t"
    root_t.mkdir()
    colmap_text_fixture(root_t, w, h, f, img, " ".join(map(str, qvec)),
                        " ".join(map(str, tvec)))
    jb, pb = both("load_colmap", str(root_b))
    jt, pt = both("load_colmap", str(root_t))
    assert_same(jb, pb)
    assert_same(jt, pt)
    for fld in ("position", "front", "up", "right", "fov"):
        np.testing.assert_allclose(np.asarray(getattr(pb.cameras[0], fld)),
                                   np.asarray(getattr(pt.cameras[0], fld)),
                                   atol=1e-12)


def test_loader_rows_match_render_orientation(tmp_path):
    """The port's renderer emits bottom-up rows (world-up content at high
    row indices), and both loaders put a PNG's top row there, as JAX's do."""
    from luisacomputegaussiansplatting_tpu_torch.config import RenderConfig
    from luisacomputegaussiansplatting_tpu_torch.ops.render import render_view
    from luisacomputegaussiansplatting_tpu_torch.utils.camera import look_at_camera

    w, h = 48, 48
    cam = look_at_camera((4.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0),
                         fov=60.0, width=w, height=h)
    sh = torch.zeros((1, 16, 3))
    sh[:, 0, :] = 2.0
    with torch.no_grad():
        img, _ = render_view(
            torch.tensor([[0.0, 0.0, 1.0]]), torch.full((1, 3), 0.2),
            torch.tensor([[0.0, 0.0, 0.0, 1.0]]), torch.ones(1), sh,
            cam.to_view("cpu"), w, h, (0.0, 0.0, 0.0),
            RenderConfig(max_pairs=10_000), 0)
    rows = img.numpy().sum(axis=(0, 2))
    com = float((rows * np.arange(h)).sum() / max(rows.sum(), 1e-9))
    assert com > h / 2, "render convention changed: up no longer = high rows"

    im = np.zeros((h, w, 3), np.uint8)
    im[0, :, :] = 255  # top row white
    nerf_fixture(tmp_path, w, h, im)
    jdata, pdata = both("load_nerf_synthetic", str(tmp_path))
    assert_same(jdata, pdata)
    t = pdata.targets[0]
    assert t[:, h - 1, :].min() > 0.9 and t[:, 0, :].max() < 0.1

    colmap_text_fixture(tmp_path, w, h, 30.0, im)
    jdata, pdata = both("load_colmap_text", str(tmp_path))
    assert_same(jdata, pdata)
    t = pdata.targets[0]
    assert t[:, h - 1, :].min() > 0.9 and t[:, 0, :].max() < 0.1
