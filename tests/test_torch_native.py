"""PyTorch port: the native PLY loader and PNG writer (``io/native.py``,
built from ``native/*.cpp`` into ``build/native/``) against the port's numpy
reader and the JAX package, mirroring ``tests/test_native_ply.py``.

Means and SH are bit for bit; the activated opacity, scales and quaternions
within 2e-7 (the C++ loader's exp/sigmoid against numpy's), as JAX's own
test holds them. The port's ``read_png`` equals JAX's bit for bit.
"""

import numpy as np
import pytest
import torch

from luisacomputegaussiansplatting_tpu.io.ply import load_ply as jload_ply
from luisacomputegaussiansplatting_tpu.utils.image import read_png as jread_png
from luisacomputegaussiansplatting_tpu_torch.io.native import (
    build_native,
    load_gsply_native,
    write_png_native,
)
from luisacomputegaussiansplatting_tpu_torch.io.ply import load_ply, save_ply
from luisacomputegaussiansplatting_tpu_torch.io.synthetic import random_scene
from luisacomputegaussiansplatting_tpu_torch.utils.image import read_png, write_png

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def built():
    assert build_native()


def saved(tmp_path, n, seed):
    path = tmp_path / "s.ply"
    save_ply(random_scene(n, seed=seed, device="cpu"), path)
    return path


def test_native_matches_numpy_and_jax(tmp_path):
    path = saved(tmp_path, 123, 9)
    out = load_gsply_native(path)
    assert out is not None, "native loader refused a standard file"
    means, sh, opacity, scales, quats = out
    ref = load_ply(path, use_native=False, device="cpu")
    np.testing.assert_array_equal(means, ref.means.numpy())
    np.testing.assert_array_equal(sh, ref.sh.numpy())
    np.testing.assert_allclose(opacity, ref.opacities.numpy(), atol=2e-7)
    np.testing.assert_allclose(scales, ref.scales.numpy(), rtol=2e-7)
    np.testing.assert_allclose(quats, ref.quats.numpy(), atol=2e-7)
    jref = jload_ply(str(path), use_native=False)
    for got, want in zip((means, scales, quats, opacity, sh), jref):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-7, atol=2e-7)


def test_native_raw_mode(tmp_path):
    path = saved(tmp_path, 17, 2)
    out = load_gsply_native(path, apply_activations=False)
    assert out is not None
    means, sh, opacity, scales, quats = out
    ref = load_ply(path, apply_activations=False, use_native=False,
                   device="cpu")
    jref = jload_ply(str(path), apply_activations=False, use_native=False)
    for got, want, jwant in zip((means, scales, quats, opacity, sh), ref,
                                jref):
        np.testing.assert_array_equal(got, want.numpy())
        np.testing.assert_array_equal(got, np.asarray(jwant))


def test_native_rejects_ascii(tmp_path):
    p = tmp_path / "a.ply"
    p.write_text(
        "ply\nformat ascii 1.0\nelement vertex 1\nproperty float x\n"
        "property float y\nproperty float z\nend_header\n0 0 0\n"
    )
    assert load_gsply_native(p) is None  # the caller takes numpy


def test_load_ply_prefers_native(tmp_path):
    path = saved(tmp_path, 64, 3)
    a = load_ply(path, device="cpu")
    b = load_ply(path, use_native=False, device="cpu")
    np.testing.assert_array_equal(a.means.numpy(), b.means.numpy())
    np.testing.assert_array_equal(a.sh.numpy(), b.sh.numpy())
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=2e-7, atol=2e-7)
    # an ASCII file goes to the numpy reader
    save_ply(random_scene(5, seed=1, device="cpu"), tmp_path / "a.ply",
             fmt="ascii")
    c = load_ply(tmp_path / "a.ply", device="cpu")
    jc = jload_ply(str(tmp_path / "a.ply"), use_native=False)
    for x, y in zip(c, jc):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_native_png_writer_roundtrip(tmp_path):
    """The C++ writer's PNG decodes back bit for bit, by JAX's read_png and
    the port's, which agree."""
    hwc = np.random.default_rng(0).integers(0, 256, (37, 53, 3), np.uint8)
    path = tmp_path / "t.png"
    assert write_png_native(path, hwc)
    back = read_png(path)
    np.testing.assert_array_equal(back, jread_png(str(path)))
    np.testing.assert_array_equal(
        back, np.transpose(hwc, (2, 0, 1)).astype(np.float32) / 255.0)
    assert not write_png_native(tmp_path / "g.png", hwc[..., 0])


@pytest.mark.parametrize("use_native", [True, False])
def test_write_png_paths_agree(tmp_path, use_native):
    """write_png through the native writer (the default) or the
    pure-Python encoder: the same pixels, read back equal by both
    packages."""
    img = np.random.default_rng(1).random((3, 24, 40)).astype(np.float32)
    path = tmp_path / "x.png"
    write_png(path, torch.from_numpy(img), flip_vertical=False,
              use_native=use_native)
    back = read_png(path)
    np.testing.assert_array_equal(back, jread_png(str(path)))
    np.testing.assert_array_equal(back, np.floor(img * 255) / np.float32(255))
