"""PyTorch port: the whole forward render against JAX ``render_aux`` and the
golden images, and the port's render CLI on the CPU.

Image and T: atol 1e-4 (the two packages sum log-transmittance in another
order); num_rendered, overflow and radii: exact; golden PNGs: 1.5/255
(tests/test_golden.py).
"""

import os

import jax
import numpy as np
import pytest
import torch

from luisacomputegaussiansplatting_tpu import config as jcfg
from luisacomputegaussiansplatting_tpu.io import synthetic as jsyn
from luisacomputegaussiansplatting_tpu.ops.render import render_aux as jrender_aux
from luisacomputegaussiansplatting_tpu.utils.camera import look_at_camera as jlook
from luisacomputegaussiansplatting_tpu.utils.image import read_png
from luisacomputegaussiansplatting_tpu_torch import config as pcfg
from luisacomputegaussiansplatting_tpu_torch.apps import render_cli
from luisacomputegaussiansplatting_tpu_torch.io import synthetic as psyn
from luisacomputegaussiansplatting_tpu_torch.ops.render import render, render_aux
from luisacomputegaussiansplatting_tpu_torch.utils.camera import look_at_camera

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
GOLDEN_TOL = 1.5 / 255.0
ATOL = 1e-4
CAM = ((3.0, -2.5, 2.0), (0, 0, 0), (0, 0, 1))


def both(fn, *a, **k):
    return getattr(jsyn, fn)(*a, **k), getattr(psyn, fn)(*a, device="cpu", **k)


def compare(js, ps, w, h, kw, bg=(0.0, 0.0, 0.0), ewa_mode="inria"):
    jc = jlook(*CAM, fov=70.0, width=w, height=h)
    pc = look_at_camera(*CAM, fov=70.0, width=w, height=h)
    jimg, jaux = jax.jit(lambda *a: jrender_aux(
        *a, jc, bg_color=bg, cfg=jcfg.RenderConfig(**kw),
        ewa_mode=ewa_mode))(*js.render_args())
    with torch.no_grad():
        pimg, paux = render_aux(*ps.render_args(), pc, bg_color=bg,
                                cfg=pcfg.RenderConfig(**kw), ewa_mode=ewa_mode)
    np.testing.assert_allclose(pimg.numpy(), np.asarray(jimg), atol=ATOL)
    np.testing.assert_allclose(paux.transmittance.numpy(),
                               np.asarray(jaux.transmittance), atol=ATOL)
    for name in ("radii", "num_rendered", "overflow"):
        np.testing.assert_array_equal(getattr(paux, name).numpy(),
                                      np.asarray(getattr(jaux, name)), name)
    np.testing.assert_allclose(paux.means2d.numpy(), np.asarray(jaux.means2d),
                               rtol=1e-5, atol=1e-4)
    assert pimg.shape == (3, h, w) and not bool(paux.overflow)
    return pimg.numpy()


def test_random_scene_matches_jax_and_golden():
    js, ps = both("random_scene", 3000, seed=42, extent=2.0,
                  scale_range=(0.02, 0.1))
    img = compare(js, ps, 160, 120, dict(max_pairs=100_000))
    golden = read_png(os.path.join(GOLDEN, "random3000_160x120.png"))
    assert np.abs(img - golden).max() <= GOLDEN_TOL


def test_cube_matches_jax_and_golden():
    js, ps = both("create_cube_scene", nx=6, scale=0.07, opacity=0.85)
    img = compare(js, ps, 160, 120, dict(max_pairs=100_000),
                  bg=(0.1, 0.2, 0.3))
    golden = read_png(os.path.join(GOLDEN, "cube_160x120.png"))
    assert np.abs(img - golden).max() <= GOLDEN_TOL


def test_render_returns_the_image():
    ps = psyn.random_scene(50, seed=1, device="cpu")
    cam = look_at_camera(*CAM, fov=70.0, width=32, height=24)
    with torch.no_grad():
        img = render(*ps.render_args(), cam, cfg=pcfg.RenderConfig(max_pairs=5_000))
        img2, _ = render_aux(*ps.render_args(), cam,
                             cfg=pcfg.RenderConfig(max_pairs=5_000))
    assert torch.equal(img, img2)


def test_cli_cpu_matches_jax_cli(tmp_path, capsys):
    from luisacomputegaussiansplatting_tpu.apps import render_cli as jcli

    args = ["--synthetic", "400", "--res", "64x48", "--max-pairs", "40000",
            "--cam-pos", "3,-2.5,2", "--cam-target", "0,0,0", "--world",
            "blender", "--exp_N", "2"]
    assert jcli.main(args + ["--platform", "cpu", "--out", str(tmp_path / "j"),
                             "--save-raw", str(tmp_path / "j.npy")]) == 0
    capsys.readouterr()
    assert render_cli.main(args + ["--device", "cpu", "--out",
                                   str(tmp_path / "p"), "--save-raw",
                                   str(tmp_path / "p.npy")]) == 0
    out = capsys.readouterr().out
    assert "num_rendered:" in out and "rep_ms:" in out and "fps:" in out
    assert (tmp_path / "p" / "synthetic400_cpu.png").exists()
    j, p = np.load(tmp_path / "j.npy"), np.load(tmp_path / "p.npy")
    assert p.shape == (3, 48, 64) and p.max() > 0.05
    np.testing.assert_allclose(p, j, atol=ATOL)


def test_cli_fails_loudly_without_gpu_and_on_unported_flags(tmp_path):
    base = ["--synthetic", "10", "--res", "16x16", "--out", str(tmp_path)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            render_cli.main(base)
    # --shard is ported: on one process it renders on one device, as the
    # JAX CLI does with one device (tests/test_torch_cli_shard.py has the
    # ranks)
    assert render_cli.main(base + ["--device", "cpu", "--shard"]) == 0
    assert (tmp_path / "synthetic10_cpu.png").exists()


def test_cli_blend_mxu_matches_vpu(tmp_path):
    """--blend mxu reaches the blend and stays within 5e-4 of --blend vpu
    at the production tiling (the bound of tests/test_cli.py:90; no lower
    bound: the two may agree exactly)."""
    raws = {}
    for mode in ("vpu", "mxu"):
        raw = tmp_path / f"{mode}.npy"
        assert render_cli.main([
            "--synthetic", "2000", "--res", "96x64", "--exp_N", "1",
            "--max-pairs", "50000", "--tile", "32", "--pack", "none",
            "--blend", mode, "--device", "cpu", "--save-raw", str(raw),
            "--out", str(tmp_path)]) == 0
        raws[mode] = np.load(raw)
    assert raws["mxu"].max() > 0.05
    assert float(np.abs(raws["vpu"] - raws["mxu"]).max()) < 5e-4
