"""PyTorch port: ``scripts/real_scene_proof.py`` against the JAX script.

The JAX script is loaded from its file. The port's pieces are held to it on
the same inputs: the ground-truth scene (both sizes), the camera rings, one
rendered view of the quick scene (the JAX side in Pallas interpret mode,
within the golden tolerance), a PLY written by the JAX package and read by
the port, the PNG rounding, and the eval metrics. Then the port's four
stages run end to end through its command line at tiny sizes on the CPU,
and the report carries every key of the JAX script's report.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from luisacomputegaussiansplatting_tpu.config import RenderConfig as JRenderConfig
from luisacomputegaussiansplatting_tpu.io.ply import save_ply as jsave_ply
from luisacomputegaussiansplatting_tpu.models import losses as jlosses
from luisacomputegaussiansplatting_tpu_torch.config import RenderConfig
from luisacomputegaussiansplatting_tpu_torch.io.ply import load_ply
from luisacomputegaussiansplatting_tpu_torch.models import losses as plosses
from luisacomputegaussiansplatting_tpu_torch.scripts import real_scene_proof as proof

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("means", "scales", "quats", "opacities", "sh")
GOLDEN_TOL = 1.5 / 255.0  # tests/test_golden.py:27


def _load_jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_real_scene_proof", os.path.join(ROOT, "scripts",
                                             "real_scene_proof.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jproof = _load_jax_script()


@pytest.mark.parametrize("quick", [True, False])
def test_gt_scene_matches_jax(quick):
    want = jproof.make_gt_scene(quick)
    got = proof.make_gt_scene(quick, device="cpu")
    assert got.num_gaussians == (8400 if quick else 70_000)
    for f in FIELDS:
        a, b = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert a.shape == b.shape, f
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-7, err_msg=f)


def test_gt_scene_default_is_the_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        proof.make_gt_scene(quick=True)


# the rings the stages use: the eval ring; interp's low, middle (phase 0.5)
# and high rings; bracket's two rings
RINGS = [
    dict(n=4, height=2.2, radius=4.6, width=400, height_px=266),
    dict(n=14, height=1.4, radius=4.2, width=800),
    dict(n=13, height=2.2, radius=4.6, width=800, phase=0.5),
    dict(n=13, height=2.8, radius=4.4, width=800),
    dict(n=20, height=1.4, radius=4.2, width=200),
    dict(n=20, height=2.8, radius=4.4, width=200),
]


@pytest.mark.parametrize("ring", RINGS)
def test_camera_ring_matches_jax(ring):
    jc, jm = jproof.camera_ring(**ring)
    pc, pm = proof.camera_ring(**ring)
    assert len(pc) == len(jc) == ring["n"]
    for a, b, ma, mb in zip(jc, pc, jm, pm):
        for f in ("position", "front", "up", "right"):
            np.testing.assert_allclose(getattr(b, f), getattr(a, f),
                                       rtol=0, atol=1e-6)
        assert (b.fov, b.width, b.height) == (a.fov, a.width, a.height)
        np.testing.assert_allclose(mb, ma, rtol=0, atol=1e-6)


def test_rendered_view_matches_jax():
    """One 96x64 eval-ring view of the quick scene through each package's
    ``render_batch`` (JAX: Pallas interpret mode on the CPU)."""
    ring = dict(n=4, height=2.2, radius=4.6, width=96, height_px=64)
    jcam, _ = jproof.camera_ring(**ring)
    pcam, _ = proof.camera_ring(**ring)
    want = jproof.render_batch(jproof.make_gt_scene(True), jcam[:1],
                               JRenderConfig(max_pairs=300_000))[0]
    got = proof.render_batch(proof.make_gt_scene(True, device="cpu"),
                             pcam[:1], RenderConfig(max_pairs=300_000))[0]
    assert got.shape == want.shape == (3, 64, 96)
    assert want.std() > 0.05  # real content, not a black frame
    assert np.abs(got - want).max() <= GOLDEN_TOL


@pytest.mark.parametrize("use_native", [True, False])
def test_jax_ply_read_by_port(tmp_path, use_native):
    scene = jproof.make_gt_scene(True)
    path = str(tmp_path / "gt.ply")
    jsave_ply(scene, path)
    got = load_ply(path, use_native=use_native, device="cpu")
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(scene, f)),
                                   rtol=0, atol=1e-6, err_msg=f)


def test_save_png_matches_jax(tmp_path):
    img = np.random.default_rng(3).uniform(-0.1, 1.1, (3, 20, 30))
    img = img.astype(np.float32)
    jproof.save_png(img, str(tmp_path / "j.png"))
    proof.save_png(img, str(tmp_path / "p.png"))
    a = np.asarray(Image.open(tmp_path / "j.png"))
    b = np.asarray(Image.open(tmp_path / "p.png"))
    np.testing.assert_array_equal(b, a)
    # rounded, not truncated, and flipped
    want = (np.clip(img, 0, 1).transpose(1, 2, 0)[::-1] * 255 + 0.5)
    np.testing.assert_array_equal(b, want.astype(np.uint8))


def test_eval_metrics_match_jax():
    rng = np.random.default_rng(11)
    gt = rng.uniform(0, 1, (3, 53, 71)).astype(np.float32)
    img = np.clip(gt + rng.normal(0, 0.05, gt.shape), 0, 1).astype(np.float32)
    jp = float(jlosses.psnr(jnp.asarray(img), jnp.asarray(gt)))
    js = float(jlosses.ssim(jnp.asarray(img), jnp.asarray(gt)))
    pp = float(plosses.psnr(torch.from_numpy(img), torch.from_numpy(gt)))
    ps = float(plosses.ssim(torch.from_numpy(img), torch.from_numpy(gt)))
    assert abs(pp - jp) <= 1e-5
    assert abs(ps - js) <= 1e-5


def _jax_report_keys():
    """Each stage's keys in the JAX script's own report
    (docs/proof_r5/proof_report.json); its parity "note" was added by
    hand, not by the script."""
    with open(os.path.join(ROOT, "docs", "proof_r5",
                           "proof_report.json")) as f:
        rep = json.load(f)
    keys = {k: set(v) for k, v in rep.items()}
    keys["parity"].discard("note")
    return keys


def test_whole_cli_tiny_run_on_cpu(tmp_path):
    root = str(tmp_path / "proof")
    common = ["--root", root, "--quick", "--device", "cpu"]
    assert proof.main(["gen", *common, "--views", "3",
                       "--data-res", "32"]) == 0
    assert proof.main(["train", *common, "--iters", "3", "--capacity",
                       "2000", "--init-points", "300"]) == 0
    assert proof.main(["eval", *common]) == 0
    assert proof.main(["parity", *common]) == 0
    with open(os.path.join(root, "proof_report.json")) as f:
        rep = json.load(f)
    for stage, keys in _jax_report_keys().items():
        assert keys <= set(rep[stage]), (stage, keys - set(rep[stage]))
    gen = rep["gen"]
    assert (gen["gt_gaussians"], gen["dataset_views"], gen["dataset_res"],
            gen["eval_res"], gen["rig"]) == (8400, 3, 32, [400, 266],
                                             "interp")
    assert gen["ply_roundtrip_render_mad"] <= GOLDEN_TOL
    assert gen["png_roundtrip_err"] < GOLDEN_TOL
    argv = rep["train"]["train_argv"]
    assert argv[argv.index("--device") + 1] == "cpu"
    assert argv[argv.index("--iters") + 1] == "3"
    # paths in the report are relative to --root
    assert argv[argv.index("--nerf-synthetic") + 1] == "."
    assert argv[argv.index("--out") + 1] == "fit"
    assert os.path.exists(os.path.join(root, rep["parity"]["ply"]))
    ev = rep["eval"]
    assert len(ev["psnr_per_view"]) == 4
    assert np.isfinite(ev["psnr_mean"]) and 0 < ev["ssim_mean"] <= 1
    par = rep["parity"]
    assert par["res"] == "400x266"
    assert par["dev_num_rendered"] == par["cpu_num_rendered"] > 0
    assert par["max_abs_diff"] == par["mean_abs_diff"] == 0.0
    assert par["dev_rep_ms"].startswith("rep_ms:")
    for i in range(4):
        assert os.path.exists(os.path.join(root, f"trained_eval_{i}.png"))


@pytest.mark.parametrize("stage", ["gen", "train", "eval"])
def test_stages_default_to_the_card(tmp_path, stage):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        proof.main([stage, "--root", str(tmp_path), "--quick"])
