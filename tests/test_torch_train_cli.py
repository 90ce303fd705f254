"""PyTorch port: the train CLI (``apps/train_cli.py``) in-process on the CPU.

The smoke and overflow tests mirror ``tests/test_cli.py:39-72`` with
``--device cpu``. The densify-parity test runs the JAX CLI and the port's
on one argv with densify rounds at iterations 4 and 8; the port CLI's
``densify_step`` is replaced by a wrapper that hands ``densify_round`` the
split noise the JAX CLI draws (``jax.random.split`` of ``PRNGKey(seed)``
per round, then ``jax.random.normal(sub, (C, children, 3))``), so both runs
take the same rounds: their ``densify:`` lines and exported gaussian counts
must be equal. The loss parity of the two CLIs is in
``test_torch_train_cli_parity.py``.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import torch

from luisacomputegaussiansplatting_tpu.apps import train_cli as jcli
from luisacomputegaussiansplatting_tpu_torch.apps import train_cli as pcli
from luisacomputegaussiansplatting_tpu_torch.models import densify as pd

torch.set_num_threads(2)


def test_train_cli_smoke(tmp_path):
    rc = pcli.main([
        "--synthetic-gt", "300", "--views", "2", "--res", "48x32",
        "--iters", "20", "--capacity", "300", "--init-points", "150",
        "--max-pairs", "20000", "--log-every", "10", "--eval-every", "20",
        "--densify-interval", "8", "--densify-from", "4",
        "--ckpt-every", "10", "--device", "cpu", "--out", str(tmp_path),
    ])
    assert rc == 0
    assert (tmp_path / "syntheticgt300_trained.ply").exists()
    assert (tmp_path / "syntheticgt300_view0.png").exists()
    assert (tmp_path / "ckpt" / "ckpt_00000020.npz").exists()


def test_train_cli_grows_capacity_on_overflow(tmp_path, capsys):
    """A render-pair overflow doubles max_pairs at the next log line,
    rebuilds the steps, and training completes."""
    rc = pcli.main([
        "--synthetic-gt", "300", "--views", "2", "--res", "48x32",
        "--iters", "8", "--capacity", "300", "--init-points", "200",
        "--max-pairs", "256",  # far below the ~1k+ entries 200 splats emit
        "--log-every", "4", "--densify-interval", "1000",
        "--device", "cpu", "--out", str(tmp_path),
    ])
    assert rc == 0
    err = capsys.readouterr().err
    assert "[overflow] raising max_pairs to 512" in err
    assert (tmp_path / "syntheticgt300_trained.ply").exists()


def test_train_cli_resume_starts_at_the_saved_step(tmp_path, capsys):
    argv = ["--synthetic-gt", "300", "--views", "2", "--res", "48x32",
            "--capacity", "400", "--init-points", "150", "--max-pairs",
            "20000", "--log-every", "5", "--densify-interval", "4",
            "--densify-from", "2", "--densify-until", "10", "--ckpt-every",
            "5", "--views-per-step", "2", "--device", "cpu", "--out",
            str(tmp_path)]
    assert pcli.main(argv + ["--iters", "10"]) == 0
    first = capsys.readouterr().out
    n_active = re.findall(r"\[10/10\] loss \S+  active (\d+)", first)
    assert n_active
    assert pcli.main(argv + ["--iters", "15", "--resume"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 10" in out
    # no step before the saved one is taken again, and the run goes on from
    # the saved active set (no densify round after step 10)
    assert not re.search(r"\[(5|10)/15\]", out)
    assert re.findall(r"\[15/15\] loss \S+  active (\d+)", out) == n_active


def densify_lines(err):
    return [ln for ln in err.splitlines() if "densify:" in ln]


def test_train_cli_densify_rounds_match_jax(tmp_path, capsys, monkeypatch):
    seed = 0
    argv = ["--synthetic-gt", "300", "--views", "2", "--res", "48x32",
            "--iters", "10", "--capacity", "3000", "--init-points", "1000",
            "--max-pairs", "20000", "--densify-from", "0",
            "--densify-interval", "4", "--densify-until", "10",
            "--log-every", "5", "--seed", str(seed)]
    assert jcli.main(argv + ["--out", str(tmp_path / "jax")]) == 0
    jout = capsys.readouterr()

    key = [jax.random.PRNGKey(seed)]

    def densify_with_jax_noise(params, opt, dstate, generator, extent, cfg):
        key[0], sub = jax.random.split(key[0])
        noise = jax.random.normal(
            sub, (params.means.shape[0], cfg.split_children, 3), jnp.float32)
        return pd.densify_round(params, opt, dstate,
                                torch.from_numpy(np.array(noise)), extent, cfg)

    monkeypatch.setattr(pcli, "densify_step", densify_with_jax_noise)
    assert pcli.main(argv + ["--device", "cpu",
                             "--out", str(tmp_path / "port")]) == 0
    pout = capsys.readouterr()

    jlines, plines = densify_lines(jout.err), densify_lines(pout.err)
    assert [ln.split("]")[0] for ln in plines] == ["[4", "[8"]
    assert plines == jlines
    saved = re.compile(r"saved (\d+) gaussians")
    assert saved.search(pout.out).group(1) == saved.search(jout.out).group(1)


def test_train_cli_colmap_init(tmp_path, capsys):
    """--colmap starts from the sparse points (graphdeco's init): means at
    the points, log scales the log of the mean 3-NN distance (here against
    a brute-force search), opacity 0.1, SH DC from the point colour."""
    from test_datasets import _write_colmap_bin, _write_png

    from luisacomputegaussiansplatting_tpu_torch.utils.sh import sh_from_color

    rng = np.random.default_rng(5)
    xyz = rng.uniform(-1, 1, (40, 3))
    rgb = rng.integers(0, 256, (40, 3))
    _write_colmap_bin(tmp_path, 32, 24, 30.0, (1, 0, 0, 0), (0, 0, -5),
                      "img0.png", points=list(zip(xyz, rgb)))
    (tmp_path / "images").mkdir()
    _write_png(tmp_path / "images" / "img0.png",
               rng.integers(0, 256, (24, 32, 3), np.uint8))
    args = pcli.build_parser().parse_args(
        ["--colmap", str(tmp_path), "--capacity", "100"])
    params = pcli._init_params(args, None, np.random.default_rng(0), "cpu")
    assert "init from COLMAP points3D: 40 points" in capsys.readouterr().out
    pts = xyz.astype(np.float32).astype(np.float64)
    d2 = np.sort(((pts[:, None] - pts[None]) ** 2).sum(-1), axis=1)[:, 1:4]
    want = np.log(np.sqrt(d2.mean(axis=1)))
    np.testing.assert_array_equal(params.means.numpy(), xyz.astype(np.float32))
    np.testing.assert_allclose(params.log_scales.numpy(),
                               np.repeat(want[:, None], 3, 1), rtol=1e-6)
    np.testing.assert_allclose(torch.sigmoid(params.opacity_logits).numpy(),
                               0.1, rtol=1e-6)
    np.testing.assert_array_equal(
        params.sh_dc.numpy()[:, 0], sh_from_color(rgb.astype(np.float32) / 255))
    assert params.sh_rest.shape == (40, 15, 3) and not params.sh_rest.any()
    assert pcli.main(["--colmap", str(tmp_path), "--capacity", "100",
                      "--iters", "3", "--max-pairs", "20000",
                      "--device", "cpu", "--out", str(tmp_path / "out")]) == 0
    assert "saved 40 gaussians" in capsys.readouterr().out
