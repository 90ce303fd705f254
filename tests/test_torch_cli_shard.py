"""PyTorch port: ``--shard`` in both CLIs, two gloo ranks on the CPU, each
CLI in one spawned job (the process group started as ``torchrun`` would
leave it, from a ``file://`` store), against the same CLI on one process.

* ``render_cli --shard`` writes the PNG of the unsharded run within the
  PNG's one level (the sharded frame equals the single-device frame up to
  float rounding, ``tests/test_torch_sharding.py``);
* ``train_cli --shard --mesh 1x2`` takes a few steps on a tiny synthetic
  capture with a densify round, writes a checkpoint, resumes from it and
  exports; rank 0 alone prints and writes;
* at one process, ``--shard`` prints the JAX CLI's single-device message.
"""

import os

import numpy as np
from PIL import Image

import _torch_dist_workers as W
from luisacomputegaussiansplatting_tpu_torch.apps import render_cli, train_cli

RENDER = ["--synthetic", "3000", "--res", "96x64", "--max-pairs", "200000",
          "--device", "cpu", "--cam-pos", "3,-2.5,2", "--cam-target", "0,0,0"]


def train_argv(out, iters, *extra):
    return ["--synthetic-gt", "300", "--views", "2", "--res", "48x32",
            "--iters", str(iters), "--capacity", "300", "--init-points", "150",
            "--max-pairs", "20000", "--log-every", "4", "--densify-interval",
            "4", "--densify-from", "2", "--densify-until", "8",
            "--ckpt-every", "6", "--device", "cpu", "--out", str(out), *extra]


def test_render_cli_shard_matches_unsharded(tmp_path):
    ranks = W.Ranks(W.cli_main, 2, tmp_path, module="render_cli",
                    argv=RENDER + ["--shard", "--out", str(tmp_path / "s")])
    assert render_cli.main(RENDER + ["--out", str(tmp_path / "u")]) == 0
    res = ranks.results()
    assert [r["code"] for r in res] == [0, 0]
    assert "num_rendered:" in res[0]["stdout"] and "2 rank(s)" in res[0]["stdout"]
    assert res[1]["stdout"] == ""  # rank 0 alone prints
    name = "synthetic3000_cpu.png"
    a = np.asarray(Image.open(tmp_path / "s" / name)).astype(int)
    b = np.asarray(Image.open(tmp_path / "u" / name)).astype(int)
    assert a.shape == b.shape == (64, 96, 3)
    assert np.abs(a - b).max() <= 1 and b.max() > 50


def test_train_cli_shard_steps_densifies_checkpoints_resumes(tmp_path):
    out = tmp_path / "fit"
    first = W.run(W.cli_main, 2, tmp_path / "a", module="train_cli",
                  argv=train_argv(out, 8, "--shard", "--mesh", "1x2"))
    assert [r["code"] for r in first] == [0, 0]
    log = first[0]["stdout"] + first[0]["stderr"]
    assert "mesh: 1 data x 2 gs devices" in log
    assert "densify:" in log and "[8/8] loss" in log
    assert first[1]["stdout"] == "" and first[1]["stderr"] == ""
    assert os.path.exists(out / "ckpt")
    assert os.path.exists(out / "syntheticgt300_trained.ply")
    second = W.run(W.cli_main, 2, tmp_path / "b", module="train_cli",
                   argv=train_argv(out, 10, "--shard", "--mesh", "1x2",
                                   "--resume"))
    assert [r["code"] for r in second] == [0, 0]
    assert "resumed from step 6" in second[0]["stdout"]
    assert "final: loss" in second[0]["stdout"]


def test_shard_on_one_process_trains_on_one_device(tmp_path, capsys):
    assert train_cli.main(train_argv(tmp_path, 2, "--shard")) == 0
    out = capsys.readouterr().out
    assert "--shard requested but only one device; running single-chip" in out
    assert "final: loss" in out
