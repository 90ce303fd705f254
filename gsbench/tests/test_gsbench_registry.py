"""Every cell, configuration, traffic mix, loop and metric is found by its
name, and a cell made of new files alone runs without an edit."""

import json
import os
import shutil

import pytest
import torch

from gsbench import harness

GSBENCH = harness.HERE
BENCH = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))


def test_benchmark_names_resolve_to_files():
    for c in BENCH["configs"]:
        assert os.path.exists(os.path.join(harness.ROOT, c["file"]))
        assert os.path.basename(c["file"]) == c["name"] + ".json"
    for w in BENCH["workloads"]:
        spec = harness.load_json("workloads", w["name"] + ".json")
        assert (spec["config"], spec["traffic"]) == (w["config"],
                                                     w["traffic"])
        traffic = harness.load_json("traffic", w["traffic"] + ".json")
        assert os.path.exists(os.path.join(GSBENCH, "loops",
                                           traffic["loop"] + ".py"))
        assert spec["limits"], w["name"]
    for m in BENCH["per_layer"]:
        mod = harness.load_module("metrics", m["name"])
        assert callable(mod.read)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_reports_setup_another_e2e_and_a_per_layer_metric(cell):
    e2e, per = harness.cell_metrics(BENCH, cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert per


def test_an_extra_cell_runs_from_its_files_alone(tmp_path, monkeypatch):
    """A copy of the benchmark's folder gains a configuration, a traffic
    mix and a cell as new files and one BENCHMARK.json entry."""
    copy = tmp_path / "gsbench"
    shutil.copytree(GSBENCH, copy, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    cfg = json.load(open(copy / "configs" / "nerf-lego-300K.json"))
    cfg["scene"]["n_gaussians"] = 1000
    json.dump(cfg, open(copy / "configs" / "extra-object.json", "w"))
    json.dump({"loop": "render", "path": "orbit", "width": 64, "height": 48,
               "warmup_frames": 1, "trace_frames": 2},
              open(copy / "traffic" / "extra-orbit.json", "w"))
    cfg["dataset"].update(kind="orbit", height_z=1.0, azimuth0_deg=0.0)
    json.dump(cfg, open(copy / "configs" / "extra-object.json", "w"))
    json.dump({"config": "extra-object", "traffic": "extra-orbit",
               "check_frames": 2, "limits": {"image_level_gap": 8.0, "num_rendered_gap": 1e-4,
                          "overflow": 0.0}},
              open(copy / "workloads" / "extra-cell.json", "w"))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "extra-cell", "config": "extra-object",
                               "traffic": "extra-orbit", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "render_frame_ms" in (m["name"], m.get("moves")):
            m["workloads"] = m["workloads"] + ["extra-cell"]
    for m in bench["end_to_end"]:
        if m["name"] == "render_frame_p95_ms":
            m["workloads"] = m["workloads"] + ["extra-cell"]
    monkeypatch.setattr(harness, "HERE", str(copy))
    cell = harness.make_cell("extra-cell", 7, torch.device("cpu"))
    out = harness.run_cell(cell, 0.2, False, 0.0, bench)
    assert out["correct"] and out["attempted"] >= 1
    assert set(out["metrics"]) == {"render_frame_ms", "render_frame_p95_ms",
                                   "peak_device_gib", "setup_s"}
