"""PyTorch port: the profiling APIs run and return the JAX package's stage
keys (as tests/test_profiling.py), the one-frame profile summarises a full
forward + backward frame, and the port's bench times its frame; all on the
CPU at a small size, where only the keys, counts and finiteness are
checked (a CPU time is no device metric).
"""

import math

import pytest
import torch

import bench_cuda
from luisacomputegaussiansplatting_tpu_torch.config import RenderConfig
from luisacomputegaussiansplatting_tpu_torch.io.synthetic import random_scene
from luisacomputegaussiansplatting_tpu_torch.utils.camera import look_at_camera
from luisacomputegaussiansplatting_tpu_torch.utils.profiling import (
    backward_timings,
    frame_profile,
    stage_timings,
    trace,
)

torch.set_num_threads(2)

CAM = look_at_camera((3.2, -2.8, 2.1), (0, 0, 0), (0, 0, 1), fov=70.0,
                     width=64, height=64)
PROD = dict(max_pairs=30_000, tile=32, pack_mode="none", tile_cull=True,
            sort_mode="fused", payload_dtype="bf16", grad_reduce_dtype="bf16",
            grad_reduce_method="rowgather", blend_quad="mxu")


@pytest.fixture(scope="module")
def scene():
    return random_scene(150, seed=2, scale_range=(0.02, 0.12), device="cpu")


def test_stage_timings_keys(scene):
    out = stage_timings(scene, CAM, RenderConfig(max_pairs=30_000), reps=1)
    for k in ("sh_eval", "projection", "binning", "payload",
              "rasterize_fwd", "full_forward", "full_fwd_bwd"):
        assert k in out and out[k] >= 0.0, k


def test_backward_timings_stages_production_config(scene):
    """The VJP attribution covers the production config (fused sort, bf16
    payload/reduce, rowgather, tile cull, mxu)."""
    out = backward_timings(scene, CAM, RenderConfig(**PROD), reps=2)
    for k in ("forward", "rast_bwd", "reduce_bwd", "params_bwd",
              "fwd_bwd_total"):
        assert k in out and out[k] >= 0.0, k


def test_frame_profile_on_cpu(scene):
    """One full differentiable frame: the CPU run lists host ops by self
    time, the blend's autograd Function among them, and reports no device
    busy time."""
    prof = frame_profile(scene, CAM, RenderConfig(**PROD))
    assert prof.device == "cpu" and prof.wall_ms > 0
    assert prof.busy_ms is None and prof.busy_share is None
    assert prof.kernels == []
    names = [name for name, _ms, _calls in prof.ops]
    assert "_RasterizeTiles" in names
    assert "_RasterizeTilesBackward" in names
    ms = [m for _n, m, _c in prof.ops]
    assert ms == sorted(ms, reverse=True) and all(m > 0 for m in ms)


def test_trace_writes_a_chrome_trace(tmp_path, scene):
    with trace(str(tmp_path)):
        stage_timings(scene, CAM, RenderConfig(max_pairs=30_000), reps=1,
                      include_backward=False)
    text = (tmp_path / "trace.json").read_text()
    assert '"traceEvents"' in text and "aten::" in text


def test_bench_run_config_on_cpu():
    """bench_cuda's frame on a 3000-gaussian 96x64 cut of the headline
    config (capacities cut to the scene): chained reps give finite times."""
    res = bench_cuda.run_config("headline", device="cpu", reps=2,
                                n_gaussians=3000, width=96, height=64,
                                max_pairs=40_000, max_pairs_sorted=30_000)
    assert res["device"] == "cpu" and res["peak_gib"] is None
    assert len(res["reps_ms"]) == 2 and res["num_rendered"] > 0
    for k in ("ms", "median_ms", "first_ms", "px_s"):
        assert math.isfinite(res[k]) and res[k] > 0, k
    assert res["px_s"] == pytest.approx(96 * 64 / (res["ms"] / 1e3))


def test_bench_configs_are_bench_py_verbatim():
    """The port's bench runs bench.py's configurations unchanged (bench.py
    imports JAX only inside its measuring child)."""
    import bench

    assert bench_cuda.CONFIGS == bench.CONFIGS
    assert (bench_cuda.WIDTH, bench_cuda.HEIGHT) == (bench.WIDTH, bench.HEIGHT)
