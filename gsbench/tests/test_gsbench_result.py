"""A whole run of each cell on the CPU at a test size: the result line's
keys, the metrics BENCHMARK.json names, and ``correct`` for the sound
program."""

import json
import os
import subprocess
import sys

import pytest
import torch

from conftest import CELLS, TINY
from gsbench import harness

BENCH = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_result_line(cell, trace):
    c = harness.make_cell(cell, 2**31 + 99, torch.device("cpu"), TINY)
    out = harness.run_cell(c, 0.3, bool(trace), 0.0, BENCH)
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    assert set(out["checks"]) == set(c.spec["limits"])
    e2e, per = harness.cell_metrics(BENCH, cell)
    if trace:
        assert set(out["metrics"]) <= {m["name"] for m in per}
        # a time read on the host's clock comes from the untraced window
        assert {m["name"] for m in per if m["source"] == "host_clock"} <= \
            set(out["metrics"])
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(out["metrics"]) == {m["name"] for m in e2e}
    for m in out["metrics"].values():
        assert m["value"] == m["value"] and m["unit"]
    json.dumps(out)


def test_run_without_a_card_exits_nonzero_and_prints_nothing():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, os.path.join(harness.HERE, "run.py"), "--workload",
         "lego-render-800", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=env, cwd=harness.ROOT,
        timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.card
def test_a_short_run_on_the_card(card):
    proc = subprocess.run(
        [sys.executable, os.path.join(harness.HERE, "run.py"), "--workload",
         "lego-render-800", "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=harness.ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
