"""The benchmark's harness: one run of one cell.

    python3 gsbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is found by name: ``gsbench/workloads/<cell>.json`` names its
configuration (``gsbench/configs/<config>.json``), its traffic
(``gsbench/traffic/<traffic>.json``, whose ``loop`` names
``gsbench/loops/<loop>.py``) and the limit of every number that decides
``correct``. ``BENCHMARK.json`` says which metrics the cell reports; a
per-layer metric is read by ``gsbench/metrics/<metric>.py``. A new cell,
configuration, traffic mix or metric is new files and a ``BENCHMARK.json``
entry; no file here changes.

A run: set-up (inputs from the seed, the program's objects, warm-up and
the first steps or frames that the check reads), then ``--seconds`` of
closed-loop steps or frames (``--trace 0``: the end-to-end metrics) or a
fixed number of them under ``torch.profiler`` (``--trace 1``: the
per-layer metrics; where one of the cell's reads the host's clock, an
untraced ``--seconds`` window comes first), then the peak memory, then the plain reference's
comparison once the program's state is freed. The last line of standard
output is the result; the numbers compared, each beside its limit, are
the last lines of standard error and the result's last key.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
import time
from typing import NamedTuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: top-level modules that no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "luisacomputegaussiansplatting_tpu")


class Cell(NamedTuple):
    name: str
    spec: dict  # workloads/<cell>.json
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json
    seed: int
    device: object  # torch.device


def load_json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``gsbench/<kind>/<name>.py`` as a module (a metric's name may hold
    dots, so it is loaded from its path)."""
    path = os.path.join(HERE, kind, name + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} file {path}")
    spec = importlib.util.spec_from_file_location(
        f"gsbench.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_cell(name: str, seed: int, device, overrides=None) -> Cell:
    """The cell's files, with ``overrides`` ({"config": {...}, "traffic":
    {...}}, merged one level deep) for runs at a test's size."""
    spec = load_json("workloads", name + ".json")
    config = load_json("configs", spec["config"] + ".json")
    traffic = load_json("traffic", spec["traffic"] + ".json")
    for part, base in (("config", config), ("traffic", traffic)):
        for key, value in ((overrides or {}).get(part) or {}).items():
            if isinstance(value, dict) and isinstance(base.get(key), dict):
                base[key] = {**base[key], **value}
            else:
                base[key] = value
    return Cell(name, spec, config, traffic, seed, device)


def forbidden_modules():
    """The forbidden top-level names that ``sys.modules`` holds."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def cell_metrics(bench: dict, cell: str):
    """(end-to-end, per-layer) metric entries of ``BENCHMARK.json`` that
    ``cell`` reports."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if (cell in m["workloads"] if "workloads" in m
               else m["moves"] in names)]
    return e2e, per


class MetricContext(NamedTuple):
    """What a per-layer metric's reader gets: the loop's kind ("train" or
    "render"), the reduced trace, the steps or frames traced, the work
    those steps needed (a list of per-step dicts, counted by the reference
    on first use), and the end-to-end readings of the untraced window that
    a traced run makes first where a metric of the cell reads the host's
    clock (else empty)."""

    loop: str
    trace: object  # gsbench.trace.Trace
    steps: int
    work: object  # () -> list of dicts
    window: dict


def run_cell(cell: Cell, seconds: float, trace: bool, t0: float,
             bench: dict | None = None) -> dict:
    """One run of ``cell`` on ``cell.device``; returns the result line as a
    dict (its ``checks`` key last). ``t0`` is the process's start on the
    host clock."""
    import torch

    from . import trace as tr

    if bench is None:
        with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
            bench = json.load(f)
    e2e_defs, per_defs = cell_metrics(bench, cell.name)
    on_card = cell.device.type == "cuda"
    t_init = time.perf_counter()
    if on_card:
        torch.empty(0, device=cell.device)  # the CUDA context
        torch.cuda.reset_peak_memory_stats(cell.device)
    imports_s = t_init - t0
    cuda_init_s = time.perf_counter() - t_init
    loop = load_module("loops", cell.traffic["loop"])
    state = loop.setup(cell)
    setup_s = time.perf_counter() - t0
    timed = {}
    if trace:
        if any(m["source"] == "host_clock" for m in per_defs):
            # a per-layer time read on the host's clock comes from an
            # untraced window, as the end-to-end metrics do
            first = loop.window(state, seconds)
            timed = first["e2e"]
        run = loop.traced(state)
        if timed:
            run["attempted"] += first["attempted"]
            run["failed"] += first["failed"]
    else:
        run = loop.window(state, seconds)
    peak = (torch.cuda.max_memory_allocated(cell.device) if on_card else 0)
    loaded = forbidden_modules()
    if loaded:
        raise RuntimeError(f"forbidden modules loaded: {loaded}")
    records = loop.release(state)
    del state
    if on_card:
        torch.cuda.empty_cache()

    metrics = {}
    if trace:
        reduced = tr.reduce_profile(run["profile"])
        cache = []

        def work():
            if not cache:
                cache.append(loop.work(cell, records))
            return cache[0]

        ctx = MetricContext(cell.traffic["loop"], reduced, run["steps"], work,
                            timed)
        for m in per_defs:
            value = load_module("metrics", m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {**run["e2e"], "setup_s": setup_s,
                  "peak_device_gib": peak / 2**30}
        for m in e2e_defs:
            if m["name"] not in values:
                raise RuntimeError(f"cell {cell.name} gives no {m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}

    numbers = loop.verify(cell, records)
    limits = cell.spec["limits"]
    checks = {}
    for name, value in numbers.items():
        if name not in limits:
            raise RuntimeError(f"no limit for {name} in {cell.name}")
        checks[name] = {"value": value, "limit": limits[name]}
    # a step or frame of the window that failed (a non-finite loss, an
    # overflow) is a wrong answer too
    correct = run["failed"] == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": (torch.cuda.get_device_name(cell.device) if on_card
                       else "cpu"),
              "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": run["attempted"],
              "failed": run["failed"], "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = reduced.busy_s
        device["window_s"] = reduced.window_s
        result["breakdown"] = tr.breakdown(reduced)
    result["setup_parts_s"] = {"imports": imports_s, "cuda_init": cuda_init_s,
                               **records.get("setup_parts", {}),
                               "total": setup_s}
    result["checks"] = checks
    return result


def card_info() -> str:
    """The card's name, power limit, SM clock and temperature, as
    ``nvidia-smi`` reads them (empty where it cannot)."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def main(argv, t0: float) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entry = [w for w in bench["workloads"] if w["name"] == args.workload]
    if not entry:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    spec = load_json("workloads", args.workload + ".json")
    if (spec["config"], spec["traffic"]) != (entry[0]["config"],
                                             entry[0]["traffic"]):
        print(f"{args.workload}: BENCHMARK.json and workloads/"
              f"{args.workload}.json name other files", file=sys.stderr)
        return 2

    import torch

    chips = entry[0]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 3
    # the configurations state float32: no TF32 in the loss's convolutions
    # or any matrix product
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {card_info()}", file=sys.stderr)
    cell = make_cell(args.workload, args.seed, torch.device("cuda", 0))
    result = run_cell(cell, args.seconds, bool(args.trace), t0, bench)
    print(f"card after: {card_info()}", file=sys.stderr)
    print(f"setup parts (s): {json.dumps(result['setup_parts_s'])}",
          file=sys.stderr)
    loaded = forbidden_modules()
    if loaded:
        print(f"forbidden modules loaded: {loaded}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0
