"""The readings that the limits of ``correct`` and the configurations'
capacities are set from, on the card at each cell's own size. The
benchmark's runs never run this.

    python3 gsbench/calibrate.py survey <cell> [<cell> ...]
    python3 gsbench/calibrate.py readings <cell> --seeds 1,2,3 [--control N]
        [--faults N] [--seconds 2]

``survey``: for every pose a cell renders (the training views, or the 360
poses of its path), the reference's rectangle slots and the entries the
cull keeps, beside the configuration's ``max_pairs`` and
``max_pairs_sorted``.

``readings``: for each seed, the program's run as the cell makes it (set-up
with its check steps; a render cell also a ``--seconds`` window), then the
numbers that decide ``correct`` for the program against the reference (the
lower readings), on the first N seeds with ``--control`` for the reference in bfloat16 in the
program's place (the upper readings) and with ``--faults`` for the training
faults planted in the reference in the program's place (half of the image
left out of the loss; no update reaching the parameters). One JSON line
per seed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def survey(cells, device):
    import torch

    from gsbench import harness, inputs
    from gsbench.reference import render as R

    for name in cells:
        cell = harness.make_cell(name, 0, device)
        cfg, tr = cell.config, cell.traffic
        rs = R.RenderSettings.from_config(cfg["render"])
        raw = inputs.draw_params(cfg["scene"], 0, device)
        ds = cfg["dataset"]
        if tr["loop"] == "train":
            views, w, h = inputs.train_views(ds, device), ds["width"], ds["height"]
        else:
            path = inputs.RenderPath(ds, tr, 0, device)
            views, w, h = path.views, path.width, path.height
        grid_x, grid_y = R.tile_grid(w, h, rs.tile)
        wide = rs._replace(max_pairs=4 * rs.max_pairs, max_pairs_sorted=None)
        aabb, kept = [], []
        with torch.no_grad():
            means, scales, quats, opac, sh = R.activate(*raw)
            sel = R.bf16(opac) if rs.payload_dtype == "bf16" else opac
            for v in views:
                p = R.project(means, scales, quats, v, w, h, rs)
                b = R.bin_entries(p, grid_x, grid_y, wide, sel)
                if b.overflow:
                    raise RuntimeError(f"{name}: a pose needs over "
                                       f"{wide.max_pairs} slots")
                aabb.append(b.aabb)
                kept.append(b.num_rendered)
        print(json.dumps({"cell": name, "poses": len(views),
                          "aabb_max": max(aabb), "aabb_min": min(aabb),
                          "kept_max": max(kept), "kept_min": min(kept),
                          "max_pairs": rs.max_pairs,
                          "max_pairs_sorted": rs.max_pairs_sorted}),
              flush=True)


def readings(name, seeds, device, control, faults, seconds):
    """``control`` and ``faults``: how many of the seeds, the first, also
    read the control and the faults."""
    import torch

    from gsbench import harness

    for i, seed in enumerate(seeds):
        cell = harness.make_cell(name, seed, device)
        loop = harness.load_module("loops", cell.traffic["loop"])
        t = time.perf_counter()
        state = loop.setup(cell)
        if cell.traffic["loop"] == "render":
            loop.window(state, seconds)
        records = loop.release(state)
        del state
        torch.cuda.empty_cache()
        t_prog = time.perf_counter() - t
        t = time.perf_counter()
        ref = loop.reference(cell, records)
        out = {"cell": name, "seed": seed, "program_s": t_prog,
               "reference_s": time.perf_counter() - t,
               "lower": loop.compare(records, ref)}
        if i < control:
            t = time.perf_counter()
            out["control"] = loop.compare(loop.reference(cell, records,
                                                         "bf16"), ref)
            out["control_s"] = time.perf_counter() - t
        if i < faults and cell.traffic["loop"] == "train":
            for fault in ("half_batch", "unchanged"):
                out[fault] = loop.compare(
                    loop.reference(cell, records, fault=fault), ref)
        print(json.dumps(out), flush=True)
        del records, ref
        torch.cuda.empty_cache()


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("what", choices=("survey", "readings"))
    p.add_argument("cells", nargs="+")
    p.add_argument("--seeds", default="1")
    p.add_argument("--control", type=int, default=0,
                   help="read the control on this many of the seeds")
    p.add_argument("--faults", type=int, default=0,
                   help="read the faults on this many of the seeds")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    if args.what == "survey":
        survey(args.cells, dev)
    else:
        seeds = [int(s) for s in args.seeds.split(",")]
        for name in args.cells:
            readings(name, seeds, dev, args.control, args.faults,
                     args.seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
