"""The readings that ``bicycle-train-b4``'s limits of ``correct`` are set
from, on the card at the cell's own size (``gsbench/calibrate.py``'s
``readings`` for the batched loop, with its faults). The benchmark's runs
never run this.

    python3 gsbench/calibrate_b4.py --seeds 1,2,3 [--control N] [--faults N]

For each seed: the program's set-up with its check steps as the cell makes
it, then the numbers that decide ``correct`` for the program against the
reference (the lower readings); on the first N seeds with ``--control`` for
the reference in bfloat16 in the program's place, and with ``--faults`` for
each fault of ``reference/train_batched.py`` (``FAULTS``) planted in the
reference in the program's place (the upper readings). One JSON line per
seed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CELL = "bicycle-train-b4"


def readings(seeds, device, control: int, faults: int):
    import torch

    from gsbench import harness
    from gsbench.reference import train_batched as RB

    for i, seed in enumerate(seeds):
        cell = harness.make_cell(CELL, seed, device)
        loop = harness.load_module("loops", cell.traffic["loop"])
        t = time.perf_counter()
        records = loop.release(loop.setup(cell))
        torch.cuda.empty_cache()
        out = {"cell": CELL, "seed": seed,
               "program_s": time.perf_counter() - t}
        t = time.perf_counter()
        ref = loop.reference(cell, records)
        out["reference_s"] = time.perf_counter() - t
        out["lower"] = loop.compare(records, ref)
        if i < control:
            out["control"] = loop.compare(
                loop.reference(cell, records, "bf16"), ref)
        for fault in RB.FAULTS if i < faults else ():
            out[fault] = loop.compare(
                loop.reference(cell, records, fault=fault), ref)
        print(json.dumps(out), flush=True)
        del records, ref
        torch.cuda.empty_cache()


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", default="1")
    p.add_argument("--control", type=int, default=0,
                   help="read the control on this many of the seeds")
    p.add_argument("--faults", type=int, default=0,
                   help="read the faults on this many of the seeds")
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    readings([int(s) for s in args.seeds.split(",")],
             torch.device("cuda", 0), args.control, args.faults)
    return 0


if __name__ == "__main__":
    sys.exit(main())
