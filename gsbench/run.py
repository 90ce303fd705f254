"""Run one cell of the benchmark of the PyTorch / CUDA port once.

    python3 gsbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

See ``gsbench/harness.py``.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from gsbench.harness import main

    sys.exit(main(sys.argv[1:], T0))
