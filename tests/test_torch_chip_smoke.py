"""``chip_smoke.py`` states each kernel's bound in the benchmark's yardstick
(``gsbench/work.py``) and keeps no peak rate or operation count of its
own."""

import math
import re

import pytest

import chip_smoke
from gsbench import work as W

#: fixed counts of the frames' shapes: (work function, its arguments)
CASES = {
    "k1 strict (no cull)": (W.k1_work, (2_000_000, 16_000_000, 7_621_554,
                                        False)),
    "k1 production (cull)": (W.k1_work, (2_000_000, 13_000_000, 4_205_371,
                                         True)),
    "k1 cull over many slots": (W.k1_work, (1_000, 1_000, 2**31 - 1, True)),
    "k2 vpu": (W.k2_work, (7_621_554, 8_160, 256, 120_000_000, 30_000_000,
                           "vpu")),
    "k2 mxu": (W.k2_work, (3_373_298, 2_040, 1024, 150_000_000, 25_000_000,
                           "mxu")),
    "k3 vpu": (W.k3_work, (7_621_554, 8_160, 256, 120_000_000, 30_000_000,
                           "vpu")),
    "k3 mxu, few pairs": (W.k3_work, (3_373_298, 2_040, 1024, 1_000, 100,
                                      "mxu")),
    "k4": (W.k4_work, (3_373_298, 2_000_000)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_bound_is_gsbench_work(case):
    """``kernel_bound`` of K1-K4's work equals ``gsbench.work.bound_s`` of
    the same counts, and names the term that sets it."""
    fn, args = CASES[case]
    nbytes, ops = fn(*args)
    got = chip_smoke.kernel_bound(nbytes, ops)
    assert got["bound_ms"] == W.bound_s(nbytes, ops) * 1e3
    t_bytes = nbytes / W.HBM_BYTES_PER_S
    t_ops = ops / W.FP32_OPS_PER_S
    assert math.isclose(got["bound_ms"], max(t_bytes, t_ops) * 1e3)
    assert got["bound_by"] == ("bytes" if t_bytes >= t_ops else "operations")


def test_cases_reach_both_limits():
    """The cases above hold both names of the limit."""
    names = {chip_smoke.kernel_bound(*fn(*args))["bound_by"]
             for fn, args in CASES.values()}
    assert names == {"bytes", "operations"}


def test_no_yardstick_of_its_own():
    """No peak rate, per-pair operation count or bound formula of its own:
    the rates and counts are ``gsbench/work.py``'s."""
    for name in ("HBM_BYTES_PER_S", "FP32_OPS_PER_S", "OPS_PER_PAIR",
                 "OPS_PER_APPLIED", "OPS_PER_EVALUATED", "bound"):
        assert not hasattr(chip_smoke, name), name
    peaks = (W.HBM_BYTES_PER_S, W.FP32_OPS_PER_S)
    for name, value in vars(chip_smoke).items():
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            assert value not in peaks, name
    with open(chip_smoke.__file__) as f:
        src = f.read()
    assert not re.search(r"3\.35e12|67e12|OPS_PER_PAIR|OPS_PER_APPLIED"
                         r"|def bound\b", src)
    assert chip_smoke.W is W
