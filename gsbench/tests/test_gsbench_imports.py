"""No module the harness runs or loads brings in JAX or the JAX package,
and the reference imports nothing of the program."""

import ast
import glob
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
GSBENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(GSBENCH)
PORT = "luisacomputegaussiansplatting_tpu_torch"

_PROBE = r"""
import glob, json, os, sys
sys.path.insert(0, {root!r})
import gsbench
from gsbench import calibrate, harness, inputs, trace, work
from gsbench.reference import render, train
for kind in ("loops", "metrics"):
    for path in sorted(glob.glob(os.path.join({gsbench!r}, kind, "*.py"))):
        name = os.path.basename(path)[:-3]
        if name != "__init__":
            harness.load_module(kind, name)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_no_jax_in_any_harness_module():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(root=ROOT, gsbench=GSBENCH)],
        capture_output=True, text=True, check=True, timeout=300)
    top = set(__import__("json").loads(out.stdout.strip().splitlines()[-1]))
    # whole top-level names: the port's name begins with the JAX package's
    assert not top & {"jax", "jaxlib", "flax",
                      "luisacomputegaussiansplatting_tpu"}
    assert PORT in top  # the loops drive the program


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    files = glob.glob(os.path.join(GSBENCH, "reference", "*.py"))
    assert files
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in (
                PORT, "luisacomputegaussiansplatting_tpu", "jax", "jaxlib",
                "gsbench"), (path, name)
    probe = ("import sys; sys.path.insert(0, %r); "
             "import gsbench.reference.render, gsbench.reference.train; "
             "print(sorted({m.split('.')[0] for m in sys.modules}))" % ROOT)
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    assert PORT not in out and "'jax'" not in out
