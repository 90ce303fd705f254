"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface. At its first use it is
compiled by ``nvcc`` for Hopper (``sm_90a``) into
``build/torch_kernels/<name>-<hash>.so`` beside the package and loaded with
``ctypes``; the hash covers the source, the headers of ``csrc/`` and the
flags, so an edited source is rebuilt and an unchanged one is reused.
Nothing is compiled at import time.

A failed build raises: there is no fallback to the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")

# no --use_fast_math: the kernels must round like the plain versions;
# -Xptxas -v reports each kernel's registers, shared memory and spills
# (kept in ``KernelLib.build_log``)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build_shared_library(command, source: str, build_dir: str, name: str,
                         headers=()):
    """Compile ``source`` with ``command`` (the compiler and its flags) into
    ``build_dir/<name>-<hash>.so`` unless that file exists; the hash covers
    the flags, the source and ``headers``. Returns (path, build seconds or
    None when the library was already built, the compiler's output). A
    failed build raises."""
    digest = hashlib.sha256(" ".join(command[1:]).encode())
    for p in [source, *headers]:
        with open(p, "rb") as f:
            digest.update(f.read())
    path = os.path.join(build_dir, f"{name}-{digest.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path, None, ""
    os.makedirs(build_dir, exist_ok=True)
    t0 = time.perf_counter()
    # build to a private name, then rename: a concurrent build never loads
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    proc = subprocess.run([*command, "-o", tmp, source], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"{os.path.basename(command[0])} failed for {source} "
            f"(rc {proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, path)
    return path, time.perf_counter() - t0, proc.stdout + proc.stderr


class KernelLib:
    """One ``csrc/<name>.cu`` shared library, built on first use.

    ``launches`` counts kernel launches; a wrapper calls :meth:`launched`
    where it launches the kernel and nowhere else. A library whose kernel
    has variants (a blend mode, a row type) also counts launches per variant
    in ``variant_launches``.
    """

    def __init__(self, name: str, signatures: dict, variants=()):
        self.name = name
        self.signatures = signatures  # C function -> (restype, argtypes)
        self.launches = 0
        self.variant_launches = dict.fromkeys(variants, 0)
        self.build_seconds = None
        self.build_log = ""  # nvcc's report of a build in this process
        self._lib = None
        self._lock = threading.Lock()

    @property
    def source(self) -> str:
        return os.path.join(CSRC_DIR, f"{self.name}.cu")

    def lib(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self._lib = self._load()
            return self._lib

    def launched(self, variant: str | None = None) -> None:
        """Count one launch (of ``variant``)."""
        self.launches += 1
        if variant is not None:
            self.variant_launches[variant] += 1

    def reset_launches(self) -> None:
        self.launches = 0
        for v in self.variant_launches:
            self.variant_launches[v] = 0

    def _load(self) -> ctypes.CDLL:
        headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
        path, self.build_seconds, self.build_log = build_shared_library(
            [_nvcc(), *NVCC_FLAGS], self.source, BUILD_DIR, self.name,
            [os.path.join(CSRC_DIR, h) for h in headers])
        lib = ctypes.CDLL(path)
        for fn, (restype, argtypes) in self.signatures.items():
            f = getattr(lib, fn)
            f.restype = restype
            f.argtypes = argtypes
        return lib

    def check(self, err: int, fn: str) -> None:
        """Raise on a non-zero cudaError_t returned by a launch."""
        if err != 0:
            raise RuntimeError(
                f"CUDA launch of {self.name}.{fn} failed: cudaError_t {err}"
            )


def require_cuda_tensors(fn: str, *tensors) -> None:
    """Every argument must be a contiguous CUDA tensor on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{fn}: expected CUDA tensors on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: expected contiguous tensors")
