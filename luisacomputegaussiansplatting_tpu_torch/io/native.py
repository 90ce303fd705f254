"""ctypes binding of the native C++ PLY loader (``native/ply_loader.cpp``) and
PNG writer (``native/png_writer.cpp``): port of ``io/native.py``.

Each source is compiled by ``g++`` with the flags of ``native/Makefile`` at
its first use, into ``build/native/<name>-<hash>.so`` beside the package
(the hash covers the source and the flags), and loaded with ``ctypes``.
Nothing is written under ``native/`` and nothing is built at import time.
A failed build raises; a file the fast path does not handle (an ASCII PLY,
another schema) makes :func:`load_gsply_native` return None, and the caller
takes the numpy reader.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading

import numpy as np

from .._build import build_shared_library

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NATIVE_DIR = os.path.join(_REPO, "native")
BUILD_DIR = os.path.join(_REPO, "build", "native")

# native/Makefile:2-3 (CXXFLAGS, LDFLAGS)
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared",
             "-pthread")

_F32P = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_SIGNATURES = {
    "ply_loader": {
        "gsply_info": (ctypes.c_int, [ctypes.c_char_p,
                                      ctypes.POINTER(ctypes.c_long),
                                      ctypes.POINTER(ctypes.c_int)]),
        "gsply_load": (ctypes.c_int, [ctypes.c_char_p, _F32P, _F32P, _F32P,
                                      _F32P, _F32P, ctypes.c_int,
                                      ctypes.c_int]),
    },
    "png_writer": {
        "write_png_rgb8": (ctypes.c_int, [ctypes.c_char_p,
                                          ctypes.POINTER(ctypes.c_uint8),
                                          ctypes.c_int, ctypes.c_int]),
    },
}
_libs: dict = {}
_lock = threading.Lock()


def _cxx() -> str:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("g++ not found: the native IO libraries cannot be "
                           "built")
    return cxx


def native_lib(name: str) -> ctypes.CDLL:
    """The library of ``native/<name>.cpp`` ("ply_loader" or "png_writer"),
    built on first use."""
    with _lock:
        if name not in _libs:
            path, _, _ = build_shared_library(
                [_cxx(), *CXX_FLAGS], os.path.join(NATIVE_DIR, f"{name}.cpp"),
                BUILD_DIR, name)
            lib = ctypes.CDLL(path)
            for fn, (restype, argtypes) in _SIGNATURES[name].items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _libs[name] = lib
        return _libs[name]


def build_native() -> bool:
    """Build both libraries now (they are otherwise built at first use);
    True on success, raises on a failed build."""
    for name in _SIGNATURES:
        native_lib(name)
    return True


def load_gsply_native(path, apply_activations: bool = True,
                      n_threads: int = 0):
    """Load a binary 3DGS PLY with the native loader.

    Returns (means, sh, opacity, scales, quats_xyzw) numpy float32 arrays,
    or None when the file is outside the fast path's schema."""
    lib = native_lib("ply_loader")
    path = os.fspath(path).encode()
    n = ctypes.c_long()
    k_rest = ctypes.c_int()
    if lib.gsply_info(path, ctypes.byref(n), ctypes.byref(k_rest)) != 0:
        return None
    n = n.value
    means = np.empty((n, 3), np.float32)
    sh = np.empty((n, 1 + k_rest.value // 3, 3), np.float32)
    opacity = np.empty((n,), np.float32)
    scales = np.empty((n, 3), np.float32)
    quats = np.empty((n, 4), np.float32)
    rc = lib.gsply_load(path, means, sh.reshape(-1), opacity, scales, quats,
                        1 if apply_activations else 0, n_threads)
    if rc != 0:
        return None
    return means, sh, opacity, scales, quats


def write_png_native(path, hwc_u8: np.ndarray) -> bool:
    """Write an (H, W, 3) uint8 array as PNG with the C++ writer; False if
    the array is not (H, W, 3) or the write fails."""
    arr = np.ascontiguousarray(hwc_u8, dtype=np.uint8)
    if arr.ndim != 3 or arr.shape[2] != 3:
        return False
    h, w = arr.shape[:2]
    rc = native_lib("png_writer").write_png_rgb8(
        os.fspath(path).encode(),
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), int(w), int(h))
    return rc == 0
