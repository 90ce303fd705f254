"""3DGS PLY scene IO (port of ``io/ply.py``): numpy, and the native C++
loader for the standard binary schema.

Property schema (reference app/gaussians.cpp:84-90): x y z [nx ny nz]
f_dc_0..2 f_rest_* opacity scale_0..2 rot_0..3, rot stored (w, x, y, z),
f_rest channel-major (gaussians.cpp:124-135). Activations at load as the
reference applies them (gaussians.cpp:137-168): sigmoid(opacity),
exp(scale), normalised rotation.
"""

from __future__ import annotations

import io
import os
from typing import Dict, List, Tuple

import numpy as np

from ..models.gaussians import GaussianScene, from_numpy
from ..utils.device import resolve_device

_PLY_TO_NP = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "int": "<i4", "int32": "<i4", "uint": "<u4", "uint32": "<u4",
    "short": "<i2", "ushort": "<u2", "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
}


def _parse_header(f) -> Tuple[str, int, List[Tuple[str, str]]]:
    """(format, vertex count, [(name, numpy dtype)]); leaves ``f`` at the
    first data byte."""
    if f.readline().strip() != b"ply":
        raise ValueError("not a PLY file")
    fmt, count, props, in_vertex = None, 0, [], False
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unexpected EOF in PLY header")
        tok = line.strip().split()
        if not tok:
            continue
        if tok[0] == b"format":
            fmt = tok[1].decode()
        elif tok[0] == b"element":
            in_vertex = tok[1] == b"vertex"
            if in_vertex:
                count = int(tok[2])
        elif tok[0] == b"property" and in_vertex:
            if tok[1] == b"list":
                raise ValueError("list properties unsupported in vertex element")
            props.append((tok[2].decode(), _PLY_TO_NP[tok[1].decode()]))
        elif tok[0] == b"end_header":
            break
    if fmt is None:
        raise ValueError("PLY missing format line")
    return fmt, count, props


def _read_vertex_table(path: str) -> Tuple[Dict[str, np.ndarray], int]:
    with open(path, "rb") as f:
        fmt, count, props = _parse_header(f)
        names = [n for n, _ in props]
        if fmt in ("binary_little_endian", "binary_big_endian"):
            order = ">" if fmt == "binary_big_endian" else "<"
            dtype = np.dtype([(n, d.replace("<", order)) for n, d in props])
            raw = np.fromfile(f, dtype=dtype, count=count)
            cols = {n: np.ascontiguousarray(raw[n]) for n in names}
        elif fmt == "ascii":
            data = np.loadtxt(f, dtype=np.float64, max_rows=count, ndmin=2)
            cols = {n: data[:, i].astype(np.float32) for i, n in enumerate(names)}
        else:
            raise ValueError(f"unsupported PLY format {fmt}")
    return cols, count


def load_ply(path, apply_activations: bool = True, use_native: bool = True,
             device="cuda") -> GaussianScene:
    """Load a 3DGS checkpoint PLY into a ``GaussianScene`` on ``device``, by
    default the card (raw stored values with ``apply_activations=False``);
    without a GPU, pass ``device="cpu"``.

    The native C++ loader (``io/native.py``) reads the standard binary
    schema; any other file, or ``use_native=False``, takes numpy."""
    dev = resolve_device(device)
    if use_native:
        from .native import load_gsply_native

        out = load_gsply_native(path, apply_activations)
        if out is not None:
            means, sh, opacity, scales, quats = out
            return from_numpy(means, scales, quats, opacity, sh, dev)
    cols, n = _read_vertex_table(os.fspath(path))

    def grab(names):
        return np.stack([cols[x].astype(np.float32) for x in names], axis=1)

    means = grab(["x", "y", "z"])
    dc = grab(["f_dc_0", "f_dc_1", "f_dc_2"])[:, None, :]
    n_rest = len([k for k in cols if k.startswith("f_rest_")])
    if n_rest % 3 != 0:
        raise ValueError(f"f_rest count {n_rest} not divisible by 3")
    if n_rest:
        rest = grab([f"f_rest_{i}" for i in range(n_rest)])
        rest = rest.reshape(n, 3, n_rest // 3).transpose(0, 2, 1)
    else:
        rest = np.zeros((n, 0, 3), np.float32)
    sh = np.concatenate([dc, rest], axis=1)

    opacity = cols["opacity"].astype(np.float32)
    scales = grab(["scale_0", "scale_1", "scale_2"])
    quats = grab(["rot_0", "rot_1", "rot_2", "rot_3"])[:, [1, 2, 3, 0]]
    if apply_activations:
        opacity = 1.0 / (1.0 + np.exp(-opacity))
        scales = np.exp(scales)
        quats = quats / np.linalg.norm(quats, axis=1, keepdims=True)
    return from_numpy(means, scales, quats, opacity, sh, dev)


def save_ply(scene: GaussianScene, path, invert_activations: bool = True,
             fmt: str = "binary"):
    """Write a scene as a graphdeco-compatible PLY ("binary" little-endian
    or "ascii"); with ``invert_activations`` it round-trips through
    :func:`load_ply`."""
    if fmt not in ("binary", "ascii"):
        raise ValueError(f"unsupported PLY write format {fmt!r}")

    def arr(x):
        return x.detach().cpu().numpy().astype(np.float32)

    n = scene.num_gaussians
    means, sh = arr(scene.means), arr(scene.sh)
    k = sh.shape[1]
    rest = sh[:, 1:, :].transpose(0, 2, 1).reshape(n, -1)  # channel-major
    opacity, scales, quats = (arr(scene.opacities), arr(scene.scales),
                              arr(scene.quats))
    if invert_activations:
        op = np.clip(opacity, 1e-6, 1 - 1e-6)
        opacity = np.log(op) - np.log1p(-op)
        scales = np.log(np.maximum(scales, 1e-12))
    names = (
        ["x", "y", "z", "nx", "ny", "nz"]
        + [f"f_dc_{i}" for i in range(3)]
        + [f"f_rest_{i}" for i in range(3 * (k - 1))]
        + ["opacity"]
        + [f"scale_{i}" for i in range(3)]
        + [f"rot_{i}" for i in range(4)]
    )
    table = np.concatenate(
        [means, np.zeros((n, 3), np.float32), sh[:, 0, :], rest,
         opacity[:, None], scales, quats[:, [3, 0, 1, 2]]],
        axis=1,
    ).astype("<f4")
    header = io.BytesIO()
    header.write(b"ply\n")
    header.write(b"format binary_little_endian 1.0\n" if fmt == "binary"
                 else b"format ascii 1.0\n")
    header.write(f"element vertex {n}\n".encode())
    for name in names:
        header.write(f"property float {name}\n".encode())
    header.write(b"end_header\n")
    with open(os.fspath(path), "wb") as f:
        f.write(header.getvalue())
        if fmt == "binary":
            table.tofile(f)
        else:
            np.savetxt(f, table, fmt="%.9g")
