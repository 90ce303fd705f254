"""Image IO (port of ``utils/image.py``).

Reproduces the reference app's post-processing (app/main.cpp:322-340):
CHW float -> HWC uint8 with a truncating cast and a vertical flip, written
as PNG by the native C++ writer (``io/native.py``, the counterpart of the
reference's stb_image_write) or, with ``use_native=False``, by the
pure-Python encoder here (``zlib`` + ``struct``). ``read_png`` decodes with
PIL, as the JAX package does.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch


def chw_to_png_array(img_chw, flip_vertical: bool = True) -> np.ndarray:
    """(3, H, W) float in [0, 1] -> (H, W, 3) uint8, flipped like the
    reference (main.cpp:331 writes row h-1-i) and truncated, not rounded."""
    if isinstance(img_chw, torch.Tensor):
        img_chw = img_chw.detach().cpu().numpy()
    img = np.clip(np.asarray(img_chw), 0.0, 1.0)
    hwc = np.transpose(img, (1, 2, 0))
    if flip_vertical:
        hwc = hwc[::-1]
    return (hwc * 255.0).astype(np.uint8)


def _chunk(tag: bytes, data: bytes) -> bytes:
    body = tag + data
    return struct.pack(">I", len(data)) + body + struct.pack(
        ">I", zlib.crc32(body) & 0xFFFFFFFF
    )


def encode_png(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes (8-bit RGB, filter type 0 per row)."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, c = rgb.shape
    if c != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {rgb.shape}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)],
                          axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", header)
        + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + _chunk(b"IEND", b"")
    )


def write_png(path, img_chw, flip_vertical: bool = True,
              use_native: bool = True) -> None:
    """Write a (3, H, W) float image (array or tensor) as PNG."""
    arr = chw_to_png_array(img_chw, flip_vertical)
    if use_native:
        from ..io.native import write_png_native

        if write_png_native(path, arr):
            return
    with open(path, "wb") as f:
        f.write(encode_png(arr))


def read_png(path) -> np.ndarray:
    """PNG -> (3, H, W) float32 in [0, 1] (no flip)."""
    from PIL import Image

    arr = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    return np.transpose(arr, (2, 0, 1))
