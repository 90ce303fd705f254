"""Sorted segment-sum: reduce per-entry rows into per-gaussian rows
(counterpart of ``ops/segsum.py``).

This is the backward of the payload gather: the per-entry payload gradients
are summed per gaussian. On CUDA tensors the rows are sorted by id with
``torch.sort`` (a CUB radix sort, the library op the JAX package's
``lax.sort`` is), gathered once, and summed by the hand-written kernel
``csrc/segsum.cu`` in two passes: the segment starts of the sorted ids (the
plain version of that pass is :func:`segment_starts_reference`), then one
thread per output id over its rows. No float atomics, the same bits on
every run. ``dtype="bf16"`` rounds every row value to bf16 (round to
nearest even) before it is added; the sums stay float32. CPU tensors take
the plain version of the kernel's two passes after the same sort
(:func:`segment_sum_sorted_reference`), which adds no scatter (the sharded
backward is held to none); :func:`segment_sum_reference`, ``index_add_``
into a zeroed table, is the plain version the card holds the kernel to.

The JAX package's int32 bf16-pair packing and one-hot MXU strips are TPU
devices and are not carried over; its ``method`` knob ("ride" or
"rowgather") only chooses how ``lax.sort`` moves operands on a TPU, so both
values run the one path here.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import KernelLib, require_cuda_tensors

_p, _i, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64

#: columns a row may have (the kernel keeps one register per column)
MAX_COLS = 16
DTYPES = ("f32", "bf16")
METHODS = ("ride", "rowgather")

#: launches are counted per row variant (``KERNEL.variant_launches``): "f32"
#: rows (replaces ``_segsum_kernel``) and rows rounded to "bf16" (replaces
#: ``_segsum_kernel_packed``)
KERNEL = KernelLib("segsum", {
    "segsum_starts_launch": (ctypes.c_int, [_p, _i64, _i64, _p, _p]),
    "segsum_sums_launch": (
        ctypes.c_int, [_p, _p, _i64, _i64, _i, _i64, _i, _p, _p],
    ),
}, variants=DTYPES)


def _check(dtype: str, cols: int, method: str = "ride") -> None:
    if dtype not in DTYPES:
        raise ValueError(f"unknown reduce dtype {dtype!r}")
    if method not in METHODS:
        raise ValueError(f"unknown reduce method {method!r}")
    if not 1 <= cols <= MAX_COLS:
        raise ValueError(f"rows must have 1..{MAX_COLS} columns, got {cols}")


def _round_rows(rows, dtype: str):
    """Rows as the reduction adds them: bf16-rounded values for "bf16"."""
    if dtype == "bf16":
        return rows.to(torch.bfloat16).to(torch.float32)
    return rows


def segment_sum_reference(ids, rows, n_out: int, dtype: str = "f32"):
    """The plain version, for ids in any order: (L,) ids and (L, cols)
    float32 rows -> (n_out, cols) sums; rows with an id outside [0, n_out)
    are dropped (their values may be garbage)."""
    keep = (ids >= 0) & (ids < n_out)
    key = torch.where(keep, ids, torch.full_like(ids, n_out)).to(torch.int64)
    vals = torch.where(keep[:, None], _round_rows(rows, dtype),
                       torch.zeros((), dtype=rows.dtype, device=rows.device))
    out = torch.zeros((n_out + 1, rows.shape[1]), dtype=torch.float32,
                      device=rows.device)
    return out.index_add_(0, key, vals.to(torch.float32))[:n_out]


def segment_starts_reference(sorted_ids, n_out: int):
    """The plain version of the kernel's first pass: (n_out + 1,) int32,
    entry g the first row of the ascending ``sorted_ids`` whose id is >= g,
    so the rows of id g are [starts[g], starts[g + 1]). Ids < 0 lie before
    starts[0] and ids >= n_out from starts[n_out] on: no range holds them."""
    bounds = torch.arange(n_out + 1, dtype=sorted_ids.dtype,
                          device=sorted_ids.device)
    return torch.searchsorted(sorted_ids, bounds, side="left",
                              out_int32=True)


def segment_sum_sorted_reference(sorted_ids, rows, n_out: int,
                                 dtype: str = "f32"):
    """The plain version of the kernel's two passes over ascending ids: the
    segment starts, then each id's rows summed in order
    (``torch.segment_reduce``); ids outside [0, n_out) are dropped."""
    starts = segment_starts_reference(sorted_ids.contiguous(), n_out)
    lo, hi = int(starts[0]), int(starts[-1])
    lengths = (starts[1:] - starts[:-1]).to(torch.int64)
    vals = _round_rows(rows[lo:hi], dtype).to(torch.float32)
    if n_out == 0 or hi == lo:
        return torch.zeros((n_out, rows.shape[1]), dtype=torch.float32,
                           device=rows.device)
    return torch.segment_reduce(vals, "sum", lengths=lengths, axis=0,
                                initial=0.0)


def _check_sorted_ids(fn: str, sorted_ids, n_out: int) -> None:
    require_cuda_tensors(fn, sorted_ids)
    if sorted_ids.dtype != torch.int32 or sorted_ids.dim() != 1:
        raise ValueError(f"{fn}: ids must be (L,) int32")
    if not 0 <= n_out < 2**31 - 1:
        raise ValueError(f"{fn}: n_out {n_out} out of range")


def _launch_starts(lib, sorted_ids, n_out: int, stream):
    starts = torch.empty(n_out + 1, dtype=torch.int32,
                         device=sorted_ids.device)
    err = lib.segsum_starts_launch(sorted_ids.data_ptr(), sorted_ids.shape[0],
                                   n_out, starts.data_ptr(), stream)
    KERNEL.check(err, "segsum_starts_launch")
    return starts


def segment_starts_kernel(sorted_ids, n_out: int):
    """The kernel's first pass alone (for checking it against
    :func:`segment_starts_reference`); not counted as a launch of the
    segment-sum, which :func:`segment_sum_kernel` counts once per
    reduction."""
    _check_sorted_ids("segment_starts_kernel", sorted_ids, n_out)
    lib = KERNEL.lib()
    dev = sorted_ids.device
    with torch.cuda.device(dev):
        return _launch_starts(lib, sorted_ids, n_out,
                              torch.cuda.current_stream(dev).cuda_stream)


def segment_sum_kernel(sorted_ids, rows, n_out: int, dtype: str = "f32"):
    """Launch ``csrc/segsum.cu`` (its two passes, counted as one launch of
    ``dtype``) on ascending int32 ids and (L, cols) float32 rows of any
    strides (a transposed field-major view needs no copy)."""
    _check_sorted_ids("segment_sum_kernel", sorted_ids, n_out)
    n_rows, cols = rows.shape
    _check(dtype, cols)
    if rows.device != sorted_ids.device or rows.dtype != torch.float32:
        raise ValueError("segment_sum_kernel: rows must be float32 on the ids' "
                         "device")
    if sorted_ids.shape != (n_rows,):
        raise ValueError(f"segment_sum_kernel: ids must be ({n_rows},) int32")
    dev = rows.device
    out = torch.empty((n_out, cols), dtype=torch.float32, device=dev)
    if n_out == 0:
        return out
    lib = KERNEL.lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        starts = _launch_starts(lib, sorted_ids, n_out, stream)
        err = lib.segsum_sums_launch(
            starts.data_ptr(), rows.data_ptr(), rows.stride(0),
            rows.stride(1), cols, n_out, int(dtype == "bf16"), out.data_ptr(),
            stream,
        )
    KERNEL.check(err, "segsum_sums_launch")
    KERNEL.launched(dtype)
    return out


def segment_sum_sorted(sorted_gid, sorted_rows, n_out: int,
                       dtype: str = "f32"):
    """Sum ``sorted_rows`` (L, cols) per id of the ascending (L,) int32
    ``sorted_gid``; ids outside [0, n_out) are dropped, ids with no rows
    give zeros. Returns (n_out, cols) float32."""
    _check(dtype, sorted_rows.shape[1])
    if sorted_rows.device.type == "cpu":
        return segment_sum_sorted_reference(sorted_gid, sorted_rows, n_out,
                                            dtype)
    return segment_sum_kernel(sorted_gid, sorted_rows, n_out, dtype)


def reduce_fields_by_id(gid, field_rows, n_out: int, dtype: str = "f32",
                        method: str = "ride"):
    """Unsorted segment-sum of field-major rows.

    Args:
      gid: (L,) int32 in [-1, n_out); -1 rows are dropped.
      field_rows: a (cols, L) float32 tensor or a sequence of cols (L,)
        tensors (e.g. the payload gradient straight off the backward blend).
      dtype: "f32", or "bf16" to round every row value before the add.
      method: "ride" or "rowgather"; both run the same path.

    Returns (n_out, cols) float32 sums.
    """
    fields = (field_rows if torch.is_tensor(field_rows)
              else torch.stack(list(field_rows)))
    _check(dtype, fields.shape[0], method)
    key = torch.where(gid >= 0, gid, torch.full_like(gid, n_out))
    # stable: a fixed order within each id, so the sums repeat bit for bit
    sorted_key, perm = torch.sort(key.to(torch.int32), stable=True)
    sorted_fields = fields[:, perm]  # one gather, field-major
    return segment_sum_sorted(sorted_key, sorted_fields.t(), n_out, dtype)


def reduce_rows_by_id(gid, rows, n_out: int, dtype: str = "f32"):
    """Like :func:`reduce_fields_by_id` for (L, cols) row-major rows."""
    return reduce_fields_by_id(gid, rows.t(), n_out, dtype)
