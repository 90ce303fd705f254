"""Scatter-free autograd Functions of the sharded exchange (port of
``parallel/exchange_vjp.py``).

The sharded render (``parallel/render_sharded.py``) moves payload rows
through four gathers and one collective: table -> sorted entries -> owner
buckets -> all-to-all -> merge permutation -> packed ranges. Autograd of a
plain index would accumulate every one of them back with
``index_put_(accumulate=True)``, float atomics on CUDA. Each has a
structured inverse instead, written as the backward of a
``torch.autograd.Function``:

  * table rows by (repeating) gaussian id -> the sorted segment-sum
    (``ops/segsum.py``, the kernel K4 on CUDA): ids repeat, a true
    reduction;
  * contiguous bucket slices -> position -> bucket by ``searchsorted``,
    then one row gather (the slices are disjoint);
  * the merge permutation -> its inverse from one sort, then one row gather;
  * chunk-packed range slots -> the closed-form slot of each entry
    (``ops/binning.pack_slot_inverse``), then one row gather;
  * the all-to-all -> the reverse all-to-all.

So the sharded backward moves gradients with sorts, row gathers and
collectives only; ``tests/test_torch_sharding.py`` holds it to no
``index_add``, ``scatter_add`` or accumulating ``index_put_``.

bf16: with ``payload_dtype="bf16"`` the forward exchange moves opacity and
rgb as ``torch.bfloat16`` (rounded to nearest even, the rounding of the
single-device gather); with ``grad_dtype="bf16"`` the reverse exchange moves
the cotangent rows as bf16 and the reduction sums them in float32. Both
backends move bf16 tensors, so the JAX package's int32 pair packing is not
carried over: the numbers are the same, the bytes are the bf16 bytes.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.segsum import reduce_rows_by_id

#: payload columns from which the bf16 payload exchange rounds (opacity, rgb)
BF16_PAYLOAD_FROM = 5


def _gather_valid(rows, idx, valid, fill=None):
    """rows[idx] where ``valid``, else ``fill`` (a row, or zeros); ``idx``
    is clamped."""
    safe = torch.clamp(idx, 0, max(rows.shape[0] - 1, 0)).to(torch.int64)
    out = rows[safe]
    mask = valid.reshape(valid.shape + (1,) * (out.dim() - valid.dim()))
    if fill is None:
        fill = torch.zeros((), dtype=out.dtype, device=out.device)
    return torch.where(mask, out, fill)


def _bucket_inverse(cuts, l_loc: int, bcap: int):
    """Position i -> (flat bucket slot, valid): the inverse of disjoint
    contiguous bucket slicing (:func:`slice_rows`)."""
    ndev = cuts.shape[0] - 1
    cuts = cuts.to(torch.int32).contiguous()
    i = torch.arange(l_loc, dtype=torch.int32, device=cuts.device)
    o = torch.clamp(torch.searchsorted(cuts, i, right=True, out_int32=True)
                    - 1, 0, ndev - 1).to(torch.int64)
    b = i - cuts[o]
    valid = (b >= 0) & (b < bcap) & (i < cuts[o + 1])
    idx = torch.clamp(o * bcap + b, 0, ndev * bcap - 1)
    return idx, valid


def _invperm(perm):
    """The inverse permutation from one sort of ``perm`` (unique values, so
    the order is exact): perm[inv] == arange. Never a scatter."""
    return torch.sort(perm).indices


def slice_rows(rows, cuts, bcap: int, fill=None):
    """(L, ...) rows + (ndev + 1,) cuts -> (ndev, bcap, ...): bucket d holds
    rows[cuts[d]:cuts[d + 1]], truncated to bcap and padded with ``fill``
    (a row; zeros by default). Rows at positions >= cuts[-1] belong to no
    bucket. Any dtype; no autograd (see :func:`slice_buckets`)."""
    l_loc = rows.shape[0]
    cuts = cuts.to(torch.int64)
    j = torch.arange(bcap, dtype=torch.int64, device=rows.device)[None, :]
    start = cuts[:-1]
    blen = cuts[1:] - start
    src = torch.clamp(start[:, None] + j, 0, l_loc - 1)
    valid = j < torch.clamp(blen, max=bcap)[:, None]
    return _gather_valid(rows, src, valid, fill)


class _TakeTableRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, gid, grad_dtype):
        ctx.save_for_backward(gid)
        ctx.n_rows = table.shape[0]
        ctx.grad_dtype = grad_dtype
        return _gather_valid(table, gid, gid >= 0)

    @staticmethod
    def backward(ctx, d_rows):
        (gid,) = ctx.saved_tensors
        if ctx.grad_dtype == "bf16":
            d_rows = d_rows.to(torch.bfloat16).to(torch.float32)
        # one stable sort by gid, one row gather, the sorted segment-sum
        return reduce_rows_by_id(gid, d_rows, ctx.n_rows), None, None


def take_table_rows(table, gid, grad_dtype: str = "f32"):
    """(N, F) table + (L,) gid in [-1, N) -> (L, F); rows of gid < 0 are 0.

    Backward: d_table is the sorted segment-sum of the cotangent rows per
    gid (K4 on CUDA), not a scatter-add. ``grad_dtype="bf16"`` rounds the
    cotangent rows to bf16 first; the sums stay float32."""
    if grad_dtype not in ("f32", "bf16"):
        raise ValueError(f"unknown grad_dtype: {grad_dtype!r}")
    return _TakeTableRows.apply(table, gid, grad_dtype)


class _SliceBuckets(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, cuts, bcap):
        ctx.save_for_backward(cuts)
        ctx.l_loc, ctx.bcap = rows.shape[0], bcap
        return slice_rows(rows, cuts, bcap)

    @staticmethod
    def backward(ctx, d_send):
        (cuts,) = ctx.saved_tensors
        idx, valid = _bucket_inverse(cuts, ctx.l_loc, ctx.bcap)
        flat = d_send.reshape(-1, d_send.shape[-1])
        return _gather_valid(flat, idx, valid), None, None


def slice_buckets(rows, cuts, bcap: int):
    """:func:`slice_rows` with a scatter-free backward: position i lies in
    bucket o = searchsorted(cuts, i, right) - 1 at offset i - cuts[o], so
    d_rows is one row gather of the flattened cotangent."""
    return _SliceBuckets.apply(rows, cuts, bcap)


class _PermuteRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, perm):
        ctx.save_for_backward(perm)
        return rows[perm]

    @staticmethod
    def backward(ctx, d_out):
        (perm,) = ctx.saved_tensors
        return d_out[_invperm(perm)], None


def permute_rows(rows, perm):
    """(M, F) rows + (M,) permutation -> rows[perm]; the backward gathers
    the cotangent by the inverse permutation (one sort)."""
    return _PermuteRows.apply(rows, perm)


class _PackGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, src, in_range, slot_of_entry):
        ctx.save_for_backward(slot_of_entry)
        return _gather_valid(rows, src, in_range)

    @staticmethod
    def backward(ctx, d_cols):
        (slot,) = ctx.saved_tensors
        d_rows = _gather_valid(d_cols, slot, slot < d_cols.shape[0])
        return d_rows, None, None, None


def pack_gather(rows, src, in_range, slot_of_entry):
    """(M, F) sorted rows -> (capacity, F) packed slots
    (``ops/binning.pack_ranges``'s src and in_range). ``slot_of_entry`` is
    the closed-form inverse (``pack_slot_inverse``; entries outside every
    range carry a slot >= capacity): each in-range entry has exactly one
    slot, so the backward is one row gather."""
    return _PackGather.apply(rows, src, in_range, slot_of_entry)


def all_to_all(x, group, bf16_from: int | None = None):
    """(ndev, B, ...) -> (ndev, B, ...) over ``group``: block d goes to the
    group's rank d, block s of the result came from rank s. With
    ``bf16_from`` the last-axis columns from that index on travel as
    ``torch.bfloat16`` (rounded to nearest even) and come back float32."""
    x = x.contiguous()
    if bf16_from is None or bf16_from >= x.shape[-1]:
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out
    parts = [x[..., bf16_from:].to(torch.bfloat16).contiguous()]
    if bf16_from > 0:
        parts.insert(0, x[..., :bf16_from].contiguous())
    outs = []
    for p in parts:
        out = torch.empty_like(p)
        dist.all_to_all_single(out, p, group=group)
        outs.append(out.to(x.dtype))
    return torch.cat(outs, dim=-1)


class _ExchangeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, send, group, payload_dtype, grad_dtype):
        ctx.group, ctx.grad_dtype = group, grad_dtype
        cut = BF16_PAYLOAD_FROM if payload_dtype == "bf16" else None
        return all_to_all(send, group, cut)

    @staticmethod
    def backward(ctx, d_recv):
        cut = 0 if ctx.grad_dtype == "bf16" else None
        return all_to_all(d_recv, ctx.group, cut), None, None, None


def exchange_rows(send, group, payload_dtype: str = "f32",
                  grad_dtype: str = "f32"):
    """The differentiable payload all-to-all: (ndev, B, 9) float32 buckets
    over ``group``; the backward is the reverse all-to-all. bf16 as in the
    module docstring; the rounding passes the gradient through unrounded,
    as the single-device bf16 gather does."""
    return _ExchangeRows.apply(send, group, payload_dtype, grad_dtype)
