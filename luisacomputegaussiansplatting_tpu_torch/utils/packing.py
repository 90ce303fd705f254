"""Column pack/unpack whose backward is one stack (port of
``utils/packing.py``).

The per-gaussian math of this package works on (N,) columns and crosses
into packed (N, K) tensors only through this module, as in the JAX package.
There the reason is the TPU layout: XLA pads an f32[N, 1] cotangent 128x.
On the GPU the reason is torch's own VJP of a column select: ``a[:, i]``
backward (``aten::select_backward``) allocates a zero-filled tensor the
size of the whole of ``a`` for every column, writes one strided column
into it, and the autograd engine adds each of those into the accumulated
gradient. For the (N, 16, 3) SH coefficients that is 48 full-size fills
and adds a view.

The forward ops are identical to ``a.unbind(1)`` and
``torch.stack(cols, 1)``. The backward of :func:`unstack_cols` is one
``torch.stack`` of the column cotangents into a (K, N) buffer, handed on
as its (N, K) transpose, as the JAX package's ``stack_cols`` backward
transposes: a stack along dim 1 writes each column at a stride of K,
which for the 48 SH columns costs several times the contiguous stack. A
column that got no gradient stacks a zero-stride zero, never a buffer of
its own. The backward of :func:`stack_cols` is one split into views.
"""

from __future__ import annotations

import torch


class _StackCols(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *cols):
        return torch.stack(cols, dim=1)

    @staticmethod
    def backward(ctx, d):
        return d.unbind(1)


class _UnstackCols(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a):
        ctx.set_materialize_grads(False)
        ctx.n = a.shape[0]
        return a.unbind(1)

    @staticmethod
    def backward(ctx, *d_cols):
        given = [d for d in d_cols if d is not None]
        if not given:
            return None
        zero = given[0].new_zeros(()).expand(ctx.n)
        return torch.stack([zero if d is None else d for d in d_cols]).t()


def stack_cols(*cols):
    """K x (N,) -> (N, K); the backward hands out views of the cotangent."""
    return _StackCols.apply(*cols)


def unstack_cols(a):
    """(N, K) -> tuple of K (N,) columns; the backward is one stack, with
    no full-size cotangent per column."""
    return _UnstackCols.apply(a)
