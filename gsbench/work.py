"""The yardstick of the per-layer shares: the card's published peaks, the
roofline bound, and the FP32 operations and bytes that the algorithm needs,
counted from shapes and from the plain reference's own counts (never from a
kernel), so that a rewritten kernel is judged against the same work.

Operations are counted as written in the plain reference
(``gsbench/reference``): one for every element an arithmetic op, a
comparison or an exp / log / sqrt produces; a reduction one per element it
reads; a convolution two per tap and output element. ``count_ops`` does the counting;
``tests/test_gsbench_work.py`` holds the constants below to it.
"""

from __future__ import annotations

#: one H100 SXM (NVIDIA data sheet): HBM bytes/s and FP32 (non-tensor) FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

#: operations of an evaluated (entry, pixel) pair, forward or backward: the
#: power and its test, then alpha, its clamp and the alpha_min test
#: (vpu: dx, dy, the conic quadratic 9, test 1, exp of the clamp 2, times
#: opacity 1, clamp 1, test 1; mxu: the pixel polynomial 10 with per-pixel
#: squares and per-entry coefficients, test 1, exp 1, clamp 1, test 1)
OPS_PER_EVALUATED = {"vpu": 17, "mxu": 14}
#: operations of an applied pair: forward -- log1p(-alpha) 2, the running
#: sum 1, T after 2, T before 2, the applied test 2, the weight 1, three
#: colour multiply-adds 6; backward -- the forward's 16, then
#: b = <colour, dL/dC> 5, the suffix 3, d_alpha 5, its gate 2, d_power 1,
#: d_opacity 2, two mean gradients 10, three conic gradients 12, three
#: colour gradients 6
OPS_PER_APPLIED = {"forward": 16, "backward": 62}
#: operations of one slot of the exact ellipse-tile cull
OPS_PER_CULLED_SLOT = 40
#: per gaussian, activation + SH (degree 3) + projection, counted by
#: ``count_ops`` on the reference; backward is autograd's
OPS_PER_GAUSSIAN = {"forward": 481, "backward": 699}
#: per pixel of the photometric loss (3 channels), forward and backward
OPS_PER_LOSS_PIXEL = {"forward": 732, "backward": 774}
#: per parameter element of one Adam update
OPS_PER_ADAM_ELEMENT = 11
#: the segment-sum adds one 9-wide row per kept entry
OPS_PER_REDUCED_ENTRY = 9
FIELDS = 9


def bound_s(nbytes: float, ops: float) -> float:
    """The least time the card could take: the larger of bytes over the
    memory rate and FP32 operations over the FP32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def k1_work(n: int, max_pairs: int, aabb: int, cull: bool):
    """(bytes, ops) of the expansion: per gaussian its inclusive end (8),
    rectangle (16) and depth (4), with the cull its centre, conic and
    opacity (24); per slot tile, depth and gid written (12); the cull's
    operations over the rectangles' slots."""
    nbytes = n * (28 + (24 if cull else 0)) + max_pairs * 12
    return nbytes, (aabb * OPS_PER_CULLED_SLOT if cull else 0)


def k2_work(entries: int, num_tiles: int, pix: int, evaluated: int,
            applied: int, quad: str):
    """(bytes, ops) of the forward blend: the kept entries' payload (36),
    each tile's start and count (8), each pixel's colour and T (16)."""
    nbytes = entries * FIELDS * 4 + num_tiles * 8 + num_tiles * pix * 16
    ops = (evaluated * OPS_PER_EVALUATED[quad]
           + applied * OPS_PER_APPLIED["forward"])
    return nbytes, ops


def k3_work(entries: int, num_tiles: int, pix: int, evaluated: int,
            applied: int, quad: str):
    """(bytes, ops) of the backward blend: the payload read and its
    gradient written (72 an entry), the residual (32 a pixel), the
    ranges (8 a tile)."""
    nbytes = entries * FIELDS * 4 * 2 + num_tiles * pix * 32 + num_tiles * 8
    ops = (evaluated * OPS_PER_EVALUATED[quad]
           + applied * OPS_PER_APPLIED["backward"])
    return nbytes, ops


def k4_work(entries: int, n: int):
    """(bytes, ops) of the gradient reduction: each kept entry's row and id
    read (40), each gaussian's sums written (36)."""
    return entries * (FIELDS * 4 + 4) + n * FIELDS * 4, \
        entries * OPS_PER_REDUCED_ENTRY


def frame_ops(n: int, evaluated: int, applied: int, aabb: int, quad: str,
              cull: bool) -> float:
    """FP32 operations of a forward frame: per gaussian, the cull, the
    blend's pairs."""
    return (n * OPS_PER_GAUSSIAN["forward"]
            + (aabb * OPS_PER_CULLED_SLOT if cull else 0)
            + evaluated * OPS_PER_EVALUATED[quad]
            + applied * OPS_PER_APPLIED["forward"])


def step_ops(n: int, params: int, pixels: int, evaluated: int, applied: int,
             aabb: int, entries: int, quad: str, cull: bool) -> float:
    """FP32 operations of a training step: the forward frame, the loss
    forward and backward, the blend's backward, the reduction, the
    per-gaussian backward and Adam over every parameter element."""
    return (frame_ops(n, evaluated, applied, aabb, quad, cull)
            + pixels * (OPS_PER_LOSS_PIXEL["forward"]
                        + OPS_PER_LOSS_PIXEL["backward"])
            + evaluated * OPS_PER_EVALUATED[quad]
            + applied * OPS_PER_APPLIED["backward"]
            + entries * OPS_PER_REDUCED_ENTRY
            + n * OPS_PER_GAUSSIAN["backward"]
            + params * OPS_PER_ADAM_ELEMENT)


#: aten ops counted, one operation per output element
_ELEMENTWISE = {
    "add", "sub", "mul", "div", "neg", "exp", "log", "log1p", "sqrt",
    "rsqrt", "sigmoid", "clamp", "clamp_min", "clamp_max", "abs", "pow",
    "maximum", "minimum", "floor", "ceil", "ge", "le", "gt", "lt", "eq",
    "ne", "reciprocal", "sgn", "sign", "sigmoid_backward", "threshold",
    "where", "addcmul", "addcdiv", "rsub", "bitwise_and", "logical_and",
    "rsqrt_backward", "exp2", "square",
}
#: aten ops counted one operation per input element
_REDUCTIONS = {"sum", "mean", "cumsum", "amin", "amax"}


def count_ops(fn, *args):
    """(result, operations) of ``fn(*args)``, counted at the dispatcher:
    elementwise ops one per output element, reductions one per input
    element, a convolution two per multiply-add. Copies, views, gathers,
    stacks and casts count nothing."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Counter(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.__name__.split(".")[0].rstrip("_")
            if name in _ELEMENTWISE:
                t = out[0] if isinstance(out, (tuple, list)) else out
                Counter.ops += t.numel()
            elif name in _REDUCTIONS:
                Counter.ops += args[0].numel()
            elif name == "convolution":
                w = args[1]
                Counter.ops += 2 * (w.numel() // w.shape[0]) * out.numel()
            elif name == "convolution_backward":
                # the input's gradient: a convolution of the output's
                w, d_in = args[2], out[0]
                if d_in is not None:
                    Counter.ops += 2 * (w.numel() // w.shape[0]) * d_in.numel()
            return out

    with Counter():
        res = fn(*args)
    return res, Counter.ops
