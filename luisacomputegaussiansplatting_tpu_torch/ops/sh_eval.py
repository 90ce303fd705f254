"""Per-gaussian view-dependent colour from SH coefficients (port of
``ops/sh_eval.py``; reference SHProcessor, lcgs/src/sh_preprocessor.cpp:159-166).

On CUDA tensors the colours and their gradients are the hand-written kernel
pair ``csrc/sh.cu`` (K5): one launch forward, one backward, the forward
equal to the plain version bit for bit. It replaces no TPU kernel (the JAX
package's version is plain ``jnp`` code that XLA fuses); torch's eager ops
cannot fuse this layer, and the plain version costs 166 launches forward
and 272 backward. CPU tensors take the plain version,
:func:`compute_colors_reference` (``utils/sh.py``), which the JAX-parity
tests hold; the card holds the kernels to it.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import KernelLib, require_cuda_tensors
from ..utils.packing import stack_cols, unstack_cols
from ..utils.sh import eval_sh_color, num_sh_coeffs

_p, _i, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64

#: launches are counted per direction (``KERNEL.variant_launches``)
KERNEL = KernelLib("sh", {
    "sh_forward_launch": (ctypes.c_int, [_p, _p, _p, _i64, _i, _i, _p, _p]),
    "sh_backward_launch": (
        ctypes.c_int, [_p, _p, _p, _i64, _i, _i, _p, _i64, _i64, _p, _p, _p],
    ),
}, variants=("forward", "backward"))


def compute_colors_reference(means, sh_coeffs, cam_pos, degree: int = 3):
    """The plain version: (N, 3) RGB in [0, 1] for direction
    normalize(mean - cam_pos) (sh_preprocessor.cpp:162-163)."""
    cam_pos = torch.as_tensor(cam_pos, dtype=means.dtype, device=means.device)
    mx, my, mz = unstack_cols(means)
    dx, dy, dz = mx - cam_pos[0], my - cam_pos[1], mz - cam_pos[2]
    inv = 1.0 / torch.clamp(torch.sqrt(dx * dx + dy * dy + dz * dz), min=1e-12)
    dirs = stack_cols(dx * inv, dy * inv, dz * inv)
    return eval_sh_color(sh_coeffs, dirs, degree)


def _check(fn: str, means, sh_coeffs, cam_pos, degree: int) -> None:
    """What the kernels take; raises before anything is built."""
    for t in (means, sh_coeffs, cam_pos):
        if t.dtype != torch.float32:
            raise ValueError(f"{fn}: expected float32 tensors, got {t.dtype}")
    if not 0 <= degree <= 3:
        raise ValueError(f"{fn}: SH degree must be in [0, 3], got {degree}")
    n = means.shape[0]
    if (means.shape != (n, 3) or sh_coeffs.dim() != 3
            or sh_coeffs.shape[0] != n or sh_coeffs.shape[2] != 3
            or cam_pos.shape != (3,)):
        raise ValueError(f"{fn}: expected means (N, 3), sh (N, K, 3) and "
                         f"cam_pos (3,), got {tuple(means.shape)}, "
                         f"{tuple(sh_coeffs.shape)}, {tuple(cam_pos.shape)}")
    if sh_coeffs.shape[1] < num_sh_coeffs(degree):
        raise ValueError(f"{fn}: degree {degree} needs "
                         f"{num_sh_coeffs(degree)} coefficients, got "
                         f"{sh_coeffs.shape[1]}")
    require_cuda_tensors(fn, means, sh_coeffs, cam_pos)


def sh_forward_kernel(means, sh_coeffs, cam_pos, degree: int = 3):
    """Launch K5's forward on contiguous float32 CUDA tensors: means (N, 3),
    sh_coeffs (N, K, 3) with K >= (degree + 1)^2 and cam_pos (3,), read on
    the device. Returns (N, 3) RGB."""
    _check("sh_forward_kernel", means, sh_coeffs, cam_pos, degree)
    n = means.shape[0]
    rgb = torch.empty((n, 3), dtype=torch.float32, device=means.device)
    if n == 0:
        return rgb
    lib = KERNEL.lib()
    with torch.cuda.device(means.device):
        err = lib.sh_forward_launch(
            means.data_ptr(), sh_coeffs.data_ptr(), cam_pos.data_ptr(), n,
            sh_coeffs.shape[1], degree, rgb.data_ptr(),
            torch.cuda.current_stream(means.device).cuda_stream)
    KERNEL.check(err, "sh_forward_launch")
    KERNEL.launched("forward")
    return rgb


def sh_backward_kernel(means, sh_coeffs, cam_pos, degree: int, d_rgb):
    """Launch K5's backward: (d_means (N, 3), d_sh (N, K, 3)) from the
    forward's inputs and the (N, 3) float32 ``d_rgb`` of any strides.
    Coefficients past the degree get exact zeros."""
    _check("sh_backward_kernel", means, sh_coeffs, cam_pos, degree)
    n = means.shape[0]
    if (d_rgb.shape != (n, 3) or d_rgb.dtype != torch.float32
            or d_rgb.device != means.device):
        raise ValueError(f"sh_backward_kernel: d_rgb must be ({n}, 3) "
                         f"float32 on {means.device}")
    d_means = torch.empty_like(means)
    d_sh = torch.empty_like(sh_coeffs)
    if n == 0:
        return d_means, d_sh
    lib = KERNEL.lib()
    with torch.cuda.device(means.device):
        err = lib.sh_backward_launch(
            means.data_ptr(), sh_coeffs.data_ptr(), cam_pos.data_ptr(), n,
            sh_coeffs.shape[1], degree, d_rgb.data_ptr(), d_rgb.stride(0),
            d_rgb.stride(1), d_sh.data_ptr(), d_means.data_ptr(),
            torch.cuda.current_stream(means.device).cuda_stream)
    KERNEL.check(err, "sh_backward_launch")
    KERNEL.launched("backward")
    return d_means, d_sh


class _ShColors(torch.autograd.Function):
    """K5 forward and backward; saves nothing but its inputs."""

    @staticmethod
    def forward(ctx, means, sh_coeffs, cam_pos, degree):
        ctx.degree = degree
        ctx.save_for_backward(means, sh_coeffs, cam_pos)
        return sh_forward_kernel(means, sh_coeffs, cam_pos, degree)

    @staticmethod
    def backward(ctx, d_rgb):
        means, sh_coeffs, cam_pos = ctx.saved_tensors
        d_means, d_sh = sh_backward_kernel(means, sh_coeffs, cam_pos,
                                           ctx.degree, d_rgb)
        # a camera-pose gradient: dir depends on mean - cam_pos
        d_cam = -d_means.sum(0) if ctx.needs_input_grad[2] else None
        return d_means, d_sh, d_cam, None


def compute_colors(means, sh_coeffs, cam_pos, degree: int = 3):
    """(N, 3) RGB in [0, 1] for direction normalize(mean - cam_pos)
    (sh_preprocessor.cpp:162-163): K5 on CUDA tensors, the plain version
    on CPU tensors."""
    if means.device.type == "cpu":
        return compute_colors_reference(means, sh_coeffs, cam_pos, degree)
    cam_pos = torch.as_tensor(cam_pos, dtype=means.dtype, device=means.device)
    return _ShColors.apply(means.contiguous(), sh_coeffs.contiguous(),
                           cam_pos.contiguous(), degree)
