"""Real spherical harmonics for view-dependent colour (port of ``utils/sh.py``).

Constants and band polynomials follow the canonical 3DGS formulation
(reference lcgs/include/lcgs/util/sh.hpp:12-138); the colour is
``clamp(sum_bands + 0.5, 0, 1)`` (lcgs/src/sh_preprocessor.cpp:150-153).
Plain differentiable torch: autograd gives the direction gradients too.
Columns cross in and out through ``utils/packing.py``, as in the JAX
package.
"""

from __future__ import annotations

import numpy as np
import torch

from .packing import stack_cols, unstack_cols

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


def num_sh_coeffs(degree: int) -> int:
    return (degree + 1) * (degree + 1)


def sh_basis_comps(x, y, z, degree: int):
    """SH basis values Y_lm(dir), l <= degree, as a list of (N,) tensors in
    the 3DGS coefficient order."""
    if not 0 <= degree <= 3:
        raise ValueError(f"SH degree must be in [0, 3], got {degree}")
    basis = [SH_C0 * torch.ones_like(x)]
    if degree >= 1:
        basis += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, zx = x * y, y * z, z * x
        basis += [
            SH_C2[0] * xy,
            SH_C2[1] * yz,
            SH_C2[2] * (2.0 * zz - xx - yy),
            SH_C2[3] * zx,
            SH_C2[4] * (xx - yy),
        ]
    if degree >= 3:
        basis += [
            SH_C3[0] * y * (3.0 * xx - yy),
            SH_C3[1] * xy * z,
            SH_C3[2] * y * (4.0 * zz - xx - yy),
            SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            SH_C3[4] * x * (4.0 * zz - xx - yy),
            SH_C3[5] * z * (xx - yy),
            SH_C3[6] * x * (xx - 3.0 * yy),
        ]
    return basis


def sh_basis(dirs, degree: int):
    """(..., 3) unit directions -> (..., (degree+1)^2) basis values."""
    return torch.stack(
        sh_basis_comps(dirs[..., 0], dirs[..., 1], dirs[..., 2], degree),
        dim=-1,
    )


def eval_sh_color(sh_coeffs, dirs, degree: int):
    """clamp(sum_k Y_k(dir) * sh_k + 0.5, 0, 1).

    Args:
      sh_coeffs: (N, K, 3), K >= (degree+1)^2.
      dirs: (N, 3) unit directions (gaussian - camera, normalised).

    Returns (N, 3) RGB in [0, 1].
    """
    n, k_tot = sh_coeffs.shape[0], sh_coeffs.shape[1]
    k = num_sh_coeffs(degree)
    x, y, z = unstack_cols(dirs)
    basis = sh_basis_comps(x, y, z, degree)
    sh_flat = unstack_cols(sh_coeffs.reshape(n, k_tot * 3))  # 3K x (N,)
    chans = []
    for c in range(3):
        # same left-to-right accumulation as the JAX package
        acc = 0.5
        for i in range(k):
            acc = acc + basis[i] * sh_flat[i * 3 + c]
        chans.append(torch.clamp(acc, 0.0, 1.0))
    return stack_cols(*chans)


def sh_from_color(color):
    """DC-only inverse: the band-0 coefficient reproducing a constant colour
    (reference sh.hpp:167-173). A numpy input is computed in float32 numpy,
    exactly as the JAX package computes it in float32."""
    if isinstance(color, torch.Tensor):
        return (color - 0.5) / SH_C0
    c = np.asarray(color, np.float32)
    return (c - np.float32(0.5)) / np.float32(SH_C0)
