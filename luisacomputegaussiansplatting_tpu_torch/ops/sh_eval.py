"""Per-gaussian view-dependent colour from SH coefficients (port of
``ops/sh_eval.py``; reference SHProcessor, lcgs/src/sh_preprocessor.cpp:159-166)."""

from __future__ import annotations

import torch

from ..utils.packing import stack_cols, unstack_cols
from ..utils.sh import eval_sh_color


def compute_colors(means, sh_coeffs, cam_pos, degree: int = 3):
    """(N, 3) RGB in [0, 1] for direction normalize(mean - cam_pos)
    (sh_preprocessor.cpp:162-163)."""
    cam_pos = torch.as_tensor(cam_pos, dtype=means.dtype, device=means.device)
    mx, my, mz = unstack_cols(means)
    dx, dy, dz = mx - cam_pos[0], my - cam_pos[1], mz - cam_pos[2]
    inv = 1.0 / torch.clamp(torch.sqrt(dx * dx + dy * dy + dz * dz), min=1e-12)
    dirs = stack_cols(dx * inv, dy * inv, dz * inv)
    return eval_sh_color(sh_coeffs, dirs, degree)
