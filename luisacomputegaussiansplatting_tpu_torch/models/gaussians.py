"""Gaussian scene containers (port of ``models/gaussians.py``).

``GaussianParams`` holds the raw (pre-activation) parameters,
``GaussianScene`` the activated tensors the renderer takes. Quaternions are
(x, y, z, w) in memory; PLY files store (w, x, y, z).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class GaussianParams(NamedTuple):
    """Raw parameters (the trainable set)."""

    means: torch.Tensor  # (N, 3)
    log_scales: torch.Tensor  # (N, 3)
    quats: torch.Tensor  # (N, 4) (x, y, z, w), not necessarily unit
    opacity_logits: torch.Tensor  # (N,)
    sh_dc: torch.Tensor  # (N, 1, 3)
    sh_rest: torch.Tensor  # (N, K-1, 3)

    @property
    def num_gaussians(self) -> int:
        return self.means.shape[0]

    def activate(self) -> "GaussianScene":
        """exp(scales), sigmoid(opacity), normalised quaternions
        (reference app/gaussians.cpp:137-168)."""
        q = self.quats
        qx, qy, qz, qw = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
        inv = torch.rsqrt(qx * qx + qy * qy + qz * qz + qw * qw)
        quats = torch.stack([qx * inv, qy * inv, qz * inv, qw * inv], dim=1)
        return GaussianScene(
            means=self.means,
            scales=torch.exp(self.log_scales),
            quats=quats,
            opacities=torch.sigmoid(self.opacity_logits),
            sh=torch.cat([self.sh_dc, self.sh_rest], dim=1),
        )


class GaussianScene(NamedTuple):
    """Activated gaussians, consumed directly by ``ops.render``."""

    means: torch.Tensor  # (N, 3)
    scales: torch.Tensor  # (N, 3) positive
    quats: torch.Tensor  # (N, 4) unit (x, y, z, w)
    opacities: torch.Tensor  # (N,) in (0, 1)
    sh: torch.Tensor  # (N, K, 3)

    @property
    def num_gaussians(self) -> int:
        return self.means.shape[0]

    @property
    def sh_degree(self) -> int:
        return int(round(self.sh.shape[1] ** 0.5)) - 1

    def render_args(self):
        """Positional arguments for ``ops.render.render``."""
        return (self.means, self.scales, self.quats, self.opacities, self.sh)

    def pad_to(self, n: int) -> "GaussianScene":
        """Pad to n gaussians with invisible ones (opacity 0, identity
        rotation, tiny scale)."""
        cur = self.num_gaussians
        if n < cur:
            raise ValueError(f"pad_to({n}) smaller than current {cur}")
        if n == cur:
            return self
        extra = n - cur

        def pad(x, fill=0.0):
            return torch.cat(
                [x, x.new_full((extra,) + tuple(x.shape[1:]), fill)], dim=0
            )

        quat_pad = self.quats.new_zeros((extra, 4))
        quat_pad[:, 3] = 1.0
        return GaussianScene(
            means=pad(self.means),
            scales=pad(self.scales, 1e-8),
            quats=torch.cat([self.quats, quat_pad], dim=0),
            opacities=pad(self.opacities),
            sh=pad(self.sh),
        )


def from_numpy(means, scales, quats_xyzw, opacities, sh,
               device) -> GaussianScene:
    """Activated parameters as numpy arrays (the JAX package's layout:
    quaternions x, y, z, w) -> a float32 ``GaussianScene`` on ``device``."""

    def t(x):
        # a copy: arrays handed over from jax are read-only
        return torch.from_numpy(np.array(x, np.float32)).to(device)

    return GaussianScene(
        means=t(means),
        scales=t(scales),
        quats=t(quats_xyzw),
        opacities=t(np.asarray(opacities).reshape(-1)),
        sh=t(sh),
    )
