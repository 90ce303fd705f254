"""Gaussian scene containers (port of ``models/gaussians.py``).

``GaussianParams`` holds the raw (pre-activation) parameters,
``GaussianScene`` the activated tensors the renderer takes. Quaternions are
(x, y, z, w) in memory; PLY files store (w, x, y, z).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.packing import stack_cols, unstack_cols


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
        qx, qy, qz, qw = unstack_cols(self.quats)
        inv = torch.rsqrt(qx * qx + qy * qy + qz * qz + qw * qw)
        quats = stack_cols(qx * inv, qy * inv, qz * inv, qw * inv)
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

    def to_params(self, eps: float = 1e-12) -> GaussianParams:
        """Invert the activations (to fine-tune a loaded scene); opacities
        are clipped to [1e-6, 1 - 1e-6] before the logit."""
        op = torch.clamp(self.opacities, 1e-6, 1 - 1e-6)
        return GaussianParams(
            means=self.means,
            log_scales=torch.log(torch.clamp(self.scales, min=eps)),
            quats=self.quats,
            opacity_logits=torch.log(op) - torch.log1p(-op),
            sh_dc=self.sh[:, :1, :],
            sh_rest=self.sh[:, 1:, :],
        )

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


def pad_params_to(params: GaussianParams, capacity: int) -> GaussianParams:
    """Pad raw parameters to a fixed capacity: padding rows are parked
    transparent (logit -15), tiny (log-scale -18) and unrotated."""
    cur = params.num_gaussians
    if capacity < cur:
        raise ValueError(f"capacity {capacity} < current {cur}")
    if capacity == cur:
        return params
    extra = capacity - cur

    def pad(x, fill=0.0):
        return torch.cat(
            [x, x.new_full((extra,) + tuple(x.shape[1:]), fill)], dim=0
        )

    quat_pad = params.quats.new_zeros((extra, 4))
    quat_pad[:, 3] = 1.0
    return GaussianParams(
        means=pad(params.means),
        log_scales=pad(params.log_scales, -18.0),
        quats=torch.cat([params.quats, quat_pad], dim=0),
        opacity_logits=pad(params.opacity_logits, -15.0),
        sh_dc=pad(params.sh_dc),
        sh_rest=pad(params.sh_rest),
    )


def _tensor(x, device):
    # a float32 copy: arrays handed over from jax are read-only
    return torch.from_numpy(np.array(x, np.float32)).to(resolve_device(device))


def params_from_numpy(means, log_scales, quats_xyzw, opacity_logits, sh_dc,
                      sh_rest, device) -> GaussianParams:
    """Raw parameters as numpy arrays (the JAX package's ``GaussianParams``
    fields, in order) -> float32 ``GaussianParams`` on ``device``."""
    return GaussianParams(
        means=_tensor(means, device),
        log_scales=_tensor(log_scales, device),
        quats=_tensor(quats_xyzw, device),
        opacity_logits=_tensor(np.asarray(opacity_logits).reshape(-1), device),
        sh_dc=_tensor(sh_dc, device),
        sh_rest=_tensor(sh_rest, device),
    )


def from_numpy(means, scales, quats_xyzw, opacities, sh,
               device) -> GaussianScene:
    """Activated parameters as numpy arrays (the JAX package's layout:
    quaternions x, y, z, w) -> a float32 ``GaussianScene`` on ``device``."""
    return GaussianScene(
        means=_tensor(means, device),
        scales=_tensor(scales, device),
        quats=_tensor(quats_xyzw, device),
        opacities=_tensor(np.asarray(opacities).reshape(-1), device),
        sh=_tensor(sh, device),
    )
