"""Synthetic scenes for tests and benchmarks (port of ``io/synthetic.py``).

``create_cube_scene`` and ``random_scene`` make their arrays in numpy with
the same RNG calls, in the same order and precision, as the JAX package, so
``random_scene(n, seed)`` gives bit-identical float32 arrays in both
packages; only the last step, the copy to ``device``, differs.
``random_scene_device`` draws the same distributions on the device itself
(other numbers than either package's ``random_scene``). ``device`` defaults
to the card; without a GPU, pass ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.gaussians import GaussianScene, from_numpy
from ..utils.device import resolve_device
from ..utils.sh import num_sh_coeffs, sh_from_color


def create_cube_scene(origin=(-1.0, -1.0, -1.0), side=(2.0, 2.0, 2.0),
                      nx: int = 8, scale: float = 0.05, opacity: float = 0.8,
                      sh_degree: int = 3, device="cuda") -> GaussianScene:
    """Regular grid of isotropic gaussians coloured by normalised position
    (reference app/gaussians.cpp:47-73)."""
    u = np.arange(nx, dtype=np.float32) / nx
    grid = np.stack(np.meshgrid(u, u, u, indexing="ij"), axis=-1).reshape(-1, 3)
    means = np.asarray(origin, np.float32) + grid * np.asarray(side, np.float32)
    n = means.shape[0]
    sh = np.zeros((n, num_sh_coeffs(sh_degree), 3), np.float32)
    sh[:, 0, :] = sh_from_color(grid)  # position-coded RGB
    quats = np.zeros((n, 4), np.float32)
    quats[:, 3] = 1.0
    return from_numpy(
        means,
        np.full((n, 3), scale, np.float32),
        quats,
        np.full((n,), opacity, np.float32),
        sh,
        device,
    )


def random_scene(n: int, seed: int = 0, extent: float = 3.0,
                 scale_range=(0.01, 0.15), sh_degree: int = 3,
                 sh_rest_std: float = 0.05, device="cuda") -> GaussianScene:
    """Reproducible random scene with anisotropic, rotated gaussians."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    log_lo, log_hi = np.log(scale_range[0]), np.log(scale_range[1])
    scales = np.exp(rng.uniform(log_lo, log_hi, (n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    opacities = rng.uniform(0.2, 0.95, (n,)).astype(np.float32)
    k = num_sh_coeffs(sh_degree)
    sh = np.zeros((n, k, 3), np.float32)
    base = rng.uniform(0.05, 0.95, (n, 3))
    sh[:, 0, :] = sh_from_color(base)
    if k > 1:
        sh[:, 1:, :] = rng.normal(0.0, sh_rest_std, (n, k - 1, 3))
    return from_numpy(means, scales, quats, opacities, sh, device)


def random_scene_device(n: int, seed: int = 0, extent: float = 3.0,
                        scale_range=(0.01, 0.15), sh_degree: int = 3,
                        sh_rest_std: float = 0.05,
                        device="cuda") -> GaussianScene:
    """``random_scene``'s distributions drawn on ``device`` from a seeded
    ``torch.Generator`` there, with no host round trip (the JAX package's
    ``random_scene_device``; other numbers than ``random_scene``'s, and
    than JAX's, by design). A benchmark-scale scene is made where it is
    consumed."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=gen, device=dev)
        return u * (hi - lo) + lo

    def normal(shape):
        return torch.randn(shape, generator=gen, device=dev)

    log_lo = float(np.log(scale_range[0]))
    log_hi = float(np.log(scale_range[1]))
    k = num_sh_coeffs(sh_degree)
    means = uniform((n, 3), -extent, extent)
    scales = torch.exp(uniform((n, 3), log_lo, log_hi))
    quats = normal((n, 4))
    quats = quats / torch.linalg.norm(quats, dim=1, keepdim=True)
    opacities = uniform((n,), 0.2, 0.95)
    base = uniform((n, 3), 0.05, 0.95)
    sh = sh_from_color(base)[:, None, :]
    if k > 1:
        sh = torch.cat([sh, normal((n, k - 1, 3)) * sh_rest_std], dim=1)
    return GaussianScene(means=means, scales=scales, quats=quats,
                         opacities=opacities, sh=sh)
