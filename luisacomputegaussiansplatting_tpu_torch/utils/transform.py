"""Coordinate and rotation math (PyTorch port of ``utils/transform.py``).

Conventions follow the reference renderer: NDC<->pixel per
lcgs/include/lcgs/util/transform.hpp:13-23, quaternions stored (x, y, z, w)
and turned into row-major matrices (R @ v rotates v).
"""

from __future__ import annotations

import torch


def ndc2pix(v, resolution):
    """NDC in [-1, 1] -> continuous pixel coordinates (pixel centres at
    integers: -1 -> -0.5, +1 -> res - 0.5). Parity: lcgs/src/module.cpp:18-20."""
    return ((v + 1.0) * resolution - 1.0) * 0.5


def pix2ndc(pix, resolution):
    """Inverse of :func:`ndc2pix` up to the half-pixel convention."""
    return 2.0 * pix / resolution - 1.0


def normalize(v, dim=-1, eps=0.0):
    n = torch.linalg.vector_norm(v, dim=dim, keepdim=True)
    return v / (n + eps)


def rotation_from_quaternion(q):
    """(..., 4) (x, y, z, w) unit quaternions -> (..., 3, 3) rotations."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def quaternion_multiply(q1, q2):
    """Hamilton product of (x, y, z, w) quaternions (transform.hpp:162-181)."""
    x1, y1, z1, w1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    x2, y2, z2, w2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )


def rotate_axis_angle(aa, p, eps=1e-12):
    """Rodrigues rotation of points ``p`` by axis-angle vectors ``aa``
    (angle = |aa|; zero vectors rotate by identity). Parity:
    transform.hpp:100-124 ``rotate_aa``."""
    angle = torch.linalg.vector_norm(aa, dim=-1, keepdim=True)
    axis = aa / torch.clamp(angle, min=eps)
    c = torch.cos(angle)
    s = torch.sin(angle)
    return (
        p * c
        + torch.linalg.cross(axis, p) * s
        + axis * torch.sum(axis * p, dim=-1, keepdim=True) * (1.0 - c)
    )


def rotation_from_axis_angle(aa, eps=1e-12):
    """(..., 3, 3) row-major rotations from axis-angle vectors
    (transform.hpp:126-160 ``R_from_aa``)."""
    angle = torch.linalg.vector_norm(aa, dim=-1)
    axis = aa / torch.clamp(angle[..., None], min=eps)
    c = torch.cos(angle)
    s = torch.sin(angle)
    c1 = 1.0 - c
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    rows = [
        [c1 * x * x + c, c1 * x * y - z * s, c1 * x * z + y * s],
        [c1 * x * y + z * s, c1 * y * y + c, c1 * y * z - x * s],
        [c1 * x * z - y * s, c1 * y * z + x * s, c1 * z * z + c],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def quaternion_from_axis_angle(axis, angle):
    """(x, y, z, w) quaternion from a unit axis and an angle in radians
    (transform.hpp:85-97)."""
    s = torch.sin(angle * 0.5)[..., None]
    return torch.cat([axis * s, torch.cos(angle * 0.5)[..., None]], dim=-1)
