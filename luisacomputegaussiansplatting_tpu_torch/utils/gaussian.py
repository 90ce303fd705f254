"""3D covariance construction and EWA screen-space projection (port of
``utils/gaussian.py``).

Math parity: Sigma = R S S^T R^T (lcgs/include/lcgs/util/gaussian.hpp:15-28);
EWA first-order projection with the focal-scaled Jacobian
(gaussian.hpp:52-70); frustum clamp of the linearisation point
(gs_projector/shader.cpp:146-158). ``ewa_mode="inria"`` is the standard
J (V Sigma V^T) J^T; ``"lcgs"`` the reference's J (V^T Sigma V) J^T.

The ``*_elems``/``*_comps`` forms work on (N,) component tensors in the same
operation order as the JAX package, so both round alike; the stacked forms
take (N, 3, 3) / (N, 3) tensors.
"""

from __future__ import annotations

import torch

from .transform import rotation_from_quaternion


def rotation_elems(qx, qy, qz, qw):
    """3x3 rotation elements from (x, y, z, w) quaternion components
    (reference transform.hpp:188-212, unfolded row-major)."""
    return [
        [
            1 - 2 * (qy * qy + qz * qz),
            2 * (qx * qy - qz * qw),
            2 * (qx * qz + qy * qw),
        ],
        [
            2 * (qx * qy + qz * qw),
            1 - 2 * (qx * qx + qz * qz),
            2 * (qy * qz - qx * qw),
        ],
        [
            2 * (qx * qz - qy * qw),
            2 * (qy * qz + qx * qw),
            1 - 2 * (qx * qx + qy * qy),
        ],
    ]


def covariance_3d_elems(s, q):
    """Sigma = R S S^T R^T as a symmetric 3x3 list of (N,) tensors, from
    3 scale and 4 quaternion (x, y, z, w) components."""
    r = rotation_elems(*q)
    m = [[r[i][j] * s[j] for j in range(3)] for i in range(3)]
    cov = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for k in range(i, 3):
            cov[i][k] = cov[k][i] = sum(m[i][j] * m[k][j] for j in range(3))
    return cov


def view_rotate_cov_elems(cov, view3, ewa_mode="inria"):
    """V Sigma V^T ("inria") or V^T Sigma V ("lcgs") for a symmetric 3x3
    list of (N,) tensors and a (3, 3) view rotation."""
    if ewa_mode == "inria":
        v = [[view3[i, j] for j in range(3)] for i in range(3)]
    elif ewa_mode == "lcgs":
        v = [[view3[j, i] for j in range(3)] for i in range(3)]
    else:
        raise ValueError(f"unknown ewa_mode: {ewa_mode!r}")
    tmp = [
        [sum(v[i][j] * cov[j][k] for j in range(3)) for k in range(3)]
        for i in range(3)
    ]
    out = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for l in range(i, 3):
            out[i][l] = out[l][i] = sum(tmp[i][k] * v[l][k] for k in range(3))
    return out


def clamp_to_frustum_comps(px, py, pz, tan_fovx, tan_fovy, clamp_factor=1.3):
    """Clamp the EWA linearisation point into the expanded frustum."""
    lim_x = clamp_factor * tan_fovx
    lim_y = clamp_factor * tan_fovy
    tx = torch.clamp(px / pz, -lim_x, lim_x) * pz
    ty = torch.clamp(py / pz, -lim_y, lim_y) * pz
    return tx, ty, pz


def ewa_project_cov_comps(sigma_view, tx, ty, tz, focal_x, focal_y):
    """J Sigma_view J^T for the sparse 2x3 pixel-space Jacobian; returns the
    packed 2D covariance (a, b, c) before the low-pass filter."""
    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    j00 = focal_x * inv_z
    j02 = -focal_x * tx * inv_z2
    j11 = focal_y * inv_z
    j12 = -focal_y * ty * inv_z2

    s00, s01, s02 = sigma_view[0][0], sigma_view[0][1], sigma_view[0][2]
    s11, s12, s22 = sigma_view[1][1], sigma_view[1][2], sigma_view[2][2]

    a = j00 * (j00 * s00 + j02 * s02) + j02 * (j00 * s02 + j02 * s22)
    b = j00 * (j11 * s01 + j12 * s02) + j02 * (j11 * s12 + j12 * s22)
    c = j11 * (j11 * s11 + j12 * s12) + j12 * (j11 * s12 + j12 * s22)
    return a, b, c


def conic_and_radius_comps(a, b, c, lowpass=0.3, radius_sigma=3.0,
                           det_eps=1e-6, tight_sigma=None):
    """Low-pass, invert to the conic, bound the radius (reference
    gs_tile_splatter/shader.cpp:139-148). ``tight_sigma`` (N,) shrinks the
    radius to the exact alpha_min reach plus a 2 px margin; a non-positive
    reach culls the splat."""
    a = a + lowpass
    c = c + lowpass
    det = a * c - b * b
    inv_det = 1.0 / (det + det_eps)
    conic = (c * inv_det, -b * inv_det, a * inv_det)
    mid = 0.5 * (a + c)
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    sq = torch.sqrt(mid + disc)
    radius = torch.ceil(radius_sigma * sq).to(torch.int32)
    if tight_sigma is not None:
        r_t = torch.ceil(tight_sigma * sq).to(torch.int32) + 2
        radius = torch.where(
            tight_sigma > 0.0, torch.minimum(radius, r_t),
            torch.zeros_like(radius),
        )
    return conic, radius


def covariance_3d(scales, quats_xyzw):
    """(N, 3, 3) world covariance R diag(s) diag(s) R^T."""
    rot = rotation_from_quaternion(quats_xyzw)
    m = rot * scales[..., None, :]
    return m @ m.transpose(-1, -2)


def clamp_to_frustum(p_view, tan_fovx, tan_fovy, clamp_factor=1.3):
    """(N, 3) view positions with x/z and y/z clamped to the frustum."""
    x, y, z = clamp_to_frustum_comps(
        p_view[..., 0], p_view[..., 1], p_view[..., 2],
        tan_fovx, tan_fovy, clamp_factor,
    )
    return torch.stack([x, y, z], dim=-1)


def ewa_project_cov(cov3d, t, view3, focal_x, focal_y, ewa_mode="inria"):
    """(N, 3, 3) world covariances -> (N, 3) packed 2D pixel covariances
    (a, b, c) before the low-pass filter."""
    if ewa_mode == "inria":
        sigma_view = view3 @ cov3d @ view3.T
    elif ewa_mode == "lcgs":
        sigma_view = view3.T @ cov3d @ view3
    else:
        raise ValueError(f"unknown ewa_mode: {ewa_mode!r}")
    rows = [[sigma_view[..., i, j] for j in range(3)] for i in range(3)]
    a, b, c = ewa_project_cov_comps(
        rows, t[..., 0], t[..., 1], t[..., 2], focal_x, focal_y
    )
    return torch.stack([a, b, c], dim=-1)


def conic_and_radius(cov2d, lowpass=0.3, radius_sigma=3.0, det_eps=1e-6):
    """(N, 3) packed 2D covariance -> ((N, 3) conic, (N,) int32 radius)."""
    conic, radius = conic_and_radius_comps(
        cov2d[..., 0], cov2d[..., 1], cov2d[..., 2],
        lowpass, radius_sigma, det_eps,
    )
    return torch.stack(conic, dim=-1), radius
