"""Camera model and view/projection matrices (port of ``utils/camera.py``).

Parity (reference lcgs/include/lcgs/util/camera.h): fields and defaults
:15-25 (``fov`` is the vertical field of view in degrees), world->view
matrix :38-51 (rows right/up/front, view-space +z looks forward),
projection :54-72, look-at :74-82.

``Camera`` is a frozen dataclass of Python numbers; ``CameraView`` holds the
same camera as float32 tensors on a device, which the render functions read.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .device import resolve_device

Vec3 = Tuple[float, float, float]


class CameraView(NamedTuple):
    """A camera as tensors: image width and height stay with the caller."""

    view: torch.Tensor  # (4, 4) world->view
    position: torch.Tensor  # (3,)
    tan_fovx: torch.Tensor  # ()
    tan_fovy: torch.Tensor  # ()


@dataclasses.dataclass(frozen=True)
class Camera:
    position: Vec3
    front: Vec3
    up: Vec3
    right: Vec3
    fov: float = 60.0  # vertical FoV, degrees
    width: int = 512
    height: int = 512

    @property
    def aspect(self) -> float:
        return self.width / self.height

    @property
    def tan_fovy(self) -> float:
        return math.tan(math.radians(self.fov) * 0.5)

    @property
    def tan_fovx(self) -> float:
        return self.tan_fovy * self.aspect

    @property
    def focal_x(self) -> float:
        return self.width / (2.0 * self.tan_fovx)

    @property
    def focal_y(self) -> float:
        return self.height / (2.0 * self.tan_fovy)

    def resized(self, width: int, height: int) -> "Camera":
        return dataclasses.replace(self, width=width, height=height)

    def to_view(self, device) -> CameraView:
        f32 = dict(dtype=torch.float32, device=device)
        return CameraView(
            view=view_matrix(self, device),
            position=torch.tensor(self.position, **f32),
            tan_fovx=torch.tensor(self.tan_fovx, **f32),
            tan_fovy=torch.tensor(self.tan_fovy, **f32),
        )


def look_at_camera(position, target, world_up, fov: float = 60.0,
                   width: int = 512, height: int = 512) -> Camera:
    """A camera at ``position`` looking at ``target`` (camera.h:74-82),
    built in float64 numpy exactly as the JAX package builds it."""
    position = np.asarray(position, np.float64)
    target = np.asarray(target, np.float64)
    world_up = np.asarray(world_up, np.float64)
    front = target - position
    front = front / np.linalg.norm(front)
    right = np.cross(front, world_up)
    right = right / np.linalg.norm(right)
    up = np.cross(right, front)
    up = up / np.linalg.norm(up)
    return Camera(
        position=tuple(float(v) for v in position),
        front=tuple(float(v) for v in front),
        up=tuple(float(v) for v in up),
        right=tuple(float(v) for v in right),
        fov=fov,
        width=width,
        height=height,
    )


def _view_from_axes(right, up, front, position):
    top = torch.stack([right, up, front], dim=0)  # (3, 3)
    # -(t0*p0 + t1*p1 + t2*p2), summed left to right like the JAX reduce
    trans = -(top[:, 0] * position[0] + top[:, 1] * position[1]
              + top[:, 2] * position[2])
    m = torch.cat([top, trans[:, None]], dim=1)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=m.dtype,
                          device=m.device)
    return torch.cat([m, bottom], dim=0)


def look_at_view(position, target, world_up, tan_fovy, aspect) -> CameraView:
    """Differentiable look-at CameraView: every argument may be a tensor
    (camera-pose gradients flow through this path)."""
    front = target - position
    front = front / torch.linalg.vector_norm(front)
    right = torch.linalg.cross(front, world_up)
    right = right / torch.linalg.vector_norm(right)
    up = torch.linalg.cross(right, front)
    up = up / torch.linalg.vector_norm(up)
    return CameraView(
        view=_view_from_axes(right, up, front, position),
        position=position,
        tan_fovx=tan_fovy * aspect,
        tan_fovy=tan_fovy,
    )


def view_matrix(cam: Camera, device) -> torch.Tensor:
    """4x4 float32 world->view matrix; view-space z is the front axis."""
    def vec(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    return _view_from_axes(vec(cam.right), vec(cam.up), vec(cam.front),
                           vec(cam.position))


def projection_matrix(tan_fovx: float, tan_fovy: float, znear: float = 0.1,
                      zfar: float = 100.0, device="cuda") -> torch.Tensor:
    """4x4 view->clip: x/w = x/(tanfovx*z), z in [znear, zfar] -> [0, 1], on
    ``device`` (by default the card; without a GPU, pass ``device="cpu"``)."""
    a = zfar / (zfar - znear)
    b = -zfar * znear / (zfar - znear)
    return torch.tensor(
        [
            [1.0 / tan_fovx, 0.0, 0.0, 0.0],
            [0.0, 1.0 / tan_fovy, 0.0, 0.0],
            [0.0, 0.0, a, b],
            [0.0, 0.0, 1.0, 0.0],
        ],
        dtype=torch.float32,
        device=resolve_device(device),
    )


def camera_matrices(cam: Camera, device, znear: float = 0.1,
                    zfar: float = 100.0):
    """(view 4x4, proj 4x4) float32 tensors for a camera
    (reference gs_projector/impl.cpp:34-42)."""
    return view_matrix(cam, device), projection_matrix(
        cam.tan_fovx, cam.tan_fovy, znear, zfar, device
    )
