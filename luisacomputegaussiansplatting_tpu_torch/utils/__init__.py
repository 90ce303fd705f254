from .camera import Camera, look_at_camera, projection_matrix, view_matrix
from .transform import ndc2pix, pix2ndc, rotation_from_quaternion

__all__ = [
    "Camera",
    "look_at_camera",
    "view_matrix",
    "projection_matrix",
    "ndc2pix",
    "pix2ndc",
    "rotation_from_quaternion",
]
