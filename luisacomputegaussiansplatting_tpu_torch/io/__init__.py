from .ply import load_ply, save_ply
from .synthetic import create_cube_scene, random_scene
from .dataset import (
    MultiViewDataset,
    load_colmap,
    load_colmap_points3d,
    load_colmap_text,
    load_nerf_synthetic,
    sphere_cameras,
    synthetic_multiview,
    turntable_cameras,
)

__all__ = [
    "load_ply",
    "save_ply",
    "create_cube_scene",
    "random_scene",
    "MultiViewDataset",
    "load_colmap",
    "load_colmap_points3d",
    "load_colmap_text",
    "load_nerf_synthetic",
    "sphere_cameras",
    "synthetic_multiview",
    "turntable_cameras",
]
