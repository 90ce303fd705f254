from .ply import load_ply, save_ply
from .synthetic import create_cube_scene, random_scene

__all__ = ["load_ply", "save_ply", "create_cube_scene", "random_scene"]
