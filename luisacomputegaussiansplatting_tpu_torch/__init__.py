"""PyTorch / CUDA port of the TPU-native differentiable 3D Gaussian
splatting package ``luisacomputegaussiansplatting_tpu``.

Same layout and public names as the JAX package; plain torch around
hand-written CUDA kernels (``csrc/``) for the expansion, the forward and
backward blends and the gradient segment-sum, each with a plain PyTorch
version that CPU tensors take. This package imports neither jax nor the
JAX package.

Public API::

    from luisacomputegaussiansplatting_tpu_torch import (
        Camera, RenderConfig, GaussianScene, render, render_aux, load_ply,
    )
    from luisacomputegaussiansplatting_tpu_torch.models import (
        TrainConfig, init_train_state, make_train_step,
    )
"""

from .config import TILE, RenderConfig
from .io.ply import load_ply, save_ply
from .io.synthetic import create_cube_scene, random_scene
from .models.gaussians import GaussianParams, GaussianScene, from_numpy
from .ops.render import render, render_aux
from .utils.camera import Camera, look_at_camera

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "look_at_camera",
    "RenderConfig",
    "GaussianScene",
    "GaussianParams",
    "from_numpy",
    "render",
    "render_aux",
    "load_ply",
    "save_ply",
    "create_cube_scene",
    "random_scene",
    "TILE",
    "__version__",
]
