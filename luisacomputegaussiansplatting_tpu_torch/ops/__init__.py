from .binning import bin_gaussians, bin_gaussians_nopack
from .projection import ProjectedGaussians, project_gaussians
from .render import render, render_aux
from .sh_eval import compute_colors

__all__ = [
    "bin_gaussians",
    "bin_gaussians_nopack",
    "project_gaussians",
    "ProjectedGaussians",
    "compute_colors",
    "render",
    "render_aux",
]
