from .gaussians import GaussianParams, GaussianScene, from_numpy

__all__ = ["GaussianParams", "GaussianScene", "from_numpy"]
