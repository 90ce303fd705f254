"""The benchmark of the PyTorch / CUDA port of the Gaussian splatting
package: data-driven cells of training steps and rendered frames on one
NVIDIA GPU (``gsbench/run.py``), with a plain PyTorch reference
(``gsbench/reference``) that decides whether a run is correct."""
