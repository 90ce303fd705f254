"""Training losses (port of ``models/losses.py``): the graphdeco 3DGS
photometric loss (1 - w) L1 + w (1 - SSIM), w = 0.2, with an 11x11
sigma = 1.5 gaussian SSIM window.

The window runs as two grouped ``conv2d`` passes (vertical, then
horizontal) over the 5C stacked channels, as the JAX package runs it
outside any kernel. On a GPU, cuDNN takes float32 convolutions in TF32
unless ``torch.backends.cudnn.allow_tf32`` is False; the JAX package
convolves at full float32 precision.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def l1_loss(pred, target):
    return torch.mean(torch.abs(pred - target))


@functools.lru_cache(maxsize=None)
def _ssim_window(size: int = 11, sigma: float = 1.5):
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    g /= g.sum()
    return g.astype(np.float32)


def _blur(img, window):
    """Separable depthwise gaussian blur of (C, H, W), zero-padded."""
    c = img.shape[0]
    size = window.shape[0]
    w = torch.from_numpy(window).to(img.device)
    kh = w.reshape(1, 1, size, 1).expand(c, 1, size, 1)
    kw = w.reshape(1, 1, 1, size).expand(c, 1, 1, size)
    x = F.conv2d(img[None], kh, padding=(size // 2, 0), groups=c)
    x = F.conv2d(x, kw, padding=(0, size // 2), groups=c)
    # squeeze, not [0]: its backward is a view, not a zero-filled buffer
    return x.squeeze(0)


def ssim_map(img0, img1, c1: float = 0.01**2, c2: float = 0.03**2):
    """Per-pixel SSIM map of a (C, H, W) image pair in [0, 1]."""
    c = img0.shape[0]
    # one stacked blur of the five moment images
    stacked = torch.cat([img0, img1, img0 * img0, img1 * img1, img0 * img1],
                        dim=0)
    # one split: its backward is one cat, not a zero-filled buffer a slice
    mu0, mu1, b00, b11, b01 = _blur(stacked, _ssim_window()).split(c)
    mu00 = mu0 * mu0
    mu11 = mu1 * mu1
    mu01 = mu0 * mu1
    s00 = b00 - mu00
    s11 = b11 - mu11
    s01 = b01 - mu01
    num = (2 * mu01 + c1) * (2 * s01 + c2)
    den = (mu00 + mu11 + c1) * (s00 + s11 + c2)
    return num / den


def ssim(img0, img1, c1: float = 0.01**2, c2: float = 0.03**2):
    """Mean SSIM over a (C, H, W) image pair in [0, 1]."""
    return torch.mean(ssim_map(img0, img1, c1, c2))


def d_ssim_l1_loss(pred, target, ssim_weight: float = 0.2):
    """(1 - w) L1 + w (1 - SSIM): the standard 3DGS photometric loss."""
    return (1.0 - ssim_weight) * l1_loss(pred, target) + ssim_weight * (
        1.0 - ssim(pred, target)
    )


def psnr(pred, target):
    mse = torch.mean((pred - target) ** 2)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))
