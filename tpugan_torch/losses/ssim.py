"""SSIM on NHWC batches (counterpart of ``tpugan/losses/ssim.py``).

An 11-tap Gaussian window (sigma 1.5), zero padding, local-window biased
variances, C1 = 0.01^2 and C2 = 0.03^2. The window is an outer product, so
the five filters (mu1, mu2, E[x^2], E[y^2], E[xy]) run as one separable
two-pass depthwise blur over a channel-stacked tensor, as in ``tpugan``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def gaussian_1d(window_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    g = torch.tensor(
        [math.exp(-((x - window_size // 2) ** 2) / (2.0 * sigma**2)) for x in range(window_size)],
        dtype=torch.float32,
    )
    return g / g.sum()


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM of two NHWC batches."""
    c = img1.shape[-1]
    pad = window_size // 2
    g = gaussian_1d(window_size, sigma).to(device=img1.device, dtype=img1.dtype)
    stacked = torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2], dim=-1)
    x = stacked.permute(0, 3, 1, 2)
    x = F.conv2d(x, g.view(1, 1, -1, 1).expand(5 * c, 1, -1, 1), padding=(pad, 0), groups=5 * c)
    x = F.conv2d(x, g.view(1, 1, 1, -1).expand(5 * c, 1, 1, -1), padding=(0, pad), groups=5 * c)
    mu1, mu2, e_x2, e_y2, e_xy = x.split(c, dim=1)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = e_x2 - mu1_sq
    sigma2_sq = e_y2 - mu2_sq
    sigma12 = e_xy - mu1_mu2
    c1, c2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    return ssim_map.mean()
