"""Paired-image metrics: PSNR, SSIM, MSE, LPIPS and cosine (counterpart of
``tpugan/eval/metrics.py``; comparing-baseline.py:17-44).

As in ``tpugan``:

* PSNR over range-255 images, ``10 log10(R^2 / mse)``;
* SSIM with skimage's defaults: a 7x7 uniform filter, the sample
  covariance (``N / (N - 1)``), K1 0.01, K2 0.03, the border of
  ``(win - 1) // 2`` cropped, channels averaged;
* MSE over range-255 images;
* LPIPS and cosine over the images scaled to [-1, 1].

Images are ``[H, W, C]`` in [0, 1] on any device. The uniform filter is a
grouped ``F.conv2d`` of ones, in full fp32 (cuDNN's TF32 off for it), as
``tpugan`` runs it at ``Precision.HIGHEST``: SSIM's variances are
differences of nearly equal sums.
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F


class PairMetrics(NamedTuple):
    psnr: torch.Tensor
    ssim: torch.Tensor
    lpips: torch.Tensor
    mse: torch.Tensor
    cosine: torch.Tensor


def psnr(a: torch.Tensor, b: torch.Tensor, data_range: float = 255.0) -> torch.Tensor:
    """a, b: [H, W, C], range 255 as the reference's."""
    mse = torch.mean(torch.square(a - b))
    return 10.0 * torch.log10(data_range**2 / mse)


@contextlib.contextmanager
def _no_tf32():
    prior = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prior


def _symmetric_pad(x: torch.Tensor, dim: int, before: int, after: int) -> torch.Tensor:
    """np.pad's 'symmetric' (the edge sample repeated: d c b a | a b c d)
    along ``dim``, for pads no wider than the axis."""
    n = x.shape[dim]
    parts = [x.narrow(dim, 0, before).flip(dim), x]
    if after:
        parts.append(x.narrow(dim, n - after, after).flip(dim))
    return torch.cat(parts, dim=dim)


def _uniform_filter(x: torch.Tensor, size: int) -> torch.Tensor:
    """scipy.ndimage.uniform_filter with its 'reflect' boundary (np.pad's
    'symmetric'), per channel. x: [H, W, C]; an even ``size`` pads one
    less after than before, as scipy centres it."""
    before = size // 2
    after = before - (1 - size % 2)
    c = x.shape[-1]
    xp = _symmetric_pad(_symmetric_pad(x.permute(2, 0, 1)[None], 2, before, after), 3, before, after)
    k = torch.full((c, 1, size, size), 1.0 / (size * size), dtype=x.dtype, device=x.device)
    with _no_tf32():
        return F.conv2d(xp, k, groups=c)[0].permute(1, 2, 0)


def ssim_uniform(a: torch.Tensor, b: torch.Tensor, data_range: float = 255.0, win_size: int = 7) -> torch.Tensor:
    """skimage's structural_similarity defaults (no gaussian weights), a, b
    [H, W, C], each channel on its own, then averaged."""
    np_ = win_size * win_size
    cov_norm = np_ / (np_ - 1.0)  # the sample covariance (skimage)
    ux = _uniform_filter(a, win_size)
    uy = _uniform_filter(b, win_size)
    uxx = _uniform_filter(a * a, win_size)
    uyy = _uniform_filter(b * b, win_size)
    uxy = _uniform_filter(a * b, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux * ux + uy * uy + c1) * (vx + vy + c2))
    pad = (win_size - 1) // 2  # skimage crops the border before the mean
    return torch.mean(s[pad:s.shape[0] - pad, pad:s.shape[1] - pad])


def pair_metrics(a: torch.Tensor, b: torch.Tensor, lpips_fn: Optional[Callable] = None) -> PairMetrics:
    """The metrics of one pair; a, b: [H, W, C] in [0, 1]. Without
    ``lpips_fn`` LPIPS is 0, as in ``tpugan``."""
    a255, b255 = a * 255.0, b * 255.0
    am, bm = a * 2.0 - 1.0, b * 2.0 - 1.0
    if lpips_fn is not None:
        lp = torch.mean(lpips_fn(am[None], bm[None]))
    else:
        lp = torch.zeros((), dtype=a.dtype, device=a.device)
    af, bf = am.reshape(-1), bm.reshape(-1)
    cos = torch.dot(af, bf) / (torch.sqrt(torch.dot(af, af)) * torch.sqrt(torch.dot(bf, bf)))
    return PairMetrics(psnr=psnr(a255, b255), ssim=ssim_uniform(a255, b255), lpips=lp,
                       mse=torch.mean(torch.square(a255 - b255)), cosine=cos)
