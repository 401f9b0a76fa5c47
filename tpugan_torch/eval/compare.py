"""Directory-pair metrics (counterpart of ``tpugan/eval/compare.py``;
comparing-baseline.py:46-88): two image directories walked in sorted
order, each pair resized to ``img_size`` and measured, the running means
of PSNR, SSIM, LPIPS, MSE and cosine printed after each pair."""

from __future__ import annotations

import os

import torch

from tpugan_torch.eval.metrics import pair_metrics
from tpugan_torch.io.image import load_image
from tpugan_torch.runtime import resolve_device

_EXTS = (".png", ".jpg", ".jpeg")


def _images(directory: str) -> list:
    return sorted(os.path.join(directory, f) for f in os.listdir(directory) if f.lower().endswith(_EXTS))


def compare_dirs(dir1: str, dir2: str, img_size: int = 512, lpips_fn=None, verbose: bool = True,
                 device="cuda") -> dict:
    """The mean of each metric over the paired files, as floats, computed
    on ``device`` (the card unless ``"cpu"`` is given; raises where there
    is none); raises :class:`FileNotFoundError` when there is no pair."""
    device = resolve_device(device)
    sums = {"psnr": 0.0, "ssim": 0.0, "lpips": 0.0, "mse": 0.0, "cosine": 0.0}
    n = 0
    for f1, f2 in zip(_images(dir1), _images(dir2)):
        a = torch.from_numpy(load_image(f1, img_size)).to(device)
        b = torch.from_numpy(load_image(f2, img_size)).to(device)
        m = pair_metrics(a, b, lpips_fn=lpips_fn)
        n += 1
        for k in sums:
            sums[k] += float(getattr(m, k))
        if verbose:
            print(
                f"img_num:{n}--psnr:{sums['psnr']/n:f}--ssim:{sums['ssim']/n:f}"
                f"--mse_value:{sums['mse']/n:f}--lpips_value:{sums['lpips']/n:f}"
                f"--cosine_value:{sums['cosine']/n:f}"
            )
    if n == 0:
        raise FileNotFoundError("no paired images found")
    return {k: v / n for k, v in sums.items()}
