"""Image files (counterpart of ``tpugan/io/image.py``).

Images are NHWC, in [-1, 1] inside the models and [0, 1] at the file
boundary. Pillow is imported only when a file is read or written.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _numpy(images) -> np.ndarray:
    if isinstance(images, torch.Tensor):
        return images.detach().cpu().numpy()
    return np.asarray(images)


def load_image(path, size: int | None = None) -> np.ndarray:
    """PNG/JPG -> [H, W, 3] float32 in [0, 1] (resized with PIL's ``resize``
    when ``size`` is given)."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if size is not None:
        img = img.resize((size, size))
    return np.asarray(img, dtype=np.float32) / 255.0


def load_image_dir(path, size: int | None = None) -> np.ndarray:
    """Directory of images -> [N, H, W, 3] in [0, 1], sorted by filename."""
    files = sorted(
        f for f in os.listdir(path) if f.lower().endswith((".png", ".jpg", ".jpeg"))
    )
    if not files:
        raise FileNotFoundError(f"no images under {path}")
    return np.stack([load_image(os.path.join(path, f), size) for f in files])


def save_image(path, img) -> None:
    """[H, W, 3] in [0, 1] -> file."""
    from PIL import Image

    arr = np.clip(_numpy(img) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    Image.fromarray(arr).save(path)


def save_image_grid(path, imgs, nrow: int = 8, padding: int = 2) -> None:
    """[N, H, W, 3] in [0, 1] -> one grid image (torchvision save_image
    semantics: ``nrow`` images per row, zero padding)."""
    imgs = _numpy(imgs)
    n, h, w, c = imgs.shape
    ncol = min(nrow, n)
    nrows = -(-n // ncol)
    grid = np.zeros(
        (nrows * h + padding * (nrows + 1), ncol * w + padding * (ncol + 1), c),
        dtype=np.float32,
    )
    for idx in range(n):
        r, col = divmod(idx, ncol)
        y = padding + r * (h + padding)
        x = padding + col * (w + padding)
        grid[y : y + h, x : x + w] = imgs[idx]
    save_image(path, grid)


def to_unit(images) -> np.ndarray:
    """[-1, 1] model range -> [0, 1] file range."""
    return _numpy(images) * 0.5 + 0.5


def from_unit(images) -> np.ndarray:
    """[0, 1] file range -> [-1, 1] model range."""
    return _numpy(images) * 2.0 - 1.0
