"""Latent editing with InterfaceGAN boundary directions (counterpart of
``tpugan/invert/edit.py``; embeded_img_edit.py).

An inverted w code [N, L, 512] and a direction [1, 512] or [512]:
``bonus * direction`` is added on a slice of the layer axis and the result
regenerated (embeded_img_edit.py:26-42).
"""

from __future__ import annotations

import numpy as np
import torch


def load_direction(path) -> torch.Tensor:
    """direction .npy -> [512] float32 on the CPU."""
    return torch.from_numpy(np.load(path).reshape(-1).astype(np.float32))


def edit_latent(
    w: torch.Tensor,
    direction: torch.Tensor,
    bonus: float = 3.0,
    start: int = 0,
    end: int = 18,
) -> torch.Tensor:
    """w [N, L, latent] -> an edited copy: ``w + bonus * direction`` on the
    layers ``start <= l < start + end``, w elsewhere (embeded_img_edit.py:
    35-38, per sample over the layer axis)."""
    edited = w + bonus * direction.to(w)[None, None, :]
    idx = torch.arange(w.shape[1], device=w.device)[None, :, None]
    mask = (idx >= start) & (idx < start + end)
    return torch.where(mask, edited, w)
