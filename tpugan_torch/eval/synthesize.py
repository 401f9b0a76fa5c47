"""Validation grids: G(z) beside G(E(G(z))) on held-out seeds (counterpart
of ``tpugan/eval/synthesize.py``; synthesized_IMG.py:21-186).

Training draws seeds 0..29999, validation seeds from 30000 (:97-98); each
seed's grid is imgs1 over imgs2, written as ``img * 0.5 + 0.5`` (:145-146).
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from tpugan_torch.io.image import save_image_grid, to_unit
from tpugan_torch.runtime import resolve_device
from tpugan_torch.utils import iteration_generator


def synthesize_grids(
    synth: Optional[Callable[[torch.Tensor], tuple]],
    encode: Optional[Callable[[torch.Tensor], torch.Tensor]],
    resynth: Optional[Callable[[torch.Tensor], torch.Tensor]],
    out_dir: str,
    batch_size: int = 2,
    z_dim: int = 512,
    start_seed: int = 30000,
    count: int = 5,
    device="cuda",
    draw_z: Optional[Callable[[int], torch.Tensor]] = None,
    serve_seed: Optional[Callable[[int], tuple]] = None,
) -> list:
    """For each seed of ``start_seed .. start_seed + count - 1``: the images
    ``(imgs1, imgs2) = serve_seed(seed)`` (NHWC in [-1, 1]) and the grid
    ``seed<k>.png`` of imgs1 over imgs2. Without ``serve_seed``, a seed is
    z, then ``(w1, imgs1) = synth(z)``, ``w2 = encode(imgs1)``, ``imgs2 =
    resynth(w2)``, z being ``draw_z(seed)``, by default N(0, 1) [batch,
    z_dim] from ``utils.iteration_generator(seed)`` on ``device`` (the card
    unless ``"cpu"`` is given; raises where there is none). The CLI passes
    ``infer_e``'s request of the seed as ``serve_seed``. Returns the files'
    paths."""
    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    if serve_seed is None:
        if draw_z is None:
            def draw_z(seed):
                return torch.randn(batch_size, z_dim, generator=iteration_generator(seed, device), device=device)

        def serve_seed(seed):
            _, imgs1 = synth(draw_z(seed))
            return imgs1, resynth(encode(imgs1))

    paths = []
    for seed in range(start_seed, start_seed + count):
        with torch.no_grad():
            imgs1, imgs2 = serve_seed(seed)
        grid = np.concatenate([to_unit(imgs1), to_unit(imgs2)], axis=0)
        path = os.path.join(out_dir, f"seed{seed}.png")
        save_image_grid(path, np.clip(grid, 0, 1), nrow=batch_size)
        paths.append(path)
    return paths
