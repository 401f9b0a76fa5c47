"""Seed discipline (counterpart of ``tpugan/utils.py``).

The reference reseeds every iteration with ``iteration % 30000``; training
seeds lie below 30000 and validation seeds at or above it. Here the seed
becomes a :class:`torch.Generator` on the device that runs the model, so
draws cost no host time or copies. A seed gives the same draws on every run
on one kind of device; the CPU's and CUDA's generators give different ones.
"""

from __future__ import annotations

import torch

TRAIN_SEED_PERIOD = 30000  # reference epoch size: epoch = iteration // 30000


def iteration_generator(iteration: int, device="cpu") -> torch.Generator:
    """Generator on ``device`` for an iteration (seed = iteration % 30000)."""
    return torch.Generator(device=device).manual_seed(int(iteration) % TRAIN_SEED_PERIOD)
