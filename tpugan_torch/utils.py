"""Seed discipline, one-hot labels and truncated noise (counterpart of
``tpugan/utils.py``).

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


def one_hot(labels: torch.Tensor, class_count: int = 1000) -> torch.Tensor:
    """fp32 one-hot rows [N, class_count] of integer ``labels`` [N]."""
    return torch.nn.functional.one_hot(labels, class_count).float()


def truncated_noise_sample(batch_size: int = 1, dim_z: int = 128, truncation: float = 1.0,
                           generator: torch.Generator | None = None) -> torch.Tensor:
    """BigGAN-style truncated N(0, 1) on [-2, 2], scaled by ``truncation``,
    drawn from ``generator`` on its device."""
    device = generator.device if generator is not None else "cpu"
    values = torch.empty(batch_size, dim_z, device=device)
    torch.nn.init.trunc_normal_(values, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return truncation * values
