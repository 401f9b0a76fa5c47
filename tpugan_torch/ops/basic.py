"""Elementwise and normalization ops on NCHW tensors (counterpart of
``tpugan/ops/basic.py``, whose functions are NHWC). The channel axis is 1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pixel_norm(x: torch.Tensor, dim: int = 1, epsilon: float = 1e-8) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) over ``dim``, moments in fp32."""
    x32 = x.float()
    r = torch.rsqrt(x32.square().mean(dim=dim, keepdim=True) + epsilon)
    return x * r.to(x.dtype)


def style_mod(x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
    """AdaIN affine ``bias + x * (scale + 1)``; ``style`` is [N, 2C], the
    scale first, then the bias. x: [N, C, H, W]."""
    n, c = x.shape[0], x.shape[1]
    s = style.reshape(n, 2, c, 1, 1)
    return s[:, 1] + x * (s[:, 0] + 1.0)


def upscale2d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsample."""
    if factor == 1:
        return x
    return x.repeat_interleave(factor, dim=2).repeat_interleave(factor, dim=3)


def downscale2d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Average-pool downsample."""
    if factor == 1:
        return x
    return F.avg_pool2d(x, factor)


def moments32(x: torch.Tensor, whole_sum=None, count: int | None = None):
    """``(mean, centred, var)``: x's per-sample, per-channel spatial mean
    [N, C], ``x - mean`` and biased variance [N, C] in fp32 (float64 stays
    float64), in two passes: the mean, then the centred square sum. A row
    shard (``parallel/spatial.py``) passes ``whole_sum``, which maps the sums
    [N, C] over its rows to the whole image's, and ``count``, the whole
    image's H x W."""
    x32 = x.to(torch.promote_types(x.dtype, torch.float32))
    if whole_sum is None:
        mean = x32.mean(dim=(2, 3))
        centred = x32 - mean[:, :, None, None]
        return mean, centred, centred.square().mean(dim=(2, 3))
    mean = whole_sum(x32.sum(dim=(2, 3))) / count
    centred = x32 - mean[:, :, None, None]
    return mean, centred, whole_sum(centred.square().sum(dim=(2, 3))) / count


def instance_moments(x: torch.Tensor, whole_sum=None, count: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-sample, per-channel spatial mean and biased std (no eps), each
    [N, C], moments in fp32, float64 for float64 (:func:`moments32`)."""
    mean, _, var = moments32(x, whole_sum, count)
    return mean.to(x.dtype), var.sqrt().to(x.dtype)


def instance_norm(x: torch.Tensor, epsilon: float = 1e-8, whole_sum=None, count: int | None = None) -> torch.Tensor:
    """InstanceNorm2d(affine=False) with biased variance and eps 1e-8
    (not ``F.instance_norm``'s default 1e-5), moments in fp32, float64 for
    float64 (:func:`moments32`)."""
    _, centred, var = moments32(x, whole_sum, count)
    return (centred * torch.rsqrt(var + epsilon)[:, :, None, None]).to(x.dtype)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)


def noise_inject(
    x: torch.Tensor, noise_weight: torch.Tensor, noise: torch.Tensor | None
) -> torch.Tensor:
    """x + noise_weight * noise with single-channel spatial noise.

    noise_weight is [C]; noise is [N, 1, H, W], taken in x's dtype, as
    tpugan draws it (bf16 activations get bf16 noise). ``noise=None``
    disables injection (deterministic eval); callers draw the noise
    themselves.
    """
    if noise is None:
        return x
    return x + noise_weight[None, :, None, None] * noise.to(x.dtype)


def minibatch_stddev(x: torch.Tensor, group_size: int = 4) -> torch.Tensor:
    """Append a cross-sample stddev feature channel (discriminators only):
    [N, C, H, W] -> [N, C+1, H, W], the statistic at channel index C.

    Groups are strided, as ``tpugan``'s reshape to (g, -1, ...) makes them:
    sample i falls in group i mod (n'/g), n' being n padded to a multiple
    of g by repeating the first samples (wrapping), and the tiled
    statistic is cut back to n samples."""
    n, c, h, w = x.shape
    g = min(group_size, n)
    pad = (g - n % g) % g
    y = torch.cat([x, x[:pad]], dim=0) if pad else x
    y = y.reshape(g, -1, c, h, w)
    y = y - y.mean(dim=0, keepdim=True)
    y = torch.sqrt(y.square().mean(dim=0) + 1e-8)
    y = y.mean(dim=(1, 2, 3))  # [n'/g]
    y = y.repeat(g)[:n]
    return torch.cat([x, y[:, None, None, None].expand(n, 1, h, w)], dim=1)
