"""The trainable StyleGAN encoder E, NCHW (counterpart of
``tpugan/models/encoders.py``: ``EncoderBlock``'s v2 forward and
``Encoder``).

``use_blur=False`` is case 1 (E.py); ``use_blur=True`` is case 2 (E_Blur.py),
which blurs before the downsampling conv and fuses that conv (stride 2,
transformed kernel) while the 1024-based resolution ladder is at 128 or
more. Each block reads the per-channel (mean, std) of its input and of its
first conv's output as style codes, and the per-block (w2, w1) pairs come
out deepest-first so ``w[:, 2i]`` and ``w[:, 2i+1]`` line up with generator
layer i. Noise is an explicit argument, as in the generator.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from tpugan_torch.nn.layers import EqConv, EqLinear
from tpugan_torch.ops.basic import (
    downscale2d,
    instance_moments,
    instance_norm,
    leaky_relu,
    noise_inject,
)
from tpugan_torch.ops.upfirdn import blur3x3


def _stats(y: torch.Tensor) -> torch.Tensor:
    mean, std = instance_moments(y)
    return torch.cat([mean, std], dim=1)


class EncoderBlock(nn.Module):
    """BEBlock: style stats -> w pair, IN -> conv -> noise -> bias -> lrelu
    twice, downsample, 0.111/0.889 residual mix."""

    def __init__(self, in_features: int, out_features: int, latent_size: int = 512,
                 has_last_conv: bool = True, fused_scale: bool = False,
                 use_blur: bool = False, generator=None):
        super().__init__()
        cin, cout = in_features, out_features
        self.has_last_conv = has_last_conv
        self.fused_scale = fused_scale
        self.use_blur = use_blur
        self.inver_mod1 = EqLinear(2 * cin, latent_size, gain=1.0, generator=generator)
        self.conv_1 = EqConv(cin, cin, 3, padding=1, use_bias=False, generator=generator)
        self.noise_weight_1 = nn.Parameter(torch.zeros(cin))
        self.bias_1 = nn.Parameter(torch.zeros(cin))
        self.inver_mod2 = EqLinear(2 * cin, latent_size, gain=1.0, generator=generator)
        if has_last_conv:
            if fused_scale:
                self.conv_2 = EqConv(cin, cout, 3, stride=2, padding=1, use_bias=False,
                                     transform_kernel=True, generator=generator)
            else:
                self.conv_2 = EqConv(cin, cout, 3, padding=1, use_bias=False, generator=generator)
            self.noise_weight_2 = nn.Parameter(torch.zeros(cout))
            self.bias_2 = nn.Parameter(torch.zeros(cout))
        self.conv_3 = EqConv(cin, cout, 1, generator=generator) if cin != cout else None

    def forward(self, x, noise: Optional[Sequence[torch.Tensor]] = None):
        w1 = self.inver_mod1(_stats(x))
        residual = x
        x = self.conv_1(instance_norm(x))
        x = noise_inject(x, self.noise_weight_1, noise[0] if noise is not None else None)
        x = leaky_relu(x + self.bias_1[None, :, None, None], 0.2)
        w2 = self.inver_mod2(_stats(x))

        x = instance_norm(x)
        if self.has_last_conv:
            if self.use_blur:
                x = blur3x3(x)
            x = self.conv_2(x)
            x = noise_inject(x, self.noise_weight_2, noise[1] if noise is not None else None)
            x = leaky_relu(x + self.bias_2[None, :, None, None], 0.2)
            if not self.fused_scale:
                x = downscale2d(x)
            residual = downscale2d(residual)
        if self.conv_3 is not None:
            residual = self.conv_3(residual)
        return 0.111 * x + 0.889 * residual, w1, w2


class Encoder(nn.Module):
    """BE / BE_Blur: images [N, C, R, R] -> (const features [N, maxf, 4, 4],
    w [N, 2*layer_count, latent])."""

    def __init__(self, startf: int = 16, maxf: int = 512, layer_count: int = 9,
                 latent_size: int = 512, channels: int = 3, use_blur: bool = False,
                 base_resolution: int = 1024, generator=None):
        super().__init__()
        self.layer_count = layer_count
        self.from_rgb = EqConv(channels, startf, 1, generator=generator)
        # the reference's fused-scale ladder starts at 1024 whatever the
        # input size (E_Blur.py:99)
        resolution = base_resolution
        inputs, outputs = startf, startf * 2
        self.fused = []
        for i in range(layer_count):
            fused_scale = use_blur and resolution >= 128
            self.fused.append(fused_scale)
            self.add_module(f"block_{i}", EncoderBlock(
                inputs, outputs, latent_size, has_last_conv=i + 1 != layer_count,
                fused_scale=fused_scale, use_blur=use_blur, generator=generator,
            ))
            inputs = min(maxf, inputs * 2)
            outputs = min(maxf, outputs * 2)
            resolution //= 2

    def noise_shapes(self, batch: int, resolution: int) -> list:
        """Noise shapes per block for ``resolution``-pixel input: n1 at the
        block's input size, n2 after its last conv (the last block has no
        last conv, so no n2)."""
        shapes = []
        for i, fused in enumerate(self.fused):
            r = resolution >> i
            n1 = (batch, 1, r, r)
            if i + 1 == self.layer_count:
                shapes.append((n1,))
            else:
                r2 = r // 2 if fused else r
                shapes.append((n1, (batch, 1, r2, r2)))
        return shapes

    def forward(self, x, noise=None):
        x = leaky_relu(self.from_rgb(x), 0.2)
        styles = []
        for i in range(self.layer_count):
            ni = noise[i] if noise is not None else None
            x, w1, w2 = getattr(self, f"block_{i}")(x, ni)
            styles.append(torch.stack([w2, w1], dim=1))
        return x, torch.cat(styles[::-1], dim=1)
