"""StyleGANv1 mapping and generator, NCHW (counterpart of
``tpugan/models/stylegan1.py``).

Submodules and parameters carry ``tpugan``'s names (``decode_block_3``,
``conv_1``, ``noise_weight_2``, ...), so ``io/bridge.py`` maps a ``tpugan``
param tree onto these modules name for name. Noise is an explicit argument:
the caller draws it (``noise_shapes`` gives the shapes) or passes ``None``
for no injection. The blur after each upsampling conv is the FIR op, which
on a CUDA tensor runs the hand-written kernel.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from tpugan_torch.nn.layers import EqConv, EqLinear
from tpugan_torch.ops.basic import (
    instance_norm,
    leaky_relu,
    noise_inject,
    pixel_norm,
    style_mod,
    upscale2d,
)
from tpugan_torch.ops.upfirdn import blur3x3


def truncation_coefs(num_layers: int, psi: float = 0.7, cutoff: Optional[int] = None) -> torch.Tensor:
    """Per-layer truncation coefficients [1, num_layers, 1]: ``psi`` for the
    first half (or ``cutoff``) of the style layers, 1.0 after."""
    if cutoff is None:
        cutoff = num_layers // 2
    idx = torch.arange(num_layers)
    return torch.where(idx < cutoff, psi, 1.0)[None, :, None]


class MappingBlock(nn.Module):
    def __init__(self, in_features: int, features: int, generator=None):
        super().__init__()
        self.fc = EqLinear(in_features, features, lrmul=0.01, generator=generator)

    def forward(self, x):
        return leaky_relu(self.fc(x), 0.2)


class StyleGANv1Mapping(nn.Module):
    """z [N, latent] -> w+ [N, num_layers, dlatent] with optional truncation
    towards ``center`` ([num_layers, dlatent]) by ``coefs``. A z of another
    dtype than the weights is pixel-normed in its own and then cast to
    theirs: tpugan's matmul promotes a bf16 z on fp32 weights to fp32
    (ablation 1 re-maps the bf16 encoder's z through the fp32 mapping)."""

    def __init__(self, num_layers: int = 18, mapping_layers: int = 8, latent_size: int = 512,
                 dlatent_size: int = 512, mapping_fmaps: int = 512, generator=None):
        super().__init__()
        self.num_layers = num_layers
        self.mapping_layers = mapping_layers
        inputs = latent_size
        for i in range(mapping_layers):
            features = dlatent_size if i == mapping_layers - 1 else mapping_fmaps
            self.add_module(f"block_{i + 1}", MappingBlock(inputs, features, generator))
            inputs = features

    def forward(self, z, coefs=None, center=None):
        x = pixel_norm(z, dim=-1).to(self.block_1.fc.weight.dtype)
        for i in range(self.mapping_layers):
            x = getattr(self, f"block_{i + 1}")(x)
        x = x[:, None, :].repeat(1, self.num_layers, 1)
        if center is not None:
            coefs = 1.0 if coefs is None else coefs.to(x)
            c = center[None].to(x)
            x = c + (x - c) * coefs
        return x


class DecodeBlock(nn.Module):
    """One synthesis block: (upsample-conv, blur)? -> noise -> bias -> lrelu
    -> IN -> AdaIN, twice. The single-stream path of ``tpugan``'s block."""

    def __init__(self, in_features: int, features: int, latent_size: int,
                 has_first_conv: bool = True, fused_scale: bool = True, generator=None):
        super().__init__()
        c = features
        self.has_first_conv = has_first_conv
        self.fused_scale = fused_scale
        if has_first_conv:
            if fused_scale:
                self.conv_1 = EqConv(in_features, c, 3, stride=2, padding=1, use_bias=False,
                                     transpose=True, transform_kernel=True, generator=generator)
            else:
                self.conv_1 = EqConv(in_features, c, 3, padding=1, use_bias=False,
                                     generator=generator)
        self.noise_weight_1 = nn.Parameter(torch.zeros(c))
        self.noise_weight_2 = nn.Parameter(torch.zeros(c))
        self.bias_1 = nn.Parameter(torch.zeros(c))
        self.bias_2 = nn.Parameter(torch.zeros(c))
        self.style_1 = EqLinear(latent_size, 2 * c, gain=1.0, generator=generator)
        self.conv_2 = EqConv(c, c, 3, padding=1, use_bias=False, generator=generator)
        self.style_2 = EqLinear(latent_size, 2 * c, gain=1.0, generator=generator)

    def forward(self, x, s1, s2, noise: Optional[Sequence[torch.Tensor]] = None):
        if self.has_first_conv:
            x = self.conv_1(x if self.fused_scale else upscale2d(x))
            x = blur3x3(x)
        n1, n2 = noise if noise is not None else (None, None)

        x = noise_inject(x, self.noise_weight_1, n1)
        x = leaky_relu(x + self.bias_1[None, :, None, None], 0.2)
        x = style_mod(instance_norm(x), self.style_1(s1))

        x = noise_inject(self.conv_2(x), self.noise_weight_2, n2)
        x = leaky_relu(x + self.bias_2[None, :, None, None], 0.2)
        return style_mod(instance_norm(x), self.style_2(s2))


class ToRGB(nn.Module):
    def __init__(self, in_features: int, channels: int = 3, generator=None):
        super().__init__()
        self.to_rgb = EqConv(in_features, channels, 1, gain=1.0, generator=generator)

    def forward(self, x):
        return self.to_rgb(x)


class StyleGANv1Generator(nn.Module):
    """Synthesis network Gs.

    Block i has min(maxf, startf * 2^(L-1-i)) outputs at 4 * 2^i pixels;
    blocks whose output reaches 128 pixels use the fused transposed conv.
    ``forward(styles [N, 2L, latent], lod)`` runs blocks 0..lod and
    ``to_rgb_<lod>``; images come out NCHW.
    """

    def __init__(self, startf: int = 32, maxf: int = 256, layer_count: int = 3,
                 latent_size: int = 128, channels: int = 3, generator=None):
        super().__init__()
        self.layer_count = layer_count
        mul = 2 ** (layer_count - 1)
        inputs = min(maxf, startf * mul)
        self.const = nn.Parameter(torch.ones(1, inputs, 4, 4))
        resolution = 2
        for i in range(layer_count):
            outputs = min(maxf, startf * mul)
            self.add_module(f"decode_block_{i}", DecodeBlock(
                inputs, outputs, latent_size, has_first_conv=i != 0,
                fused_scale=resolution * 2 >= 128, generator=generator,
            ))
            self.add_module(f"to_rgb_{i}", ToRGB(outputs, channels, generator))
            inputs = outputs
            resolution *= 2
            mul //= 2

    def noise_shapes(self, batch: int, lod: Optional[int] = None) -> list:
        """Shapes of the (n1, n2) noise pair of each block up to ``lod``."""
        lod = self.layer_count - 1 if lod is None else lod
        return [((batch, 1, 4 << i, 4 << i),) * 2 for i in range(lod + 1)]

    def forward(self, styles, lod: Optional[int] = None, noise=None):
        lod = self.layer_count - 1 if lod is None else lod
        if not 0 <= lod < self.layer_count:
            raise ValueError(f"lod {lod} out of range for layer_count {self.layer_count}")
        if styles.shape[1] < 2 * (lod + 1):
            raise ValueError(f"styles has {styles.shape[1]} layers; lod {lod} needs {2 * (lod + 1)}")
        return self.decode(styles, lod, noise)

    def decode(self, styles, lod: int, noise=None):
        x = self.const.expand(styles.shape[0], -1, -1, -1)
        for i in range(lod + 1):
            ni = noise[i] if noise is not None else None
            block = getattr(self, f"decode_block_{i}")
            x = block(x, styles[:, 2 * i], styles[:, 2 * i + 1], ni)
        return getattr(self, f"to_rgb_{lod}")(x)
