"""StyleGANv1 mappings, generator and discriminator, NCHW (counterpart of
``tpugan/models/stylegan1.py``).

Submodules and parameters carry ``tpugan``'s names (``decode_block_3``,
``conv_1``, ``noise_weight_2``, ...), so ``io/bridge.py`` maps a ``tpugan``
param tree onto these modules name for name. Noise is an explicit argument:
the caller draws it (``noise_shapes`` gives the shapes) or passes ``None``
for no injection. The blur after each upsampling conv of the generator,
and before each downsampling conv of the discriminator, is the FIR op,
which on a CUDA tensor runs the hand-written kernel.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from tpugan_torch.nn.layers import EqConv, EqLinear
from tpugan_torch.ops.basic import (
    downscale2d,
    instance_norm,
    leaky_relu,
    minibatch_stddev,
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


def _shared_norm(main, pair):
    """Normalise both streams by the *main* stream's per-channel spatial
    mean and *unbiased* std (torch's ``.std`` default), in their own dtype."""
    mean = main.mean(dim=(2, 3), keepdim=True)
    nhw = main.shape[2] * main.shape[3]
    std = ((main - mean).square().sum(dim=(2, 3), keepdim=True) / max(nhw - 1, 1)).sqrt()
    return (main - mean) / std, (pair - mean) / std


class DecodeBlock(nn.Module):
    """One synthesis block: (upsample-conv, blur)? -> noise -> bias -> lrelu
    -> IN -> AdaIN, twice. With ``x_pair`` (blob removal's paired stream)
    both streams run the same convs and noise and are normalised by the
    main stream's statistics (:func:`_shared_norm`); returns both."""

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

    def forward(self, x, s1, s2, noise: Optional[Sequence[torch.Tensor]] = None,
                x_pair: Optional[torch.Tensor] = None):
        streams = [x] if x_pair is None else [x, x_pair]
        if self.has_first_conv:
            streams = [blur3x3(self.conv_1(y if self.fused_scale else upscale2d(y))) for y in streams]
        n1, n2 = noise if noise is not None else (None, None)
        streams = self._adain(streams, self.noise_weight_1, self.bias_1, n1, self.style_1(s1))
        streams = self._adain([self.conv_2(y) for y in streams], self.noise_weight_2, self.bias_2, n2,
                              self.style_2(s2))
        return streams[0] if x_pair is None else tuple(streams)

    @staticmethod
    def _adain(streams, noise_weight, bias, noise, style):
        """noise -> bias -> lrelu -> normalisation -> AdaIN on each stream."""
        streams = [leaky_relu(noise_inject(y, noise_weight, noise) + bias[None, :, None, None], 0.2)
                   for y in streams]
        streams = [instance_norm(streams[0])] if len(streams) == 1 else list(_shared_norm(*streams))
        return [style_mod(y, style) for y in streams]


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

    def forward(self, styles, lod: Optional[int] = None, noise=None, blend: float = 1.0):
        """Images at ``lod``; ``blend`` < 1 fades the lod in from the
        previous one (:meth:`decode2`)."""
        lod = self.layer_count - 1 if lod is None else lod
        if not 0 <= lod < self.layer_count:
            raise ValueError(f"lod {lod} out of range for layer_count {self.layer_count}")
        if styles.shape[1] < 2 * (lod + 1):
            raise ValueError(f"styles has {styles.shape[1]} layers; lod {lod} needs {2 * (lod + 1)}")
        if blend == 1.0:
            return self.decode(styles, lod, noise)
        return self.decode2(styles, lod, blend, noise)

    def _block(self, i, x, styles, noise, x_pair=None):
        ni = noise[i] if noise is not None else None
        return getattr(self, f"decode_block_{i}")(x, styles[:, 2 * i], styles[:, 2 * i + 1], ni, x_pair)

    def decode(self, styles, lod: int, noise=None):
        x = self.const.expand(styles.shape[0], -1, -1, -1)
        for i in range(lod + 1):
            x = self._block(i, x, styles, noise)
        return getattr(self, f"to_rgb_{lod}")(x)

    def decode2(self, styles, lod: int, blend: float, noise=None):
        """The fade-in: the lod's image lerped by ``blend`` from the
        nearest-upscaled ``to_rgb_<lod-1>`` of the previous block."""
        if lod < 1:
            raise ValueError("decode2 blends from the previous lod; lod 0 has none")
        x = self.const.expand(styles.shape[0], -1, -1, -1)
        for i in range(lod):
            x = self._block(i, x, styles, noise)
        x_prev = upscale2d(getattr(self, f"to_rgb_{lod - 1}")(x))
        x = getattr(self, f"to_rgb_{lod}")(self._block(lod, x, styles, noise))
        return x_prev + (x - x_prev) * blend

    def decode3(self, styles, lod: int, noise=None, blob_threshold: float = 300.0):
        """Blob-removal decode: after block 3 a copy of the stream with the
        activations above ``blob_threshold`` zeroed runs the later blocks
        as the paired stream of each (:class:`DecodeBlock`). At lod 8 the
        copy goes through ``to_rgb_8``; below, the result is the normalised
        channel-max grayscale preview, as three channels."""
        x = self.const.expand(styles.shape[0], -1, -1, -1)
        x_pair = None
        for i in range(lod + 1):
            if i < 4:
                x = self._block(i, x, styles, noise)
                if i == 3:
                    x_pair = x.masked_fill(x > blob_threshold, 0.0)
            else:
                x, x_pair = self._block(i, x, styles, noise, x_pair)
        if x_pair is not None:
            x = x_pair
        if lod == 8:
            return getattr(self, f"to_rgb_{lod}")(x)
        x = x.amax(dim=1, keepdim=True)
        x = x - x.min()
        x = (x / x.max()).pow(1.0 / 2.2)
        return x.repeat(1, 3, 1, 1)


class StyleGANv1Mapping2(nn.Module):
    """Pyramid map to the full w+ stack: z [N, latent] -> w+ [N, num_layers,
    latent], the last block widening to num_layers * latent; ``inverse``
    (a module of its own) maps w+ -> z through the same block names in
    reverse."""

    def __init__(self, num_layers: int = 18, mapping_layers: int = 8, latent_size: int = 512,
                 inverse: bool = False, generator=None):
        super().__init__()
        self.num_layers, self.mapping_layers, self.inverse = num_layers, mapping_layers, inverse
        self.latent_size = latent_size
        wide = num_layers * latent_size
        for i in range(1, mapping_layers):
            self.add_module(f"block_{i}", MappingBlock(latent_size, latent_size, generator))
        last = (wide, latent_size) if inverse else (latent_size, wide)
        self.add_module(f"block_{mapping_layers}", MappingBlock(*last, generator))

    def forward(self, z):
        x = pixel_norm(z, dim=-1)
        if not self.inverse:
            for i in range(1, self.mapping_layers + 1):
                x = getattr(self, f"block_{i}")(x)
            return x.reshape(-1, self.num_layers, self.latent_size)
        x = x.reshape(-1, self.num_layers * self.latent_size)
        for i in range(self.mapping_layers, 0, -1):
            x = getattr(self, f"block_{i}")(x)
        return x


class StyleGANv1Mapping3(nn.Module):
    """Widening pyramid: z [N, latent] -> w+ [N, num_layers, latent] through
    2, 4, ..., 14 and num_layers times latent."""

    def __init__(self, num_layers: int = 18, latent_size: int = 512, generator=None):
        super().__init__()
        self.num_layers, self.latent_size = num_layers, latent_size
        widths = [latent_size] + [latent_size * m for m in (2, 4, 6, 8, 10, 12, 14, num_layers)]
        for i in range(8):
            self.add_module(f"block_{i + 1}", MappingBlock(widths[i], widths[i + 1], generator))

    def forward(self, z):
        x = pixel_norm(z, dim=-1)
        for i in range(8):
            x = getattr(self, f"block_{i + 1}")(x)
        return x.reshape(-1, self.num_layers, self.latent_size)


class StyleGANv1Mapping4(nn.Module):
    """Narrowing pyramid: w+ [N, num_layers, latent] -> [N, latent] through
    14, 12, ..., 2 and 1 times latent."""

    def __init__(self, num_layers: int = 18, latent_size: int = 512, generator=None):
        super().__init__()
        self.num_layers, self.latent_size = num_layers, latent_size
        widths = [num_layers * latent_size] + [latent_size * m for m in (14, 12, 10, 8, 6, 4, 2, 1)]
        for i in range(8):
            self.add_module(f"block_{i + 1}", MappingBlock(widths[i], widths[i + 1], generator))

    def forward(self, w):
        x = pixel_norm(w, dim=-1).reshape(-1, self.num_layers * self.latent_size)
        for i in range(8):
            x = getattr(self, f"block_{i + 1}")(x)
        return x


class DiscriminatorBlock(nn.Module):
    """conv -> bias -> lrelu, then blur -> downsampling conv -> bias ->
    lrelu; the last block (4x4 input) appends the minibatch stddev channel
    first and ends in ``dense`` over the flattened map instead. ``dense``
    reads the map flattened in tpugan's NHWC order (h, w, c), so its
    weight is tpugan's kernel transposed."""

    def __init__(self, in_features: int, features: int, last: bool = False, fused_scale: bool = True,
                 generator=None):
        super().__init__()
        self.last, self.fused_scale = last, fused_scale
        self.conv_1 = EqConv(in_features + last, in_features, 3, padding=1, use_bias=False,
                             generator=generator)
        self.bias_1 = nn.Parameter(torch.zeros(in_features))
        if last:
            self.dense = EqLinear(in_features * 16, features, generator=generator)
        else:
            self.conv_2 = EqConv(in_features, features, 3, stride=2 if fused_scale else 1, padding=1,
                                 use_bias=False, transform_kernel=fused_scale, generator=generator)
            self.bias_2 = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        if self.last:
            x = minibatch_stddev(x)
        x = leaky_relu(self.conv_1(x) + self.bias_1[None, :, None, None], 0.2)
        if self.last:
            return leaky_relu(self.dense(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)), 0.2)
        x = self.conv_2(blur3x3(x))
        if not self.fused_scale:
            x = downscale2d(x)
        return leaky_relu(x + self.bias_2[None, :, None, None], 0.2)


class StyleGANv1Discriminator(nn.Module):
    """Progressive discriminator: images [N, C, 2^(lod+2), 2^(lod+2)] ->
    [N, 1]. Block i takes min(maxf, startf * 2^i) channels (startf for
    block 0) to min(maxf, startf * 2^(i+1)) at 2^(L+1-i) pixels, with the
    fused stride-2 conv from 128 pixels up; ``from_rgb_<i>`` feeds block i,
    the first that ``lod`` runs. It has no fade-in (no ``blend``), as
    tpugan's has none."""

    def __init__(self, startf: int = 32, maxf: int = 256, layer_count: int = 3, channels: int = 3,
                 generator=None):
        super().__init__()
        self.layer_count = layer_count
        inputs, mul, resolution = startf, 2, 2 ** (layer_count + 1)
        for i in range(layer_count):
            outputs = min(maxf, startf * mul)
            self.add_module(f"from_rgb_{i}", EqConv(channels, inputs, 1, generator=generator))
            self.add_module(f"encode_block_{i}", DiscriminatorBlock(
                inputs, outputs, last=i == layer_count - 1, fused_scale=resolution >= 128,
                generator=generator))
            resolution //= 2
            inputs = outputs
            mul *= 2
        self.fc2 = EqLinear(outputs, 1, gain=1.0, generator=generator)

    def forward(self, x, lod: Optional[int] = None):
        lod = self.layer_count - 1 if lod is None else lod
        if not 0 <= lod < self.layer_count:
            raise ValueError(f"lod {lod} out of range for layer_count {self.layer_count}")
        start = self.layer_count - lod - 1
        x = leaky_relu(getattr(self, f"from_rgb_{start}")(x), 0.2)
        for i in range(start, self.layer_count):
            x = getattr(self, f"encode_block_{i}")(x)
        return self.fc2(x)
