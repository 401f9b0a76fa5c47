"""PGGAN's generator, NCHW (counterpart of ``tpugan/models/pggan.py``:
``PGConvBlock`` and ``PGGANGenerator``; GenForce's pggan_generator.py).

pixel-norm z; the 4x4 "dense" conv (kernel 4, pad 3 on a 1x1 input); per
resolution a conv pair, the first up-sampling (nearest, or fused into a
transposed conv with the 4-tap kernel); a ToRGB head per resolution and
progressive ``lod`` blending between heads. Weights are stored unscaled,
N(0, 1), as the reference stores them, and scaled at run time by
``gain / sqrt(fan_in)``. PGGAN runs no TPU kernel: its convolutions go to
cuDNN. The discriminator comes with GAN training.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from tpugan_torch.ops.basic import leaky_relu, pixel_norm, upscale2d
from tpugan_torch.ops.eq_lr import transform_kernel_2d

_WSCALE_GAIN = math.sqrt(2.0)
_INIT_RES = 4


class PGConvBlock(nn.Module):
    """pixel_norm -> (nearest up-sample | fused transposed conv) -> wscale
    conv -> bias -> (lrelu). ``weight`` is OIHW ``[out, in, k, k]``, or
    ``[in, out, k, k]`` for the fused up-sampling conv (``fused``), which
    runs as ``F.conv_transpose2d`` (stride 2, padding 1) on its 4-tap
    (k + 1) kernel."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3, padding: int = 1,
                 upsample: bool = False, fused_scale: bool = False, wscale_gain: float = _WSCALE_GAIN,
                 activation_type: str = "lrelu", generator: torch.Generator | None = None):
        super().__init__()
        self.padding = padding
        self.upsample = upsample
        self.fused = upsample and fused_scale
        self.lrelu = activation_type == "lrelu"
        self.wscale = wscale_gain / math.sqrt(kernel_size * kernel_size * in_channels)
        shape = (in_channels, out_channels) if self.fused else (out_channels, in_channels)
        self.weight = nn.Parameter(torch.empty(*shape, kernel_size, kernel_size))
        nn.init.normal_(self.weight, std=1.0, generator=generator)
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = pixel_norm(x)
        w = self.weight * self.wscale
        if self.fused:
            x = F.conv_transpose2d(x, transform_kernel_2d(w, average=False), self.bias, stride=2, padding=1)
        else:
            if self.upsample:
                x = upscale2d(x)
            x = F.conv2d(x, w, self.bias, padding=self.padding)
        return leaky_relu(x, 0.2) if self.lrelu else x


class PGGANGenerator(nn.Module):
    """z [N, z_dim] -> {"z", "label", "image" [N, C, R, R]} at a static
    ``lod``; block i (4 << i px) is ``layer{2i}``/``layer{2i+1}`` and
    ``output{i}``, the reference's names. Only the heads that ``lod`` reads
    run."""

    def __init__(self, resolution: int, z_space_dim: int = 512, image_channels: int = 3,
                 final_tanh: bool = False, label_size: int = 0, fused_scale: bool = False,
                 fmaps_base: int = 16 << 10, fmaps_max: int = 512, generator: torch.Generator | None = None):
        super().__init__()
        self.resolution = resolution
        self.z_space_dim = z_space_dim
        self.final_tanh = final_tanh
        self.label_size = label_size
        self.fmaps_base, self.fmaps_max = fmaps_base, fmaps_max
        self.init_log2 = int(math.log2(_INIT_RES))
        self.final_log2 = int(math.log2(resolution))
        for res_log2 in range(self.init_log2, self.final_log2 + 1):
            res = 2**res_log2
            b = res_log2 - self.init_log2
            if res == _INIT_RES:
                first = PGConvBlock(z_space_dim + label_size, self.get_nf(res), kernel_size=_INIT_RES,
                                    padding=_INIT_RES - 1, generator=generator)
            else:
                first = PGConvBlock(self.get_nf(res // 2), self.get_nf(res), upsample=True,
                                    fused_scale=fused_scale, generator=generator)
            self.add_module(f"layer{2 * b}", first)
            self.add_module(f"layer{2 * b + 1}", PGConvBlock(self.get_nf(res), self.get_nf(res),
                                                             generator=generator))
            self.add_module(f"output{b}", PGConvBlock(self.get_nf(res), image_channels, kernel_size=1,
                                                      padding=0, wscale_gain=1.0, activation_type="linear",
                                                      generator=generator))

    def get_nf(self, res: int) -> int:
        return min(self.fmaps_base // res, self.fmaps_max)

    def forward(self, z: torch.Tensor, label: torch.Tensor | None = None, lod: float = 0.0) -> dict:
        if z.dim() != 2 or z.shape[1] != self.z_space_dim:
            raise ValueError(f"latent code must be [batch, {self.z_space_dim}], got {tuple(z.shape)}")
        if lod + self.init_log2 > self.final_log2:
            raise ValueError(f"maximum lod is {self.final_log2 - self.init_log2}, got {lod}")
        z = pixel_norm(z)
        if self.label_size:
            if label is None:
                raise ValueError(f"model requires a label of size {self.label_size}")
            z = torch.cat([z, label], dim=1)
        x = z.reshape(z.shape[0], -1, 1, 1)
        image = None
        for res_log2 in range(self.init_log2, self.final_log2 + 1):
            b = res_log2 - self.init_log2
            current_lod = self.final_log2 - res_log2
            if lod < current_lod + 1:
                x = getattr(self, f"layer{2 * b + 1}")(getattr(self, f"layer{2 * b}")(x))
            if current_lod - 1 < lod <= current_lod:
                image = getattr(self, f"output{b}")(x)
            elif current_lod < lod < current_lod + 1:
                alpha = math.ceil(lod) - lod
                image = getattr(self, f"output{b}")(x) * alpha + upscale2d(image) * (1 - alpha)
            elif lod >= current_lod + 1:
                image = upscale2d(image)
        if self.final_tanh:
            image = torch.tanh(image)
        return {"z": z, "label": label, "image": image}
