"""StyleGAN2 (config F) mapping, truncation and synthesis, NCHW (counterpart
of ``tpugan/models/stylegan2.py``).

Modules, parameters and buffers carry ``tpugan``'s names (``mapping.dense0``,
``synthesis.layer3.style``, ``noise_strength``, the ``noise`` and ``w_avg``
buffers), so ``io/bridge.py`` maps a ``tpugan`` variable tree onto them name
for name. Weights are stored as ``tpugan`` stores them, unscaled (the
reference's "wscale" parameterisation), and scaled in the forward; conv
weights are OIHW. The generator is unconditional, starts from its learned
const and ends in a linear image, as ``tpugan``'s defaults do; its modulated
convs run at ``lr_mul`` 1, the mapping at ``lr_mul``.

A modulated conv scales its input by the style, convolves with the one
shared weight and divides its output by the demodulation norm, as ``tpugan``
does. The up-sampling conv is ``tpugan``'s lhs-dilated correlation with the
unflipped weight, here a stride-2 transposed conv with the flipped weight,
then the 4-tap FIR; the skip architecture's image path up-samples with the
FIR alone. On a CUDA tensor both FIRs launch the hand-written kernel.

Noise: a modulated conv adds its ``noise`` buffer unless the caller passes
``noise``, or a :class:`torch.Generator` as ``randomize_noise`` to draw it
from (``tpugan``'s ``randomize_noise`` with its ``noise`` rng).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpugan_torch.ops.basic import pixel_norm
from tpugan_torch.ops.upfirdn import setup_fir_kernel, upfirdn2d

_INIT_RES = 4
_EPSILON = 1e-8  # of the demodulation norm
_FIR = setup_fir_kernel((1.0, 3.0, 3.0, 1.0))


def _activate(x: torch.Tensor, activation_type: str) -> torch.Tensor:
    if activation_type == "linear":
        return x
    if activation_type == "lrelu":
        return F.leaky_relu(x, 0.2) * math.sqrt(2.0)
    raise NotImplementedError(f"activation: {activation_type}")


def _conv(x: torch.Tensor, weight: torch.Tensor, scale_factor: int) -> torch.Tensor:
    """The same-size conv, or the up-sampling one: the reference pre-flips
    the kernel before its transposed conv, so the op is a correlation of
    the lhs-dilated input with the unflipped weight (``tpugan``'s
    ``conv_general_dilated``), a transposed conv with the flipped weight
    here, [2H + k - 2], then the 4-tap FIR at gain scale² -> [2H]."""
    k = weight.shape[-1]
    if scale_factor == 1:
        return F.conv2d(x, weight, padding=k // 2)
    y = F.conv_transpose2d(x, weight.transpose(0, 1).flip(2, 3), stride=scale_factor)
    p = _FIR.shape[0] - 1 + (scale_factor - k)
    return upfirdn2d(y, _FIR, pad=((p + 1) // 2, p // 2), gain=float(scale_factor**2))


def _normal(shape, std: float, generator) -> nn.Parameter:
    return nn.Parameter(torch.randn(*shape, generator=generator) * std)


class SG2Dense(nn.Module):
    """DenseBlock: wscale linear (weight [out, in], unscaled), the bias
    times ``lr_mul``, ``additional_bias``, the activation."""

    def __init__(self, in_features: int, features: int, additional_bias: float = 0.0,
                 lr_mul: float = 1.0, activation_type: str = "lrelu", generator=None):
        super().__init__()
        self.wscale = 1.0 / math.sqrt(in_features) * lr_mul
        self.lr_mul = lr_mul
        self.additional_bias = additional_bias
        self.activation_type = activation_type
        self.weight = _normal((features, in_features), 1.0 / lr_mul, generator)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x.reshape(x.shape[0], -1), self.weight * self.wscale, self.bias * self.lr_mul)
        return _activate(y + self.additional_bias, self.activation_type)


class SG2Mapping(nn.Module):
    """z [N, input_space_dim] -> pixel norm -> ``num_layers`` dense layers
    at ``lr_mul``; returns dict(z, w) with the normalised z."""

    def __init__(self, input_space_dim: int = 512, hidden_space_dim: int = 512,
                 final_space_dim: int = 512, num_layers: int = 8, lr_mul: float = 0.01,
                 generator=None):
        super().__init__()
        self.input_space_dim = input_space_dim
        self.num_layers = num_layers
        inputs = input_space_dim
        for i in range(num_layers):
            features = final_space_dim if i == num_layers - 1 else hidden_space_dim
            self.add_module(f"dense{i}", SG2Dense(inputs, features, lr_mul=lr_mul, generator=generator))
            inputs = features

    def forward(self, z: torch.Tensor) -> dict:
        if z.dim() != 2 or z.shape[1] != self.input_space_dim:
            raise ValueError(f"latent code must be [batch, {self.input_space_dim}], got {tuple(z.shape)}")
        z = pixel_norm(z, dim=-1)
        w = z
        for i in range(self.num_layers):
            w = getattr(self, f"dense{i}")(w)
        return {"z": z, "w": w}


class SG2Truncation(nn.Module):
    """w -> wp [N, num_layers, w_space_dim], pulled towards the ``w_avg``
    buffer by ``trunc_psi`` in the first ``trunc_layers`` layers."""

    def __init__(self, w_space_dim: int = 512, num_layers: int = 18, repeat_w: bool = True):
        super().__init__()
        self.w_space_dim = w_space_dim
        self.num_layers = num_layers
        self.repeat_w = repeat_w
        self.register_buffer("w_avg", torch.zeros(w_space_dim if repeat_w else num_layers * w_space_dim))

    def forward(self, w: torch.Tensor, trunc_psi: Optional[float] = None,
                trunc_layers: Optional[int] = None) -> torch.Tensor:
        layers, dim = self.num_layers, self.w_space_dim
        wp = w
        if w.dim() == 2:
            if self.repeat_w and w.shape[1] == dim:
                wp = w[:, None, :].expand(-1, layers, -1)
            else:
                wp = w.reshape(-1, layers, dim)
        if wp.dim() != 3 or tuple(wp.shape[1:]) != (layers, dim):
            raise ValueError(f"wp must be [batch, {layers}, {dim}], got {tuple(wp.shape)}")
        trunc_psi = 1.0 if trunc_psi is None else trunc_psi
        trunc_layers = 0 if trunc_layers is None else trunc_layers
        if trunc_psi < 1.0 and trunc_layers > 0:
            idx = torch.arange(layers, device=wp.device)[None, :, None]
            coefs = torch.where(idx < trunc_layers, trunc_psi, 1.0).to(wp.dtype)
            avg = self.w_avg.reshape(1, -1, dim).to(wp.dtype)
            wp = avg + (wp - avg) * coefs
        return wp


def update_w_avg(w_avg: torch.Tensor, w: torch.Tensor, decay: float = 0.995,
                 axis_name=None) -> torch.Tensor:
    """The training-mode w_avg EMA towards the batch mean of ``w``. With
    ``axis_name``, a process group (the counterpart of tpugan's named axis;
    ``parallel.mesh.data_group(mesh)``), the batch mean is the mean of the
    ranks' batch means, as tpugan's ``pmean``."""
    batch_mean = w.mean(dim=0)
    if axis_name is not None:
        if isinstance(axis_name, str):
            raise TypeError("update_w_avg takes a process group (parallel.mesh.data_group(mesh)) where tpugan "
                            f"takes a named axis, not the name {axis_name!r}")
        from tpugan_torch.parallel.mesh import all_sum, group_size

        batch_mean = all_sum(batch_mean, axis_name) / group_size(axis_name)
    return w_avg * decay + batch_mean * (1.0 - decay)


class ModulatedConv(nn.Module):
    """ModulateConvBlock, input-scale/output-demod form; returns (y, style)."""

    def __init__(self, in_channels: int, out_channels: int, resolution: int,
                 w_space_dim: int = 512, kernel_size: int = 3, scale_factor: int = 1,
                 demodulate: bool = True, add_noise: bool = True, activation_type: str = "lrelu",
                 generator=None):
        super().__init__()
        k = kernel_size
        self.resolution = resolution
        self.scale_factor = scale_factor
        self.demodulate = demodulate
        self.add_noise = add_noise
        self.activation_type = activation_type
        self.wscale = 1.0 / math.sqrt(k * k * in_channels)
        self.weight = _normal((out_channels, in_channels, k, k), 1.0, generator)
        self.style = SG2Dense(w_space_dim, in_channels, additional_bias=1.0,
                              activation_type="linear", generator=generator)
        if add_noise:
            self.register_buffer("noise", torch.randn(1, 1, resolution, resolution, generator=generator))
            self.noise_strength = nn.Parameter(torch.zeros(()))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor, w: torch.Tensor,
                randomize_noise: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None):
        weight = self.weight * self.wscale
        style = self.style(w)
        if self.demodulate:
            # the norm over (in, k, k) of the style-scaled weight, in fp32
            w2 = weight.float().square().sum(dim=(2, 3))
            norm = torch.sqrt(style.float().square() @ w2.t() + _EPSILON).to(x.dtype)
        y = _conv(x * style[:, :, None, None], weight, self.scale_factor)
        if self.demodulate:
            y = y / norm[:, :, None, None]
        if self.add_noise:
            if noise is None:
                noise = self.noise
                if randomize_noise is not None:
                    r = self.resolution
                    noise = torch.randn(y.shape[0], 1, r, r, generator=randomize_noise,
                                        device=randomize_noise.device)
            y = y + noise.to(y.dtype) * self.noise_strength
        return _activate(y + self.bias[None, :, None, None], self.activation_type), style


class SG2ConvBlock(nn.Module):
    """Plain wscale conv (the resnet architecture's skip branch)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 add_bias: bool = True, scale_factor: int = 1, activation_type: str = "lrelu",
                 generator=None):
        super().__init__()
        k = kernel_size
        self.scale_factor = scale_factor
        self.activation_type = activation_type
        self.wscale = 1.0 / math.sqrt(k * k * in_channels)
        self.weight = _normal((out_channels, in_channels, k, k), 1.0, generator)
        self.bias = nn.Parameter(torch.zeros(out_channels)) if add_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _conv(x, self.weight * self.wscale, self.scale_factor)
        if self.bias is not None:
            y = y + self.bias[None, :, None, None]
        return _activate(y, self.activation_type)


class SG2Synthesis(nn.Module):
    """wp [N, num_layers, w_space_dim] -> dict(wp, style.., output_style..,
    image [N, C, R, R]), in the ``skip``, ``origin`` or ``resnet``
    architecture, from a 4x4 const. Block resolutions r have
    ``min(fmaps_base // r, fmaps_max)`` channels."""

    def __init__(self, resolution: int = 1024, w_space_dim: int = 512, image_channels: int = 3,
                 architecture: str = "skip", demodulate: bool = True, fmaps_base: int = 32 << 10,
                 fmaps_max: int = 512, generator=None):
        super().__init__()
        if architecture not in ("skip", "origin", "resnet"):
            raise ValueError(f"architecture: {architecture}")
        self.resolution = resolution
        self.init_res = init_res = _INIT_RES
        self.w_space_dim = w_space_dim
        self.architecture = architecture
        self.fmaps_base = fmaps_base
        self.fmaps_max = fmaps_max
        self.num_layers = (int(math.log2(resolution)) - int(math.log2(init_res)) + 1) * 2
        nf = self.get_nf
        self.const = _normal((1, nf(init_res), init_res, init_res), 1.0, generator)

        def conv_layer(idx, res, in_ch, out_ch, up):
            self.add_module(f"layer{idx}", ModulatedConv(
                in_ch, out_ch, res, w_space_dim, scale_factor=2 if up else 1,
                demodulate=demodulate, generator=generator))

        def output_layer(block_idx, res, in_ch):
            self.add_module(f"output{block_idx}", ModulatedConv(
                in_ch, image_channels, res, w_space_dim, kernel_size=1, demodulate=False,
                add_noise=False, activation_type="linear", generator=generator))

        for res, block_idx in self._blocks():
            if res > init_res:
                if architecture == "resnet":
                    self.add_module(f"skip_layer{block_idx - 1}", SG2ConvBlock(
                        nf(res // 2), nf(res), kernel_size=1, add_bias=False, scale_factor=2,
                        activation_type="linear", generator=generator))
                conv_layer(2 * block_idx - 1, res, nf(res // 2), nf(res), True)
            conv_layer(2 * block_idx, res, nf(res), nf(res), False)
            if res == resolution or architecture == "skip":
                output_layer(block_idx, res, nf(res))

    def get_nf(self, res: int) -> int:
        return min(self.fmaps_base // res, self.fmaps_max)

    def _blocks(self):
        """(resolution, block index) from init_res up."""
        init_log2 = int(math.log2(self.init_res))
        return [(2**r, r - init_log2) for r in range(init_log2, int(math.log2(self.resolution)) + 1)]

    def forward(self, wp: torch.Tensor, randomize_noise: Optional[torch.Generator] = None) -> dict:
        if wp.dim() != 3 or tuple(wp.shape[1:]) != (self.num_layers, self.w_space_dim):
            raise ValueError(
                f"wp must be [batch, {self.num_layers}, {self.w_space_dim}], got {tuple(wp.shape)}"
            )
        results = {"wp": wp}
        x = self.const.expand(wp.shape[0], -1, -1, -1)
        image = None
        for res, block_idx in self._blocks():
            idx = 2 * block_idx
            if res > self.init_res:
                if self.architecture == "resnet":
                    residual = getattr(self, f"skip_layer{block_idx - 1}")(x)
                x, results[f"style{idx - 1:02d}"] = getattr(self, f"layer{idx - 1}")(
                    x, wp[:, idx - 1], randomize_noise)
            x, results[f"style{idx:02d}"] = getattr(self, f"layer{idx}")(x, wp[:, idx], randomize_noise)
            if res > self.init_res and self.architecture == "resnet":
                x = (x + residual) / math.sqrt(2.0)
            if res == self.resolution or self.architecture == "skip":
                temp, results[f"output_style{block_idx}"] = getattr(self, f"output{block_idx}")(
                    x, wp[:, idx + 1])
                if image is None or self.architecture != "skip":
                    image = temp
                else:
                    image = temp + upfirdn2d(image, _FIR, up=2, pad=(2, 1), gain=4.0)
        results["image"] = image
        return results


class StyleGAN2Generator(nn.Module):
    """Mapping -> truncation -> synthesis. ``forward(z, trunc_psi,
    trunc_layers, randomize_noise)`` returns the mapping's and the
    synthesis's results (``w``, ``wp``, ``image`` NCHW, the styles);
    ``synthesize(wp)`` runs the synthesis alone. The training-mode w_avg
    EMA is :func:`update_w_avg`."""

    def __init__(self, resolution: int = 1024, z_space_dim: int = 512, w_space_dim: int = 512,
                 mapping_layers: int = 8, mapping_fmaps: int = 512, mapping_lr_mul: float = 0.01,
                 repeat_w: bool = True, image_channels: int = 3, architecture: str = "skip",
                 demodulate: bool = True, fmaps_base: int = 32 << 10, fmaps_max: int = 512,
                 generator=None):
        super().__init__()
        self.num_layers = int(math.log2(resolution // _INIT_RES * 2)) * 2
        self.mapping = SG2Mapping(
            z_space_dim, mapping_fmaps, w_space_dim if repeat_w else w_space_dim * self.num_layers,
            mapping_layers, lr_mul=mapping_lr_mul, generator=generator,
        )
        self.truncation = SG2Truncation(w_space_dim, self.num_layers, repeat_w)
        self.synthesis = SG2Synthesis(
            resolution, w_space_dim=w_space_dim, image_channels=image_channels,
            architecture=architecture, demodulate=demodulate, fmaps_base=fmaps_base,
            fmaps_max=fmaps_max, generator=generator,
        )

    def forward(self, z: torch.Tensor, trunc_psi: Optional[float] = None,
                trunc_layers: Optional[int] = None,
                randomize_noise: Optional[torch.Generator] = None) -> dict:
        mapping = self.mapping(z)
        wp = self.truncation(mapping["w"], trunc_psi, trunc_layers)
        return {**mapping, **self.synthesis(wp, randomize_noise)}

    def synthesize(self, wp: torch.Tensor, randomize_noise: Optional[torch.Generator] = None) -> dict:
        """Run synthesis only (the reference's ``generator.synthesis(w2)``)."""
        return self.synthesis(wp, randomize_noise)
