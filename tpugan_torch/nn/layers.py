"""Equalized-learning-rate layers on NCHW tensors (counterpart of
``tpugan/nn/layers.py``).

"Implicit lreq": weights are initialised and stored at their working scale
(std = gain / sqrt(fan_in)), so the forward is a plain linear map or conv
with no runtime scaling, even for ``lrmul != 1``. Each layer records its
equalization coefficients as ``weight_coef`` and ``bias_coef`` (the
``kernel_coef`` and ``bias_coef`` of ``tpugan``'s ``lreq`` collection) for
the optimizer; see :func:`tpugan_torch.ops.eq_lr.lreq_coefs`.
:func:`plain_conv` and :func:`plain_linear` make the plain layers that
``tpugan`` writes as flax ``nn.Conv`` / ``nn.Dense``, with flax's init.

Parameters are made on the CPU from an optional :class:`torch.Generator`;
move the finished model with ``.to(device)``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from tpugan_torch.ops.eq_lr import eq_lr_std, transform_kernel_2d


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
    """flax's default kernel init in place: a normal of variance 1/fan_in
    truncated at two standard deviations (fan_in = all dims but the first,
    the output dim, of a torch weight)."""
    fan_in = weight[0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978  # the truncation's std correction
    return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def plain_conv(cin: int, cout: int, k: int, bias: bool = True,
               generator: torch.Generator | None = None) -> nn.Conv2d:
    """A same-padded ``nn.Conv2d`` with flax's default init (lecun-normal
    weight, zero bias), for the layers ``tpugan`` writes as ``nn.Conv``."""
    conv = nn.Conv2d(cin, cout, k, padding=k // 2, bias=bias)
    with torch.no_grad():
        lecun_normal_(conv.weight, generator)
        if bias:
            conv.bias.zero_()
    return conv


def plain_linear(cin: int, cout: int, bias: bool = True,
                 generator: torch.Generator | None = None) -> nn.Linear:
    """An ``nn.Linear`` with flax's default init, for ``tpugan``'s ``nn.Dense``."""
    lin = nn.Linear(cin, cout, bias=bias)
    with torch.no_grad():
        lecun_normal_(lin.weight, generator)
        if bias:
            lin.bias.zero_()
    return lin


class EqLinear(nn.Module):
    """Dense layer with equalized LR; weight [out, in] (``F.linear``)."""

    def __init__(self, in_features: int, out_features: int, use_bias: bool = True,
                 gain: float = math.sqrt(2.0), lrmul: float = 1.0,
                 generator: torch.Generator | None = None):
        super().__init__()
        std = eq_lr_std(in_features, gain, lrmul)
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        nn.init.normal_(self.weight, std=std / lrmul, generator=generator)
        self.weight_coef = std
        self.bias = None
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(out_features))
            self.bias_coef = lrmul

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


class EqConv(nn.Module):
    """2-D (transposed) convolution with equalized LR, NCHW.

    fan_in = k*k*in; ``transform_kernel`` applies the 4-tap smoothing of
    fused-scale resampling (averaged for forward convs, summed for
    transposed ones). Weights are OIHW ``[out, in, k, k]`` for a forward
    conv and ``[in, out, k, k]`` for a transposed one, which then runs as
    ``F.conv_transpose2d`` on the unflipped (transformed) kernel.
    """

    def __init__(self, in_features: int, out_features: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 0, use_bias: bool = True,
                 gain: float = math.sqrt(2.0), lrmul: float = 1.0,
                 transpose: bool = False, transform_kernel: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.stride = stride
        self.padding = padding
        self.transpose = transpose
        self.transform_kernel = transform_kernel
        std = eq_lr_std(kernel_size * kernel_size * in_features, gain, lrmul)
        shape = (in_features, out_features) if transpose else (out_features, in_features)
        self.weight = nn.Parameter(torch.empty(*shape, kernel_size, kernel_size))
        nn.init.normal_(self.weight, std=std / lrmul, generator=generator)
        self.weight_coef = std
        self.bias = None
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(out_features))
            self.bias_coef = lrmul

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        if self.transform_kernel:
            w = transform_kernel_2d(w, average=not self.transpose)
        if self.transpose:
            return F.conv_transpose2d(x, w, self.bias, stride=self.stride, padding=self.padding)
        return F.conv2d(x, w, self.bias, stride=self.stride, padding=self.padding)
