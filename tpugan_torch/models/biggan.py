"""BigGAN-deep generator, NCHW (counterpart of ``tpugan/models/biggan.py``).

Submodules and parameters carry ``tpugan``'s names (``generator.layers_8``,
``snconv1x1_theta``, ``bn_0.scale``, ...), so ``io/bridge.py`` maps its
``params`` and ``buffers`` collections onto these modules name for name.
Spectral norm is folded into the frozen generator's weights, as in
``tpugan``, so its convs and linears are plain. ``truncation`` is a Python
float: the batch norms pick their running statistics with Python
arithmetic. The SAGAN attention of :class:`SelfAttn` runs the hand-written
kernel on a CUDA tensor.

Parameters are made on the CPU from an optional :class:`torch.Generator`
with flax's defaults (lecun-normal kernels, zero biases, ``gamma`` 0,
running means 0 and variances 1); move the finished model with
``.to(device)``.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tpugan_torch.nn.layers import plain_conv, plain_linear
from tpugan_torch.nn.spectral import SNDense
from tpugan_torch.ops.attention import sagan_attention
from tpugan_torch.ops.basic import upscale2d


@dataclasses.dataclass
class BigGANConfig:
    """The reference JSON config's schema. ``layers`` tuples are
    (up_sample?, in_mul, out_mul)."""

    output_dim: int = 128
    z_dim: int = 128
    class_embed_dim: int = 128
    channel_width: int = 128
    num_classes: int = 1000
    layers: List[Tuple[bool, int, int]] = dataclasses.field(
        default_factory=lambda: [
            (False, 16, 16), (True, 16, 16), (False, 16, 16), (True, 16, 8),
            (False, 8, 8), (True, 8, 4), (False, 4, 4), (True, 4, 2),
            (False, 2, 2), (True, 2, 1),
        ]
    )
    attention_layer_position: int = 8
    eps: float = 1e-4
    n_stats: int = 51

    @classmethod
    def from_json_file(cls, path) -> "BigGANConfig":
        with open(path, "r", encoding="utf-8") as f:
            d = json.load(f)
        cfg = cls()
        for k, v in d.items():
            if k == "layers":
                v = [tuple(t) for t in v]
            setattr(cfg, k, v)
        return cfg

    def to_json_string(self) -> str:
        d = dataclasses.asdict(self)
        d["layers"] = [list(t) for t in d["layers"]]
        return json.dumps(d, indent=2, sort_keys=True) + "\n"

    @classmethod
    def for_resolution(cls, output_dim: int, **kw) -> "BigGANConfig":
        """The layer layouts of the three biggan-deep zoo checkpoints (128,
        the dataclass default; 256; 512)."""
        layouts = {
            128: [(False, 16, 16), (True, 16, 16), (False, 16, 16), (True, 16, 8),
                  (False, 8, 8), (True, 8, 4), (False, 4, 4), (True, 4, 2),
                  (False, 2, 2), (True, 2, 1)],
            256: [(False, 16, 16), (True, 16, 16), (False, 16, 16), (True, 16, 8),
                  (False, 8, 8), (True, 8, 8), (False, 8, 8), (True, 8, 4),
                  (False, 4, 4), (True, 4, 2), (False, 2, 2), (True, 2, 1)],
            512: [(False, 16, 16), (True, 16, 16), (False, 16, 16), (True, 16, 8),
                  (False, 8, 8), (True, 8, 8), (False, 8, 8), (True, 8, 4),
                  (False, 4, 4), (True, 4, 2), (False, 2, 2), (True, 2, 1),
                  (False, 1, 1), (True, 1, 1)],
        }
        if output_dim not in layouts:
            raise ValueError(
                f"no biggan-deep zoo layout for {output_dim}; pass --config_dir "
                "with the checkpoint's JSON config (choices: 128/256/512)"
            )
        return cls(output_dim=output_dim, layers=layouts[output_dim], **kw)


def _nchw_rows(x: torch.Tensor) -> torch.Tensor:
    """[N, C, H, W] -> contiguous [N, H*W, C], rows in (h, w) row-major
    order, as ``tpugan``'s NHWC reshape gives them."""
    n, c = x.shape[:2]
    return x.permute(0, 2, 3, 1).reshape(n, -1, c).contiguous()


class SelfAttn(nn.Module):
    """SAGAN self-attention: bias-free 1x1 theta / phi / g convs, 2x2 max
    pool on phi and g, ``softmax(theta phi^T) g`` over the (h*w) x (h*w/4)
    scores, the 1x1 ``o`` conv and a ``gamma``-gated residual."""

    def __init__(self, in_channels: int, generator=None):
        super().__init__()
        ch = in_channels
        self.snconv1x1_theta = plain_conv(ch, ch // 8, 1, bias=False, generator=generator)
        self.snconv1x1_phi = plain_conv(ch, ch // 8, 1, bias=False, generator=generator)
        self.snconv1x1_g = plain_conv(ch, ch // 2, 1, bias=False, generator=generator)
        self.snconv1x1_o_conv = plain_conv(ch // 2, ch, 1, bias=False, generator=generator)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        n, _, h, w = x.shape
        theta = _nchw_rows(self.snconv1x1_theta(x))
        phi = _nchw_rows(F.max_pool2d(self.snconv1x1_phi(x), 2))
        g = _nchw_rows(F.max_pool2d(self.snconv1x1_g(x), 2))
        attn_g = sagan_attention(theta, phi, g)  # [N, H*W, C/2]
        attn_g = attn_g.reshape(n, h, w, -1).permute(0, 3, 1, 2)
        return x + self.gamma * self.snconv1x1_o_conv(attn_g)


class BigGANBatchNorm(nn.Module):
    """Batch norm with truncation-interpolated running statistics
    (buffers ``running_means``, ``running_vars`` [n_stats, C]); conditional
    (``scale``/``offset`` linears of the condition vector, spectral-normalised
    with ``sn=True``) or unconditional (``weight``/``bias`` params)."""

    def __init__(self, num_features: int, condition_vector_dim: Optional[int] = None,
                 n_stats: int = 51, eps: float = 1e-4, conditional: bool = True,
                 sn: bool = False, generator=None):
        super().__init__()
        self.n_stats = n_stats
        self.eps = eps
        self.conditional = conditional
        self.register_buffer("running_means", torch.zeros(n_stats, num_features))
        self.register_buffer("running_vars", torch.ones(n_stats, num_features))
        if conditional:
            if condition_vector_dim is None:
                raise ValueError("a conditional BigGANBatchNorm needs condition_vector_dim")
            if sn:
                dense = lambda: SNDense(condition_vector_dim, num_features, use_bias=False,
                                        generator=generator)
            else:
                dense = lambda: plain_linear(condition_vector_dim, num_features, bias=False,
                                             generator=generator)
            self.scale = dense()
            self.offset = dense()
        else:
            self.weight = nn.Parameter(torch.ones(num_features))
            self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x, truncation: float, condition_vector=None):
        step_size = 1.0 / (self.n_stats - 1)
        coef, start_idx = math.modf(truncation / step_size)
        start_idx = int(start_idx)
        rm, rv = self.running_means, self.running_vars
        if coef != 0.0:  # the reference's (reversed-looking) interpolation
            mean = rm[start_idx] * coef + rm[start_idx + 1] * (1 - coef)
            var = rv[start_idx] * coef + rv[start_idx + 1] * (1 - coef)
        else:
            mean, var = rm[start_idx], rv[start_idx]
        mean = mean.to(x.dtype)[None, :, None, None]
        var = var.to(x.dtype)[None, :, None, None]
        if self.conditional:
            if condition_vector is None:
                raise ValueError("a conditional BigGANBatchNorm needs a condition vector")
            weight = 1.0 + self.scale(condition_vector)[:, :, None, None]
            bias = self.offset(condition_vector)[:, :, None, None]
        else:
            weight = self.weight[None, :, None, None]
            bias = self.bias[None, :, None, None]
        return (x - mean) / torch.sqrt(var + self.eps) * weight + bias


class GenBlock(nn.Module):
    """Bottleneck block (reduction 4): four BN -> ReLU -> conv stages, an
    optional 2x nearest upsample, and a residual that drops the upper half
    of its channels when the width changes."""

    def __init__(self, in_size: int, out_size: int, condition_vector_dim: int,
                 reduction_factor: int = 4, up_sample: bool = False, n_stats: int = 51,
                 eps: float = 1e-4, generator=None):
        super().__init__()
        middle = in_size // reduction_factor
        self.in_size, self.out_size, self.up_sample = in_size, out_size, up_sample

        def bn(features):
            return BigGANBatchNorm(features, condition_vector_dim, n_stats=n_stats, eps=eps,
                                   conditional=True, generator=generator)

        self.bn_0 = bn(in_size)
        self.conv_0 = plain_conv(in_size, middle, 1, generator=generator)
        self.bn_1 = bn(middle)
        self.conv_1 = plain_conv(middle, middle, 3, generator=generator)
        self.bn_2 = bn(middle)
        self.conv_2 = plain_conv(middle, middle, 3, generator=generator)
        self.bn_3 = bn(middle)
        self.conv_3 = plain_conv(middle, out_size, 1, generator=generator)

    def forward(self, x, cond_vector, truncation: float):
        x0 = x
        x = self.conv_0(F.relu(self.bn_0(x, truncation, cond_vector)))
        x = F.relu(self.bn_1(x, truncation, cond_vector))
        if self.up_sample:
            x = upscale2d(x)
        x = self.conv_1(x)
        x = self.conv_2(F.relu(self.bn_2(x, truncation, cond_vector)))
        x = self.conv_3(F.relu(self.bn_3(x, truncation, cond_vector)))
        if self.in_size != self.out_size:
            x0 = x0[:, : x0.shape[1] // 2]
        if self.up_sample:
            x0 = upscale2d(x0)
        return x + x0


class BigGANGenerator(nn.Module):
    """cond_vector [N, 2*z_dim] -> image [N, 3, R, R] in [-1, 1].

    Submodules are ``layers_{idx}`` as flax numbers them: the ``SelfAttn``
    takes an index of its own, so the blocks after it shift by one."""

    def __init__(self, config: BigGANConfig, generator=None):
        super().__init__()
        cfg = self.config = config
        ch = cfg.channel_width
        cvd = cfg.z_dim * 2
        self.gen_z = plain_linear(cvd, 4 * 4 * 16 * ch, generator=generator)
        idx = 0
        for i, (up, in_mul, out_mul) in enumerate(cfg.layers):
            if i == cfg.attention_layer_position:
                self.add_module(f"layers_{idx}", SelfAttn(ch * in_mul, generator=generator))
                idx += 1
            self.add_module(f"layers_{idx}", GenBlock(
                ch * in_mul, ch * out_mul, cvd, up_sample=up, n_stats=cfg.n_stats,
                eps=cfg.eps, generator=generator,
            ))
            idx += 1
        self.num_layers = idx
        self.bn = BigGANBatchNorm(ch, n_stats=cfg.n_stats, eps=cfg.eps, conditional=False)
        self.conv_to_rgb = plain_conv(ch, ch, 3, generator=generator)

    def forward(self, cond_vector, truncation: float):
        ch = self.config.channel_width
        # tpugan reshapes NHWC (-1, 4, 4, 16 ch); the same order, then NCHW
        x = self.gen_z(cond_vector).reshape(-1, 4, 4, 16 * ch).permute(0, 3, 1, 2)
        for idx in range(self.num_layers):
            layer = getattr(self, f"layers_{idx}")
            if isinstance(layer, SelfAttn):
                x = layer(x)
            else:
                x = layer(x, cond_vector, truncation)
        x = F.relu(self.bn(x, truncation))
        x = self.conv_to_rgb(x)[:, :3]
        return torch.tanh(x)


class BigGAN(nn.Module):
    """Class embedding (no bias) + generator:
    ``forward(z [N, z_dim], class_label one-hot [N, num_classes],
    truncation) -> (image [N, 3, R, R], cond_vector [N, 2*z_dim])``."""

    def __init__(self, config: BigGANConfig, generator=None):
        super().__init__()
        self.config = config
        self.embeddings = plain_linear(config.num_classes, config.z_dim, bias=False, generator=generator)
        self.generator = BigGANGenerator(config, generator=generator)

    def forward(self, z, class_label, truncation: float):
        if not 0 < truncation <= 1:
            raise ValueError(f"truncation must be in (0, 1], got {truncation}")
        embed = self.embeddings(class_label.to(z.dtype))
        cond_vector = torch.cat([z, embed], dim=1)
        return self.generator(cond_vector, truncation), cond_vector
