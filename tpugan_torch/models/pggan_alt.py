"""The Pro-GAN alternative PGGAN stack, NCHW (counterpart of
``tpugan/models/pggan_alt.py``; the reference's
model/pggan/utils/{CustomLayers, Networks, Encoder}.py, pro_gan_pytorch's
stack, kept in the reference but unused by its main scripts):

* equalized conv and transposed conv (a run-time sqrt(2 / fan_in) scale on
  N(0, 1) weights, zero biases);
* ``GenInitialBlock``, ``GenGeneralConvBlock``, ``DisGeneralConvBlock``,
  ``DisFinalBlock`` and ``ConDisFinalBlock`` (the projection
  discriminator's);
* ``ProGANGenerator`` and ``ProGANDiscriminator`` (``conditional``) with
  progressive ``depth``/``height`` and ``alpha`` fade-in;
* ``ProGANEncoder`` (the discriminator's ladder with a 4x4 conv head to the
  latent code) and ``SmallEncoder``.

Module and parameter names are tpugan's, so its variables load through the
bridge. Only the levels that ``depth``/``height`` reach run. None of these
runs a TPU kernel.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpugan_torch.ops.basic import downscale2d, leaky_relu, pixel_norm, upscale2d


class EqlConv(nn.Module):
    """_equalized_conv2d (CustomLayers.py:8-38): ``weight`` OIHW, N(0, 1),
    scaled by sqrt(2) / sqrt(k * k * in) at run time; zero bias."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3, stride: int = 1,
                 padding: int = 0, use_bias: bool = True, generator: torch.Generator | None = None):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.scale = math.sqrt(2.0) / math.sqrt(kernel_size * kernel_size * in_channels)
        self.weight = nn.Parameter(torch.empty(features, in_channels, kernel_size, kernel_size))
        nn.init.normal_(self.weight, std=1.0, generator=generator)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight * self.scale, self.bias, stride=self.stride, padding=self.padding)


class EqlDeconv(nn.Module):
    """_equalized_deconv2d (CustomLayers.py:40-77): ``weight`` ``[in, out,
    k, k]``, the layout of ``F.conv_transpose2d`` (tpugan keeps HWIO and
    flips the taps into a dilated conv, which is the same product), scaled
    by sqrt(2) / sqrt(in)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 4, stride: int = 1,
                 padding: int = 0, use_bias: bool = True, generator: torch.Generator | None = None):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.scale = math.sqrt(2.0) / math.sqrt(in_channels)
        self.weight = nn.Parameter(torch.empty(in_channels, features, kernel_size, kernel_size))
        nn.init.normal_(self.weight, std=1.0, generator=generator)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.weight * self.scale, self.bias, stride=self.stride,
                                  padding=self.padding)


def _lecun_normal(layer: nn.Module, generator: torch.Generator | None) -> nn.Module:
    """A plain conv's or dense layer's weight drawn N(0, 1 / fan_in) (flax's
    lecun_normal without its truncation), its bias zero."""
    fan_in = layer.weight[0].numel()
    nn.init.normal_(layer.weight, std=1.0 / math.sqrt(fan_in), generator=generator)
    if layer.bias is not None:
        nn.init.zeros_(layer.bias)
    return layer


def _mb_stddev(x: torch.Tensor, alpha: float = 1e-8) -> torch.Tensor:
    """MinibatchStdDev (CustomLayers.py:203-225): the batch's stddev
    averaged to one scalar, appended as a channel."""
    n, _, h, w = x.shape
    y = x - x.mean(dim=0, keepdim=True)
    y = torch.sqrt(y.square().mean(dim=0) + alpha).mean()
    return torch.cat([x, y.expand(n, 1, h, w)], dim=1)


class GenInitialBlock(nn.Module):
    """z [N, latent] as a 1x1 image -> 4x4 deconv -> 3x3 conv, each with
    lrelu, then the pixel norm."""

    def __init__(self, latent: int, features: int, generator: torch.Generator | None = None):
        super().__init__()
        self.conv_1 = EqlDeconv(latent, features, 4, generator=generator)
        self.conv_2 = EqlConv(features, features, 3, padding=1, generator=generator)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        y = leaky_relu(self.conv_1(z[:, :, None, None]), 0.2)
        return pixel_norm(leaky_relu(self.conv_2(y), 0.2))


class GenGeneralConvBlock(nn.Module):
    """Nearest up-sampling, then two 3x3 convs, each lrelu then pixel norm."""

    def __init__(self, in_channels: int, features: int, generator: torch.Generator | None = None):
        super().__init__()
        self.conv_1 = EqlConv(in_channels, features, 3, padding=1, generator=generator)
        self.conv_2 = EqlConv(features, features, 3, padding=1, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = pixel_norm(leaky_relu(self.conv_1(upscale2d(x)), 0.2))
        return pixel_norm(leaky_relu(self.conv_2(y), 0.2))


class DisGeneralConvBlock(nn.Module):
    """Two 3x3 convs with lrelu, then average-pool down-sampling."""

    def __init__(self, in_channels: int, mid_features: int, out_features: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.conv_1 = EqlConv(in_channels, mid_features, 3, padding=1, generator=generator)
        self.conv_2 = EqlConv(mid_features, out_features, 3, padding=1, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = leaky_relu(self.conv_1(x), 0.2)
        return downscale2d(leaky_relu(self.conv_2(y), 0.2))


class DisFinalBlock(nn.Module):
    """Minibatch-std channel, 3x3 conv, 4x4 conv (to 1x1), 1x1 conv to the
    score [N]."""

    def __init__(self, features: int, generator: torch.Generator | None = None):
        super().__init__()
        self.conv_1 = EqlConv(features + 1, features, 3, padding=1, generator=generator)
        self.conv_2 = EqlConv(features, features, 4, generator=generator)
        self.conv_3 = EqlConv(features, 1, 1, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = leaky_relu(self.conv_1(_mb_stddev(x)), 0.2)
        y = leaky_relu(self.conv_2(y), 0.2)
        return self.conv_3(y).reshape(-1)


class LabelEmbedder(nn.Module):
    """A class's embedding row, ``embedding`` ``[classes, features]``,
    renormalised to at most unit norm in the forward. The weight is left as
    it is: ``nn.Embedding(max_norm=1)`` would rewrite its rows in place,
    which tpugan does not."""

    def __init__(self, num_classes: int, features: int, generator: torch.Generator | None = None):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num_classes, features))
        nn.init.normal_(self.embedding, std=1.0, generator=generator)

    def forward(self, labels: torch.Tensor) -> torch.Tensor:
        emb = F.embedding(labels, self.embedding)
        return emb / torch.clamp(torch.linalg.vector_norm(emb, dim=-1, keepdim=True), min=1.0)


class ConDisFinalBlock(nn.Module):
    """The projection discriminator's final block (CustomLayers.py:297-348):
    the score of :class:`DisFinalBlock`'s convs (with lrelu on the last)
    plus the projection of the 1x1 features on the label's embedding."""

    def __init__(self, features: int, num_classes: int, generator: torch.Generator | None = None):
        super().__init__()
        self.conv_1 = EqlConv(features + 1, features, 3, padding=1, generator=generator)
        self.conv_2 = EqlConv(features, features, 4, generator=generator)
        self.conv_3 = EqlConv(features, 1, 1, generator=generator)
        self.label_embedder = LabelEmbedder(num_classes, features, generator=generator)

    def forward(self, x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        y = leaky_relu(self.conv_1(_mb_stddev(x)), 0.2)
        y = leaky_relu(self.conv_2(y), 0.2)
        projection = (y.reshape(y.shape[0], -1) * self.label_embedder(labels)).sum(dim=-1)
        return leaky_relu(self.conv_3(y), 0.2).reshape(-1) + projection


def _check_level(level: int, levels: int, name: str) -> None:
    if not 0 <= level < levels:
        raise ValueError(f"{name} must be in [0, {levels}), got {level}")


class ProGANGenerator(nn.Module):
    """Networks.Generator (:11-80): z [N, latent] -> RGB [N, 3, 4 * 2^depth,
    4 * 2^depth] with the fade-in from the previous level's ToRGB on the
    up-sampled features at ``alpha`` < 1."""

    def __init__(self, depth: int = 7, latent_size: int = 512, generator: torch.Generator | None = None):
        super().__init__()
        self.depth = depth
        self.initial_block = GenInitialBlock(latent_size, latent_size, generator=generator)
        channels = [latent_size]
        for i in range(depth - 1):
            out = latent_size if i <= 2 else latent_size // (2 ** (i - 2))
            self.add_module(f"layer_{i}", GenGeneralConvBlock(channels[-1], out, generator=generator))
            channels.append(out)
        for i, c in enumerate(channels):
            self.add_module(f"rgb_{i}", EqlConv(c, 3, 1, generator=generator))

    def forward(self, z: torch.Tensor, depth: Optional[int] = None, alpha: float = 1.0) -> torch.Tensor:
        depth = self.depth - 1 if depth is None else depth
        _check_level(depth, self.depth, "depth")
        feats = [self.initial_block(z)]
        for i in range(depth):
            feats.append(getattr(self, f"layer_{i}")(feats[-1]))
        if depth == 0:
            return self.rgb_0(feats[0])
        residual = getattr(self, f"rgb_{depth - 1}")(upscale2d(feats[depth - 1]))
        return alpha * getattr(self, f"rgb_{depth}")(feats[depth]) + (1 - alpha) * residual


class _DisLadder(nn.Module):
    """The discriminator's and the encoder's ladder (Networks.py:104-168): a
    FromRGB head per level (``from_rgb_j``) and the conv blocks
    (``layer_i``) from a 4 * 2^height image down to 4x4, with the fade-in
    from the previous level's head on the down-sampled image at ``alpha``
    < 1."""

    def __init__(self, max_height: int, feature_size: int, generator: torch.Generator | None = None):
        super().__init__()
        self.max_height = max_height

        def rch(j):  # head j feeds layer j-1, whose input is feature_size // 2^(j-3) once j > 3
            return feature_size if j <= 3 else feature_size // (2 ** (j - 3))

        for j in range(max_height):
            self.add_module(f"from_rgb_{j}", EqlConv(3, rch(j), 1, generator=generator))
        for i in range(max_height - 1):
            if i > 2:
                block = DisGeneralConvBlock(rch(i + 1), feature_size // (2 ** (i - 2)),
                                            feature_size // (2 ** (i - 3)), generator=generator)
            else:
                block = DisGeneralConvBlock(rch(i + 1), feature_size, feature_size, generator=generator)
            self.add_module(f"layer_{i}", block)

    def ladder(self, x: torch.Tensor, height: int, alpha: float) -> torch.Tensor:
        if height == 0:
            return self.from_rgb_0(x)
        residual = getattr(self, f"from_rgb_{height - 1}")(downscale2d(x))
        straight = getattr(self, f"layer_{height - 1}")(getattr(self, f"from_rgb_{height}")(x))
        y = alpha * straight + (1 - alpha) * residual
        for i in reversed(range(height - 1)):
            y = getattr(self, f"layer_{i}")(y)
        return y


class ProGANDiscriminator(_DisLadder):
    """Networks.Discriminator (:83-168): image [N, 3, 4 * 2^height, ...] ->
    score [N]; ``conditional`` takes the projection discriminator's final
    block and ``labels`` [N]."""

    def __init__(self, height: int = 7, feature_size: int = 512, conditional: bool = False, num_classes: int = 0,
                 generator: torch.Generator | None = None):
        super().__init__(height, feature_size, generator=generator)
        self.conditional = conditional
        self.final_block = (ConDisFinalBlock(feature_size, num_classes, generator=generator) if conditional
                            else DisFinalBlock(feature_size, generator=generator))

    def forward(self, x: torch.Tensor, height: Optional[int] = None, alpha: float = 1.0,
                labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        height = self.max_height - 1 if height is None else height
        _check_level(height, self.max_height, "height")
        y = self.ladder(x, height, alpha)
        return self.final_block(y, labels) if self.conditional else self.final_block(y)


class ProGANEncoder(_DisLadder):
    """Encoder.encoder (Encoder.py:11-86): the discriminator's ladder with a
    plain 4x4 conv (``new_final``) to the code [N, feature_size]."""

    def __init__(self, height: int = 7, feature_size: int = 512, generator: torch.Generator | None = None):
        super().__init__(height, feature_size, generator=generator)
        self.feature_size = feature_size
        self.new_final = _lecun_normal(nn.Conv2d(feature_size, feature_size, 4), generator)

    def forward(self, x: torch.Tensor, depth: Optional[int] = None, alpha: float = 1.0) -> torch.Tensor:
        depth = self.max_height - 1 if depth is None else depth
        _check_level(depth, self.max_height, "depth")
        z = self.new_final(self.ladder(x, depth, alpha))
        return z.reshape(z.shape[0], self.feature_size)


class FrozenBatchNorm(nn.Module):
    """BatchNorm on its running statistics (flax's ``use_running_average``):
    ``scale`` and ``bias`` parameters, ``mean`` and ``var`` buffers, eps
    1e-5 (flax's default)."""

    def __init__(self, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.mean, self.var, self.scale, self.bias, training=False, eps=1e-5)


class SmallEncoder(nn.Module):
    """encoder_small (Encoder.py:88-106): four stride-2 4x4 convs from an
    ``img_size`` image (1024 in the reference) to one channel, then a dense
    layer to z [N, 512]."""

    def __init__(self, img_size: int = 1024, generator: torch.Generator | None = None):
        super().__init__()

        def conv(cin, cout):
            return _lecun_normal(nn.Conv2d(cin, cout, 4, stride=2, padding=1, bias=False), generator)

        self.conv_0 = conv(3, 12)
        self.conv_1 = conv(12, 12)
        self.bn_1 = FrozenBatchNorm(12)
        self.conv_2 = conv(12, 3)
        self.bn_2 = FrozenBatchNorm(3)
        self.conv_3 = conv(3, 1)
        self.fc = _lecun_normal(nn.Linear((img_size // 16) ** 2, 512), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = leaky_relu(self.conv_0(x), 0.2)
        y = leaky_relu(self.bn_1(self.conv_1(y)), 0.2)
        y = leaky_relu(self.bn_2(self.conv_2(y)), 0.2)
        y = self.conv_3(y)  # one channel: the NCHW and NHWC flattens agree
        return self.fc(y.reshape(y.shape[0], -1))
