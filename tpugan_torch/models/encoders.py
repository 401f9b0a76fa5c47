"""The trainable encoders, NCHW (counterpart of
``tpugan/models/encoders.py``: ``EncoderBlock`` (its v2 and v1 forwards),
``Encoder``, ``PGEncoderBlock``, ``PGEncoder``, ``BigGANEncoderBlock`` and
``BigGANEncoder``).

``use_blur=False`` is case 1 (E.py); ``use_blur=True`` is case 2 (E_Blur.py),
which blurs before the downsampling conv and fuses that conv (stride 2,
transformed kernel) while the 1024-based resolution ladder is at 128 or
more. Each block reads the per-channel (mean, std) of its input and of its
first conv's output as style codes, and the per-block (w2, w1) pairs come
out deepest-first so ``w[:, 2i]`` and ``w[:, 2i+1]`` line up with generator
layer i. Noise is an explicit argument, as in the generator. The ablation
encoders (model/E/Ablation_Study) are flags of the same classes: E_Blur_W
(no noise), E_Blur_W_2 (one w per block), E_Blur_Z (a z head only), E_v2_std
and E_v1. tpugan's space-to-depth forward (``_s2d_forward``) computes the
dense forward's function in a layout for TPU lanes; the dense forward is its
counterpart.

E_PG (:class:`PGEncoder`, PGGAN's encoder) has no style heads: instance
norm before each conv, noise, an affine instance-normed 1x1 residual and a
2x average-pool after each block, then z from the flattened 4x4 features.

E_BIG (:class:`BigGANEncoder`) conditions every block on BigGAN's condition
vector through spectral-normalised batch norms and ends in two heads, the
condition vector and z.

Every encoder's ``forward`` takes ``space``, a space group whose ranks each
hold equal shares of the images' rows (``parallel/spatial.py``): the 3x3
convolutions take halos, instance norm and the style statistics sum over
the group, 1x1 convolutions, noise, the average pools and E_BIG's batch
norms (stored statistics, a per-image condition) are local; from the first
block whose input is too thin to shard (``runs_on_rows``) the rows are
gathered and the rest runs whole, and the outputs come out whole on every
rank.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from tpugan_torch.models.biggan import BigGANBatchNorm
from tpugan_torch.nn.layers import EqConv, EqLinear, plain_conv
from tpugan_torch.ops.basic import (
    downscale2d,
    leaky_relu,
    noise_inject,
)
from tpugan_torch.parallel.spatial import RowOps, runs_on_rows


def _stats(y: torch.Tensor, style_stats: str = "meanstd", ops: RowOps = RowOps()) -> torch.Tensor:
    mean, std = ops.moments(y)
    if style_stats == "std":
        # E_v2_std reads torch's x.std((2, 3)): unbiased, unlike E.py's
        nhw = ops.total(y) * y.shape[3]
        return std * math.sqrt(nhw / max(nhw - 1, 1))
    return torch.cat([mean, std], dim=1)


class EncoderBlock(nn.Module):
    """BEBlock: style stats -> w pair, IN -> conv -> noise -> bias -> lrelu
    twice, downsample, 0.111/0.889 residual mix.

    The ablation encoders are flags: ``use_noise=False`` has no noise
    weights and injects none; ``style_mode="single"`` emits the post-conv w2
    in both slots (E_Blur_W_2.py:130), ``"none"`` has no style heads;
    ``style_stats="std"`` feeds the heads the unbiased std alone (E_v2_std);
    ``block_version=1`` is E_v1's block (conv before IN, a resnet residual
    through conv_3 and an affine IN, no 0.111 mix; its noise weights exist
    whatever ``use_noise``, and it neither blurs nor fuses)."""

    def __init__(self, in_features: int, out_features: int, latent_size: int = 512,
                 has_last_conv: bool = True, fused_scale: bool = False,
                 use_blur: bool = False, use_noise: bool = True, style_mode: str = "dual",
                 style_stats: str = "meanstd", block_version: int = 2, generator=None):
        super().__init__()
        cin, cout = in_features, out_features
        self.has_last_conv = has_last_conv
        self.fused_scale = fused_scale
        self.use_blur = use_blur
        self.use_noise = use_noise
        self.style_mode = style_mode
        self.style_stats = style_stats
        self.block_version = block_version
        v1 = block_version == 1
        heads = v1 or style_mode != "none"
        stats_width = cin if style_stats == "std" and not v1 else 2 * cin
        noise = v1 or use_noise
        if heads:
            self.inver_mod1 = EqLinear(stats_width, latent_size, gain=1.0, generator=generator)
        self.conv_1 = EqConv(cin, cin, 3, padding=1, use_bias=False, generator=generator)
        if noise:
            self.noise_weight_1 = nn.Parameter(torch.zeros(cin))
        self.bias_1 = nn.Parameter(torch.zeros(cin))
        if heads:
            self.inver_mod2 = EqLinear(stats_width, latent_size, gain=1.0, generator=generator)
        self.conv_3 = None
        if has_last_conv:
            if fused_scale and not v1:
                self.conv_2 = EqConv(cin, cout, 3, stride=2, padding=1, use_bias=False,
                                     transform_kernel=True, generator=generator)
            else:
                self.conv_2 = EqConv(cin, cout, 3, padding=1, use_bias=False, generator=generator)
            if noise:
                self.noise_weight_2 = nn.Parameter(torch.zeros(cout))
            self.bias_2 = nn.Parameter(torch.zeros(cout))
        if cin != cout and (has_last_conv or not v1):
            self.conv_3 = EqConv(cin, cout, 1, generator=generator)
            if v1:
                self.in3_scale = nn.Parameter(torch.ones(cout))
                self.in3_bias = nn.Parameter(torch.zeros(cout))

    def noise_shapes(self, batch: int, r: int) -> tuple:
        """The noise this block takes at ``r``-pixel input: n1 at r, n2
        after its last conv (at r / 2 if that conv is fused); none without
        noise."""
        if not self.use_noise:
            return ()
        n1 = (batch, 1, r, r)
        if not self.has_last_conv:
            return (n1,)
        r2 = r // 2 if self.fused_scale and self.block_version == 2 else r
        return (n1, (batch, 1, r2, r2))

    def runs_on_rows(self, rows: int) -> bool:
        """Whether the block runs on shards of ``rows`` rows: a block that
        halves its input needs an even count."""
        return runs_on_rows(rows, self.has_last_conv)

    def forward(self, x, noise: Optional[Sequence[torch.Tensor]] = None, space=None):
        """``space``: the space group whose ranks each hold equal shares of
        ``x``'s rows (``parallel/spatial.py``), ``noise`` the whole image's
        (each rank takes its rows); the style codes come out whole on every
        rank."""
        ops = RowOps(space)
        if self.block_version == 1:
            return self._v1_forward(x, noise, ops)
        heads = self.style_mode != "none"
        n1 = n2 = None
        if self.use_noise and noise:
            n1, n2 = ops.rows(noise[0]), ops.rows(noise[1]) if len(noise) > 1 else None
        w1 = w2 = None
        if heads:
            w1 = self.inver_mod1(_stats(x, self.style_stats, ops))
        residual = x
        x = ops.conv(self.conv_1, ops.instance_norm(x))
        if self.use_noise:
            x = noise_inject(x, self.noise_weight_1, n1)
        x = leaky_relu(x + self.bias_1[None, :, None, None], 0.2)
        if heads:
            w2 = self.inver_mod2(_stats(x, self.style_stats, ops))
            if self.style_mode == "single":
                w1 = w2

        x = ops.instance_norm(x)
        if self.has_last_conv:
            if self.use_blur:
                x = ops.blur(x)
            x = ops.conv(self.conv_2, x)
            if self.use_noise:
                x = noise_inject(x, self.noise_weight_2, n2)
            x = leaky_relu(x + self.bias_2[None, :, None, None], 0.2)
            if not self.fused_scale:
                x = downscale2d(x)
            residual = downscale2d(residual)
        if self.conv_3 is not None:
            residual = self.conv_3(residual)
        return 0.111 * x + 0.889 * residual, w1, w2

    def _v1_forward(self, x, noise, ops: RowOps):
        """E_v1's block (Ablation_Study/E_v1.py:67-100)."""
        n1, n2 = (ops.rows(noise[0]), ops.rows(noise[1]) if len(noise) > 1 else None) if noise else (None, None)
        residual = x
        w1 = self.inver_mod1(_stats(x, ops=ops))
        x = ops.instance_norm(ops.conv(self.conv_1, x))
        x = noise_inject(x, self.noise_weight_1, n1)
        x = leaky_relu(x + self.bias_1[None, :, None, None], 0.2)
        w2 = self.inver_mod2(_stats(x, ops=ops))
        if self.has_last_conv:
            x = ops.instance_norm(ops.conv(self.conv_2, x))
            x = noise_inject(x, self.noise_weight_2, n2)
            x = x + self.bias_2[None, :, None, None]
            if self.conv_3 is not None:
                residual = ops.instance_norm(self.conv_3(residual))
                residual = residual * self.in3_scale[None, :, None, None] \
                    + self.in3_bias[None, :, None, None]
            x = downscale2d(leaky_relu(x + residual, 0.2))
        return x, w1, w2


class Encoder(nn.Module):
    """BE / BE_Blur and the ablation encoders: images [N, C, R, R] ->
    (const features [N, maxf, 4, 4], w [N, 2*layer_count, latent]).

    ``use_noise``, ``style_mode``, ``style_stats`` and ``block_version`` go
    to every block (:class:`EncoderBlock`). With ``style_mode="none"`` the
    second output is ``None`` or, with ``z_head`` (E_Blur_Z), z [N, latent]
    from a stride-2 3x3 conv on the 4x4 features (``out_z``)."""

    def __init__(self, startf: int = 16, maxf: int = 512, layer_count: int = 9,
                 latent_size: int = 512, channels: int = 3, use_blur: bool = False,
                 use_noise: bool = True, style_mode: str = "dual", style_stats: str = "meanstd",
                 block_version: int = 2, z_head: bool = False, base_resolution: int = 1024,
                 generator=None):
        super().__init__()
        self.layer_count = layer_count
        self.style_mode = style_mode
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
                fused_scale=fused_scale, use_blur=use_blur, use_noise=use_noise,
                style_mode=style_mode, style_stats=style_stats, block_version=block_version,
                generator=generator,
            ))
            last_width = inputs  # the last block keeps its input width
            inputs = min(maxf, inputs * 2)
            outputs = min(maxf, outputs * 2)
            resolution //= 2
        self.out_z = None
        if style_mode == "none" and z_head:
            self.out_z = EqConv(last_width, latent_size, 3, stride=2, generator=generator)

    def noise_shapes(self, batch: int, resolution: int) -> list:
        """Noise shapes per block for ``resolution``-pixel input (block i at
        ``resolution >> i``): n1 at the block's input size, n2 after its
        last conv (the last block has no last conv, so no n2); an empty
        tuple for a block without noise. With ``start_block`` > 0 the input
        is ``resolution >> start_block`` pixels and the earlier blocks'
        entries go unread."""
        return [getattr(self, f"block_{i}").noise_shapes(batch, resolution >> i)
                for i in range(self.layer_count)]

    def forward(self, x, noise=None, start_block: int = 0, space=None):
        """``start_block`` skips the blocks before it (the reference's
        progressive ``block_num`` offset, E.py:122-134); ``noise[i]`` is
        block i's, the whole image's.

        ``space``: the space group whose ranks each hold equal shares of the
        images' rows (``parallel/spatial.py``). Each block runs on the rows
        while its input leaves every rank rows enough
        (:meth:`EncoderBlock.runs_on_rows`); from the first that does not,
        the rows are gathered and the rest runs whole on every rank. The
        outputs come out whole on every rank."""
        x = leaky_relu(self.from_rgb(x), 0.2)
        ops = RowOps(space)
        styles = []
        for i in range(start_block, self.layer_count):
            ni = noise[i] if noise is not None else None
            block = getattr(self, f"block_{i}")
            if ops.group is not None and not block.runs_on_rows(x.shape[2]):
                x, ops = ops.gather(x)
            x, w1, w2 = block(x, ni, space=ops.group)
            if self.style_mode != "none":
                styles.append(torch.stack([w2, w1], dim=1))
        x = ops.gather(x)[0]
        if self.style_mode != "none":
            return x, torch.cat(styles[::-1], dim=1)
        if self.out_z is None:
            return x, None
        return x, self.out_z(x).reshape(x.shape[0], -1)


class PGEncoderBlock(nn.Module):
    """E_PG's BEBlock: IN -> conv -> noise -> bias -> lrelu, then (except in
    the last block) IN -> conv -> noise -> bias, the residual (through
    ``conv_3`` and an affine IN, ``in3_scale``/``in3_bias``, where the width
    changes) added, lrelu and a 2x average-pool."""

    def __init__(self, in_features: int, out_features: int, has_second_conv: bool = True,
                 generator=None):
        super().__init__()
        cin, cout = in_features, out_features
        self.has_second_conv = has_second_conv
        self.conv_1 = EqConv(cin, cin, 3, padding=1, use_bias=False, generator=generator)
        self.noise_weight_1 = nn.Parameter(torch.zeros(cin))
        self.bias_1 = nn.Parameter(torch.zeros(cin))
        self.conv_3 = None
        if has_second_conv:
            self.conv_2 = EqConv(cin, cout, 3, padding=1, use_bias=False, generator=generator)
            self.noise_weight_2 = nn.Parameter(torch.zeros(cout))
            self.bias_2 = nn.Parameter(torch.zeros(cout))
            if cin != cout:
                self.conv_3 = EqConv(cin, cout, 1, generator=generator)
                self.in3_scale = nn.Parameter(torch.ones(cout))
                self.in3_bias = nn.Parameter(torch.zeros(cout))

    def noise_shapes(self, batch: int, r: int) -> tuple:
        """Both convs run at the block's input size ``r``; the last block
        has one."""
        return ((batch, 1, r, r),) * (2 if self.has_second_conv else 1)

    def runs_on_rows(self, rows: int) -> bool:
        """Whether the block runs on shards of ``rows`` rows: its pool
        needs an even count."""
        return runs_on_rows(rows, self.has_second_conv)

    def forward(self, x, noise: Optional[Sequence[torch.Tensor]] = None, space=None):
        """``space`` as :meth:`EncoderBlock.forward` takes it: ``x`` this
        rank's rows, ``noise`` the whole image's."""
        ops = RowOps(space)
        residual = x
        x = ops.conv(self.conv_1, ops.instance_norm(x))
        x = noise_inject(x, self.noise_weight_1, ops.rows(noise[0]) if noise is not None else None)
        x = leaky_relu(x + self.bias_1[None, :, None, None], 0.2)
        if not self.has_second_conv:
            return x
        x = ops.conv(self.conv_2, ops.instance_norm(x))
        x = noise_inject(x, self.noise_weight_2, ops.rows(noise[1]) if noise is not None else None)
        x = x + self.bias_2[None, :, None, None]
        if self.conv_3 is not None:
            residual = ops.instance_norm(self.conv_3(residual))
            residual = residual * self.in3_scale[None, :, None, None] + self.in3_bias[None, :, None, None]
        return downscale2d(leaky_relu(x + residual, 0.2))


class PGEncoder(nn.Module):
    """E_PG: images [N, C, R, R] -> (features [N, C', s, s], z [N, latent]).

    ``new_final`` reads the last block's features flattened in (h, w, c)
    order, as ``tpugan``'s NHWC reshape gives them (E_BIG's rule), so the
    bridge copies its kernel as it is and the converter reorders the
    reference's (c, h, w) columns. Returns ``(features, z)``: tpugan's
    contract, not the reference's forward, which returns two zeros
    (E_PG.py:163-164)."""

    def __init__(self, startf: int = 64, maxf: int = 512, layer_count: int = 7, latent_size: int = 512,
                 channels: int = 3, *, img_size: int, generator=None):
        super().__init__()
        self.layer_count = layer_count
        self.from_rgb = EqConv(channels, startf, 1, generator=generator)
        inputs, outputs = startf, startf * 2
        for i in range(layer_count):
            self.add_module(f"block_{i}", PGEncoderBlock(inputs, outputs, has_second_conv=i + 1 != layer_count,
                                                         generator=generator))
            last_width = inputs  # the last block keeps its input width
            inputs = min(maxf, inputs * 2)
            outputs = min(maxf, outputs * 2)
        side = img_size >> (layer_count - 1)
        if side < 1:
            raise ValueError(f"{layer_count} blocks do not fit a {img_size}px image")
        self.new_final = EqLinear(last_width * side * side, latent_size, gain=1.0, generator=generator)

    def noise_shapes(self, batch: int, resolution: int) -> list:
        """Noise shapes per block for ``resolution``-pixel input (block i at
        ``resolution >> i``)."""
        return [getattr(self, f"block_{i}").noise_shapes(batch, resolution >> i)
                for i in range(self.layer_count)]

    def forward(self, x, noise=None, space=None):
        """``space`` as :meth:`Encoder.forward` takes it; the last level is
        gathered whole before ``new_final``'s flatten."""
        x = leaky_relu(self.from_rgb(x), 0.2)
        x = _blocks_on_rows(self, x, noise, space)
        return x, self.new_final(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))


def _blocks_on_rows(encoder, x, noise, space, *extra):
    """E_PG's or E_BIG's blocks in order (``extra`` after ``x``: E_BIG's
    condition vector), on the rows of ``space`` while each block's input
    leaves every rank rows enough, then gathered and whole; the last level
    comes out whole."""
    ops = RowOps(space)
    for i in range(encoder.layer_count):
        block = getattr(encoder, f"block_{i}")
        if ops.group is not None and not block.runs_on_rows(x.shape[2]):
            x, ops = ops.gather(x)
        x = block(x, *extra, noise[i] if noise is not None else None, space=ops.group)
    return ops.gather(x)[0]


class BigGANEncoderBlock(nn.Module):
    """E_BIG's BEBlock: conditional, spectral-normalised BigGAN batch norms
    (eps 1e-12, the truncation fixed at 0.4) before each conv, noise, bias,
    lrelu; a second conv, a 1x1 residual conv when the width changes and a
    2x average-pool downsample, except in the last block. Keeps the
    reference's second lrelu on width-changing blocks."""

    def __init__(self, in_features: int, out_features: int, cond_dim: int = 256,
                 n_stats: int = 51, has_second_conv: bool = True, truncation: float = 0.4,
                 generator=None):
        super().__init__()
        cin, cout = in_features, out_features
        self.has_second_conv = has_second_conv
        self.truncation = truncation

        def bn():
            return BigGANBatchNorm(cin, cond_dim, n_stats=n_stats, eps=1e-12, conditional=True,
                                   sn=True, generator=generator)

        self.batch_norm_1 = bn()
        self.conv_1 = EqConv(cin, cin, 3, padding=1, use_bias=False, generator=generator)
        self.noise_weight_1 = nn.Parameter(torch.zeros(cin))
        self.bias_1 = nn.Parameter(torch.zeros(cin))
        self.conv_3 = None
        if has_second_conv:
            self.batch_norm_2 = bn()
            self.conv_2 = EqConv(cin, cout, 3, padding=1, use_bias=False, generator=generator)
            self.noise_weight_2 = nn.Parameter(torch.zeros(cout))
            self.bias_2 = nn.Parameter(torch.zeros(cout))
            if cin != cout:
                self.batch_norm_3 = bn()
                self.conv_3 = EqConv(cin, cout, 1, generator=generator)

    def runs_on_rows(self, rows: int) -> bool:
        """Whether the block runs on shards of ``rows`` rows: its pool
        needs an even count."""
        return runs_on_rows(rows, self.has_second_conv)

    def forward(self, x, cond_vector, noise: Optional[Sequence[torch.Tensor]] = None, space=None):
        """``space`` as :meth:`EncoderBlock.forward` takes it: ``x`` this
        rank's rows, ``noise`` the whole image's, ``cond_vector`` per image
        (whole); the batch norms normalise by stored statistics, so they
        are local."""
        ops = RowOps(space)
        t = self.truncation
        residual = x
        x = ops.conv(self.conv_1, self.batch_norm_1(x, t, cond_vector))
        x = noise_inject(x, self.noise_weight_1, ops.rows(noise[0]) if noise is not None else None)
        x = leaky_relu(x + self.bias_1[None, :, None, None], 0.2)
        if not self.has_second_conv:
            return x
        x = ops.conv(self.conv_2, self.batch_norm_2(x, t, cond_vector))
        x = noise_inject(x, self.noise_weight_2, ops.rows(noise[1]) if noise is not None else None)
        x = leaky_relu(x + self.bias_2[None, :, None, None], 0.2)
        if self.conv_3 is not None:
            residual = self.conv_3(self.batch_norm_3(residual, t, cond_vector))
            x = leaky_relu(x, 0.2)  # the reference's double lrelu
        return downscale2d(x + residual)


class BigGANEncoder(nn.Module):
    """E_BIG: images [N, C, R, R] and BigGAN's condition vector [N, cond_dim]
    -> (condition vector [N, cond_dim], z [N, z_dim]).

    ``from_rgb`` is a plain conv with bias. The first head reads the last
    block's features flattened in (h, w, c) order, as ``tpugan``'s NHWC
    reshape gives them; its fan-in depends on the image size, which the
    constructor therefore takes."""

    def __init__(self, startf: int = 64, maxf: int = 512, layer_count: int = 7,
                 channels: int = 3, cond_dim: int = 256, z_dim: int = 128, *, img_size: int,
                 generator=None):
        super().__init__()
        self.layer_count = layer_count
        self.from_rgb = plain_conv(channels, startf, 1, generator=generator)
        inputs, outputs = startf, startf * 2
        for i in range(layer_count):
            self.add_module(f"block_{i}", BigGANEncoderBlock(
                inputs, outputs, cond_dim, has_second_conv=i + 1 != layer_count,
                generator=generator,
            ))
            last_width = inputs  # the last block keeps its input width
            inputs = min(maxf, inputs * 2)
            outputs = min(maxf, outputs * 2)
        side = img_size >> (layer_count - 1)
        if side < 1:
            raise ValueError(f"{layer_count} blocks do not fit a {img_size}px image")
        self.new_final_1 = EqLinear(last_width * side * side, cond_dim, gain=1.0,
                                    generator=generator)
        self.new_final_2 = EqLinear(cond_dim, z_dim, gain=1.0, generator=generator)

    def noise_shapes(self, batch: int, resolution: int) -> list:
        """Noise shapes per block for ``resolution``-pixel input: both convs
        of block i run at ``resolution >> i``; the last block has one."""
        return [
            ((batch, 1, resolution >> i, resolution >> i),) * (1 if i + 1 == self.layer_count else 2)
            for i in range(self.layer_count)
        ]

    def forward(self, x, cond_vector, noise=None, space=None):
        """``space`` as :meth:`Encoder.forward` takes it (``from_rgb`` is
        1x1, local); the last level is gathered whole before
        ``new_final_1``'s flatten."""
        x = leaky_relu(self.from_rgb(x), 0.2)
        x = _blocks_on_rows(self, x, noise, space, cond_vector)
        c_v = self.new_final_1(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))
        return c_v, self.new_final_2(c_v)
