"""Serving pieces of encoder alignment (counterpart of
``tpugan/train/e_align.py``): the frozen StyleGANv1 synth/resynth closures
and the encode closure. The training step comes with the training slice.

Images cross this boundary NHWC, as in ``tpugan``; the models run NCHW.
Noise is explicit everywhere: the caller draws it (:func:`draw_noise`) or
passes ``None`` for no injection.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from tpugan_torch.models.stylegan1 import StyleGANv1Generator, StyleGANv1Mapping, truncation_coefs


class SynthBatch(NamedTuple):
    """A frozen-generator sample: latents [N, 2L, latent], target images
    [N, H, W, C] and the generator const [N, C, 4, 4]."""

    w1: torch.Tensor
    imgs1: torch.Tensor
    const1: torch.Tensor


def nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def draw_noise(shapes, generator: torch.Generator) -> list:
    """One standard-normal tensor per shape of a model's ``noise_shapes``,
    drawn in order on the generator's device."""
    return [
        tuple(torch.randn(s, generator=generator, device=generator.device) for s in block)
        for block in shapes
    ]


def build_stylegan1_pipeline(
    gen: StyleGANv1Generator,
    gm: StyleGANv1Mapping,
    lod: int,
    psi: float = 0.7,
    center: Optional[torch.Tensor] = None,
):
    """Frozen StyleGANv1 synth/resynth closures (mtype 1):
    ``w1 = Gm(z, coefs)``, ``imgs1 = Gs(w1, lod)`` and ``imgs2 = Gs(w2, lod)``.

    ``synth(z, noise) -> SynthBatch`` and ``resynth(w2, batch, noise) ->
    images``, with ``noise`` as from ``gen.noise_shapes`` (or ``None``).
    """
    coefs = truncation_coefs(gm.num_layers, psi)

    @torch.no_grad()
    def synth(z: torch.Tensor, noise=None) -> SynthBatch:
        w1 = gm(z, coefs, center)
        imgs1 = nchw_to_nhwc(gen(w1, lod, noise))
        const1 = gen.const.expand(z.shape[0], -1, -1, -1)
        return SynthBatch(w1=w1, imgs1=imgs1, const1=const1)

    @torch.no_grad()
    def resynth(w2: torch.Tensor, batch: SynthBatch, noise=None) -> torch.Tensor:
        return nchw_to_nhwc(gen(w2, lod, noise))

    return synth, resynth


def make_encode_fn(encoder):
    """Encode closure: ``(batch, noise) -> (const2, w2)`` on ``batch.imgs1``."""

    @torch.no_grad()
    def encode(batch: SynthBatch, noise=None):
        return encoder(nhwc_to_nchw(batch.imgs1), noise)

    return encode
