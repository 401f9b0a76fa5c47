"""Serving pieces of encoder alignment (counterpart of
``tpugan/train/e_align.py``): the frozen generators' synth/resynth closures
(StyleGANv1, mtype 1; BigGAN, mtype 4) and the encode closure. The training
step comes with the training slice.

Images cross this boundary NHWC, as in ``tpugan``; the models run NCHW.
Noise and labels are explicit everywhere: the caller draws them
(:func:`draw_noise`, ``cli/infer_e.draw_request``) or passes ``None`` for no
noise injection.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from tpugan_torch.models.biggan import BigGAN
from tpugan_torch.models.stylegan1 import StyleGANv1Generator, StyleGANv1Mapping, truncation_coefs

# BigGAN's truncation in the encoder pipeline (E_align_cropping_s1.py:140-150)
BIGGAN_TRUNCATION = 0.4


class SynthBatch(NamedTuple):
    """A frozen-generator sample: latents, target images [N, H, W, C], the
    generator const [N, C, 4, 4] (BigGAN: the condition vector [N, 2 z_dim])
    and, for BigGAN, the one-hot class label."""

    w1: torch.Tensor
    imgs1: torch.Tensor
    const1: torch.Tensor
    label: Any = None


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


def build_biggan_pipeline(model: BigGAN):
    """Frozen BigGAN synth/resynth closures (mtype 4):
    ``(imgs1, cond) = G(zt, label)`` and ``imgs2 = G(w2, label)`` with the
    same label (E_align_cropping_s1.py:140-162), both at
    ``BIGGAN_TRUNCATION``, the truncation ``draw_request`` draws ``zt`` at.

    ``synth(zt, label) -> SynthBatch`` takes the truncated latents and the
    one-hot labels the caller drew; ``resynth(w2, batch, noise=None)``
    regenerates with ``batch.label``. BigGAN has no generator noise.
    """

    @torch.no_grad()
    def synth(zt: torch.Tensor, label: torch.Tensor) -> SynthBatch:
        imgs1, cond = model(zt, label, BIGGAN_TRUNCATION)
        return SynthBatch(w1=zt, imgs1=nchw_to_nhwc(imgs1), const1=cond, label=label)

    @torch.no_grad()
    def resynth(w2: torch.Tensor, batch: SynthBatch, noise=None) -> torch.Tensor:
        if noise is not None:
            raise ValueError("BigGAN takes no generator noise")
        imgs2, _ = model(w2, batch.label, BIGGAN_TRUNCATION)
        return nchw_to_nhwc(imgs2)

    return synth, resynth


def make_encode_fn(encoder, conditional: bool = False):
    """Encode closure: ``(batch, noise) -> (const2, w2)`` on ``batch.imgs1``;
    a ``conditional`` encoder (E_BIG) also reads the condition vector
    ``batch.const1`` (E_align_cropping_s1.py:155)."""

    @torch.no_grad()
    def encode(batch: SynthBatch, noise=None):
        imgs = nhwc_to_nchw(batch.imgs1)
        if conditional:
            return encoder(imgs, batch.const1, noise)
        return encoder(imgs, noise)

    return encode
