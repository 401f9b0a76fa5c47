"""Shared CLI plumbing (counterpart of ``tpugan/cli/common.py``): the same
flags, plus ``--device {cuda,cpu}``, and the model factory for ``--mtype 1``
(StyleGANv1 with E, E_Blur in case 2, or the encoder of ``--ablation``),
``--mtype 2`` (StyleGAN2, config F, with E or E_Blur) and ``--mtype 4``
(BigGAN-deep with E_BIG).

What later slices bring raises :class:`NotImplementedError` naming the
ROADMAP slice: other mtypes, converted checkpoints (so ``--random_init`` is
required), ``--space_shards`` above 1, ``--multihost``, ``--lpips_weights``
and ``--vgg_weights``.
"""

from __future__ import annotations

import argparse
import math
import os
from typing import Any, NamedTuple

import torch

from tpugan_torch.runtime import resolve_device

_LATER = {
    3: "PGGAN (mtype 3) comes with ROADMAP slice 7 (PGGAN, eval, I/O, CLIs)",
}


def add_common_args(parser: argparse.ArgumentParser, training: bool = True):
    if training:
        parser.add_argument("--iterations", type=int, default=210000)
        parser.add_argument("--lr", type=float, default=0.0015)
        parser.add_argument("--beta_1", type=float, default=0.0)
        parser.add_argument("--batch_size", type=int, default=2)
    parser.add_argument("--experiment_dir", default=None)
    parser.add_argument("--checkpoint_dir_GAN", default=None)
    parser.add_argument("--config_dir", default=None)  # BigGAN config JSON
    parser.add_argument("--checkpoint_dir_E", default=None)
    parser.add_argument("--img_size", type=int, default=1024)
    parser.add_argument("--img_channels", type=int, default=3)
    parser.add_argument("--z_dim", type=int, default=512)
    parser.add_argument("--mtype", type=int, default=2)
    parser.add_argument("--start_features", type=int, default=16)
    parser.add_argument("--random_init", action="store_true",
                        help="random weights instead of converted checkpoints")
    parser.add_argument("--ablation", type=int, default=0, choices=range(0, 9),
                        help="ablation ladder step (ablation_utils/1..8); 0 = off")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--space_shards", type=int, default=1)
    parser.add_argument("--lpips_weights", default=None,
                        help="official lpips (vgg) state dict; random heads if absent")
    parser.add_argument("--vgg_weights", default=None,
                        help="torchvision vgg16 state dict (grad-cam path)")
    parser.add_argument("--multihost", action="store_true",
                        help="span several hosts (not in the port yet)")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="run on the GPU (default; raises if there is none) or the CPU")
    return parser


class GanBundle(NamedTuple):
    """Frozen generator closures + encoder for one mtype, on ``device``.

    ``synth(z, noise)`` (mtype 1 and 2; StyleGAN2 reads its noise buffers,
    so its ``noise`` is ``None``) or ``synth(zt, label)`` (mtype 4) and
    ``resynth(w, batch, noise)`` close over the frozen generator,
    ``encode(batch, noise)`` over the encoder; ``generator`` and
    ``encoder`` give the noise shapes (and BigGAN's config). For mtype 1,
    ``mapping`` is the frozen mapping and ``remap(z) -> w+`` runs it with
    the truncation coefficients of 2 * layer_count style layers (psi 0.7 on
    the first half): ablation 1's re-mapping of the encoder's z."""

    synth: Any  # (z, noise) or (zt, label) -> SynthBatch
    resynth: Any  # (w, batch, noise) -> images [N, H, W, C]
    encode: Any  # (batch, noise) -> (const2, w2)
    encoder: Any  # nn.Module
    z_dim: int
    layer_count: int
    num_style_layers: int
    generator: Any  # nn.Module (frozen)
    device: torch.device
    img_size: int
    mtype: int = 1
    mapping: Any = None  # nn.Module (frozen; mtype 1)
    remap: Any = None  # (z) -> w+ (mtype 1)


def _encoder_variant_kwargs(ablation: int, case: int) -> dict:
    """The ablation ladder's encoders (model/E/Ablation_Study/*, as
    ``tpugan/cli/common.py:82-94``): 1 -> E_Blur_Z (a z head only), 2 ->
    E_Blur_W_2 (one w per block, no noise), 3 -> E_Blur_W (no noise), 4 and
    up -> E_Blur; without an ablation, E_Blur in case 2."""
    if ablation == 1:
        return dict(use_blur=True, style_mode="none", z_head=True)
    if ablation == 2:
        return dict(use_blur=True, style_mode="single", use_noise=False)
    if ablation == 3:
        return dict(use_blur=True, use_noise=False)
    if ablation >= 4:
        return dict(use_blur=True)
    return dict(use_blur=case == 2)


def _layer_count(img_size: int) -> int:
    return int(math.log2(img_size)) - 1


def build_bundle(args) -> GanBundle:
    """Construct the frozen G (+ mapping) and the encoder E for args.mtype,
    from random weights seeded by ``args.seed``, on ``args.device``."""
    if getattr(args, "multihost", False):
        raise NotImplementedError("--multihost comes with ROADMAP slice 7 (parallelism)")
    if getattr(args, "space_shards", 1) != 1:
        raise NotImplementedError("--space_shards > 1 comes with ROADMAP slice 7 (parallelism)")
    if args.mtype in _LATER:
        raise NotImplementedError(_LATER[args.mtype])
    if args.mtype not in (1, 2, 4):
        raise ValueError(f"unknown mtype {args.mtype}")
    if not args.random_init or args.checkpoint_dir_E:
        raise NotImplementedError(
            "loading converted checkpoints comes with ROADMAP slice 7 (io/convert); "
            "pass --random_init and no --checkpoint_dir_E"
        )
    device = resolve_device(getattr(args, "device", "cuda"))
    layer_count = _layer_count(args.img_size)
    g = torch.Generator(device="cpu").manual_seed(args.seed)
    if args.mtype == 4:
        return _build_biggan_bundle(args, layer_count, g, device)
    if args.mtype == 2:
        return _build_stylegan2_bundle(args, layer_count, g, device)

    from tpugan_torch.models import Encoder, StyleGANv1Generator, StyleGANv1Mapping
    from tpugan_torch.models.stylegan1 import truncation_coefs
    from tpugan_torch.train.e_align import build_stylegan1_pipeline, make_encode_fn

    gen = StyleGANv1Generator(
        startf=args.start_features, maxf=512, layer_count=layer_count, latent_size=512,
        generator=g,
    ).to(device)
    gm = StyleGANv1Mapping(num_layers=2 * layer_count, mapping_layers=8, generator=g).to(device)
    enc = Encoder(
        startf=args.start_features, maxf=512, layer_count=layer_count, latent_size=512,
        **_encoder_variant_kwargs(getattr(args, "ablation", 0), getattr(args, "case", 1)),
        generator=g,
    ).to(device)
    synth, resynth = build_stylegan1_pipeline(gen, gm, lod=layer_count - 1)
    coefs = truncation_coefs(2 * layer_count)

    def remap(z: torch.Tensor) -> torch.Tensor:
        return gm(z, coefs)

    return GanBundle(
        synth, resynth, make_encode_fn(enc), enc, 512, layer_count, 2 * layer_count, gen, device,
        args.img_size, mapping=gm, remap=remap,
    )


def _build_stylegan2_bundle(args, layer_count: int, g: torch.Generator,
                            device: torch.device) -> GanBundle:
    """StyleGAN2 config F at ``--img_size`` (``tpugan/cli/common.py:160-209``)
    and E, or E_Blur in case 2. ``synth(z)`` truncates at psi 0.7 in the
    first 8 layers and ``resynth(w2)`` runs the synthesis alone, both on the
    noise buffers, as ``tpugan``'s closures do
    (:func:`~tpugan_torch.train.e_align.build_stylegan2_pipeline`)."""
    from tpugan_torch.models import Encoder, StyleGAN2Generator
    from tpugan_torch.train.e_align import build_stylegan2_pipeline, make_encode_fn

    gen = StyleGAN2Generator(resolution=args.img_size, generator=g).to(device)
    enc = Encoder(
        startf=args.start_features, maxf=512, layer_count=layer_count, latent_size=512,
        use_blur=getattr(args, "case", 1) == 2, generator=g,
    ).to(device)
    synth, resynth = build_stylegan2_pipeline(gen)
    return GanBundle(
        synth, resynth, make_encode_fn(enc), enc, 512, layer_count, 2 * layer_count, gen, device,
        args.img_size, mtype=2,
    )


def _build_biggan_bundle(args, layer_count: int, g: torch.Generator,
                         device: torch.device) -> GanBundle:
    """BigGAN-deep (the config from ``--config_dir`` or the zoo layout for
    ``--img_size`` with ``--z_dim``) and E_BIG, in eval mode: the spectral
    norms read their stored ``u`` and ``v``."""
    from tpugan_torch.models import BigGAN, BigGANConfig, BigGANEncoder
    from tpugan_torch.train.e_align import build_biggan_pipeline, make_encode_fn

    cfg = (
        BigGANConfig.from_json_file(args.config_dir)
        if args.config_dir
        else BigGANConfig.for_resolution(args.img_size, z_dim=args.z_dim)
    )
    if cfg.output_dim != args.img_size:
        raise ValueError(f"the BigGAN config makes {cfg.output_dim}px images, "
                         f"but --img_size is {args.img_size}")
    model = BigGAN(cfg, generator=g).eval().to(device)
    enc = BigGANEncoder(
        startf=args.start_features, maxf=512, layer_count=layer_count,
        cond_dim=2 * cfg.z_dim, z_dim=cfg.z_dim, img_size=args.img_size, generator=g,
    ).eval().to(device)
    synth, resynth = build_biggan_pipeline(model)
    return GanBundle(
        synth, resynth, make_encode_fn(enc, conditional=True), enc, cfg.z_dim, layer_count,
        2 * layer_count, model, device, args.img_size, mtype=4,
    )


def warn_random_weights(flag: str, consequence: str) -> None:
    """Unmissable warning that a perceptual net is random or disabled, which
    makes results incomparable with the reference."""
    import sys

    bar = "!" * 74
    print(
        f"\n{bar}\nWARNING: --{flag} not provided — {consequence}.\n"
        f"Results will NOT be comparable to the reference pipeline.\n{bar}\n",
        file=sys.stderr,
        flush=True,
    )


def build_lpips_fn(args):
    """The LPIPS closure of ``--lpips_weights``. The reference always trains
    with real LPIPS (E_align_cropping_s1.py:98); without weights the term is
    disabled, loudly, as in ``tpugan``. Converting the official weights
    comes with ROADMAP slice 7 (io/convert)."""
    if getattr(args, "lpips_weights", None):
        raise NotImplementedError(
            "--lpips_weights needs the LPIPS converter, which comes with ROADMAP slice 7 "
            "(io/convert)"
        )
    warn_random_weights("lpips_weights", "the LPIPS loss term is DISABLED")
    return None


def build_vgg16(args):
    """The Grad-CAM VGG16 (1000 classes) on ``args.device``, frozen, with
    random weights seeded by ``args.seed`` and a loud warning, as ``tpugan``
    runs without ``--vgg_weights``: the attention over random features is
    exercised, not meaningful. Converting torchvision's weights comes with
    ROADMAP slice 7 (io/convert)."""
    from tpugan_torch.losses.vgg import VGG16

    if getattr(args, "vgg_weights", None):
        raise NotImplementedError(
            "--vgg_weights needs the torchvision VGG16 converter, which comes with ROADMAP slice 7 "
            "(io/convert)"
        )
    warn_random_weights("vgg_weights", "VGG16 (Grad-CAM/GBP) weights are RANDOM")
    vgg = VGG16(generator=torch.Generator().manual_seed(args.seed))
    return vgg.requires_grad_(False).to(resolve_device(getattr(args, "device", "cuda")))


def make_result_dirs(experiment_dir, default_name: str):
    """Mirror the reference's result tree (E_align_cropping_s1.py:318-331)."""
    base = experiment_dir or os.path.join("./result", default_name)
    imgs = os.path.join(base, "imgs")
    models = os.path.join(base, "models")
    for d in (base, imgs, models):
        os.makedirs(d, exist_ok=True)
    return base, imgs, models


class InversionDraws(NamedTuple):
    """The inversion CLIs' fixed inputs: the encoder's noise, StyleGANv1's
    generator noise (``None`` for the others) and, for BigGAN, the
    truncated z of the condition."""

    noise_e: list
    noise_g: Any = None
    zt: Any = None


def draw_inputs(bundle: GanBundle, batch_size: int, iterations: int = 0) -> InversionDraws:
    """StyleGANv1's generator noise from seed 0, the encoder's noise from
    seed 1 and BigGAN's truncated z (at 0.4) from the seed ``iterations %
    30000``, drawn on the CPU (once a run: the same draws on every device)
    and moved to the bundle's device. ``embedding``, ``rec_real_img``,
    ``edit`` and ``baseline_i2s`` read these draws on every call, as
    tpugan's fixed ``PRNGKey(0)`` gives the same draws on every call."""
    from tpugan_torch.train.e_align import BIGGAN_TRUNCATION, draw_noise
    from tpugan_torch.utils import iteration_generator, truncated_noise_sample

    dev = bundle.device

    def on_device(blocks):
        return [tuple(n.to(dev) for n in block) for block in blocks]

    noise_g = zt = None
    if bundle.mtype == 1:
        noise_g = on_device(draw_noise(bundle.generator.noise_shapes(batch_size), iteration_generator(0)))
    noise_e = on_device(draw_noise(bundle.encoder.noise_shapes(batch_size, bundle.img_size),
                                   iteration_generator(1)))
    if bundle.mtype == 4:
        zt = truncated_noise_sample(batch_size, bundle.z_dim, BIGGAN_TRUNCATION,
                                    generator=iteration_generator(iterations)).to(dev)
    return InversionDraws(noise_e, noise_g, zt)
