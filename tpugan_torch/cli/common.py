"""Shared CLI plumbing (counterpart of ``tpugan/cli/common.py``): the same
flags, plus ``--device {cuda,cpu}``, and the model factory for ``--mtype 1``
(StyleGANv1 with E, E_Blur in case 2, or the encoder of ``--ablation``),
``--mtype 2`` (StyleGAN2, config F, with E or E_Blur), ``--mtype 3``
(PGGAN with E_PG) and ``--mtype 4`` (BigGAN-deep with E_BIG).

Weights are random, seeded by ``--seed``, with ``--random_init``; else the
generator comes from ``--checkpoint_dir_GAN`` (StyleGANv1's directory of
``Gs_dict.pth``, ``Gm_dict.pth`` and ``center_tensor.pt``, StyleGAN2's and
PGGAN's ``.pth``, BigGAN's ``.pt`` with ``--config_dir``), and the encoder from
``--checkpoint_dir_E`` where it is given, LPIPS from ``--lpips_weights`` and
VGG16 from ``--vgg_weights``, each converted from the reference's torch
state dict (``tpugan_torch/io/convert.py``); the last two take a path or an
http(s) URL, downloaded once (``tpugan_torch/io/fetch.py``).

Data parallelism: ``--multihost``, or torchrun's environment naming more
than one process, starts the process group (``runtime.init_distributed``),
and the training and inversion CLIs shard their batch over
:func:`data_parallel`'s mesh. ``--space_shards`` above 1 adds tpugan's
``space`` axis: ``e_align`` and ``embedding`` on mtypes 1 and 2 shard the
images' rows over it (``parallel/spatial.py``); on mtypes 3 and 4 it raises
:class:`NotImplementedError` naming ROADMAP A 1's part 2.
"""

from __future__ import annotations

import argparse
import math
import os
from typing import Any, NamedTuple

import torch

from tpugan_torch.io import convert
from tpugan_torch.io.fetch import cached_path
from tpugan_torch.parallel.mesh import SPACE_AXIS_PART2, auto_mesh, takes_part
from tpugan_torch.runtime import init_distributed, resolve_device

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
                        help="start the process group (runtime.init_distributed: torchrun's environment) "
                             "so that the mesh spans every process; a no-op for a single process")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="run on the GPU (default; raises if there is none) or the CPU")
    return parser


class GanBundle(NamedTuple):
    """Frozen generator closures + encoder for one mtype, on ``device``.

    ``synth(z, noise)`` (mtype 1, 2 and 3; StyleGAN2 reads its noise
    buffers and PGGAN has none, so their ``noise`` is ``None``) or
    ``synth(zt, label)`` (mtype 4) and
    ``resynth(w, batch, noise)`` close over the frozen generator,
    ``encode(batch, noise)`` over the encoder; ``generator`` and
    ``encoder`` give the noise shapes (and BigGAN's config). For mtype 1,
    ``mapping`` is the frozen mapping and ``remap(z) -> w+`` runs it with
    the truncation coefficients of 2 * layer_count style layers (psi 0.7 on
    the first half): ablation 1's re-mapping of the encoder's z. Converted
    StyleGANv1 weights bring ``center``, the truncation center that synth
    and remap truncate towards."""

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
    center: Any = None  # the mapping's truncation center [num_layers, 512] (mtype 1, converted)


def start_distributed(args) -> bool:
    """Start the process group with ``--multihost`` or where torchrun's
    environment names more than one process (tpugan's ``--multihost``, and
    its view of a host's local devices without it); gloo for ``--device
    cpu``. True when a group of more than one process is up."""
    world = os.environ.get("WORLD_SIZE", "").strip()
    if not (getattr(args, "multihost", False) or (world and int(world) > 1)):
        return False
    return init_distributed(backend="gloo" if getattr(args, "device", "cuda") == "cpu" else None)


def spatial(args) -> bool:
    """Whether ``args`` ask for the ``space`` axis (tpugan's
    ``spatial=args.space_shards > 1``); raises where the port has no row
    shards yet (ROADMAP A 1's part 2: mtypes 3 and 4)."""
    if getattr(args, "space_shards", 1) == 1:
        return False
    if args.mtype not in (1, 2):
        raise NotImplementedError(SPACE_AXIS_PART2)
    return True


def data_parallel(args):
    """``(mesh, takes_part)`` of a training or inversion CLI: the group
    started (:func:`start_distributed`), tpugan's ``auto_mesh(batch_size,
    space=space_shards)`` over its processes (``None`` for one), and whether
    this process runs the steps (ranks past the mesh leave after its note).
    ``--space_shards`` above 1 on mtypes 3 and 4 raises (:func:`spatial`)."""
    spatial(args)
    start_distributed(args)
    mesh = auto_mesh(args.batch_size, space=args.space_shards, device_type=resolve_device(args.device).type)
    return mesh, takes_part(mesh)


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


def _load_encoder(enc, args, layer_count: int):
    """``enc`` with ``--checkpoint_dir_E`` converted into it, where given."""
    if args.checkpoint_dir_E:
        to_port = {3: convert.pg_encoder, 4: convert.biggan_encoder}.get(args.mtype, convert.encoder)
        convert.load_state(enc, to_port(convert.load_torch_state_dict(args.checkpoint_dir_E), layer_count))
    return enc


def build_bundle(args) -> GanBundle:
    """Construct the frozen G (+ mapping) and the encoder E for args.mtype
    on ``args.device``: random weights seeded by ``args.seed`` with
    ``--random_init``, else the generator converted from
    ``--checkpoint_dir_GAN``; the encoder converted from
    ``--checkpoint_dir_E`` where it is given (``tpugan/cli/common.py:
    114-307``)."""
    spatial(args)
    start_distributed(args)
    if args.mtype not in (1, 2, 3, 4):
        raise ValueError(f"unknown mtype {args.mtype}")
    if not args.random_init and not args.checkpoint_dir_GAN:
        raise ValueError("pass --checkpoint_dir_GAN (the reference's generator weights) or "
                         "--random_init")
    device = resolve_device(getattr(args, "device", "cuda"))
    layer_count = _layer_count(args.img_size)
    g = torch.Generator(device="cpu").manual_seed(args.seed)
    if args.mtype == 4:
        return _build_biggan_bundle(args, layer_count, g, device)
    if args.mtype == 3:
        return _build_pggan_bundle(args, layer_count, g, device)
    if args.mtype == 2:
        return _build_stylegan2_bundle(args, layer_count, g, device)

    from tpugan_torch.models import Encoder, StyleGANv1Generator, StyleGANv1Mapping
    from tpugan_torch.models.stylegan1 import truncation_coefs
    from tpugan_torch.train.e_align import build_stylegan1_pipeline, make_encode_fn

    gen = StyleGANv1Generator(
        startf=args.start_features, maxf=512, layer_count=layer_count, latent_size=512,
        generator=g,
    )
    gm = StyleGANv1Mapping(num_layers=2 * layer_count, mapping_layers=8, generator=g)
    center = None
    if not args.random_init:
        path = args.checkpoint_dir_GAN
        gs_state = convert.load_torch_state_dict(os.path.join(path, "Gs_dict.pth"))
        gm_state = convert.load_torch_state_dict(os.path.join(path, "Gm_dict.pth"))
        convert.load_state(gen, convert.stylegan1_generator(gs_state, layer_count))
        convert.load_state(gm, convert.stylegan1_mapping(gm_state))
        center = torch.from_numpy(convert.center_tensor(os.path.join(path, "center_tensor.pt"))).to(device)
    gen, gm = gen.to(device), gm.to(device)
    enc = _load_encoder(Encoder(
        startf=args.start_features, maxf=512, layer_count=layer_count, latent_size=512,
        **_encoder_variant_kwargs(getattr(args, "ablation", 0), getattr(args, "case", 1)),
        generator=g,
    ), args, layer_count).to(device)
    synth, resynth = build_stylegan1_pipeline(gen, gm, lod=layer_count - 1, center=center)
    coefs = truncation_coefs(2 * layer_count)

    def remap(z: torch.Tensor) -> torch.Tensor:
        return gm(z, coefs, center)

    return GanBundle(
        synth, resynth, make_encode_fn(enc), enc, 512, layer_count, 2 * layer_count, gen, device,
        args.img_size, mapping=gm, remap=remap, center=center,
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

    gen = StyleGAN2Generator(resolution=args.img_size, generator=g)
    if not args.random_init:
        state = convert.stylegan2_state(convert.load_torch_state_dict(args.checkpoint_dir_GAN))
        convert.load_state(gen, convert.stylegan2_generator(state))
    gen = gen.to(device)
    enc = _load_encoder(Encoder(
        startf=args.start_features, maxf=512, layer_count=layer_count, latent_size=512,
        use_blur=getattr(args, "case", 1) == 2, generator=g,
    ), args, layer_count).to(device)
    synth, resynth = build_stylegan2_pipeline(gen)
    return GanBundle(
        synth, resynth, make_encode_fn(enc), enc, 512, layer_count, 2 * layer_count, gen, device,
        args.img_size, mtype=2,
    )


def _build_pggan_bundle(args, layer_count: int, g: torch.Generator,
                        device: torch.device) -> GanBundle:
    """PGGAN at ``--img_size`` (GenForce's fmaps, min(16384 / res, 512);
    converted from the ``.pth`` of ``--checkpoint_dir_GAN``, its
    ``generator_smooth`` unwrapped, unless ``--random_init``) and E_PG
    (``tpugan/cli/common.py:211-249``). ``synth(z)`` gives ``w1 = z`` and
    ``resynth(z2)`` regenerates from E_PG's z
    (:func:`~tpugan_torch.train.e_align.build_pggan_pipeline`)."""
    from tpugan_torch.models import PGEncoder, PGGANGenerator
    from tpugan_torch.train.e_align import build_pggan_pipeline, make_encode_fn

    gen = PGGANGenerator(resolution=args.img_size, generator=g)
    if not args.random_init:
        state = convert.stylegan2_state(convert.load_torch_state_dict(args.checkpoint_dir_GAN))
        convert.load_state(gen, convert.pggan_generator(state))
    gen = gen.to(device)
    enc = _load_encoder(PGEncoder(
        startf=args.start_features, maxf=512, layer_count=layer_count, latent_size=512,
        img_size=args.img_size, generator=g,
    ), args, layer_count).to(device)
    synth, resynth = build_pggan_pipeline(gen)
    return GanBundle(
        synth, resynth, make_encode_fn(enc), enc, args.z_dim, layer_count, 2 * layer_count, gen, device,
        args.img_size, mtype=3,
    )


def family_pipeline(bundle: GanBundle, generator, mapping=None, train: bool = False):
    """``(synth, resynth)`` of the bundle's family over ``generator`` (and,
    for mtype 1, ``mapping``, with the bundle's truncation center): a
    bf16 copy of the bundle's generator, or the train-mode closures."""
    from tpugan_torch.train import e_align as ea

    if bundle.mtype == 4:
        return ea.build_biggan_pipeline(generator, train=train)
    if bundle.mtype == 3:
        return ea.build_pggan_pipeline(generator, train=train)
    if bundle.mtype == 2:
        return ea.build_stylegan2_pipeline(generator, train=train)
    return ea.build_stylegan1_pipeline(generator, mapping, bundle.layer_count - 1, center=bundle.center,
                                       train=train)


def _build_biggan_bundle(args, layer_count: int, g: torch.Generator,
                         device: torch.device) -> GanBundle:
    """BigGAN-deep (the config from ``--config_dir`` or the zoo layout for
    ``--img_size`` with ``--z_dim``; converted from ``--checkpoint_dir_GAN``
    unless ``--random_init``) and E_BIG, in eval mode: the spectral norms
    read their stored ``u`` and ``v``."""
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
    model = BigGAN(cfg, generator=g).eval()
    if not args.random_init:
        convert.load_state(model, convert.biggan(convert.load_torch_state_dict(args.checkpoint_dir_GAN)))
    model = model.to(device)
    enc = _load_encoder(BigGANEncoder(
        startf=args.start_features, maxf=512, layer_count=layer_count,
        cond_dim=2 * cfg.z_dim, z_dim=cfg.z_dim, img_size=args.img_size, generator=g,
    ), args, layer_count).eval().to(device)
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
    """The LPIPS closure of ``--lpips_weights`` (the official VGG LPIPS
    state dict, converted; a path or URL, ``io/fetch.py``), on
    ``args.device``; in bf16 under ``--bf16`` unless ``--fp32_lpips``
    (``tpugan/cli/common.py:327-353``). The
    reference always trains with real LPIPS (E_align_cropping_s1.py:98);
    without weights the term is disabled, loudly, as in ``tpugan``."""
    if getattr(args, "lpips_weights", None):
        from tpugan_torch.losses.lpips import LPIPS, make_lpips_fn

        state = convert.lpips_vgg(convert.load_torch_state_dict(cached_path(args.lpips_weights)))
        model = convert.built(LPIPS, state).to(resolve_device(getattr(args, "device", "cuda")))
        if getattr(args, "bf16", False) and not getattr(args, "fp32_lpips", False):
            # the bf16 LPIPS of tpugan's bf16 runs: bf16 VGG weights and
            # inputs, fp32 distances. The training CLIs' perceptual terms
            # are log-only; the inversion's is in the gradient, where
            # --fp32_lpips keeps it fp32
            from tpugan_torch.precision import BF16, bf16_lpips

            return bf16_lpips(make_lpips_fn(model.to(BF16)))
        return make_lpips_fn(model)
    warn_random_weights("lpips_weights", "the LPIPS loss term is DISABLED")
    return None


def build_vgg16(args):
    """The Grad-CAM VGG16 (1000 classes) on ``args.device``, frozen: from
    ``--vgg_weights`` (torchvision's state dict, classifier included,
    converted; ``tpugan/cli/common.py:356-372``), else with random weights
    seeded by ``args.seed`` and a loud warning, as ``tpugan`` runs without
    it: the attention over random features is exercised, not meaningful.
    ``--vgg_weights`` takes a path or URL (``io/fetch.py``)."""
    from tpugan_torch.losses.vgg import VGG16

    if getattr(args, "vgg_weights", None):
        vgg = convert.built(VGG16, convert.vgg16(convert.load_torch_state_dict(cached_path(args.vgg_weights))))
    else:
        warn_random_weights("vgg_weights", "VGG16 (Grad-CAM/GBP) weights are RANDOM")
        vgg = VGG16(generator=torch.Generator().manual_seed(args.seed))
    return vgg.requires_grad_(False).to(resolve_device(getattr(args, "device", "cuda")))


def loss_log_of(base: str):
    """``Loss.txt`` under ``base``, opened for appending on the primary
    process (``runtime.is_primary_host``); elsewhere a context that gives
    ``None``: the other processes of a group write nothing."""
    import contextlib

    from tpugan_torch.runtime import is_primary_host

    if is_primary_host():
        return open(os.path.join(base, "Loss.txt"), "a")
    return contextlib.nullcontext()


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
    """StyleGANv1's generator noise from seed 0 (StyleGAN2 reads its noise
    buffers, PGGAN and BigGAN have none), the encoder's noise from seed 1
    (E_PG's too) and BigGAN's truncated z (at 0.4) from the seed ``iterations %
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
