"""Qualitative encoder evaluation (counterpart of ``tpugan/cli/infer_e.py``).

``python -m tpugan_torch.cli.infer_e --mtype 1 --img_size 256
--start_features 64 --random_init`` — fixed-seed synthetic images through
z -> Mapping -> G -> E -> G, written as side-by-side grids. ``--mtype 2
--img_size 1024 --start_features 16`` (``tpugan``'s default request) serves
StyleGAN2-1024 instead: z -> SG2Mapping -> truncation (psi 0.7, 8 layers)
-> SG2Synthesis -> E -> SG2Synthesis, on the generator's noise buffers.
``--mtype 4 --img_size 256 --start_features 64 --z_dim 128`` serves
BigGAN-deep-256 with E_BIG: truncated z and a class label -> G -> E_BIG ->
G. ``--mtype 3 --img_size 1024 --start_features 16`` serves PGGAN-1024
with E_PG: z -> G -> E_PG -> G. One request is :func:`run`:
:func:`draw_request` draws its inputs from the seed, :func:`serve`
computes ``(imgs1, imgs2)``; ``main`` only adds the files. ``--gradcam``
also writes each request's Grad-CAM++ overlay of imgs1
(``cam_seed<k>.png``, :func:`cam_overlay`), from a random VGG16 without
``--vgg_weights`` (which comes with ROADMAP slice 7), as in ``tpugan``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from tpugan_torch.cli.common import GanBundle, add_common_args, build_bundle, build_vgg16, make_result_dirs
from tpugan_torch.losses.gradcam import grad_cam, mask2cam
from tpugan_torch.train.e_align import Request, draw_biggan_request, draw_noise
from tpugan_torch.utils import iteration_generator


def draw_request(bundle: GanBundle, batch_size: int, seed: int) -> Request:
    """Draw a request's inputs from the seed (``seed % 30000``) on the
    bundle's device. BigGAN's request is a truncated z, one class shared by
    the batch (cli/common.py:277-281 of ``tpugan``) and E_BIG's noise;
    StyleGAN2's and PGGAN's are z and the encoder's noise (StyleGAN2 reads
    its noise buffers in both decodes, PGGAN has none)."""
    if bundle.mtype == 4:
        return draw_biggan_request(bundle.encoder, bundle.generator.config.num_classes,
                                   bundle.z_dim, bundle.img_size, batch_size, seed, bundle.device)
    g = iteration_generator(seed, bundle.device)
    z = torch.randn(batch_size, bundle.z_dim, generator=g, device=bundle.device)
    if bundle.mtype in (2, 3):
        noise_e = draw_noise(bundle.encoder.noise_shapes(batch_size, bundle.img_size), g)
        return Request(z, None, noise_e, None)
    g_shapes = bundle.generator.noise_shapes(batch_size)
    noise_g = draw_noise(g_shapes, g)
    noise_e = draw_noise(bundle.encoder.noise_shapes(batch_size, bundle.img_size), g)
    noise_g2 = draw_noise(g_shapes, g)
    return Request(z, noise_g, noise_e, noise_g2)


def serve(bundle: GanBundle, request: Request):
    """imgs1 = G(M(z)); imgs2 = G(E(imgs1)); both [N, H, W, C] in [-1, 1].
    BigGAN: (imgs1, cond) = G(zt, label); (c, z2) = E(imgs1, cond);
    imgs2 = G(z2, label)."""
    batch = bundle.synth(request.z, request.label if bundle.mtype == 4 else request.noise_g)
    _, w2 = bundle.encode(batch, request.noise_e)
    imgs2 = bundle.resynth(w2, batch, request.noise_g2)
    return batch.imgs1, imgs2


def run(bundle: GanBundle, batch_size: int, seed: int):
    """One request: ``serve(draw_request(seed))``."""
    return serve(bundle, draw_request(bundle, batch_size, seed))


def write_request(bundle: GanBundle, batch_size: int, seed: int, imgs_dir: str, vgg=None):
    """Serve the request of ``seed`` and write its grid of imgs1 over imgs2
    (``infer_seed<k>.png``) and, with a ``vgg``, its CAM overlay
    (``cam_seed<k>.png``); returns ``(imgs1, imgs2)``."""
    from tpugan_torch.io.image import save_image_grid, to_unit

    imgs1, imgs2 = run(bundle, batch_size, seed)
    grid = np.concatenate([to_unit(imgs1), to_unit(imgs2)], axis=0)
    save_image_grid(os.path.join(imgs_dir, f"infer_seed{seed}.png"), np.clip(grid, 0, 1), nrow=batch_size)
    if vgg is not None:
        save_image_grid(os.path.join(imgs_dir, f"cam_seed{seed}.png"),
                        np.clip(cam_overlay(vgg, imgs1).cpu().numpy(), 0, 1), nrow=batch_size)
    return imgs1, imgs2


def cam_overlay(vgg, imgs1: torch.Tensor) -> torch.Tensor:
    """The Grad-CAM++ overlay of a request's imgs1 (inferE.py's CAM dump;
    ``tpugan/cli/infer_e.py:63-72``)."""
    return mask2cam(grad_cam(vgg, imgs1, plus_plus=True), imgs1)[1]


def main(argv=None):
    parser = argparse.ArgumentParser(description="encoder qualitative eval")
    add_common_args(parser, training=True)
    parser.add_argument("--seed_eval", type=int, default=30000)
    parser.add_argument("--count", type=int, default=3)
    parser.add_argument("--gradcam", action="store_true", help="dump CAM heatmaps")
    args = parser.parse_args(argv)
    bundle = build_bundle(args)
    vgg = build_vgg16(args) if args.gradcam else None
    _, imgs_dir, _ = make_result_dirs(args.experiment_dir, f"mtype{args.mtype}-inferE")
    for seed in range(args.seed_eval, args.seed_eval + args.count):
        write_request(bundle, args.batch_size, seed, imgs_dir, vgg)
    print(imgs_dir)


if __name__ == "__main__":
    main()
