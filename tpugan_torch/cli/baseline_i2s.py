"""Image2StyleGAN baseline: direct w+ optimisation against a frozen G
(counterpart of ``tpugan/cli/baseline_i2s.py``;
baseline_utils/image2stylegan_w2z_opW.py).

``python -m tpugan_torch.cli.baseline_i2s --mtype 2 --img_size 1024
--random_init --img_dir ./faces [--iterations 1000]`` optimises, for each
image, a w+ code from zeros ``[1, num_style_layers, 512]`` on the image
space loss (no encoder), with Adam at optax.adam's defaults, in chunks of
100 iterations (at least one), and saves w and the reconstruction. The
generator noise is :func:`~tpugan_torch.cli.common.draw_inputs`'s.

As in ``tpugan``, an untrained StyleGANv1 goes NaN from w = 0 by the
task's design (its docstring): the generator's noise weights and biases
start at 0, so each instance norm sees zero variance and amplifies the
backward by about 1/sqrt(eps). ``--mtype 4`` raises, as ``tpugan``'s does:
BigGAN needs a class label, which this tool does not build. So does
``--mtype 3``: PGGAN takes z [N, 512], not a w+ code.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from tpugan_torch.cli.common import (
    GanBundle,
    add_common_args,
    build_bundle,
    draw_inputs,
    family_pipeline,
    make_result_dirs,
)
from tpugan_torch.losses.space_loss import space_loss

CHUNK = 100  # iterations between logs (tpugan's scan length)


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="image2stylegan w optimization")
    add_common_args(parser, training=True)
    parser.add_argument("--img_dir", required=True)
    parser.set_defaults(iterations=1000, lr=0.01, batch_size=1)
    return parser


def adam(w: torch.Tensor, lr: float) -> torch.optim.Adam:
    """Adam as ``optax.adam(lr)``: betas 0.9 and 0.999, eps 1e-8 added
    outside the square root, both moments bias-corrected."""
    return torch.optim.Adam([w], lr=lr, betas=(0.9, 0.999), eps=1e-8)


def train_resynth(bundle: GanBundle):
    """``resynth(w) -> images`` through the frozen generator, differentiable
    with respect to w, on :func:`draw_inputs`'s generator noise (StyleGAN2
    reads its noise buffers)."""
    _, resynth = family_pipeline(bundle, bundle.generator, bundle.mapping, train=True)
    noise_g = draw_inputs(bundle, 1).noise_g
    return lambda w: resynth(w, None, noise_g)


def optimise(resynth, target: torch.Tensor, w: torch.Tensor, opt: torch.optim.Adam,
             steps: int) -> torch.Tensor:
    """``steps`` Adam updates of the leaf ``w`` on ``space_loss(target,
    resynth(w))``; returns each step's loss, before its update, on the
    device."""
    losses = []
    for _ in range(steps):
        loss, _ = space_loss(target, resynth(w))
        (w.grad,) = torch.autograd.grad(loss, [w])
        opt.step()
        losses.append(loss.detach())
    return torch.stack(losses)


def main(argv=None):
    args = make_parser().parse_args(argv)
    if args.mtype == 4:
        raise TypeError("baseline_i2s regenerates without BigGAN's class label (tpugan's fails the "
                        "same way); it optimises StyleGAN w+ codes (mtypes 1 and 2)")
    if args.mtype == 3:
        raise TypeError("baseline_i2s optimises a w+ code [1, layers, 512], which PGGAN's generator "
                        "refuses (tpugan's fails the same way); it optimises StyleGAN w+ codes (mtypes 1 and 2)")

    from tpugan_torch.io.image import from_unit, save_image, to_unit
    from tpugan_torch.io.native import load_image_dir_fast as load_image_dir

    bundle = build_bundle(args)
    resynth = train_resynth(bundle)
    images = from_unit(load_image_dir(args.img_dir, args.img_size))
    _, imgs_dir, models_dir = make_result_dirs(args.experiment_dir, f"mtype{args.mtype}-i2s")
    for g in range(len(images)):
        target = torch.from_numpy(np.ascontiguousarray(images[g:g + 1])).to(bundle.device)
        w = torch.zeros((1, bundle.num_style_layers, 512), device=bundle.device, requires_grad=True)
        opt = adam(w, args.lr)
        for _ in range(max(1, args.iterations // CHUNK)):
            loss = optimise(resynth, target, w, opt, CHUNK)[-1]
        with torch.no_grad():
            rec = resynth(w)
        np.save(os.path.join(models_dir, f"{g:05d}_w.npy"), w.detach()[0].cpu().numpy())
        save_image(os.path.join(imgs_dir, f"{g:05d}_rec.png"), np.clip(to_unit(rec[0]), 0, 1))
        print(f"image {g}: final loss {float(loss):.4f}", flush=True)


if __name__ == "__main__":
    main()
