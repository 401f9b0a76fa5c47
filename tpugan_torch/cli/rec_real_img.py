"""One-shot real-image reconstruction CLI (counterpart of
``tpugan/cli/rec_real_img.py``; rec_real_img.py).

``python -m tpugan_torch.cli.rec_real_img --mtype 2 --img_size 1024
--start_features 16 --random_init --img_dir ./faces`` runs E(img) -> w ->
G(w) without gradient, no optimisation, and saves each real/reconstructed
pair and w. The noise is :func:`~tpugan_torch.cli.common.draw_inputs`'s.
``--mtype 4`` raises, as ``tpugan``'s does: E_BIG needs a condition vector,
which this tool does not build.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from tpugan_torch.cli.common import add_common_args, build_bundle, draw_inputs, make_result_dirs
from tpugan_torch.train.e_align import SynthBatch


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="one-shot reconstruction")
    add_common_args(parser, training=True)
    parser.add_argument("--img_dir", required=True)
    parser.set_defaults(batch_size=1)
    return parser


def main(argv=None):
    args = make_parser().parse_args(argv)
    if args.mtype == 4:
        raise TypeError("rec_real_img runs E_BIG without the condition vector it needs "
                        "(tpugan's rec_real_img fails the same way); use embedding --mtype 4")

    from tpugan_torch.io.image import from_unit, save_image, to_unit
    from tpugan_torch.io.native import load_image_dir_fast as load_image_dir

    bundle = build_bundle(args)
    bs = args.batch_size
    draws = draw_inputs(bundle, bs)

    @torch.no_grad()
    def reconstruct(imgs):
        _, w = bundle.encode(SynthBatch(w1=None, imgs1=imgs, const1=None), draws.noise_e)
        return bundle.resynth(w, None, draws.noise_g), w

    images = from_unit(load_image_dir(args.img_dir, args.img_size))
    _, imgs_dir, models_dir = make_result_dirs(args.experiment_dir, f"mtype{args.mtype}-rec")
    for g in range(len(images) // bs):
        batch = torch.from_numpy(np.ascontiguousarray(images[g * bs:(g + 1) * bs])).to(bundle.device)
        rec, w = (x.cpu().numpy() for x in reconstruct(batch))
        for i in range(bs):
            save_image(os.path.join(imgs_dir, f"{g * bs + i:05d}_real.png"),
                       np.clip(to_unit(images[g * bs + i]), 0, 1))
            save_image(os.path.join(imgs_dir, f"{g * bs + i:05d}_rec.png"), np.clip(to_unit(rec[i]), 0, 1))
            np.save(os.path.join(models_dir, f"{g * bs + i:05d}_w.npy"), w[i])
    print(imgs_dir)


if __name__ == "__main__":
    main()
