"""Latent-editing CLI (counterpart of ``tpugan/cli/edit.py``;
embeded_img_edit.py).

``python -m tpugan_torch.cli.edit --mtype 2 --img_size 1024 --random_init
--w_path id0-i0-w.npy --direction age.npy --bonus 3 --start 0 --end 18
--out edited.png`` adds ``bonus * direction`` to an inverted w code on the
layers ``start .. start + end - 1`` and regenerates the image. w codes are
``.npy`` or the reference's torch ``.pt``. The generator noise is
:func:`~tpugan_torch.cli.common.draw_inputs`'s. ``--mtype 4`` raises,
as ``tpugan``'s does: BigGAN needs a class label, which this tool does not
build.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from tpugan_torch.cli.common import add_common_args, build_bundle, draw_inputs
from tpugan_torch.invert.edit import edit_latent, load_direction


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="latent direction editing")
    add_common_args(parser, training=False)
    parser.add_argument("--w_path", required=True, help="inverted w code (.npy or torch .pt)")
    parser.add_argument("--direction", required=True, help="direction .npy [1,512]")
    parser.add_argument("--bonus", type=float, default=3.0)
    parser.add_argument("--start", type=int, default=0)
    parser.add_argument("--end", type=int, default=18)
    parser.add_argument("--out", default="./edited.png")
    return parser


def load_w(path) -> np.ndarray:
    """A w code from ``.npy`` or a torch ``.pt`` (embeded_img_edit.py:31).
    A ``.pt`` is read with torch's safe unpickler (``weights_only``): it
    holds a tensor, and any other pickled object is refused."""
    if path.endswith(".npy"):
        return np.load(path)
    w = torch.load(path, map_location="cpu", weights_only=True)
    return np.asarray(w.detach() if hasattr(w, "detach") else w)


def main(argv=None):
    args = make_parser().parse_args(argv)
    if args.mtype == 4:
        raise TypeError("edit regenerates without BigGAN's class label (tpugan's edit fails the "
                        "same way); it edits StyleGAN w codes (mtypes 1 and 2)")

    from tpugan_torch.io.image import save_image, to_unit

    bundle = build_bundle(args)
    w = torch.from_numpy(load_w(args.w_path).reshape(1, -1, 512).astype(np.float32)).to(bundle.device)
    w_edited = edit_latent(w, load_direction(args.direction), args.bonus, args.start, args.end)
    img = bundle.resynth(w_edited, None, draw_inputs(bundle, 1).noise_g)
    save_image(args.out, np.clip(to_unit(img[0]), 0, 1))
    print(args.out)


if __name__ == "__main__":
    main()
