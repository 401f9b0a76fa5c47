"""Metric table of two image directories (counterpart of
``tpugan/cli/compare.py``; comparing-baseline.py).

``python -m tpugan_torch.cli.compare --dir1 ./generations --dir2 ./recs
--img_size 512 [--lpips_weights lpips_vgg.pth] [--device cpu]`` prints the
running means after each pair and then one JSON dict of the means of PSNR,
SSIM, LPIPS, MSE and cosine. Without ``--lpips_weights`` LPIPS is 0, with
``tpugan``'s warning.
"""

from __future__ import annotations

import argparse
import json

from tpugan_torch.cli.common import build_lpips_fn
from tpugan_torch.eval.compare import compare_dirs
from tpugan_torch.runtime import resolve_device


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="paired-directory metrics")
    parser.add_argument("--dir1", required=True)
    parser.add_argument("--dir2", required=True)
    parser.add_argument("--img_size", type=int, default=512)
    parser.add_argument("--lpips_weights", default=None)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="run on the GPU (default; raises if there is none) or the CPU")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    result = compare_dirs(args.dir1, args.dir2, args.img_size, lpips_fn=build_lpips_fn(args), device=device)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
