"""The first iterations of ``chip_smoke.py`` phase 12's BigGAN-deep-256
inversion (``embedding --mtype 4``, fine-tuning E_BIG on random weights) at
a given lr, run four ways on the same weights, target and draws: on the
card through the attention kernels; on the CPU through the plain
attention in fp32 and in float64 (the port's arithmetic in float64 where
its modules allow it: the plain attention and the spectral norms' sigma
stay fp32); and on the CPU in float64 with the attention's backward taken
by autograd of a float64 softmax in place of the logsumexp form. Each runs
with E_BIG's spectral-norm ``u``/``v`` as drawn at init and again
converged by 50 power iterations, as a trained E_BIG's are. It tells a
divergence of the update itself, which all four share, from a fault of
the kernels, of fp32 or of the logsumexp backward, which the float64 runs
do not share.

Run from the root of a checkout, on a machine with the card:
``python3 tpugan_torch/tools/inversion_lr.py [--lr 0.01 ...]
[--iterations 2]``. It imports ``chip_smoke.py`` and the ``tpugan_torch``
of the working directory. Prints the card, then each run's loss_msiv and
|w| by iteration, and a JSON summary as its last line.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

# (name, device, dtype, attention backward by autograd of the softmax)
FORMS = (("card fp32", "cuda", "float32", False), ("cpu fp32", "cpu", "float32", False),
         ("cpu float64", "cpu", "float64", False), ("cpu float64, autograd attention", "cpu", "float64", True))
UV_ITERATIONS = {"as drawn": 0, "converged": 50}


def softmax_attention(q, k, v):
    """``softmax(q k^T) v`` in the inputs' dtype, differentiated by autograd:
    no logsumexp backward, no fp32 score matrix."""
    import torch

    return torch.bmm(torch.softmax(torch.bmm(q, k.transpose(1, 2)), dim=-1), v)


def inverter(torch, smoke, place, dtype, lr, iterations, factor=None, uv_iterations=0):
    """Phase 12's BigGAN inverter (``embedding.build_inverter`` over the
    bundle of its flags) in ``dtype`` on ``place``, with the random LPIPS of
    ``random_lpips_fn`` in the same dtype. With ``factor`` (``None`` for
    the probe that measures it), the z head scaled by it and every SelfAttn
    gamma set, as phase 12 sets them after drawing its target, and E_BIG's
    u/v advanced ``uv_iterations`` times."""
    from tpugan_torch.cli import embedding
    from tpugan_torch.cli.common import build_bundle
    from tpugan_torch.losses.lpips import make_lpips_fn, random_params
    from tpugan_torch.nn.spectral import power_iterate

    args = embedding.make_parser().parse_args(list(smoke.INV_BIGGAN) + [
        "--optimizeE", "true", "--lr", str(lr), "--iterations", str(iterations), "--random_init",
        "--seed", str(smoke.SEED), "--device", place])
    bundle = build_bundle(args)
    bundle.generator.to(dtype)
    bundle.encoder.to(dtype)
    if factor is not None:
        smoke.scale_z_head(torch, bundle.encoder, factor)
        smoke.set_attention_gamma(torch, bundle.generator, smoke.ATTN_GAMMA)
        if uv_iterations:
            power_iterate(bundle.encoder, n_iter=uv_iterations)
    lpips = make_lpips_fn(random_params(torch.Generator().manual_seed(7)).to(bundle.device, dtype))
    return embedding.build_inverter(args, lpips, bundle=bundle)


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke as smoke
    from tpugan_torch.cli import infer_e
    from tpugan_torch.io.image import from_unit, load_image_dir
    from tpugan_torch.models import biggan
    from tpugan_torch.ops import attention, cuda
    from tpugan_torch.runtime import parity_mode

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--lr", type=float, nargs="+", default=[0.01])
    parser.add_argument("--iterations", type=int, default=2)
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("inversion_lr: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}, {torch.get_num_threads()} CPU threads", flush=True)
    cuda.build()
    parity_mode()

    # the target and the z head's factor, as phase 12 makes them on the card
    probe = inverter(torch, smoke, "cuda", torch.float32, opts.lr[0], opts.iterations)
    zt_std, z2_std = smoke.latent_stds(torch, infer_e, probe.bundle, smoke.INV_TARGET_SEED)
    factor = zt_std / z2_std
    with tempfile.TemporaryDirectory() as img_dir:
        smoke.write_target(torch, probe.bundle, img_dir)
        target = torch.from_numpy(np.ascontiguousarray(from_unit(load_image_dir(img_dir, smoke.BIGGAN_SIZE))))
    del probe
    torch.cuda.empty_cache()
    print(f"BigGAN-deep-{smoke.BIGGAN_SIZE} + E_BIG, {' '.join(smoke.INV_BIGGAN)}, fine-tuning E, batch 1, "
          f"{opts.iterations} iterations; gamma {smoke.ATTN_GAMMA:g}, z head scaled by {factor:.4e}", flush=True)

    summary = []
    for lr in opts.lr:
        for uv, uv_iterations in UV_ITERATIONS.items():
            for name, place, dtype_name, by_autograd in FORMS:
                dtype = getattr(torch, dtype_name)
                inv = inverter(torch, smoke, place, dtype, lr, opts.iterations, factor, uv_iterations)
                cuda.reset_launches()
                t0 = time.perf_counter()
                if by_autograd:
                    biggan.sagan_attention = softmax_attention
                try:
                    result = inv.invert(target.to(inv.bundle.device, dtype))
                finally:
                    biggan.sagan_attention = attention.sagan_attention
                if place == "cuda":
                    torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                launched = sum(cuda.launches.values())
                if (launched > 0) != (place == "cuda"):
                    print(f"inversion_lr: {name} launched {dict(cuda.launches)}", file=sys.stderr)
                    return 1
                msiv = [float(x) for x in result.msiv_history.tolist()]
                wnorm = [float(x) for x in result.wnorm_history.tolist()]
                print(f"lr {lr:g}, u/v {uv}, {name}: loss_msiv by iteration {msiv}, |w| {wnorm}; final w "
                      f"finite {bool(torch.isfinite(result.w).all())} ({seconds:.1f} s)", flush=True)
                summary.append({"lr": lr, "uv": uv, "form": name, "loss_msiv": msiv, "w_norm": wnorm,
                                "finite": all(math.isfinite(x) for x in msiv + wnorm), "seconds": seconds})
                del inv, result
                torch.cuda.empty_cache()
    print(f"card: {smi}")
    print(json.dumps({"runs": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
