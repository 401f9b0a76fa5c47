"""PGGAN's fp32 convolutions on one GPU with TF32 off: which layer is slow,
what cuDNN runs for it, and how far a case-2 step's gradient leaves float64
on the card, by cuDNN mode.

``python3 tpugan_torch/tools/pggan_conv_probe.py [--replay]`` from the
repository root, on a machine with a CUDA card (about 20 s; 2 min with
``--replay``, most of it the CPU's float64 steps):

* each conv block of PGGAN-1024 (batch 2) timed with CUDA events;
* layer10's convolution ([2, 256, 128, 128] * [128, 256, 3, 3]) as cuDNN
  runs it by default, per sample, channels_last, deterministic, benchmark,
  with TF32 allowed, and its data gradient; each with the two largest
  kernels of its profile and its distance from float64;
* ``--replay``: a PGGAN-256 case-2 step of ``e_align`` (E_PG at
  start_features 64, batch 2) on the card (cuDNN deterministic, default, G
  per sample, cuDNN off) and on the CPU in fp32, each gradient against a
  float64 CPU run (the norm moments in fp32, as the port computes them) and
  that run against one with float64 moments: the largest distances and
  their leaves.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile


def timed(name, fn, ref=None, iters=5):
    """Mean time of ``iters`` calls from CUDA events, the two largest
    kernels of one profiled call and, with ``ref``, the max |error|."""
    out = fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        out = fn()
    end.record()
    end.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    top = sorted(((e.device_time_total, e.count, e.key) for e in prof.key_averages() if e.device_time_total > 0),
                 reverse=True)[:2]
    err = "" if ref is None else f", max |err| vs float64 {(out.double() - ref).abs().max().item():.3e}"
    print(f"{name}: {start.elapsed_time(end) / iters:.3f} ms{err}; "
          + "; ".join(f"x{c} {k[:70]}" for _, c, k in top), flush=True)


@contextlib.contextmanager
def cudnn(**flags):
    saved = {k: getattr(torch.backends.cudnn, k) for k in flags}
    for k, v in flags.items():
        setattr(torch.backends.cudnn, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(torch.backends.cudnn, k, v)


def layers():
    from tpugan_torch.models import PGGANGenerator

    dev = torch.device("cuda")
    gen = PGGANGenerator(1024, generator=torch.Generator().manual_seed(0)).to(dev)
    x = torch.randn(2, 512, device=dev).reshape(2, -1, 1, 1)
    with torch.no_grad():
        for i in range(2 * (gen.final_log2 - gen.init_log2 + 1)):
            block, xin = getattr(gen, f"layer{i}"), x
            timed(f"layer{i}, input {tuple(xin.shape)}, weight {tuple(block.weight.shape)}", lambda: block(xin))
            x = block(xin)
        g = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn(2, 256, 128, 128, device=dev, generator=g)
        w = torch.randn(128, 256, 3, 3, device=dev, generator=g) * 0.02
        ref = F.conv2d(x.double(), w.double(), padding=1)
        conv = lambda: F.conv2d(x, w, padding=1)  # noqa: E731
        timed("layer10's conv, default", conv, ref)
        timed("per sample", lambda: torch.cat([F.conv2d(x[i:i + 1], w, padding=1) for i in range(2)]), ref)
        xc, wc = (t.contiguous(memory_format=torch.channels_last) for t in (x, w))
        timed("channels_last", lambda: F.conv2d(xc, wc, padding=1), ref)
        for flags in (dict(deterministic=True), dict(benchmark=True), dict(allow_tf32=True)):
            with cudnn(**flags):
                timed(", ".join(f"{k} {v}" for k, v in flags.items()), conv, ref)
    x.requires_grad_(True)
    gy = torch.randn(2, 128, 128, 128, device=dev)
    timed("its data gradient, default", lambda: torch.autograd.grad(F.conv2d(x, w, padding=1), x, gy)[0])


def replay():
    from tpugan_torch.cli import e_align, infer_e
    from tpugan_torch.losses.lpips import make_lpips_fn, random_params
    from tpugan_torch.models import encoders, pggan

    argv = ["--mtype", "3", "--img_size", "256", "--start_features", "64", "--random_init", "--case", "2",
            "--iterations", "1", "--batch_size", "2", "--seed", "0"]
    parser = e_align.make_parser()
    request = infer_e.draw_request(e_align.build_trainer(parser.parse_args(argv + ["--device", "cpu"])).bundle, 2, 0)

    def run(device, dtype):
        lpips = make_lpips_fn(random_params(torch.Generator().manual_seed(7)).to(device, dtype))
        req = request.to(device)
        req = req._replace(z=req.z.to(dtype), noise_e=[tuple(n.to(dtype) for n in b) for b in req.noise_e])
        trainer = e_align.build_trainer(parser.parse_args(argv + ["--device", device]), lpips, draw=lambda it: req)
        for module in (trainer.bundle.generator, trainer.bundle.encoder):
            module.to(dtype)
        grads = []
        step = trainer.state.optimizer.step
        trainer.state.optimizer.step = lambda g=None: (grads.append(g), step(g))
        trainer.step(trainer.state, 0)
        names = [n for n, _ in trainer.state.encoder.named_parameters()]
        return names, [[x.detach().double().cpu() for x in g] for g in grads]

    real_in, real_pn, real_fwd = encoders.instance_norm, pggan.pixel_norm, pggan.PGConvBlock.forward

    def in64(x, epsilon=1e-8):
        mean = x.mean(dim=(2, 3), keepdim=True)
        return (x - mean) * torch.rsqrt((x - mean).square().mean(dim=(2, 3), keepdim=True) + epsilon)

    def pn64(x, dim=1, epsilon=1e-8):
        return x * torch.rsqrt(x.square().mean(dim=dim, keepdim=True) + epsilon)

    def per_sample(self, x):
        return torch.cat([real_fwd(self, x[i:i + 1]) for i in range(x.shape[0])])

    t0 = time.perf_counter()
    names, ref = run("cpu", torch.float64)
    encoders.instance_norm, pggan.pixel_norm = in64, pn64
    variants = {"float64 with float64 moments": run("cpu", torch.float64)[1]}
    encoders.instance_norm, pggan.pixel_norm = real_in, real_pn
    variants["cpu fp32"] = run("cpu", torch.float32)[1]
    with cudnn(deterministic=True):
        variants["card, cuDNN deterministic"] = run("cuda", torch.float32)[1]
    variants["card, cuDNN default"] = run("cuda", torch.float32)[1]
    pggan.PGConvBlock.forward = per_sample
    with cudnn(deterministic=True):
        variants["card, cuDNN deterministic, G per sample"] = run("cuda", torch.float32)[1]
    pggan.PGConvBlock.forward = real_fwd
    with cudnn(enabled=False):
        variants["card, cuDNN off"] = run("cuda", torch.float32)[1]
    print(f"the runs took {time.perf_counter() - t0:.1f} s; max |g| of the float64 step "
          f"{max(r.abs().max().item() for g in ref for r in g):.3e}")
    for label, grads in variants.items():
        worst = sorted(((a - r).abs().max().item(), (a - r).abs().max().item() / max(r.abs().max().item(), 1e-30),
                        f"gradient {k} of {names[i]}") for k, (ga, gr) in enumerate(zip(grads, ref))
                       for i, (a, r) in enumerate(zip(ga, gr)))[::-1][:4]
        print(f"{label}: " + "; ".join(f"{e:.3e} ({rel:.2e} of its leaf) at {w}" for e, rel, w in worst), flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--replay", action="store_true", help="also the case-2 step's gradient by cuDNN mode")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("pggan_conv_probe: no CUDA device")
    sys.path.insert(0, os.getcwd())  # the repository root, where it runs from
    from tpugan_torch.runtime import parity_mode

    parity_mode()
    layers()
    if args.replay:
        replay()


if __name__ == "__main__":
    main()
