#!/usr/bin/env python3
"""Drive tpugan_torch's serving paths on one NVIDIA GPU and check its kernels.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
card and ``nvcc``: it builds ``tpugan_torch/csrc`` from the checkout. Any
failure ends the run with a non-zero exit code and no result line, as does
a machine without a GPU or a directory without the repository.

Phases:
  1. the card (name and power limit, from nvidia-smi) and the kernel build;
  2. each kernel against its plain PyTorch version on the card, at the main
     paths' shapes and at the TPU kernels' contract cases (TF32 off), and
     out-of-contract calls refused;
  3. the StyleGANv1 Cat256 path: the bundle (random weights from a seed,
     batch 2) answers requests through ``tpugan_torch.cli.infer_e.run``
     while the kernels' launches are counted; one request is replayed on
     the CPU, where the plain versions run, and compared;
  4. its times: request latency, the device time of a request by kernel,
     and the FIR kernel's device time beside its plain version, one library
     call for the same function and the least time the card could take
     (its bound);
  5. the BigGAN-deep-256 + E_BIG path (mtype 4) the same way: the attention
     kernel on the path's own q/k/v, requests with launch counts, a request
     replayed on the CPU with every SelfAttn gamma set non-zero, latency,
     device time by kernel, and the attention kernel's times at the path's
     shape.
The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

# (name substring, memory bytes/s, fp32 FLOP/s outside the tensor cores),
# first match wins; NVIDIA data sheets, dense rates
CARD_SPECS = (
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H100", 3.35e12, 67e12),
    ("H200", 4.8e12, 67e12),
)
SEED = 0
REQUEST_SEEDS = (30000, 30001, 30002)  # infer_e's --seed_eval default and the next two
BATCH = 2
IMG_SIZE = 256
# the six same-size 3x3 blurs of one Cat256 decode: (channels, side)
PATH_BLURS = ((512, 8), (512, 16), (512, 32), (256, 64), (128, 128), (64, 256))
# tests/test_pallas_kernels.py's cases, NHWC shapes as written there
B1_CASES = (
    (1, 1, (1, 2, 1), (1, 1), (2, 8, 8, 4)),
    (1, 1, (1, 2, 1), (1, 1), (1, 16, 12, 8)),
    (2, 1, (1, 3, 3, 1), (3, 1), (2, 8, 8, 4)),
    (1, 2, (1, 3, 3, 1), (1, 1), (2, 16, 16, 4)),
    (1, 1, (1, 3, 3, 1), (2, 1), (1, 8, 8, 4)),
    (2, 1, (1, 2, 1), (2, 0), (1, 6, 6, 2)),
    (2, 1, (1, 3, 3, 1), (3, 1), (1, 32, 8, 4)),  # the multi-tile case
)
B2_CASES = (
    ((1, 2, 1), (1, 1), (2, 16, 16, 16)),
    ((1, 3, 3, 1), (2, 1), (1, 32, 24, 8)),
    ((1, 2, 1), (1, 1), (2, 9, 11, 4)),
)
# the rest of the kernel's contract: up and down together, a gain, 8 taps
# (up, down, taps, pad, NHWC shape, gain)
EXTRA_CASES = (
    (2, 2, (1, 3, 3, 1), (2, 2), (1, 7, 7, 3), 1.0),
    (2, 1, (1, 3, 3, 1), (2, 1), (2, 5, 5, 3), 4.0),
    (1, 1, (1, 7, 21, 35, 35, 21, 7, 1), (4, 3), (1, 12, 10, 5), 1.0),
)
KERNEL_TOL = 1e-5  # abs and rel, the Pallas kernels' own contract
CPU_GPU_ATOL = 1e-3  # whole request, fp32 on both sides: cuDNN vs CPU conv summation order
# tests/test_attention.py's cases: (q, k, v shapes, input scale, rtol, atol, check lse);
# then lengths that are not multiples of the kernel's 64-row tiles, widths that are not
# multiples of 4 (4-byte V copies), and BigGAN-128's head widths (dk 32, dv 128) at its
# attention layer (64x64x256)
ATTENTION_CASES = (
    ((2, 256, 32), (2, 128, 32), (2, 128, 64), 1.0, 2e-5, 2e-5, False),
    ((1, 512, 16), (1, 512, 16), (1, 512, 32), 3.0, 2e-4, 2e-5, False),
    ((2, 256, 16), (2, 256, 16), (2, 256, 32), 2.0, 2e-5, 2e-5, True),
    ((1, 37, 8), (1, 19, 8), (1, 19, 24), 2.0, 2e-5, 2e-5, True),
    ((2, 100, 16), (2, 25, 16), (2, 25, 40), 2.0, 2e-5, 2e-5, True),
    ((1, 5, 4), (1, 1, 4), (1, 1, 4), 1.0, 2e-5, 2e-5, True),
    ((1, 130, 128), (1, 70, 128), (1, 70, 256), 0.3, 2e-5, 2e-5, True),
    ((1, 50, 13), (1, 33, 13), (1, 33, 30), 1.0, 2e-5, 2e-5, True),
    ((2, 70, 20), (2, 45, 20), (2, 45, 130), 1.0, 2e-5, 2e-5, True),
    ((2, 4096, 32), (2, 1024, 32), (2, 1024, 128), 1.0, 2e-5, 2e-5, True),
)
LSE_TOL = 1e-5  # tests/test_attention.py:54
BIGGAN_SIZE = 256
BIGGAN_Z_DIM = 128
ATTN_GAMMA = 1.0  # every SelfAttn.gamma in the CUDA-vs-CPU BigGAN check (random init gives 0)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def say(*parts):
    print(*parts, flush=True)


def card_specs(name):
    for key, bandwidth, fp32 in CARD_SPECS:
        if key in name:
            return bandwidth, fp32
    raise RuntimeError(f"chip_smoke: no memory/compute peaks known for {name!r}")


def time_ms(torch, fn, iters=50, warmup=5):
    """Mean time per call of ``iters`` calls back to back, from CUDA events:
    the device time, or the host's issue time where that is longer."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_kernels(torch, fn, iters):
    """Device time (ms) and count per call of each kernel and copy that
    ``iters`` calls of ``fn`` ran, from torch.profiler (CUPTI). A trace
    with no device time at all is taken again, twice at most, and each
    retake prints a line."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, 4):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        found = {
            e.key: (e.device_time_total / iters / 1e3, e.count / iters)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0
        }
        if found:
            return found
        say(f"profiler: trace {attempt} of 3 saw no device time; taking it again")
    raise RuntimeError("chip_smoke: three profiler traces in a row saw no device time")


def request_latency(torch, run, seed, label):
    """Host-clock latency of 20 requests ``run(seed + i)``, each ending in a
    synchronize, after two warm-up requests; returns the median (ms)."""
    lat = []
    for i in range(22):
        t0 = time.perf_counter()
        run(seed + i)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    lat = sorted(lat[2:])
    say(f"request latency, {label} ({len(lat)} requests): median {statistics.median(lat):.3f} ms, "
        f"min {lat[0]:.3f}, max {lat[-1]:.3f}")
    return statistics.median(lat)


def request_device_time(torch, run, seed, median, symbol, name):
    """A request's device time by kernel (torch.profiler over 5 requests),
    the share of the kernel whose symbol contains ``symbol``, and the
    request's peak device memory."""
    kernels = device_kernels(torch, lambda: run(seed), iters=5)
    busy = sum(ms for ms, _ in kernels.values())
    say(f"device time per request {busy:.3f} ms over {sum(n for _, n in kernels.values()):.0f} "
        f"kernels and copies = {busy / median * 100:.1f}% of the median latency; by name:")
    for kname, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]:
        say(f"  {ms:8.3f} ms  x{n:5.0f}  {kname[:100]}")
    own = sum(ms for kname, (ms, _) in kernels.items() if symbol in kname)
    say(f"{name} kernel: {own:.3f} ms per request, {own / busy * 100:.2f}% of device time")
    torch.cuda.reset_peak_memory_stats()
    run(seed)
    say(f"peak device memory of a request: {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")


def compare_attention(torch, label, q, k, v, rtol, atol, with_lse):
    """The attention kernel against its plain version on one input; returns
    the max |err| of the output (and of the logsumexp, when checked)."""
    from tpugan_torch.ops.attention import sagan_attention_cuda, sagan_attention_plain

    got = sagan_attention_cuda(q, k, v, return_lse=with_lse)
    want = sagan_attention_plain(q, k, v, return_lse=with_lse)
    torch.cuda.synchronize()
    if with_lse:
        (got, got_lse), (want, want_lse) = got, want
    check(got.shape == want.shape, f"{label}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
    err = (got - want).abs().max().item()
    check(torch.allclose(got, want, rtol=rtol, atol=atol),
          f"{label}: kernel disagrees with plain version, max |err| {err:.3e} "
          f"(rtol {rtol:g}, atol {atol:g})")
    msg = f"parity {label}: max |err| {err:.3e} (rtol {rtol:g}, atol {atol:g})"
    if with_lse:
        lse_err = (got_lse - want_lse).abs().max().item()
        check(got_lse.shape == want_lse.shape == (q.shape[0], q.shape[1], 1), f"{label}: lse shape")
        check(torch.allclose(got_lse, want_lse, rtol=LSE_TOL, atol=LSE_TOL),
              f"{label}: kernel logsumexp disagrees, max |err| {lse_err:.3e}")
        msg += f"; lse max |err| {lse_err:.3e} ({LSE_TOL:g})"
        err = max(err, lse_err)
    say(msg)
    return err


def attention_parity(torch, dev, gen):
    """The attention kernel against its plain version (TF32 off) on
    ATTENTION_CASES, and out-of-contract calls refused; returns the max |err|."""
    from tpugan_torch.ops import cuda
    from tpugan_torch.ops.attention import sagan_attention_cuda

    before = cuda.launches["sagan_attention"]
    max_err = 0.0
    for q_shape, k_shape, v_shape, scale, rtol, atol, with_lse in ATTENTION_CASES:
        q = torch.randn(q_shape, device=dev, generator=gen) * scale
        k = torch.randn(k_shape, device=dev, generator=gen) * scale
        v = torch.randn(v_shape, device=dev, generator=gen)
        label = f"attention q{q_shape} k{k_shape} v{v_shape} x{scale:g}"
        max_err = max(max_err, compare_attention(torch, label, q, k, v, rtol, atol, with_lse))
    check(cuda.launches["sagan_attention"] - before == len(ATTENTION_CASES),
          f"attention launch count {cuda.launches}")
    x = torch.randn(2, 8, 16, device=dev, generator=gen)
    refused = {
        "fp16": lambda: sagan_attention_cuda(x.half(), x.half(), x.half()),
        "non-contiguous": lambda: sagan_attention_cuda(x.transpose(0, 1), x, x),
        "dk 129": lambda: sagan_attention_cuda(x.new_zeros(2, 8, 129), x.new_zeros(2, 8, 129), x),
        "dv 257": lambda: sagan_attention_cuda(x, x, x.new_zeros(2, 8, 257)),
        "CPU tensors": lambda: sagan_attention_cuda(x.cpu(), x.cpu(), x.cpu()),
    }
    for name, call in refused.items():
        try:
            call()
        except (TypeError, ValueError):
            continue
        raise RuntimeError(f"chip_smoke: out-of-contract attention call ({name}) was not refused")
    check(cuda.launches["sagan_attention"] - before == len(ATTENTION_CASES), "a refused call launched")
    say(f"attention parity: {len(ATTENTION_CASES)} cases (max |err| {max_err:.3e}); "
        f"{len(refused)} out-of-contract calls refused: {', '.join(refused)}")
    return max_err


def set_attention_gamma(torch, model, value):
    from tpugan_torch.models import SelfAttn

    layers = [m for m in model.modules() if isinstance(m, SelfAttn)]
    with torch.no_grad():
        for m in layers:
            m.gamma.fill_(value)
    return len(layers)


def latent_stds(torch, infer_e, bundle, seed):
    """The std of one request's truncated latents zt and of E_BIG's z2 for
    them. A trained E_BIG returns z2 close to zt; with flax's random init
    z2 comes out far wider, and BigGAN's conditional batch norms, which
    scale by 1 + a linear map of [z2, embedding], then overflow fp32 in the
    resynthesis pass (tpugan's own init does the same:
    tests/test_torch_init.py)."""
    request = infer_e.draw_request(bundle, BATCH, seed)
    batch = bundle.synth(request.z, request.label)
    _, z2 = bundle.encode(batch, request.noise_e)
    return request.z.std().item(), z2.std().item()


def scale_z_head(torch, encoder, factor):
    with torch.no_grad():
        encoder.new_final_2.weight.mul_(factor)
        encoder.new_final_2.bias.mul_(factor)


def biggan_path(torch, dev, parser, smi, bandwidth, fp32_peak):
    """Phase 5: the mtype-4 path (BigGAN-deep-256 + E_BIG, batch 2). Returns
    the attention kernel's entry of the kernel table."""
    import torch.nn.functional as F

    from tpugan_torch.cli import common, infer_e
    from tpugan_torch.models import biggan as biggan_model
    from tpugan_torch.ops import cuda
    from tpugan_torch.ops.attention import sagan_attention_cuda, sagan_attention_plain

    argv = ["--mtype", "4", "--img_size", str(BIGGAN_SIZE), "--start_features", "64",
            "--z_dim", str(BIGGAN_Z_DIM), "--random_init", "--batch_size", str(BATCH),
            "--seed", str(SEED)]
    t0 = time.perf_counter()
    bundle = common.build_bundle(parser.parse_args(argv + ["--device", "cuda"]))
    torch.cuda.synchronize()
    cfg = bundle.generator.config
    say(f"bundle: mtype 4, BigGAN-deep-{cfg.output_dim} (channel_width {cfg.channel_width}, "
        f"{len(cfg.layers)} GenBlocks, SelfAttn at position {cfg.attention_layer_position}, "
        f"{cfg.num_classes} classes, n_stats {cfg.n_stats}, z_dim {cfg.z_dim}) + E_BIG (startf 64, "
        f"maxf 512, layer_count {bundle.layer_count}) built in {time.perf_counter() - t0:.2f} s")
    seed = REQUEST_SEEDS[0]
    # the CLI's own weights first: the synthesis is finite, the resynthesis
    # from E_BIG's wide z2 overflows
    imgs1, imgs2 = infer_e.run(bundle, BATCH, seed)
    check(bool(torch.isfinite(imgs1).all()), "BigGAN imgs1 of the CLI's weights is not finite")
    not_finite = (~torch.isfinite(imgs2)).float().mean().item()
    zt_std, z2_std = latent_stds(torch, infer_e, bundle, seed)
    say(f"the CLI's weights (flax's random init): z2 std {z2_std:.4f} against zt std {zt_std:.4f}; "
        f"imgs1 finite, {not_finite * 100:.2f}% of imgs2 not finite (a wide z2 overflows fp32 in "
        "BigGAN's conditional batch norms, with tpugan's own init too: tests/test_torch_init.py)")
    factor = zt_std / z2_std
    scale_z_head(torch, bundle.encoder, factor)
    say(f"from here on E_BIG's z head (new_final_2) is scaled by {factor:.4e}, so z2 has zt's std "
        "(a trained E_BIG returns z2 close to zt)")

    # the kernel on the path's own q/k/v, captured from one request
    captured = []
    real = biggan_model.sagan_attention

    def capture(q, k, v):
        captured.append((q.clone(), k.clone(), v.clone()))
        return real(q, k, v)

    biggan_model.sagan_attention = capture
    try:
        infer_e.run(bundle, BATCH, seed)
    finally:
        biggan_model.sagan_attention = real
    check(len(captured) == 2, f"a request called the attention {len(captured)} times, not 2")
    max_err = 0.0
    for name, (q, k, v) in zip(("synthesis", "resynthesis"), captured):
        scores = torch.bmm(q, k.transpose(1, 2)).abs().max().item()
        label = (f"attention, the path's own q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)} "
                 f"({name} pass, max |q k^T| {scores:.2f})")
        max_err = max(max_err, compare_attention(torch, label, q, k, v, 2e-5, 2e-5, True))

    # the main path: launches counted from 0
    cuda.reset_launches()
    for s in REQUEST_SEEDS:
        imgs1, imgs2 = infer_e.run(bundle, BATCH, s)
        torch.cuda.synchronize()
        for label, img in (("imgs1", imgs1), ("imgs2", imgs2)):
            check(tuple(img.shape) == (BATCH, BIGGAN_SIZE, BIGGAN_SIZE, 3),
                  f"BigGAN {label} shape {tuple(img.shape)}")
            check(bool(torch.isfinite(img).all()), f"BigGAN {label} of seed {s} is not finite")
    launches = dict(cuda.launches)
    want = {"upfirdn2d": 0, "sagan_attention": 2 * len(REQUEST_SEEDS)}
    check(launches == want, f"BigGAN path launches {launches}, expected {want}")
    say(f"BigGAN path: {len(REQUEST_SEEDS)} requests, launches {launches} "
        "(2 per request: the synthesis and the resynthesis pass)")

    # one request on the card and on the CPU, with the attention in the images
    cpu = common.build_bundle(parser.parse_args(argv + ["--device", "cpu"]))
    scale_z_head(torch, cpu.encoder, factor)
    request = infer_e.draw_request(cpu, BATCH, seed)
    zero_gamma = infer_e.serve(bundle, request.to(dev))
    for b in (bundle, cpu):
        check(set_attention_gamma(torch, b.generator, ATTN_GAMMA) == 1, "expected one SelfAttn")
    cuda.reset_launches()
    on_gpu = infer_e.serve(bundle, request.to(dev))
    torch.cuda.synchronize()
    check(cuda.launches["sagan_attention"] == 2, f"cuda request launches {cuda.launches}")
    on_cpu = infer_e.serve(cpu, request)
    check(cuda.launches["sagan_attention"] == 2, "the CPU request launched the kernel")
    moved = max((a - b).abs().max().item() for a, b in zip(on_gpu, zero_gamma))
    say(f"cuda vs cpu (BigGAN): SelfAttn.gamma set to {ATTN_GAMMA:g} on both bundles (random "
        f"init gives 0, which keeps the attention out of the images); the images moved by up to "
        f"{moved:.3f} against gamma 0")
    check(moved > 1e-2, "gamma did not change the images")
    for label, g, c in zip(("imgs1", "imgs2"), on_gpu, on_cpu):
        err = (g.cpu() - c).abs().max().item()
        say(f"cuda vs cpu (BigGAN) {label}: max |err| {err:.3e} (max |ref| {c.abs().max().item():.3f})")
        check(err <= CPU_GPU_ATOL, f"BigGAN {label}: cuda and cpu differ by {err:.3e} > {CPU_GPU_ATOL:g}")
    set_attention_gamma(torch, bundle.generator, 0.0)  # back to the CLI's init for the times
    del cpu

    say(f"BigGAN times below: {smi}; device times from torch.profiler, request times from the host clock")
    run = lambda s: infer_e.run(bundle, BATCH, s)  # noqa: E731
    median = request_latency(torch, run, seed, f"BigGAN-deep-{BIGGAN_SIZE} + E_BIG, fp32, TF32 off")
    request_device_time(torch, run, seed, median, "sagan_attention_kernel", "sagan_attention")

    # the kernel at the path's shape, on the synthesis pass's own inputs
    q, k, v = captured[0]
    n, lq, dk = q.shape
    lk, dv = v.shape[1], v.shape[2]
    library = lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0)  # noqa: E731
    lib_err = (library() - sagan_attention_plain(q, k, v)).abs().max().item()
    check(lib_err < 1e-3, f"scaled_dot_product_attention differs by {lib_err:.3e}")
    calls = {
        "ms": lambda: sagan_attention_cuda(q, k, v),
        "plain_ms": lambda: sagan_attention_plain(q, k, v),
        "library_ms": library,
    }
    row = {}
    names = {}
    for key, fn in calls.items():
        kernels = device_kernels(torch, fn, iters=20)
        row[key] = sum(ms for ms, _ in kernels.values())
        names[key] = sorted(kernels, key=lambda name: -kernels[name][0])
    nbytes = 4 * (q.numel() + k.numel() + v.numel() + n * lq * dv)
    flops = 2 * n * lq * lk * (dk + dv)
    row["bound_ms"] = max(nbytes / bandwidth, flops / fp32_peak) * 1e3
    row["bound_by"] = "bytes" if nbytes / bandwidth >= flops / fp32_peak else "operations"
    issue = {key: time_ms(torch, fn, iters=20) for key, fn in calls.items()}
    shape = f"q [{n}, {lq}, {dk}], k [{n}, {lk}, {dk}], v [{n}, {lk}, {dv}]"
    say(f"attention at the path's shape ({shape}): device time kernel {row['ms'] * 1e3:.2f} us, "
        f"plain {row['plain_ms'] * 1e3:.2f} us, library {row['library_ms'] * 1e3:.2f} us; bound "
        f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}: {flops / 1e9:.3f} GFLOP at "
        f"{fp32_peak / 1e12:.0f} TFLOP/s fp32 outside the tensor cores, {nbytes / 1e6:.3f} MB at "
        f"{bandwidth / 1e12:.2f} TB/s); back to back per call: "
        + ", ".join(f"{k_} {v_ * 1e3:.2f} us" for k_, v_ in issue.items()))
    say(f"  library call: scaled_dot_product_attention(q, k, v, scale=1.0) ran "
        f"{', '.join(name[:80] for name in names['library_ms'])} (max |err| {lib_err:.3e} against "
        "the plain version)")
    say(f"  plain version ran {', '.join(name[:60] for name in names['plain_ms'])}")
    say("  the bound is for fp32 FMAs outside the tensor cores, as the kernel computes; a TF32 "
        "tensor-core design would have a lower bound, and that design is a later PR's")
    return {
        "name": "sagan_attention",
        "route": "cuda",
        "source": "tpugan_torch/csrc/sagan_attention.cu",
        "replaces": "tpugan/ops/pallas/attention.py:68 (sagan_attention_pallas); "
                    "tpugan/ops/pallas/attention.py:77 (sagan_attention_pallas, return_lse=True)",
        "launches": launches["sagan_attention"],
        "max_abs_err": max_err,
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
        "library_kernels": [name[:100] for name in names["library_ms"]],
        "times_are": f"one call at the BigGAN-{BIGGAN_SIZE} path's shape ({shape}), on a request's own inputs",
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1

    import torch.nn.functional as F

    from tpugan_torch.cli import common, infer_e
    from tpugan_torch.ops import cuda
    from tpugan_torch.ops.upfirdn import setup_fir_kernel, upfirdn2d_cuda, upfirdn2d_plain
    from tpugan_torch.runtime import parity_mode

    dev = torch.device("cuda")
    # ---- 1. the card and the build ----------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    bandwidth, fp32_peak = card_specs(kind)
    say(f"card: {smi}")
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    t0 = time.perf_counter()
    logs = cuda.build()
    say(f"build: {sorted(cuda.KERNELS)} in {time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                say(f"  ptxas[{name}]: {line.strip()}")

    # ---- 2. kernels against their plain versions --------------------------
    parity_mode()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    blur = setup_fir_kernel((1, 2, 1))
    cases = [(f"blur {c}x{r}x{r}", 1, 1, (1, 2, 1), (1, 1), (BATCH, r, r, c), 1.0)
             for c, r in PATH_BLURS]
    cases += [(f"B1 up{u} down{d}", u, d, t, p, s, 1.0) for u, d, t, p, s in B1_CASES]
    cases += [("B2", 1, 1, t, p, s, 1.0) for t, p, s in B2_CASES]
    cases += [(f"up{u} down{d} gain{g:g}", u, d, t, p, s, g) for u, d, t, p, s, g in EXTRA_CASES]
    max_err = 0.0
    cuda.reset_launches()
    for label, up, down, taps, pad, (n, h, w, c), gain in cases:
        label = f"{label} taps{len(taps)} pad{pad} NCHW{(n, c, h, w)}"
        x = torch.randn(n, c, h, w, device=dev, generator=gen)
        taps = setup_fir_kernel(taps)
        got = upfirdn2d_cuda(x, taps, up, down, pad, gain)
        want = upfirdn2d_plain(x, taps, up, down, pad, gain)
        torch.cuda.synchronize()
        check(got.shape == want.shape, f"{label}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
        err = (got - want).abs().max().item()
        max_err = max(max_err, err)
        check(torch.allclose(got, want, rtol=KERNEL_TOL, atol=KERNEL_TOL),
              f"{label}: kernel disagrees with plain version, max |err| {err:.3e}")
        say(f"parity {label}: max |err| {err:.3e}")
    check(cuda.launches["upfirdn2d"] == len(cases), f"launch count {cuda.launches} != {len(cases)}")
    x = torch.randn(1, 4, 8, 8, device=dev, generator=gen)
    refused = [
        lambda: upfirdn2d_cuda(x.half(), blur, pad=(1, 1)),
        lambda: upfirdn2d_cuda(x.transpose(2, 3), blur, pad=(1, 1)),
        lambda: upfirdn2d_cuda(x, blur, up=3, pad=(1, 1)),
        lambda: upfirdn2d_cuda(x, setup_fir_kernel([1.0] * 9), pad=(4, 4)),
        lambda: upfirdn2d_cuda(x, blur, pad=(-1, 1)),
    ]
    for i, call in enumerate(refused):
        try:
            call()
        except (TypeError, ValueError):
            continue
        raise RuntimeError(f"chip_smoke: out-of-contract call {i} was not refused")
    say(f"parity: {len(cases)} cases within {KERNEL_TOL:g} (max |err| {max_err:.3e}); "
        f"{len(refused)} out-of-contract calls refused")
    attn_err = attention_parity(torch, dev, gen)

    # ---- 3. the main path -----------------------------------------------------
    parser = argparse.ArgumentParser()
    common.add_common_args(parser, training=True)
    argv = ["--mtype", "1", "--img_size", str(IMG_SIZE), "--start_features", "64", "--random_init",
            "--batch_size", str(BATCH), "--seed", str(SEED)]
    t0 = time.perf_counter()
    bundle = common.build_bundle(parser.parse_args(argv + ["--device", "cuda"]))
    torch.cuda.synchronize()
    say(f"bundle: mtype 1 at {IMG_SIZE}px (startf 64, maxf 512, layer_count {bundle.layer_count}) "
        f"built in {time.perf_counter() - t0:.2f} s")
    blurs_per_request = 2 * (bundle.layer_count - 1)  # two decodes, a blur in each block but the first
    check(blurs_per_request == 2 * len(PATH_BLURS), "PATH_BLURS does not match the generator")

    cuda.reset_launches()
    for seed in REQUEST_SEEDS:
        imgs1, imgs2 = infer_e.run(bundle, BATCH, seed)
        torch.cuda.synchronize()
        for label, img in (("imgs1", imgs1), ("imgs2", imgs2)):
            check(tuple(img.shape) == (BATCH, IMG_SIZE, IMG_SIZE, 3), f"{label} shape {tuple(img.shape)}")
            check(bool(torch.isfinite(img).all()), f"{label} of seed {seed} is not finite")
    launches = dict(cuda.launches)
    want = blurs_per_request * len(REQUEST_SEEDS)
    check(launches == {"upfirdn2d": want, "sagan_attention": 0},
          f"main path launches {launches}, expected {want} upfirdn2d and no attention")
    say(f"main path: {len(REQUEST_SEEDS)} requests, launches {launches} "
        f"({blurs_per_request} per request)")

    # the same explicit inputs, drawn on the CPU, through the plain versions there
    cpu = common.build_bundle(parser.parse_args(argv + ["--device", "cpu"]))
    seed = REQUEST_SEEDS[0]
    request = infer_e.draw_request(cpu, BATCH, seed)
    cuda.reset_launches()
    on_gpu = infer_e.serve(bundle, request.to(dev))
    torch.cuda.synchronize()
    check(cuda.launches["upfirdn2d"] == blurs_per_request, f"cuda request launches {cuda.launches}")
    on_cpu = infer_e.serve(cpu, request)
    check(cuda.launches["upfirdn2d"] == blurs_per_request, "the CPU request launched the kernel")
    for label, g, c in zip(("imgs1", "imgs2"), on_gpu, on_cpu):
        err = (g.cpu() - c).abs().max().item()
        say(f"cuda vs cpu {label}: max |err| {err:.3e} (max |ref| {c.abs().max().item():.3f})")
        check(err <= CPU_GPU_ATOL, f"{label}: cuda and cpu differ by {err:.3e} > {CPU_GPU_ATOL:g}")

    # ---- 4. times ----------------------------------------------------------
    say(f"times below: {smi}; device times from torch.profiler, request times from the host clock")

    run = lambda s: infer_e.run(bundle, BATCH, s)  # noqa: E731
    median = request_latency(torch, run, seed, "fp32, TF32 off")
    request_device_time(torch, run, seed, median, "upfirdn2d_kernel", "upfirdn2d")
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default, which the CLI keeps
    request_latency(torch, run, seed, "PyTorch defaults (cuDNN convolutions in TF32)")
    parity_mode()

    rows = []
    for c, r in PATH_BLURS:
        x = torch.randn(BATCH, c, r, r, device=dev, generator=gen)
        w = torch.from_numpy(blur).to(dev).expand(c, 1, 3, 3).contiguous()
        got = upfirdn2d_cuda(x, blur, pad=(1, 1))
        check(torch.allclose(F.conv2d(x, w, padding=1, groups=c), got, rtol=KERNEL_TOL,
                             atol=KERNEL_TOL), f"library call differs at {c}x{r}")
        calls = {
            "ms": lambda: upfirdn2d_cuda(x, blur, pad=(1, 1)),
            "plain_ms": lambda: upfirdn2d_plain(x, blur, pad=(1, 1)),
            "library_ms": lambda: F.conv2d(x, w, padding=1, groups=c),
        }
        nbytes = 2 * x.numel() * x.element_size()
        flops = 2 * 9 * x.numel()
        row = {"shape": [BATCH, c, r, r]}
        for key, fn in calls.items():
            row[key] = sum(ms for ms, _ in device_kernels(torch, fn, iters=20).values())
        row["bound_ms"] = max(nbytes / bandwidth, flops / fp32_peak) * 1e3
        row["bound_by"] = "bytes" if nbytes / bandwidth >= flops / fp32_peak else "operations"
        rows.append(row)
        issue = {key: time_ms(torch, fn) for key, fn in calls.items()}
        say(f"blur {c}x{r}x{r}: device time kernel {row['ms'] * 1e3:.2f} us, plain "
            f"{row['plain_ms'] * 1e3:.2f} us, library {row['library_ms'] * 1e3:.2f} us; bound "
            f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}, {nbytes / 1e6:.3f} MB); "
            "back to back per call: " + ", ".join(f"{k} {v * 1e3:.2f} us" for k, v in issue.items()))
    per_decode = {k: sum(r[k] for r in rows) for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    say(f"per decode ({len(PATH_BLURS)} blurs): kernel {per_decode['ms'] * 1e3:.2f} us, plain "
        f"{per_decode['plain_ms'] * 1e3:.2f} us, library {per_decode['library_ms'] * 1e3:.2f} us, "
        f"bound {per_decode['bound_ms'] * 1e3:.2f} us")

    attn = biggan_path(torch, dev, parser, smi, bandwidth, fp32_peak)
    attn["max_abs_err"] = max(attn["max_abs_err"], attn_err)

    say(f"card: {smi}")
    say(json.dumps({"kernels": [{
        "name": "upfirdn2d",
        "route": "cuda",
        "source": "tpugan_torch/csrc/upfirdn2d.cu",
        "replaces": "tpugan/ops/pallas/upfirdn2d.py:96 (upfirdn2d_pallas); "
                    "tpugan/ops/pallas/upfirdn2d.py:153 (upfirdn2d_pallas_small_c)",
        "launches": launches["upfirdn2d"],
        "max_abs_err": max_err,
        "ms": per_decode["ms"],
        "plain_ms": per_decode["plain_ms"],
        "bound_ms": per_decode["bound_ms"],
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rows) else "operations",
        "library_ms": per_decode["library_ms"],
        "times_are": f"sum over the {len(PATH_BLURS)} blur shapes of one decode at batch {BATCH}",
        "per_shape": rows,
    }, attn]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
