#!/usr/bin/env python3
"""Drive tpugan_torch's serving path on one NVIDIA GPU and check its kernels.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
card and ``nvcc``: it builds ``tpugan_torch/csrc`` from the checkout. Any
failure ends the run with a non-zero exit code and no result line, as does
a machine without a GPU or a directory without the repository.

Phases:
  1. the card (name and power limit, from nvidia-smi) and the kernel build;
  2. each kernel against its plain PyTorch version on the card, at the main
     path's shapes and at the TPU kernels' contract cases (TF32 off);
  3. the main path: the StyleGANv1 Cat256 bundle (random weights from a
     seed, batch 2) answers requests through ``tpugan_torch.cli.infer_e.run``
     while the kernels' launches are counted; one request is replayed on
     the CPU, where the plain versions run, and compared;
  4. times: request latency, the device time of a request by kernel, and
     each kernel's device time beside its plain version, one library call
     for the same function and the least time the card could take (its
     bound).
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
    ``iters`` calls of ``fn`` ran, from torch.profiler (CUPTI)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {
        e.key: (e.device_time_total / iters / 1e3, e.count / iters)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0
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
    check(launches == {"upfirdn2d": want}, f"main path launches {launches}, expected {want}")
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

    def latency(label):
        lat = []
        for i in range(22):
            t0 = time.perf_counter()
            infer_e.run(bundle, BATCH, seed + i)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        lat = sorted(lat[2:])  # after two warm-up requests
        say(f"request latency, {label} ({len(lat)} requests): median {statistics.median(lat):.3f} ms, "
            f"min {lat[0]:.3f}, max {lat[-1]:.3f}")
        return statistics.median(lat)

    median = latency("fp32, TF32 off")
    kernels = device_kernels(torch, lambda: infer_e.run(bundle, BATCH, seed), iters=5)
    busy = sum(ms for ms, _ in kernels.values())
    say(f"device time per request {busy:.3f} ms over {sum(n for _, n in kernels.values()):.0f} "
        f"kernels and copies = {busy / median * 100:.1f}% of the median latency; by name:")
    for name, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]:
        say(f"  {ms:8.3f} ms  x{n:5.0f}  {name[:100]}")
    fir_ms = sum(ms for name, (ms, _) in kernels.items() if "upfirdn2d_kernel" in name)
    say(f"upfirdn2d kernel: {fir_ms:.3f} ms per request, {fir_ms / busy * 100:.2f}% of device time")
    torch.cuda.reset_peak_memory_stats()
    infer_e.run(bundle, BATCH, seed)
    say(f"peak device memory of a request: {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default, which the CLI keeps
    latency("PyTorch defaults (cuDNN convolutions in TF32)")
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
    }]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
