"""Device time of the attention forward (B3, without and with the
logsumexp) and backward (B4) of the checkout this is run from, at the
BigGAN-256 paths' shape, from torch.profiler.

Run from the root of a checkout, on a machine with the card:
``python3 <path to this file> LABEL``. It imports the ``tpugan_torch`` of the
working directory, so the same file times another commit's kernels from
that commit's unpacked tree (``git archive``), in the same session as the
current one. Prints the card, each kernel's time per call and the total.
"""

from __future__ import annotations

import os
import subprocess
import sys

SHAPE = ((2, 4096, 64), (2, 1024, 64), (2, 1024, 256))  # q, k, v
ITERS = 20


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpugan_torch.ops import attention, cuda

    if not torch.cuda.is_available():
        print("attention_times: no CUDA device", file=sys.stderr)
        return 1
    label = sys.argv[1] if len(sys.argv) > 1 else os.getcwd()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda.build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(shape, device=dev, generator=gen) for shape in SHAPE)
    do = torch.randn(SHAPE[0][0], SHAPE[0][1], SHAPE[2][2], device=dev, generator=gen)
    o, lse = attention.sagan_attention_plain(q, k, v, return_lse=True)
    print(f"attention_times {label}: {smi}; q {list(SHAPE[0])}, k {list(SHAPE[1])}, v {list(SHAPE[2])}")
    calls = {
        "B3": lambda: attention.sagan_attention_cuda(q, k, v),
        "B3 with lse": lambda: attention.sagan_attention_cuda(q, k, v, return_lse=True),
        "B4": lambda: attention.sagan_attention_bwd_cuda(q, k, v, o, lse, do),
    }
    for name, fn in calls.items():
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(ITERS):
                fn()
            torch.cuda.synchronize()
        total = 0.0
        for e in prof.key_averages():
            if e.device_time_total > 0:
                us = e.device_time_total / ITERS
                total += us
                print(f"  {us:9.2f} us x{e.count / ITERS:.0f}  {e.key[:90]}")
        print(f"attention_times {label} {name}: {total:.2f} us per call (torch.profiler, {ITERS} calls)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
