"""This checkout's FIR kernel (``csrc/upfirdn2d.cu`` with ``ops/upfirdn.py``'s
plans) beside another checkout's, on one card and the same inputs.

Run from the root of this checkout on a machine with the card:
``python3 -m tpugan_torch.tools.fir_ab OTHER [--out FILE]``, OTHER the root
of the other checkout (an unpacked ``git archive``, in a directory that
.gitignore lists). It builds the other's source with the same nvcc flags
into OTHER/tpugan_torch/_build, takes the other's launch plans from its
``ops/upfirdn.py`` (the code above ``min_blocks``), and runs both entry
points on the same inputs at the FIR shapes of a StyleGAN2-1024 case-2 step
at batch 2 (the 4-tap FIRs after the up-sampling convolutions and their
adjoints into odd widths, ToRGB up-2s and their adjoints, E_Blur's blurs)
and of a StyleGANv1 Cat256 decode's blurs, in fp32 and bf16. Each output is
held bitwise equal between the two checkouts, and each bf16 output bitwise
the fp32 one on the same values rounded. Device times: CUDA events around
20 calls queued behind a device-side sleep, in turns (other, this, this,
other); this checkout's kernel also times a same-size FIR with its
other strip widths (1 and 4 columns, and 8 in bf16).
Prints a line per shape and dtype and the sums; ``--out`` writes the rows
as JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import functools
import json
import os
import subprocess
import sys
import time
import types
from pathlib import Path

BANDWIDTH = 3.35e12  # an H100 SXM's memory, bytes a second
SLEEP_CYCLES_PER_MS = 2.0e6
TAPS3, TAPS4 = (1.0, 2.0, 1.0), (1.0, 3.0, 3.0, 1.0)
# (label, planes, side in, up, down, taps, pads, gain)
SG2_CHANNELS = ((512, 8), (512, 16), (512, 32), (512, 64), (256, 128), (128, 256), (64, 512), (32, 1024))
SHAPES = (
    *((f"SG2 4-tap FIR {c}x{r + 1}", 2 * c, r + 1, 1, 1, TAPS4, (1, 1), 4.0) for c, r in SG2_CHANNELS),
    *((f"SG2 4-tap adjoint {c}x{r} -> {r + 1}", 2 * c, r, 1, 1, TAPS4, (2, 2), 4.0) for c, r in SG2_CHANNELS),
    *((f"SG2 ToRGB up-2 3x{r}", 6, r, 2, 1, TAPS4, (2, 1), 4.0) for r in (128, 256, 512)),
    *((f"SG2 ToRGB adjoint 3x{2 * r}", 6, 2 * r, 1, 2, TAPS4, (1, 1), 4.0) for r in (128, 256, 512)),
    *((f"E_Blur blur {c}x{r}", 2 * c, r, 1, 1, TAPS3, (1, 1), 1.0) for c, r in ((16, 1024), (32, 512), (64, 256))),
    *((f"SGv1 blur {c}x{r}", 2 * c, r, 1, 1, TAPS3, (1, 1), 1.0)
      for c, r in ((512, 8), (512, 16), (512, 32), (256, 64), (128, 128), (64, 256))),
)


def other_plans(root: Path) -> dict:
    """The other checkout's plan code: its ops/upfirdn.py up to min_blocks."""
    text = (root / "tpugan_torch" / "ops" / "upfirdn.py").read_text()
    module = types.ModuleType("other_upfirdn")
    sys.modules[module.__name__] = module  # dataclasses look their module up
    exec(compile(text[:text.index("@functools.lru_cache(maxsize=None)\ndef min_blocks")], "other_upfirdn", "exec"),
         module.__dict__)
    return module.__dict__


def build_other(root: Path, cuda) -> ctypes.CDLL:
    """The other checkout's csrc/upfirdn2d.cu, built with this checkout's nvcc flags."""
    out = root / "tpugan_torch" / "_build" / "libupfirdn2d_other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([cuda.nvcc_path(), *cuda.NVCC_FLAGS, "-o", str(out),
                    str(root / "tpugan_torch" / "csrc" / "upfirdn2d.cu")], check=True, capture_output=True)
    return ctypes.CDLL(str(out))


def queued_ms(torch, fn, iters=20):
    """Device time per call of ``fn``: CUDA events around ``iters`` calls
    queued behind a device-side sleep three times as long as the host took
    to issue them."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(3 * host_ms * SLEEP_CYCLES_PER_MS))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    from tpugan_torch.ops import cuda, upfirdn

    parser = argparse.ArgumentParser()
    parser.add_argument("other", type=Path)
    parser.add_argument("--out", type=Path)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("fir_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    cuda.build(["upfirdn2d"])
    lib = build_other(args.other.resolve(), cuda)
    print(f"fir_ab: {smi}; both built in {time.perf_counter() - t0:.1f} s", flush=True)
    plans = other_plans(args.other.resolve())
    other_takes_pad_x0 = "pad_x0" in (args.other / "tpugan_torch" / "csrc" / "upfirdn2d.cu").read_text()
    ints = 10 if other_takes_pad_x0 else 9
    others = {}
    for dtype, symbol in ((torch.float32, "tpugan_upfirdn2d_f32"), (torch.bfloat16, "tpugan_upfirdn2d_bf16")):
        fn = getattr(lib, symbol)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_int] * ints + [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        others[dtype] = fn
    dev = torch.device("cuda", torch.cuda.current_device())
    stream = torch.cuda.current_stream(dev).cuda_stream
    min_blocks = upfirdn.min_blocks(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows, sums = [], {}
    for label, planes, side, up, down, taps, pads, gain in SHAPES:
        k = upfirdn._taps(upfirdn.setup_fir_kernel(taps), gain)
        kh, kw = k.shape
        out = (side * up + sum(pads) - kh) // down + 1
        x32 = torch.randn(1, planes, side, side, device=dev, generator=gen)
        outputs = {}
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            eb = x.element_size()
            mine = upfirdn.fir_plan(planes, side, side, up, down, pads[0], kh, kw, out, out,
                                    min_blocks=min_blocks, elem_bytes=eb)
            variants = {"this": mine}
            plan = functools.partial(upfirdn.fir_plan, planes, side, side, up, down, pads[0], kh, kw, out, out,
                                     min_blocks=min_blocks, elem_bytes=eb)
            if (up, down) == (1, 1):  # the same-size FIR's other strip widths: 1, 4 and bf16's 8
                for rw in (1, 4, 8)[:3 if eb == 2 else 2]:
                    if rw != mine.rw:
                        variants[f"this, {rw}-column strips"] = plan(rw=rw)
            theirs = plans["fir_plan"](planes, side, side, up, down, pads[0], kh, kw, out, out,
                                       min_blocks=min_blocks, elem_bytes=eb).as_array()
            ys = {name: torch.empty(1, planes, out, out, dtype=dtype, device=dev) for name in (*variants, "other")}

            def call_mine(name, x=x):
                rc = cuda.kernel(upfirdn.KERNEL_OF_DTYPE[dtype])(
                    x.data_ptr(), ys[name].data_ptr(), planes, side, side, out, out, up, down, pads[0], pads[0], kh,
                    kw, k.ctypes.data, plans_of[name].ctypes.data, dev.index, stream)
                assert rc == 0, (label, name, rc)

            def call_other(x=x):
                pad_args = (pads[0], pads[0]) if other_takes_pad_x0 else (pads[0],)
                rc = others[dtype](x.data_ptr(), ys["other"].data_ptr(), planes, side, side, out, out, up, down,
                                   *pad_args, kh, kw, k.ctypes.data, theirs.ctypes.data, dev.index, stream)
                assert rc == 0, (label, "other", rc)

            plans_of = {name: p.as_array() for name, p in variants.items()}
            for name in variants:
                call_mine(name)
            call_other()
            torch.cuda.synchronize()
            for name in variants:
                assert torch.equal(ys[name], ys["other"]), f"{label} {dtype} {name}: differs from the other checkout"
            outputs[dtype] = ys["this"]
            times = {"other": [], "this": []}
            for side_ in ("other", "this", "this", "other"):
                times[side_].append(queued_ms(torch, call_other if side_ == "other" else lambda: call_mine("this")))
            row = {"label": label, "dtype": str(dtype).split(".")[1], "shape": [planes, side, side], "out": out,
                   "up": up, "down": down, "pads": list(pads),
                   "other_us": 1e3 * float(np.mean(times["other"])), "this_us": 1e3 * float(np.mean(times["this"])),
                   "turns_us": {k_: [1e3 * t for t in v] for k_, v in times.items()},
                   "bound_us": 1e6 * eb * planes * (side * side + out * out) / BANDWIDTH,
                   "plan": dataclasses.asdict(mine)}
            for name in variants:
                if name != "this":
                    row[f"{name}_us"] = 1e3 * queued_ms(torch, lambda name=name: call_mine(name))
            rows.append(row)
            part = sums.setdefault(row["dtype"], {"other_us": 0.0, "this_us": 0.0, "bound_us": 0.0})
            for key in part:
                part[key] += row[key]
            extra = ", ".join(f"{name} {row[f'{name}_us']:.2f}" for name in variants if name != "this")
            print(f"fir_ab {label} {row['dtype']} -> {out}: other {row['other_us']:.2f} us, this {row['this_us']:.2f} us "
                  f"({row['this_us'] / row['other_us']:.3f}x), bound {row['bound_us']:.2f} us "
                  f"({row['bound_us'] / row['this_us'] * 100:.1f}% of it){'; ' + extra if extra else ''}; "
                  f"{mine.blocks} blocks, tile {mine.tile_rows}x{mine.tile_cols}, strips of {mine.rw}, "
                  f"{mine.shared_bytes} B", flush=True)
            del x, ys
        f32_on_bf16 = torch.empty_like(outputs[torch.float32])
        plan32 = upfirdn.fir_plan(planes, side, side, up, down, pads[0], kh, kw, out, out, min_blocks=min_blocks)
        xw = x32.bfloat16().float()
        rc = cuda.kernel("upfirdn2d")(xw.data_ptr(), f32_on_bf16.data_ptr(), planes, side, side, out, out, up, down,
                                      pads[0], pads[0], kh, kw, k.ctypes.data, plan32.as_array().ctypes.data,
                                      dev.index, stream)
        torch.cuda.synchronize()
        assert rc == 0 and torch.equal(outputs[torch.bfloat16], f32_on_bf16.bfloat16()), \
            f"{label}: the bf16 output is not the fp32 kernel's on the same values rounded"
        del x32, xw, outputs, f32_on_bf16
        torch.cuda.empty_cache()
    for dtype, part in sums.items():
        print(f"fir_ab sum {dtype}: other {part['other_us']:.2f} us, this {part['this_us']:.2f} us "
              f"({part['this_us'] / part['other_us']:.3f}x), bound {part['bound_us']:.2f} us; {smi}")
    print("fir_ab: every output bitwise the other checkout's; every bf16 output bitwise the fp32 kernel's rounded")
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": smi, "rows": rows, "sums": sums}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
