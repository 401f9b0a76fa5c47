"""The spread of ``chip_smoke.py`` phase 12's replays: the same replay run
many times on the card, with cuDNN's default algorithms and with its
deterministic ones, and on the CPU at several thread counts, each held
against the float64 run on the CPU.

The replays (``chip_smoke.replay_inversion_on_cpu``) hold the card's w to
twice the CPU fp32 run's distance from float64. Adam's and LREQAdam's first
updates are about ``lr * sign(g)``, so an element whose gradient nearly
cancels moves with the rounding of its gradient, and the distance is the
largest of many such amplified roundings. This tool shows how far that
distance moves between runs of the same program: between cuDNN's
non-deterministic algorithms' runs on the card, between its deterministic
ones, and between summation orders on the CPU (its thread count). For the
worst element of each card run of baseline_i2s it prints w and the
gradient of each step on the card and in float64.

Run from the root of a checkout, on a machine with the card:
``python3 tpugan_torch/tools/replay_spread.py [--repeats 8] [--variants]
[--exact N]``. ``--variants`` adds card runs with cuDNN's benchmark mode
(it times and picks among all its algorithms), with cuDNN off (PyTorch's
own convolutions), and with the card's memory filled to SQUEEZE_FREE_MIB
free (cuDNN skips algorithms whose workspace does not fit), and lists the
kernels of one baseline_i2s run in each form. ``--exact N`` runs
``chip_smoke.replay_inversion_on_cpu`` itself N times, after phase 12's
full-width inversion forms with ``--context``. ``--stress N`` runs
the card's baseline_i2s replay N times with cuDNN's default algorithms and
N times with its deterministic ones, every other run after filling freed
device memory with large values and running a full-width FIR over them
(so a kernel that read memory it did not write would see stale data), and
prints the distances' distribution and how many distinct w each gave.
``--sgv1 N`` does the same for phase 8's replay, an SGv1 case-2 step's
gradients (``chip_smoke.sgv1_replay_step``), without the stale memory. It imports
``chip_smoke.py`` and the ``tpugan_torch`` of the working directory, and
prints a JSON summary as its last line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

THREADS = (1, 2, 4, 8)
SQUEEZE_FREE_MIB = 256


class CardForm:
    """cuDNN's settings for one form of card runs, and the memory filler."""

    def __init__(self, torch, deterministic=False, benchmark=False, enabled=True, squeeze=False):
        self.torch, self.squeeze = torch, squeeze
        self.flags = {"deterministic": deterministic, "benchmark": benchmark, "enabled": enabled}
        self.filler = None

    def __enter__(self):
        cudnn = self.torch.backends.cudnn
        self.saved = {k: getattr(cudnn, k) for k in self.flags}
        for k, v in self.flags.items():
            setattr(cudnn, k, v)
        if self.squeeze:
            self.torch.cuda.empty_cache()
            free = self.torch.cuda.mem_get_info()[0]
            self.filler = self.torch.empty(free - SQUEEZE_FREE_MIB * 2**20, dtype=self.torch.uint8, device="cuda")
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            setattr(self.torch.backends.cudnn, k, v)
        self.filler = None
        self.torch.cuda.empty_cache()


def kernel_names(torch, fn):
    """The device kernels of one call of ``fn``, by name, with their counts."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts = {}
    for e in prof.events():
        if e.device_type.name == "CUDA":
            counts[e.name] = counts.get(e.name, 0) + 1
    return counts


def dirty(torch):
    """Leaves large values in freed device memory and in shared memory."""
    from tpugan_torch.ops.upfirdn import setup_fir_kernel, upfirdn2d_cuda

    junk = torch.full((2**30,), 1e4, device="cuda")  # 4 GiB, back to the cache when freed
    x = torch.randn(4, 512, 128, 128, device="cuda") * 1e4
    upfirdn2d_cuda(x, setup_fir_kernel((1.0, 3.0, 3.0, 1.0)), up=2, pad=(2, 1), gain=4.0)
    torch.cuda.synchronize()
    del junk, x


def stress(torch, smoke, target, ref, n):
    """``n`` card runs of baseline_i2s in each cuDNN mode, every other one
    after :func:`dirty`; their distances from ``ref``."""
    out = {}
    for deterministic in (False, True):
        name = "deterministic" if deterministic else "default"
        with CardForm(torch, deterministic=deterministic):
            dists, seen = [], set()
            for i in range(n):
                if i % 2:
                    dirty(torch)
                r = baseline_run(torch, smoke, "cuda", torch.float32, target)
                dists.append(float((r["w"] - ref["w"]).abs().max()))
                seen.add(tuple(r["w"].flatten().tolist()))
        ranked = sorted(dists)
        print(f"stress, cuDNN {name}: {n} runs of baseline_i2s on the card, {len(seen)} distinct w; from float64 "
              f"median {ranked[n // 2]:.3e}, 90th {ranked[int(n * 0.9)]:.3e}, max {ranked[-1]:.3e}; after dirty "
              f"memory max {max(dists[1::2]):.3e}, clean max {max(dists[0::2]):.3e}", flush=True)
        out[name] = {"dists": dists, "distinct_w": len(seen)}
    return out


def sgv1_stress(torch, smoke, n):
    """``n`` card runs of phase 8's replay step in each cuDNN mode: the
    gradients' largest distance from the float64 run on the CPU."""
    from tpugan_torch.cli import e_align

    argv, request = smoke.sgv1_replay_request(torch, e_align)
    cpu = torch.device("cpu")
    _, ref, _, names = smoke.sgv1_replay_step(torch, e_align, argv, request, "cpu", cpu, torch.float64)
    scale = max(float(r.abs().max()) for g in ref for r in g)

    def distance(grads):
        return max((float((a - r).abs().max()), f"gradient {k} of {names[i]}")
                   for k, (ga, gr) in enumerate(zip(grads, ref)) for i, (a, r) in enumerate(zip(ga, gr)))

    _, cpu32, _, _ = smoke.sgv1_replay_step(torch, e_align, argv, request, "cpu", cpu, torch.float32)
    out = {"max_abs_ref": scale, "cpu fp32": distance(cpu32)[0]}
    print(f"sgv1 stress: the CPU fp32 {distance(cpu32)[0]:.3e} from float64 (at {distance(cpu32)[1]}; max |g| "
          f"{scale:.3e})", flush=True)
    for deterministic in (False, True):
        name = "deterministic" if deterministic else "default"
        with CardForm(torch, deterministic=deterministic):
            found, seen = [], set()
            for _ in range(n):
                _, grads, _, _ = smoke.sgv1_replay_step(torch, e_align, argv, request, "cuda", torch.device("cuda"),
                                                        torch.float32, card=True)
                found.append(distance(grads))
                seen.add(tuple(float(g.sum()) for group in grads for g in group))
        dists = sorted(d for d, _ in found)
        worst = max(found)
        print(f"sgv1 stress, cuDNN {name}: {n} card steps, {len(seen)} distinct gradients; from float64 median "
              f"{dists[n // 2]:.3e}, 90th {dists[int(n * 0.9)]:.3e}, max {worst[0]:.3e} (at {worst[1]}); each "
              f"{', '.join(f'{d:.3e}' for d, _ in found)}", flush=True)
        out[name] = {"dists": [d for d, _ in found], "distinct": len(seen)}
    return out


def baseline_run(torch, smoke, place, dtype, target):
    """baseline_i2s's Adam as phase 12 replays it, with each step's gradient."""
    from tpugan_torch.cli import baseline_i2s

    bundle = smoke.gate_inverter(torch, place, dtype, False).bundle
    resynth = baseline_i2s.train_resynth(bundle)
    w = torch.zeros((1, bundle.num_style_layers, 512), device=place, dtype=dtype, requires_grad=True)
    opt = baseline_i2s.adam(w, 0.01)
    grads = []
    step = opt.step

    def recording_step():
        grads.append(w.grad.detach().double().cpu().clone())
        return step()

    opt.step = recording_step
    losses = baseline_i2s.optimise(resynth, target.to(place, dtype), w, opt, smoke.INV_REPLAY_STEPS)
    return {"w": w.detach().double().cpu(), "losses": losses.double().cpu(), "grads": torch.stack(grads)}


def inversion_run(torch, smoke, place, dtype, target, optimize_e):
    """Phase 12's inversion replay in one mode: w, the snapshot's w and the
    images."""
    inverter = smoke.gate_inverter(torch, place, dtype, optimize_e)
    r = inverter.invert(target.to(place, dtype))
    return {"w": r.w.detach().double().cpu(), "w_best": r.w_best.detach().double().cpu(),
            "images": r.images.detach().double().cpu()}


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as smoke
    from tpugan_torch.ops import cuda
    from tpugan_torch.runtime import parity_mode

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--repeats", type=int, default=8)
    parser.add_argument("--variants", action="store_true")
    parser.add_argument("--exact", type=int, default=0)
    parser.add_argument("--stress", type=int, default=0)
    parser.add_argument("--context", action="store_true")
    parser.add_argument("--sgv1", type=int, default=0)
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("replay_spread: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}, {torch.get_num_threads()} CPU threads", flush=True)
    cuda.build()
    parity_mode()
    target = smoke.gate_target(torch)
    threads = torch.get_num_threads()
    summary = {}
    runners = {"baseline_i2s": (lambda place, dtype: baseline_run(torch, smoke, place, dtype, target), ("w",)),
               "fine-tune E": (lambda place, dtype: inversion_run(torch, smoke, place, dtype, target, True),
                               ("w", "w_best", "images")),
               "optimise w": (lambda place, dtype: inversion_run(torch, smoke, place, dtype, target, False),
                              ("w", "w_best", "images"))}
    if opts.sgv1:
        summary["sgv1 stress"] = sgv1_stress(torch, smoke, opts.sgv1)
    for label, (run, keys) in runners.items():
        t0 = time.perf_counter()
        ref = run("cpu", torch.float64)
        scale = {k: float(ref[k].abs().max()) for k in keys}
        forms = {}
        for n in THREADS:
            torch.set_num_threads(n)
            forms[f"cpu {n} threads"] = [run("cpu", torch.float32)]
        torch.set_num_threads(threads)
        card_forms = {"card, cuDNN default": (CardForm(torch), opts.repeats),
                      "card, cuDNN deterministic": (CardForm(torch, deterministic=True), opts.repeats)}
        if opts.variants:
            card_forms.update({"card, cuDNN benchmark": (CardForm(torch, benchmark=True), 2),
                               "card, cuDNN off": (CardForm(torch, enabled=False), 1),
                               "card, memory squeezed": (CardForm(torch, squeeze=True), 2)})
        for name, (form, repeats) in card_forms.items():
            with form:
                forms[name] = []
                for _ in range(repeats):
                    forms[name].append(run("cuda", torch.float32))
                    torch.cuda.synchronize()
                if opts.variants and label == "baseline_i2s":
                    names = kernel_names(torch, lambda: run("cuda", torch.float32))
                    print(f"{label}, {name}: {sum(names.values())} kernel launches, {len(names)} kernels:", flush=True)
                    for kname, n in sorted(names.items(), key=lambda kv: -kv[1]):
                        print(f"  {n:5d}  {kname[:150]}", flush=True)
        out = {}
        for name, runs in forms.items():
            dists = {k: [float((r[k] - ref[k]).abs().max()) for r in runs] for k in keys}
            distinct = len({tuple(r["w"].flatten().tolist()) for r in runs})
            out[name] = {"dist": dists, "distinct_w": distinct}
            for k in keys:
                d = dists[k]
                print(f"{label} {k}, {name}: {len(d)} runs ({distinct} distinct w), from float64 min {min(d):.3e} "
                      f"max {max(d):.3e} (max |ref| {scale[k]:.3e}; each {', '.join(f'{x:.3e}' for x in d)})",
                      flush=True)
            if label == "baseline_i2s" and name.startswith("card"):
                worst = max(runs, key=lambda r: float((r["w"] - ref["w"]).abs().max()))
                i = int((worst["w"] - ref["w"]).abs().flatten().argmax())
                cpu = forms["cpu 8 threads"][0]
                print(f"  worst element {i}: w card {float(worst['w'].flatten()[i]):.9e}, float64 "
                      f"{float(ref['w'].flatten()[i]):.9e}, cpu {float(cpu['w'].flatten()[i]):.9e}; gradient by "
                      f"step card {[f'{float(g.flatten()[i]):.6e}' for g in worst['grads']]}, float64 "
                      f"{[f'{float(g.flatten()[i]):.6e}' for g in ref['grads']]}; max |g| by step "
                      f"{[f'{float(g.abs().max()):.3e}' for g in ref['grads']]}", flush=True)
                gerr = [float((worst["grads"][s] - ref["grads"][s]).abs().max()) for s in range(len(ref["grads"]))]
                cerr = [float((cpu["grads"][s] - ref["grads"][s]).abs().max()) for s in range(len(ref["grads"]))]
                print(f"  gradient max |err| from float64 by step: card {[f'{e:.3e}' for e in gerr]}, cpu "
                      f"{[f'{e:.3e}' for e in cerr]}", flush=True)
        summary[label] = {"max_abs_ref": scale, "forms": out, "seconds": time.perf_counter() - t0}
        if label == "baseline_i2s" and opts.stress:
            summary["stress"] = stress(torch, smoke, target, ref, opts.stress)
        print(f"{label}: {time.perf_counter() - t0:.1f} s", flush=True)
    if opts.context:
        import shutil
        import tempfile

        workdir = tempfile.mkdtemp(prefix="replay_spread_")
        try:
            for form, flags in smoke.INV_FORMS:
                smoke.inversion_form(torch, torch.device("cuda"), smi, form, flags, workdir)
                torch.cuda.empty_cache()
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
    for i in range(opts.exact):
        t0 = time.perf_counter()
        try:
            smoke.replay_inversion_on_cpu(torch, torch.device("cuda"))
            passed = True
        except RuntimeError as failed:
            print(f"exact replay {i}: {failed}", flush=True)
            passed = False
        summary[f"exact replay {i}"] = passed
        print(f"exact replay {i}: {'passed' if passed else 'FAILED'} in {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"card: {smi}")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
