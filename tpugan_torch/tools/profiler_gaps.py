"""How often torch.profiler's traces on the card hold no device time, and
whether a retake after a pause recovers: ``chip_smoke.py``'s phase 2 (the
kernels against their plain versions, then the attention and FIR times)
once, then its FIR times (``chip_smoke.fir_times``) again and again for
``--seconds``, with every ``torch.profiler.profile`` counted.

``chip_smoke.device_kernels`` retakes a trace with no device time after
each pause of ``chip_smoke.PROFILER_RETAKE_PAUSES``; this tool records, for
each run of empty traces in a row, its length and whether the trace after
it saw device time (a run that ends the call fell back to CUDA events).

Run from the root of a checkout, on a machine with the card:
``python3 tpugan_torch/tools/profiler_gaps.py [--seconds 150]``. It imports
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


class Traces:
    """Every trace's outcome in order: True where it held device time."""

    def __init__(self, torch):
        self.torch, self.held, self.at = torch, [], []
        self.start = time.perf_counter()

    def profile_class(self, real):
        traces = self

        class Counted(real):
            def key_averages(self, *args, **kwargs):
                averages = super().key_averages(*args, **kwargs)
                traces.held.append(any(e.device_type == traces.torch.autograd.DeviceType.CUDA
                                       and e.device_time_total > 0 for e in averages))
                traces.at.append(time.perf_counter() - traces.start)
                if not traces.held[-1]:
                    print(f"profiler_gaps: trace {len(traces.held)} at {traces.at[-1]:.1f} s held no device time",
                          flush=True)
                return averages

        return Counted

    def runs(self):
        """(start index, length, recovered) of each run of empty traces."""
        out, i = [], 0
        while i < len(self.held):
            if self.held[i]:
                i += 1
                continue
            j = i
            while j < len(self.held) and not self.held[j]:
                j += 1
            out.append((i, j - i, j < len(self.held)))
            i = j
        return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seconds", type=float, default=150.0, help="time to spend repeating the FIR times")
    args = parser.parse_args()
    sys.path.insert(0, os.getcwd())
    import torch
    import torch.profiler

    if not torch.cuda.is_available():
        print("profiler_gaps: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from tpugan_torch.ops import cuda
    from tpugan_torch.runtime import parity_mode

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    traces = Traces(torch)
    torch.profiler.profile = traces.profile_class(torch.profiler.profile)
    bandwidth, fp32_peak, tf32_peak, bf16_peak = cs.card_specs(torch.cuda.get_device_name(0))
    cuda.build()
    dev = torch.device(cs.CARD)
    parity_mode()
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    t0 = time.perf_counter()
    cs.fir_parity(torch, dev, gen)
    cs.fir_adjoint(torch, dev, gen, bandwidth)
    cs.attention_parity(torch, dev, gen)
    cs.attention_bwd_parity(torch, dev, gen)
    cs.attention_times(torch, dev, gen, bandwidth, fp32_peak, tf32_peak)
    cs.attention_bf16_times(torch, dev, gen, bandwidth, tf32_peak, bf16_peak)
    phase2 = len(traces.held)
    rounds, fallbacks = 0, 0
    while rounds == 0 or time.perf_counter() - t0 < args.seconds:
        fir = cs.fir_times(torch, dev, gen, bandwidth, fp32_peak)
        fallbacks += sum(v == "CUDA events" for row in fir["per_shape"] for k, v in row.items()
                         if k.endswith("_from"))
        rounds += 1
    runs = traces.runs()
    summary = {"card": smi, "seconds": time.perf_counter() - t0, "traces": len(traces.held),
               "traces_before_fir_times": phase2, "fir_times_rounds": rounds,
               "empty_traces": traces.held.count(False),
               "empty_runs": [{"first_trace": i, "at_s": traces.at[i], "length": n, "recovered": rec}
                              for i, n, rec in runs],
               "fir_rows_timed_by_cuda_events": fallbacks}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
