"""Tracing and profiling (counterpart of ``tpugan/profiling.py``).

A step timer with EMA smoothing, best-of-windows timing, a
``torch.profiler`` trace of a window, and a roofline reading of one
callable: its device time per call from the trace's kernels, its FLOPs as
counted by ``torch.utils.flop_counter`` (ATen's matmuls and convolutions and
this package's operators), and, where the GPU driver grants the user CUPTI's
performance counters, the device-memory bytes and the tensor-core use that
the counters measure. Where it does not, those fields are ``None`` and
``counters`` says why: no number stands in for a measurement.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from typing import Optional


class StepTimer:
    """Per-step wall-clock with EMA (LODDriver-style bookkeeping)."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.avg: Optional[float] = None
        self._t0: Optional[float] = None
        self.total = 0.0
        self.steps = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self.total += dt
        self.steps += 1
        self.avg = dt if self.avg is None else self.ema * self.avg + (1 - self.ema) * dt
        return False

    @property
    def steps_per_sec(self) -> float:
        return 0.0 if not self.avg else 1.0 / self.avg


def _fence(out) -> None:
    """Wait for the devices that hold ``out``'s tensors (nested tuples,
    lists and dicts): ``torch.cuda.synchronize`` for each CUDA device, no
    wait for CPU tensors, whose ops return finished."""
    import torch

    devices = set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(out)
    for device in devices:
        torch.cuda.synchronize(device)


def timeit_ms(fn, *args, iters: int = 10, windows: int = 3) -> float:
    """Best-of-``windows`` mean latency of ``fn(*args)`` in ms: one warm-up
    call (kernel builds, cuDNN's choices), then ``windows`` windows of
    ``iters`` calls, each closed by a ``torch.cuda.synchronize`` on the
    devices of the last output (best-of-N absorbs a shared host's noise)."""
    _fence(fn(*args))
    best = float("inf")
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        _fence(out)
        best = min(best, (time.perf_counter() - t0) / iters * 1e3)
    return best


def _default_logdir(name: str) -> str:
    return os.path.join(tempfile.gettempdir(), name)


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """Record a ``torch.profiler`` trace of the block (the CPU, and the
    card where there is one) and write it to ``logdir/trace.json`` (Chrome's
    trace format; open it in Perfetto or ``chrome://tracing``). Yields
    ``logdir``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    logdir = logdir or _default_logdir("tpugan_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


# FLOPs of this package's operators, as FlopCounterMode's formulas take them
# (tensors as shapes): the FIR's taps on real samples, the attention's two
# products and the backward's five
def _fir_flops(x, taps, kh, kw, up, down, pads, key, out_shape=None, **kwargs) -> int:
    n, c, h, w = out_shape
    return 2 * n * c * h * w * kh * kw // (up * up)


def _attention_flops(q, k, v, out_shape=None, **kwargs) -> int:
    n, lq, dk = q
    return 2 * n * lq * k[1] * (dk + v[2])


def _attention_bwd_flops(q, k, v, o, lse, do, out_shape=None, **kwargs) -> int:
    n, lq, dk = q
    return 2 * n * lq * k[1] * (3 * dk + 2 * v[2])


def _flop_formulas() -> dict:
    import torch

    import tpugan_torch.ops  # noqa: F401  (registers the operators)

    ops = torch.ops.tpugan_torch
    return {ops.upfirdn2d: _fir_flops, ops.sagan_attention: _attention_flops,
            ops.sagan_attention_lse: _attention_flops, ops.sagan_attention_bwd: _attention_bwd_flops}


def count_flops(fn, *args) -> int:
    """FLOPs of one call of ``fn(*args)``, counted by
    ``torch.utils.flop_counter.FlopCounterMode``: ATen's matmuls and
    convolutions and this package's operators (elementwise work is not
    counted)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False, custom_mapping=_flop_formulas()) as counter:
        _fence(fn(*args))
    return int(counter.get_total_flops())


# CUPTI's per-kernel counters that trace_roofline asks for: device-memory
# bytes read and written, and the tensor pipes' share of active cycles
COUNTER_METRICS = (
    "dram__bytes_read.sum",
    "dram__bytes_write.sum",
    "sm__pipe_tensor_op_hmma_cycles_active.avg.pct_of_peak_sustained_active",
)


def _device_kernels(prof, iters: int) -> dict:
    """Device time (s) and launches per call of each kernel and copy of a
    trace; user annotations, which span kernels already counted, are left
    out."""
    import torch

    return {e.key: (e.device_time_total / iters / 1e6, e.count / iters)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0
            and not getattr(e, "is_user_annotation", False)}


@contextlib.contextmanager
def _stderr_to(path: str):
    """The process's file descriptor 2 (where CUPTI and Kineto write their
    refusals) into ``path`` for the block."""
    import sys

    sys.stderr.flush()
    saved = os.dup(2)
    with open(path, "wb") as sink:
        os.dup2(sink.fileno(), 2)
        try:
            yield
        finally:
            sys.stderr.flush()
            os.dup2(saved, 2)
            os.close(saved)


def _read_counters(fn, args, logdir: str) -> tuple[dict, str]:
    """One call of ``fn`` profiled in CUPTI's range-profiler mode, per
    kernel, for COUNTER_METRICS. Returns the metric values by kernel name
    (summed over its launches) and, where there are none, what the GPU driver
    or the profiler said instead."""
    from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

    log = os.path.join(logdir, "counters_stderr.txt")
    path = os.path.join(logdir, "counters_trace.json")
    config = _ExperimentalConfig(profiler_metrics=list(COUNTER_METRICS), profiler_measure_per_kernel=True)
    try:
        with _stderr_to(log):
            with profile(activities=[ProfilerActivity.CUDA], experimental_config=config) as prof:
                _fence(fn(*args))
            prof.export_chrome_trace(path)
    except RuntimeError as err:  # the profiler's own refusal
        return {}, f"torch.profiler raised: {err}"
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    by_kernel: dict = {}
    for e in events:
        values = {m: e.get("args", {}).get(m) for m in COUNTER_METRICS}
        if any(isinstance(v, (int, float)) for v in values.values()):
            row = by_kernel.setdefault(e.get("name", "?"), {m: 0.0 for m in COUNTER_METRICS} | {"launches": 0})
            row["launches"] += 1
            for m, v in values.items():
                if isinstance(v, (int, float)):
                    row[m] += float(v)
    if by_kernel:
        return by_kernel, "granted"
    with open(log, errors="replace") as f:
        said = " ".join(line.strip() for line in f if line.strip())
    return {}, ("refused: " + said[:2000]) if said else "refused: the trace held no counter values"


def trace_roofline(fn, args, iters: int = 3, logdir: Optional[str] = None) -> dict:
    """Roofline numbers of one callable on the card: ``fn(*args)`` run once
    outside the window (builds, cuDNN's choices), then ``iters`` calls under
    ``torch.profiler`` recording the device alone.

    Returns ``seconds_per_call`` (the kernels' and copies' device time, not
    the host's), ``kernels_per_call``, ``flops_per_call`` (counted, see
    :func:`count_flops`; ``flops_are`` says so), the kernels by name, and
    from CUPTI's counters ``hbm_bytes_per_call``, ``measured_hbm_gbps`` and
    ``tensor_core_use`` where the GPU driver grants them, else ``None`` with the
    refusal in ``counters``. ``fn`` must not donate or modify its inputs (it
    is called again on them). Raises RuntimeError when the trace holds no
    device kernel (a CPU function)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    no_kernel = "the trace holds no device kernel: trace_roofline measures a function that runs on the card"
    if not torch.cuda.is_available():
        raise RuntimeError(f"{no_kernel} (no CUDA device here)")
    logdir = logdir or tempfile.mkdtemp(prefix="tpugan_torch_roofline_")
    os.makedirs(logdir, exist_ok=True)
    _fence(fn(*args))
    flops = count_flops(fn, *args)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            out = fn(*args)
        _fence(out)
    kernels = _device_kernels(prof, iters)
    if not kernels:
        raise RuntimeError(no_kernel)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    secs = sum(s for s, _ in kernels.values())
    counters, status = _read_counters(fn, args, logdir)
    hbm = tc = None
    if counters:
        hbm = sum(r["dram__bytes_read.sum"] + r["dram__bytes_write.sum"] for r in counters.values())
        tc_metric = COUNTER_METRICS[2]
        launches = sum(r["launches"] for r in counters.values())
        tc = sum(r[tc_metric] for r in counters.values()) / launches / 100.0 if launches else None
    return {
        "iters": iters,
        "seconds_per_call": secs,
        "kernels_per_call": sum(n for _, n in kernels.values()),
        "flops_per_call": float(flops),
        "flops_are": "counted by torch.utils.flop_counter (ATen matmuls and convolutions, tpugan_torch's "
                     "operators), not measured",
        "hbm_bytes_per_call": hbm,
        "measured_hbm_gbps": hbm / secs / 1e9 if hbm is not None and secs else None,
        "tensor_core_use": tc,
        "counters": status,
        "logdir": logdir,
        "_kernels": kernels,
        "_counters": counters,
    }


_CATEGORIES = (
    ("tpugan_torch kernel", ("upfirdn2d", "sagan_attention")),
    ("convolution", ("conv", "cudnn", "xmma", "implicit", "dgrad", "wgrad", "fprop", "fft", "winograd")),
    ("matmul", ("gemm", "cutlass", "cublas", "matmul")),
    ("copy", ("memcpy", "memset", "copy", "cat")),
    ("reduction", ("reduce", "norm", "softmax")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def kernel_category(name: str) -> str:
    """A kernel's kind from its name: this package's kernels, convolution,
    matmul, copy, reduction, elementwise, or other."""
    low = name.lower()
    for category, words in _CATEGORIES:
        if any(word in low for word in words):
            return category
    return "other"


def op_table(roofline_result: dict, top: int = 25) -> list:
    """:func:`trace_roofline`'s kernels as rows ``(name, category, time
    share, byte share, tensor-core use)``, sorted by time share; the last
    two come from CUPTI's counters and are ``None`` where the GPU driver did not
    grant them."""
    kernels = roofline_result["_kernels"]
    counters = roofline_result["_counters"]
    total = sum(s for s, _ in kernels.values()) or 1.0
    total_bytes = sum(r["dram__bytes_read.sum"] + r["dram__bytes_write.sum"] for r in counters.values()) or None
    rows = []
    for name, (secs, _) in kernels.items():
        own = counters.get(name)
        byte_share = tc = None
        if own is not None and total_bytes:
            byte_share = (own["dram__bytes_read.sum"] + own["dram__bytes_write.sum"]) / total_bytes
            tc = own[COUNTER_METRICS[2]] / own["launches"] / 100.0
        rows.append((name, kernel_category(name), secs / total, byte_share, tc))
    rows.sort(key=lambda r: -r[2])
    return rows[:top]
