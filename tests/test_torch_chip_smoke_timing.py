"""chip_smoke.py's timing helpers when torch.profiler's traces come back
empty, as CUPTI's have on the card: a run of empty traces shorter than the
retakes is recovered from the profiler; where every trace is empty, a
kernel's time comes from CUDA events, and a step's or request's device time
is left out with its peak memory kept. The profiler and ``torch.cuda`` are
faked; nothing here needs the card.
"""

import importlib.util
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
EVENTS_MS = 0.25  # what the fake CUDA events read for 20 calls, per call
KERNEL_MS = 0.005  # what a fake trace holds per call


@pytest.fixture
def cs(monkeypatch):
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.pauses = []
    monkeypatch.setattr(module.time, "sleep", module.pauses.append)
    monkeypatch.setattr(module, "say", lambda *parts: None)
    return module


class FakeTorch:
    """The parts of torch the timing helpers call, on no device."""

    CUDA = "cuda"

    def __init__(self):
        self.autograd = types.SimpleNamespace(DeviceType=types.SimpleNamespace(CUDA=self.CUDA))
        self.cuda = types.SimpleNamespace(synchronize=lambda: None, reset_peak_memory_stats=lambda: None,
                                          max_memory_allocated=lambda: 3 * 2**20, Event=self.Event)

    class Event:
        def __init__(self, enable_timing=True):
            pass

        def record(self):
            pass

        def synchronize(self):
            pass

        def elapsed_time(self, end):
            return EVENTS_MS * 20


def fake_profiler(monkeypatch, held):
    """torch.profiler.profile whose traces hold one FIR kernel where the
    next entry of ``held`` is true and no device time where it is false."""
    import torch.profiler

    outcomes = list(held)

    class Profile:
        def __init__(self, activities):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            if not outcomes.pop(0):
                return []
            return [types.SimpleNamespace(key="upfirdn2d_kernel<float>", device_type=FakeTorch.CUDA,
                                          device_time_total=KERNEL_MS * 20 * 1e3, count=20)]

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    return outcomes


@pytest.mark.parametrize("empty", [1, 3])
def test_empty_traces_are_taken_again_after_a_pause(cs, monkeypatch, empty):
    left = fake_profiler(monkeypatch, [False] * empty + [True])
    ms, kernels, source = cs.kernel_ms(FakeTorch(), lambda: None, ("upfirdn2d_kernel",))
    assert source == "torch.profiler" and ms == pytest.approx(KERNEL_MS)
    assert list(kernels) == ["upfirdn2d_kernel<float>"] and not left
    assert cs.pauses == [0.0, *cs.PROFILER_RETAKE_PAUSES[:empty]]


@pytest.mark.parametrize("expect", [("upfirdn2d_kernel",), ()])
def test_kernel_ms_times_with_cuda_events_where_every_trace_is_empty(cs, monkeypatch, expect):
    takes = len(cs.PROFILER_RETAKE_PAUSES) + 1
    left = fake_profiler(monkeypatch, [False] * takes)
    assert cs.kernel_ms(FakeTorch(), lambda: None, expect) == (pytest.approx(EVENTS_MS), {}, "CUDA events")
    assert not left


def test_device_kernels_raises_missed_launches_with_no_device_time(cs, monkeypatch):
    fake_profiler(monkeypatch, [False] * (len(cs.PROFILER_RETAKE_PAUSES) + 1))
    with pytest.raises(cs.MissedLaunches, match="saw no device time") as missed:
        cs.device_kernels(FakeTorch(), lambda: None, iters=20)
    assert missed.value.found == {} and isinstance(missed.value, RuntimeError)


@pytest.mark.parametrize("held", [True, False])
def test_step_and_request_device_times_keep_the_peak(cs, monkeypatch, held):
    takes = len(cs.PROFILER_RETAKE_PAUSES) + 1
    fake_profiler(monkeypatch, [held] * 2 * takes)
    step = cs.step_device_time(FakeTorch(), lambda state, i: None, None, 1.0, 0, symbols=("upfirdn2d",),
                                iters=20)  # the fake trace holds 20 calls
    request = cs.request_device_time(FakeTorch(), lambda seed: None, 0, 1.0, "upfirdn2d", "upfirdn2d", iters=20)
    assert step["peak_mib"] == request["peak_mib"] == 3.0
    if held:
        assert step["device_ms"] == request["device_ms"] == pytest.approx(KERNEL_MS)
        assert step["kernel_ms"] == {"upfirdn2d": pytest.approx(KERNEL_MS)}
    else:
        assert step == request == {"peak_mib": 3.0}
