"""tpugan_torch's ``profiling.py`` and ``config.py`` (CPU).

The step timer as tests/test_runtime_profiling.py:11 holds tpugan's;
``timeit_ms`` and ``trace`` on a CPU function; ``trace_roofline`` refuses
a function whose trace holds no device kernel (here: no card); the FLOPs
it counts for the port's operators; the configuration dataclasses' fields,
defaults and properties equal to tpugan's over a grid of image sizes.
"""

import dataclasses
import json
import time

import pytest
import torch

from tpugan import config as jconfig
from tpugan_torch import config, profiling
from tpugan_torch.ops import attention, cuda, upfirdn


def test_step_timer():
    t = profiling.StepTimer(ema=0.5)
    for _ in range(3):
        with t:
            time.sleep(0.01)
    assert t.steps == 3
    assert t.avg is not None and t.avg > 0.005
    assert t.steps_per_sec > 0 and t.total >= 0.03


def test_timeit_ms_times_a_cpu_function():
    calls = []
    ms = profiling.timeit_ms(lambda x: calls.append(1) or x * 2, torch.ones(4), iters=3, windows=2)
    assert ms > 0 and len(calls) == 1 + 3 * 2


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as logdir:
        upfirdn.blur3x3(torch.randn(1, 4, 8, 8))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert logdir == str(tmp_path) and any("tpugan_torch::upfirdn2d" in e.get("name", "") for e in events)


def test_trace_roofline_refuses_a_cpu_function(tmp_path):
    with pytest.raises(RuntimeError, match="no device kernel"):
        profiling.trace_roofline(lambda x: x + 1, (torch.ones(3),), logdir=str(tmp_path))


def test_flops_are_counted_for_the_port_operators():
    """FlopCounterMode with this package's formulas: the FIR's taps on real
    samples (a quarter of the stuffed ones at up 2), the attention's two
    products, the backward's five; ATen's convolutions as ever."""
    cuda.reset_launches()
    x = torch.randn(2, 4, 8, 8)
    assert profiling.count_flops(upfirdn.blur3x3, x) == 2 * x.numel() * 9
    k = upfirdn.setup_fir_kernel((1, 3, 3, 1))
    assert profiling.count_flops(lambda a: upfirdn.upfirdn2d(a, k, up=2, pad=(2, 1), gain=4.0), x) == \
        2 * 2 * 4 * 16 * 16 * 16 // 4
    q, kk, v = torch.randn(2, 16, 8), torch.randn(2, 4, 8), torch.randn(2, 4, 12)
    assert profiling.count_flops(attention.sagan_attention, q, kk, v) == 2 * 2 * 16 * 4 * (8 + 12)
    o, lse = attention.sagan_attention(q, kk, v, return_lse=True)
    do = torch.randn_like(o)
    assert profiling.count_flops(attention.sagan_attention_bwd, q, kk, v, o, lse, do) == \
        2 * 2 * 16 * 4 * (3 * 8 + 2 * 12)
    w = torch.randn(5, 4, 3, 3)
    assert profiling.count_flops(lambda a: torch.nn.functional.conv2d(a, w, padding=1), x) == \
        2 * 2 * 5 * 8 * 8 * 4 * 9
    assert not any(cuda.launches.values())


@pytest.mark.parametrize("name,want", [("void upfirdn2d_kernel<float>(...)", "tpugan_torch kernel"),
                                       ("sm90_xmma_fprop_implicit_gemm_f32f32", "convolution"),
                                       ("ampere_sgemm_128x64_nn", "matmul"),
                                       ("Memcpy DtoD (Device -> Device)", "copy"),
                                       ("void at::native::reduce_kernel<512, 1>", "reduction"),
                                       ("void at::native::vectorized_elementwise_kernel<4>", "elementwise"),
                                       ("something_else", "other")])
def test_kernel_category(name, want):
    assert profiling.kernel_category(name) == want


def test_op_table_sorts_by_time_and_leaves_unmeasured_shares_out():
    result = {"_kernels": {"a_gemm": (1e-3, 1.0), "b_elementwise": (3e-3, 2.0)}, "_counters": {}}
    rows = profiling.op_table(result)
    assert [r[0] for r in rows] == ["b_elementwise", "a_gemm"]
    assert rows[0][1:] == ("elementwise", 0.75, None, None)


@pytest.mark.parametrize("img_size", [32, 64, 128, 256, 512, 1024])
@pytest.mark.parametrize("mtype", [config.MTYPE_STYLEGAN1, config.MTYPE_STYLEGAN2, config.MTYPE_PGGAN,
                                   config.MTYPE_BIGGAN])
def test_configs_equal_tpugan(mtype, img_size):
    assert (config.MTYPE_STYLEGAN1, config.MTYPE_STYLEGAN2, config.MTYPE_PGGAN, config.MTYPE_BIGGAN) == (
        jconfig.MTYPE_STYLEGAN1, jconfig.MTYPE_STYLEGAN2, jconfig.MTYPE_PGGAN, jconfig.MTYPE_BIGGAN)
    for ours, theirs in ((config.ModelConfig, jconfig.ModelConfig), (config.TrainConfig, jconfig.TrainConfig)):
        assert [(f.name, f.default) for f in dataclasses.fields(ours)] == \
            [(f.name, f.default) for f in dataclasses.fields(theirs)]
    m, jm = config.ModelConfig(mtype=mtype, img_size=img_size), jconfig.ModelConfig(mtype=mtype, img_size=img_size)
    assert (m.layer_count, m.lod, m.num_style_layers) == (jm.layer_count, jm.lod, jm.num_style_layers)
    assert dataclasses.asdict(m) == dataclasses.asdict(jm)
    with pytest.raises(dataclasses.FrozenInstanceError):
        m.img_size = 8
