"""Host cost of reaching the kernels through PyTorch operators, at a small
shape where a call is host-bound: a FIR and an attention forward each as
the ctypes launch alone, as the port's operator (``torch.library``'s
define/impl, ``torch.ops.tpugan_torch.*``), through the public functions
(``upfirdn.blur3x3``, ``attention.sagan_attention``), and, for the FIR, as
the same launch behind a ``torch.library.custom_op`` registered here, the
form the port did not take. fp32 and bf16. Each form is timed on the host
clock over ``calls`` calls back to back after 200 warm-up calls, best of
two, closed by a synchronize.

Run from the root of a checkout on a machine with the card:
``python3 tpugan_torch/tools/operator_overhead.py``; ``chip_smoke.py``
(phase 17) calls :func:`measure`.
"""

import os
import sys
import time

import torch

CALLS = 3000
SHAPE = (1, 8, 16, 16)  # the FIR's input
QKV = ((1, 64, 16), (1, 16, 16), (1, 16, 32))

_custom_op = None


def _custom_op_twin():
    """The FIR's card implementation behind a ``torch.library.custom_op``
    (``tpugan_tools::upfirdn2d_custom_op``), registered once."""
    global _custom_op
    if _custom_op is None:
        from tpugan_torch.ops import upfirdn

        @torch.library.custom_op("tpugan_tools::upfirdn2d_custom_op", mutates_args=(), device_types="cuda")
        def twin(x: torch.Tensor, taps: list[float], kh: int, kw: int, up: int, down: int, pads: list[int],
                 key: str) -> torch.Tensor:
            return upfirdn._fir_kernel(x, taps, kh, kw, up, down, pads, key)

        _custom_op = twin
    return _custom_op


def measure(dev, calls: int = CALLS, say=print) -> dict:
    """Host µs a call of each form, by dtype; and the operator's added cost
    a FIR over the ctypes launch, and custom_op's."""
    from tpugan_torch.ops import attention, upfirdn

    def host_us(fn):
        best = float("inf")
        for _ in range(2):
            for _ in range(200):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            best = min(best, (time.perf_counter() - t0) / calls * 1e6)
        return best

    twin = _custom_op_twin()
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(*SHAPE, device=dev).to(dtype)
        taps = upfirdn._taps(upfirdn.setup_fir_kernel((1, 2, 1)), 1.0)
        args = (taps.ravel().tolist(), 3, 3, 1, 1, [1, 1, 1, 1], "B2")
        q, k, v = (torch.randn(*s, device=dev).to(dtype) for s in QKV)
        forms = {
            "FIR ctypes launch": lambda: upfirdn._launch(x, taps, 1, 1, 1, 1, SHAPE[2], SHAPE[3], "B2"),
            "FIR operator": lambda: torch.ops.tpugan_torch.upfirdn2d.default(x, *args),
            "FIR custom_op": lambda: twin(x, *args),
            "FIR upfirdn.blur3x3": lambda: upfirdn.blur3x3(x),
            "attention ctypes launch": lambda: attention._launch_attention(q, k, v, False),
            "attention operator": lambda: torch.ops.tpugan_torch.sagan_attention.default(q, k, v),
            "attention.sagan_attention": lambda: attention.sagan_attention(q, k, v),
        }
        times = {name: host_us(fn) for name, fn in forms.items()}
        times["FIR operator added"] = times["FIR operator"] - times["FIR ctypes launch"]
        times["FIR custom_op added"] = times["FIR custom_op"] - times["FIR ctypes launch"]
        name = str(dtype).removeprefix("torch.")
        say(f"operator overhead ({name}, host µs a call at {list(SHAPE)}, best of 2 x {calls} calls): "
            + "; ".join(f"{n} {t:.2f}" for n, t in times.items())
            + f"; over the 72 FIRs of an SG2 case-2 step the operator adds "
            f"{72 * times['FIR operator added'] / 1e3:.3f} ms, custom_op would add "
            f"{72 * times['FIR custom_op added'] / 1e3:.3f} ms")
        out[name] = times
    return out


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import subprocess

    if not torch.cuda.is_available():
        print("operator_overhead: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    measure(torch.device("cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
