"""The GAN replay of ``chip_smoke.py`` phase 16 (a D step and a G step of
SGv1 at full width, batch 4) under each cuDNN mode on one GPU, TF32 off:
how far each card run's gradients and dlatent average land from a float64
run on the CPU, beside the CPU's own fp32 run, with the worst leaves.

``python3 tpugan_torch/tools/gan_replay_forms.py [SIZE ...]`` from the
repository root, on a machine with a CUDA card (256 px by default; about
90 s a size at 256 px, most of it the CPU's float64 steps). Card forms:
cuDNN deterministic (printed as held; the rule's verdict follows), cuDNN
off, cuDNN default and cuDNN benchmark.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from tpugan_torch.ops import cuda  # noqa: E402
from tpugan_torch.runtime import parity_mode  # noqa: E402


@contextlib.contextmanager
def cudnn_default(torch):
    yield


@contextlib.contextmanager
def cudnn_benchmark(torch):
    torch.backends.cudnn.benchmark = True
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark = False


FORMS = (("cuda, cuDNN deterministic", cs.cudnn_deterministic), ("cuda, cuDNN off", cs.cudnn_off),
         ("cuda, cuDNN default", cudnn_default), ("cuda, cuDNN benchmark", cudnn_benchmark))


def main() -> int:
    if not torch.cuda.is_available():
        print("gan_replay_forms: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cs.say(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}; CPU threads "
           f"{torch.get_num_threads()}")
    cuda.build()
    parity_mode()
    for size in [int(a) for a in sys.argv[1:]] or [256]:
        cs.GAN_REPLAY_SIZE = size
        try:
            cs.gan_replay(torch, torch.device("cuda"), FORMS)
        except RuntimeError as e:  # the held form over the rule: reported, the next size still runs
            cs.say(f"size {size}: {e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
