"""tpugan_torch — the PyTorch/CUDA port of tpugan for NVIDIA Hopper.

Mirrors ``tpugan``'s layout (``ops/``, ``nn/``, ``models/``, ``io/``,
``train/``, ``invert/``, ``cli/``). Models run NCHW with OIHW weights;
images cross the pipeline's public boundary as NHWC, as in ``tpugan``.
Every Pallas kernel of ``tpugan`` on a ported path is a hand-written CUDA
kernel here (``csrc/``), built with ``nvcc`` at first use; its plain
PyTorch version beside it serves CPU tensors and is what the kernel is
checked against.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(see :mod:`tpugan_torch.runtime`).
"""

from tpugan_torch.runtime import parity_mode, resolve_device

__all__ = ["parity_mode", "resolve_device"]
