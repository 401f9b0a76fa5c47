"""Device selection and numerics settings.

The port never falls back to the CPU on its own: an entry point runs on
``cuda`` unless the caller asks for ``cpu``, and raises if no GPU is there.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises when CUDA is asked for
    and absent (pass ``device="cpu"`` to run on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def parity_mode() -> None:
    """Full-fp32 matmuls and convolutions on the GPU.

    cuDNN runs fp32 convolutions in TF32 by default (about three decimal
    digits), which is too coarse to compare against the fp32 reference.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
