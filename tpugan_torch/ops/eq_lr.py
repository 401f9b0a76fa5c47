"""Equalized learning-rate bookkeeping (counterpart of ``tpugan/ops/eq_lr.py``).

Weights are stored at their working scale ("implicit lreq"); each layer
records its equalization coefficient as ``<param>_coef`` for the optimizer,
as ``tpugan``'s ``lreq`` collection does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def eq_lr_std(fan_in: int, gain: float = math.sqrt(2.0), lrmul: float = 1.0) -> float:
    """The equalized-LR std: gain / sqrt(fan_in) * lrmul."""
    return gain / math.sqrt(fan_in) * lrmul


def transform_kernel_2d(w: torch.Tensor, average: bool) -> torch.Tensor:
    """4-tap kernel smoothing of fused-scale convs: pad the two trailing
    (spatial) dims by 1 and sum the four diagonal shifts, giving a
    (k+1)x(k+1) kernel; forward (stride-2) convs also multiply by 0.25.

    ``w`` is ``[a, b, kh, kw]`` (OIHW, or ``[in, out, kh, kw]`` for a
    transposed conv).
    """
    w = F.pad(w, (1, 1, 1, 1))
    w = w[..., 1:, 1:] + w[..., :-1, 1:] + w[..., 1:, :-1] + w[..., :-1, :-1]
    if average:
        w = w * 0.25
    return w


def lreq_coefs(module: torch.nn.Module, default: float = 1.0) -> dict[str, float]:
    """Per-parameter coefficient by parameter name: the ``<name>_coef``
    attribute of the owning layer, ``default`` where there is none (plain
    biases, const inputs)."""
    out = {}
    for name, _ in module.named_parameters():
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name) if owner_name else module
        out[name] = float(getattr(owner, f"{leaf}_coef", default))
    return out
