"""Weight bridge: ``tpugan`` variables -> this package's modules.

The JAX package's variables arrive as nested dicts of **numpy** arrays (the
caller converts them; this module imports no JAX). The port's modules carry
the same names as ``tpugan``'s param tree, so the walk is name for name;
only the layouts differ:

* conv kernels, HWIO ``[kh, kw, in, out]`` -> OIHW ``[out, in, kh, kw]``;
* transposed-conv kernels, HWIO -> ``[in, out, kh, kw]``;
* dense kernels ``[in, out]`` -> ``[out, in]``;
* the generator's ``const`` ``[1, 4, 4, C]`` -> NCHW ``[1, C, 4, 4]``;
* noise weights and biases unchanged.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from tpugan_torch.nn.layers import EqConv, EqLinear


def _convert(owner: nn.Module, name: str, value: np.ndarray) -> np.ndarray:
    if name == "kernel":
        if isinstance(owner, EqLinear):
            return value.T
        if isinstance(owner, EqConv):
            return value.transpose((2, 3, 0, 1) if owner.transpose else (3, 2, 0, 1))
        raise TypeError(f"'kernel' under {type(owner).__name__}, which is not an Eq layer")
    if name == "const":
        return value.transpose(0, 3, 1, 2)
    return value


def _walk(module: nn.Module, params: Mapping, prefix: str, out: dict) -> None:
    for key, value in params.items():
        if isinstance(value, Mapping):
            _walk(getattr(module, key), value, f"{prefix}{key}.", out)
        else:
            leaf = "weight" if key == "kernel" else key
            out[prefix + leaf] = _convert(module, key, np.asarray(value))


def load_variables(module: nn.Module, variables: Mapping, unused=()) -> nn.Module:
    """Copy ``variables["params"]`` (a ``tpugan`` mapping, generator or
    encoder) into ``module`` in place and return it.

    flax makes a submodule's params only when it runs, so a generator
    initialised at one lod has no ``to_rgb`` of the others: name such
    submodules in ``unused``; they keep their values. Raises unless every
    other parameter of ``module`` is set, with its exact shape, and no leaf
    is left over."""
    tensors: dict = {}
    _walk(module, variables["params"], "", tensors)
    own = dict(module.named_parameters())
    skip = tuple(f"{name}." for name in unused)
    missing = sorted(n for n in set(own) - set(tensors) if not n.startswith(skip))
    extra = sorted(set(tensors) - set(own))
    if missing or extra:
        raise KeyError(f"param trees differ: missing {missing}, unexpected {extra}")
    with torch.no_grad():
        for name, value in tensors.items():
            p = own[name]
            if tuple(value.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {value.shape} does not fit {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.ascontiguousarray(value, dtype=np.float32)))
    return module
