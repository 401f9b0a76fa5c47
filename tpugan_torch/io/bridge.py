"""Weight bridge: ``tpugan`` variables -> this package's modules.

The JAX package's variables arrive as nested dicts of **numpy** arrays (the
caller converts them; this module imports no JAX). The port's modules carry
the same names as ``tpugan``'s variable trees, so the walk is name for name:
``params`` into the module's parameters, ``buffers`` (BigGAN batch norms'
running statistics) and ``sn`` (spectral norms' ``u`` and ``v``) into its
buffers. Generators, encoders, VGG16's features and LPIPS (plain 3x3 and
1x1 convs) all load this way. Only the layouts differ:

* conv kernels (Eq or plain), HWIO ``[kh, kw, in, out]`` -> OIHW
  ``[out, in, kh, kw]``;
* transposed-conv kernels, HWIO -> ``[in, out, kh, kw]``;
* dense kernels (Eq, plain or spectral-normalised) ``[in, out]`` ->
  ``[out, in]``; VGG16's ``head.fc_0`` (``FlattenedLinear``) also has its
  input rows reordered from ``tpugan``'s NHWC flatten, (h, w, c), to the
  port's NCHW one, (c, h, w), torchvision's;
* the generator's ``const`` ``[1, 4, 4, C]`` -> NCHW ``[1, C, 4, 4]``;
* StyleGAN2's ``weight`` leaves, stored unscaled as ``tpugan`` stores them:
  ``ModulatedConv``/``SG2ConvBlock`` HWIO -> OIHW, ``SG2Dense`` ``[in, out]``
  -> ``[out, in]``; a ``ModulatedConv``'s ``noise`` buffer ``[1, r, r, 1]``
  -> ``[1, 1, r, r]``;
* everything else (noise weights and strengths, biases, ``gamma``,
  ``w_avg``, other buffers) unchanged; a 0-d leaf stays 0-d.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from tpugan_torch.losses.vgg import FlattenedLinear
from tpugan_torch.models.pggan import PGConvBlock
from tpugan_torch.models.stylegan2 import ModulatedConv, SG2ConvBlock, SG2Dense
from tpugan_torch.nn.layers import EqConv, EqLinear
from tpugan_torch.nn.spectral import SNDense

_DENSE = (EqLinear, nn.Linear, SNDense)
# the collections copied, and whether each goes to parameters or buffers
_COLLECTIONS = (("params", "parameters"), ("buffers", "buffers"), ("sn", "buffers"))


def _convert(owner: nn.Module, name: str, value: np.ndarray) -> np.ndarray:
    if name == "kernel":
        if isinstance(owner, FlattenedLinear):
            c, h, w = owner.in_shape
            return value.reshape(h, w, c, -1).transpose(3, 2, 0, 1).reshape(-1, c * h * w)
        if isinstance(owner, _DENSE):
            return value.T
        if isinstance(owner, EqConv):
            return value.transpose((2, 3, 0, 1) if owner.transpose else (3, 2, 0, 1))
        if isinstance(owner, nn.Conv2d):
            return value.transpose(3, 2, 0, 1)
        raise TypeError(f"'kernel' under {type(owner).__name__}, which is not a conv or dense layer")
    if name == "const" or (name == "noise" and isinstance(owner, ModulatedConv)):
        return value.transpose(0, 3, 1, 2)
    if name == "weight" and isinstance(owner, SG2Dense):
        return value.T
    if name == "weight" and isinstance(owner, (ModulatedConv, SG2ConvBlock)):
        return value.transpose(3, 2, 0, 1)
    if name == "weight" and isinstance(owner, PGConvBlock):
        return value.transpose((2, 3, 0, 1) if owner.fused else (3, 2, 0, 1))
    return value


def _walk(module: nn.Module, tree: Mapping, prefix: str, out: dict) -> None:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            _walk(getattr(module, key), value, f"{prefix}{key}.", out)
        else:
            leaf = "weight" if key == "kernel" else key
            out[prefix + leaf] = _convert(module, key, np.asarray(value))


def load_variables(module: nn.Module, variables: Mapping, unused=()) -> nn.Module:
    """Copy a ``tpugan`` variable mapping (generator or encoder) into
    ``module`` in place and return it: ``params`` into its parameters,
    ``buffers`` and ``sn`` into its buffers.

    flax makes a submodule's variables only when it runs, so a generator
    initialised at one lod has no ``to_rgb`` of the others: name such
    submodules in ``unused``; they keep their values. Raises unless every
    other parameter and buffer of ``module`` is set, with its exact shape,
    and no leaf is left over."""
    skip = tuple(f"{name}." for name in unused)
    for kind in ("parameters", "buffers"):
        tensors: dict = {}
        for collection, target in _COLLECTIONS:
            if target == kind:
                _walk(module, variables.get(collection, {}), "", tensors)
        own = dict(getattr(module, f"named_{kind}")())
        missing = sorted(n for n in set(own) - set(tensors) if not n.startswith(skip))
        extra = sorted(set(tensors) - set(own))
        if missing or extra:
            raise KeyError(f"{kind} differ: missing {missing}, unexpected {extra}")
        with torch.no_grad():
            for name, value in tensors.items():
                t = own[name]
                if tuple(value.shape) != tuple(t.shape):
                    raise ValueError(f"{name}: shape {value.shape} does not fit {tuple(t.shape)}")
                t.copy_(torch.from_numpy(np.array(value, dtype=np.float32, order="C")))
    return module
