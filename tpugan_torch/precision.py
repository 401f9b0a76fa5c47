"""Mixed precision: bf16 compute for the frozen generators and the encoder
(counterpart of ``tpugan/precision.py``).

The scheme, cast for cast at tpugan's boundaries:

* the frozen generator's weights, buffers and activations are bf16
  (:func:`bf16_frozen`, :func:`bf16_pipeline`);
* the encoder's forward and backward compute in bf16 from fp32 master
  parameters, cast inside the closure (:func:`bf16_encode`), so their
  gradients land fp32 on the masters and LREQAdam's moments stay fp32;
* norm moments and the demodulation norm accumulate in fp32 inside the ops
  (``ops/basic.py``, ``models/stylegan2.py``);
* everything that crosses into the losses is cast back to fp32, so losses
  and gradients are fp32.

No ``torch.autocast``: it casts op by op from lists of its own, which is
not what tpugan computes. Activations keep the dtype of what produced them,
and the only casts are the ones here and in the ops above. On a CUDA tensor
a bf16 FIR launches the kernel's bf16 form (``ops/upfirdn.py``).
"""

from __future__ import annotations

import copy
import functools

import torch

BF16 = torch.bfloat16


def cast_floating(tree, dtype: torch.dtype):
    """Cast every floating tensor of a nested structure (dicts, lists,
    tuples, NamedTuples such as ``SynthBatch``) to ``dtype``; other leaves
    (integer tensors, ``None``, numbers) pass."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(cast_floating(v, dtype) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floating(v, dtype) for v in tree)
    return tree


def bf16_frozen(module: torch.nn.Module) -> torch.nn.Module:
    """A bf16 copy of a frozen generator module: its floating parameters
    and buffers (noise buffers, ``w_avg``) in bf16, the rest as they are.
    The module itself stays fp32 (ablation 1's re-mapping reads it)."""
    return copy.deepcopy(module).to(BF16)


def bf16_pipeline(synth, resynth):
    """Wrap ``synth(z, *rest)`` and ``resynth(w, batch, *rest)`` closures
    over :func:`bf16_frozen` generators: z and w are cast down at the
    boundary, every float output comes back fp32, so the losses, the
    encoder and the optimizer never see bf16. Noise passes as given: the
    ops draw it into the activations' dtype (``ops/basic.noise_inject``)."""

    def synth_bf16(z, *rest):
        return cast_floating(synth(z.to(BF16), *rest), torch.float32)

    def resynth_bf16(w, batch, *rest):
        return cast_floating(resynth(w.to(BF16), batch, *rest), torch.float32)

    return synth_bf16, resynth_bf16


class _Closure(torch.nn.Module):
    """Runs a closure with ``module`` as its only submodule, so that
    :func:`torch.func.functional_call` can swap the module's parameters
    for the closure's call."""

    def __init__(self, module: torch.nn.Module):
        super().__init__()
        self.module = module

    def forward(self, fn, *args):
        return fn(*args)


def _with_bf16_params(encoder: torch.nn.Module):
    """``call(fn, *args)``: ``fn(*args)`` with ``encoder``'s floating
    parameters replaced by bf16 casts of themselves (differentiable, so
    their gradients reach the fp32 parameters in fp32); its buffers stay."""
    holder = _Closure(encoder)

    def call(fn, *args):
        params = {f"module.{name}": p.to(BF16) if p.is_floating_point() else p
                  for name, p in encoder.named_parameters()}
        return torch.func.functional_call(holder, params, (fn, *args))

    return call


def bf16_encode(encode, encoder: torch.nn.Module):
    """Mixed-precision train-step encode: ``encode(batch, noise)``, a
    closure over ``encoder``, runs on bf16 casts of the encoder's fp32
    parameters, made inside the call, with ``batch.imgs1`` and
    ``batch.const1`` cast down; its outputs come back fp32. Master
    parameters, their gradients (the backward of a cast is the cast back)
    and LREQAdam's state stay fp32."""
    call = _with_bf16_params(encoder)

    def wrapped(batch, noise=None):
        batch16 = batch._replace(imgs1=batch.imgs1.to(BF16), const1=batch.const1.to(BF16))
        return cast_floating(call(encode, batch16, noise), torch.float32)

    return wrapped


def bf16_encode_images(encode, encoder: torch.nn.Module):
    """The inversion form of :func:`bf16_encode`: ``encode(imgs, *rest)``,
    a closure over ``encoder`` taking a raw image tensor, runs on bf16
    casts of the encoder's parameters with the images cast down, and every
    float output comes back fp32. The wrapper has the inner closure's
    signature (``inspect.signature`` follows ``__wrapped__``), so a caller
    that threads extra arguments by the signature, as tpugan's
    ``encode_accepts_sn`` does for ``sn``, sees the same parameters."""
    call = _with_bf16_params(encoder)

    @functools.wraps(encode)
    def wrapped(imgs, *rest):
        return cast_floating(call(encode, imgs.to(BF16), *rest), torch.float32)

    return wrapped


def bf16_lpips(lpips_fn):
    """Wrap an LPIPS closure made from a bf16 model (VGG weights cast, e.g.
    ``make_lpips_fn(model.to(torch.bfloat16))``) so that its inputs are cast
    down at the boundary and the per-sample distances come back fp32;
    ``fn.features`` too, where the closure has it."""

    def fn(a, b, a_feats=None):
        return lpips_fn(a.to(BF16), b.to(BF16), a_feats=a_feats).float()

    if hasattr(lpips_fn, "features"):
        fn.features = lambda x: lpips_fn.features(x.to(BF16))
    return fn
