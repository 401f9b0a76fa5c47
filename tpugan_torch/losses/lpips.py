"""LPIPS perceptual distance, VGG flavour (counterpart of
``tpugan/losses/lpips.py``).

The published scaling layer, the VGG16 backbone, unit-normalised feature
maps over channels, the squared difference through a 1x1 linear head per
layer (``lin_0`` ... ``lin_4``), a spatial mean, the sum over the five
layers. Images are NHWC in [-1, 1], as in ``tpugan``; weights come from
``tpugan``'s params through ``io/bridge.py``, or at random
(:func:`random_lpips_fn`, flax's init).
"""

from __future__ import annotations

import torch
from torch import nn

from tpugan_torch.losses.vgg import LPIPS_FEATURES, VGG16Features
from tpugan_torch.nn.layers import plain_conv

# published scaling-layer constants (lpips/lpips.py ScalingLayer)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

_LIN_CHANNELS = (64, 128, 256, 512, 512)


def _normalize_tensor(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
    return x / (norm + eps)


class LPIPS(nn.Module):
    """``forward(a, b)``: NHWC images -> per-sample distance [N].
    ``forward(a)``: the five unit-normalised feature maps of ``a`` (NCHW),
    which ``forward(a, b, a_feats=...)`` takes in place of the a-side pass."""

    def __init__(self, generator: torch.Generator | None = None):
        super().__init__()
        self.backbone = VGG16Features(generator=generator)
        for j, c in enumerate(_LIN_CHANNELS):
            self.add_module(f"lin_{j}", plain_conv(c, 1, 1, bias=False, generator=generator))

    def features(self, x: torch.Tensor) -> list:
        shift = torch.tensor(_SHIFT, dtype=x.dtype, device=x.device)
        scale = torch.tensor(_SCALE, dtype=x.dtype, device=x.device)
        x = ((x - shift) / scale).permute(0, 3, 1, 2)
        fs = self.backbone(x)
        return [_normalize_tensor(fs[i]) for i in LPIPS_FEATURES]

    def forward(self, a: torch.Tensor, b: torch.Tensor | None = None, a_feats=None):
        if b is None:
            return self.features(a)
        fa = self.features(a) if a_feats is None else a_feats
        fb = self.features(b)
        total = 0.0
        for j, (xa, xb) in enumerate(zip(fa, fb)):
            diff = (xa - xb) ** 2
            total = total + getattr(self, f"lin_{j}")(diff).mean(dim=(1, 2, 3))
        return total


def random_params(generator: torch.Generator | None = None) -> LPIPS:
    """An LPIPS with random weights (flax's default init), for tests and
    runs without weight files."""
    return LPIPS(generator=generator)


def make_lpips_fn(model: LPIPS):
    """Closure for ``space_loss(..., lpips_fn=...)``: ``fn(a, b, a_feats=None)
    -> [N]``, with ``fn.features(x)`` for a side that stays fixed. The
    model's weights take no gradient."""
    model.requires_grad_(False)

    def fn(a, b, a_feats=None):
        return model(a, b, a_feats=a_feats)

    fn.features = model.features
    return fn


def random_lpips_fn(device, seed: int = 7, dtype: torch.dtype | None = None):
    """Random-weight LPIPS closure on ``device`` for benchmarks: random heads
    cost what trained ones cost, so a step does the reference's real work
    (six VGG16 passes: the full image and both crops, each on target and
    reconstruction). Not for quality evaluation. ``dtype=torch.bfloat16``
    gives the bf16 LPIPS of ``precision.bf16_lpips`` (bf16 VGG weights and
    activations, fp32 distances), as tpugan's ``dtype`` does."""
    model = random_params(torch.Generator().manual_seed(seed)).to(device)
    if dtype is not None:
        from tpugan_torch.precision import bf16_lpips

        return bf16_lpips(make_lpips_fn(model.to(dtype)))
    return make_lpips_fn(model)
