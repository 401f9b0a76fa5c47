"""VGG16, NCHW (counterpart of ``tpugan/losses/vgg.py``): the LPIPS backbone
and the Grad-CAM network.

Convolutions are ``conv_0`` ... ``conv_12`` and the classifier ``head.fc_0``,
``head.fc_1``, ``head.fc_2``, as ``tpugan`` names them, so ``io/bridge.py``
loads its params name for name. The classifier flattens its 7x7 map in
NCHW order, torchvision's (c, h, w); ``tpugan`` flattens NHWC, (h, w, c), and
the bridge permutes ``fc_0``'s input rows accordingly. There is no dropout:
the reference runs VGG16 in eval mode.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpugan_torch.nn.layers import lecun_normal_, plain_conv, plain_linear

# channels per conv layer; 'M' = 2x2 max pool (torchvision 'D' config)
VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M"]

# post-ReLU feature indices used by LPIPS (relu1_2, 2_2, 3_3, 4_3, 5_3)
LPIPS_FEATURES = (1, 3, 6, 9, 12)

# index of the last conv (features.28), Grad-CAM's target
LAST_CONV_FEATURE = 12

# the classifier's input: the last conv's 512 channels pooled to 7x7
HEAD_IN = (512, 7, 7)


class GuidedReLU(torch.autograd.Function):
    """ReLU whose backward passes only positive gradients where the input
    is positive (guided backpropagation; ``tpugan``'s ``guided_relu``, the
    reference's ``clamp(grad_in, min=0)`` hook)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x.clamp(min=0)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x > 0, g.clamp(min=0), 0.0)


class FlattenedLinear(nn.Linear):
    """``fc_0``: a dense layer over a feature map flattened in (c, h, w)
    order, ``in_shape`` = (c, h, w). The bridge reorders ``tpugan``'s
    (h, w, c) rows for it."""

    in_shape = HEAD_IN


class VGG16(nn.Module):
    """``forward(x [N, 3, H, W], return_conv_out=False, guided=None) ->
    (logits | None, feats[, conv_out])``: ``feats[j]`` is the j-th conv's
    post-ReLU activation (13), ``conv_out`` the last conv's pre-ReLU output
    (what the reference's hook on features.28 captures). ``guided`` (default
    the module's) swaps in :class:`GuidedReLU` everywhere. Without the
    classifier the last max pool, which feeds only it, is not run."""

    def __init__(self, num_classes: int = 1000, include_classifier: bool = True, guided: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.guided = guided
        self.include_classifier = include_classifier
        self.plan = []
        cin, idx = 3, 0
        for v in VGG16_CFG[:-1]:
            if v == "M":
                self.plan.append(None)
                continue
            self.add_module(f"conv_{idx}", plain_conv(cin, v, 3, generator=generator))
            self.plan.append(f"conv_{idx}")
            cin, idx = v, idx + 1
        if include_classifier:
            fc_0 = FlattenedLinear(HEAD_IN[0] * HEAD_IN[1] * HEAD_IN[2], 4096)
            with torch.no_grad():  # plain_linear's init
                lecun_normal_(fc_0.weight, generator)
                fc_0.bias.zero_()
            self.head = nn.ModuleDict({
                "fc_0": fc_0,
                "fc_1": plain_linear(4096, 4096, generator=generator),
                "fc_2": plain_linear(4096, num_classes, generator=generator),
            })

    def _relu(self, x, guided):
        return GuidedReLU.apply(x) if guided else F.relu(x)

    def _guided(self, guided):
        return self.guided if guided is None else guided

    def forward(self, x: torch.Tensor, return_conv_out: bool = False, guided: bool | None = None):
        guided = self._guided(guided)
        feats, conv_out = [], None
        for name in self.plan:
            if name is None:
                x = F.max_pool2d(x, 2)
                continue
            x = getattr(self, name)(x)
            if len(feats) == LAST_CONV_FEATURE:
                conv_out = x
            x = self._relu(x, guided)
            feats.append(x)
        logits = self._head(feats[LAST_CONV_FEATURE], guided) if self.include_classifier else None
        if return_conv_out:
            return logits, feats, conv_out
        return logits, feats

    def head_from_conv(self, conv_out: torch.Tensor, guided: bool | None = None) -> torch.Tensor:
        """The last conv's pre-ReLU output -> logits: the function Grad-CAM
        differentiates (its ReLU, guided or not, then the classifier)."""
        guided = self._guided(guided)
        return self._head(self._relu(conv_out, guided), guided)

    def _head(self, x: torch.Tensor, guided: bool) -> torch.Tensor:
        """The last conv's activation -> logits: the last max pool, the
        adaptive average pool to 7x7, the (c, h, w) flatten, fc + ReLU,
        fc + ReLU, fc."""
        x = F.adaptive_avg_pool2d(F.max_pool2d(x, 2), HEAD_IN[1:]).flatten(1)
        x = self._relu(self.head.fc_0(x), guided)
        x = self._relu(self.head.fc_1(x), guided)
        return self.head.fc_2(x)


class VGG16Features(VGG16):
    """The LPIPS backbone (``tpugan``'s ``VGG16(include_classifier=False)``):
    ``forward(x [N, 3, H, W]) -> [13 post-ReLU feature maps]``."""

    def __init__(self, generator: torch.Generator | None = None):
        super().__init__(include_classifier=False, generator=generator)

    def forward(self, x: torch.Tensor) -> list:
        return super().forward(x)[1]

