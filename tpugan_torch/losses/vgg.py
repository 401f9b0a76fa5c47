"""VGG16's convolutional features, NCHW (counterpart of
``tpugan/losses/vgg.py``'s ``VGG16(include_classifier=False)``), the LPIPS
backbone. Convolutions are ``conv_0`` ... ``conv_12`` as ``tpugan`` names
them, so ``io/bridge.py`` loads its params name for name. The classifier
head and the guided-backprop ReLU come with ROADMAP slice 6 (Grad-CAM).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpugan_torch.nn.layers import plain_conv

# channels per conv layer; 'M' = 2x2 max pool (torchvision 'D' config)
VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M"]

# post-ReLU feature indices used by LPIPS (relu1_2, 2_2, 3_3, 4_3, 5_3)
LPIPS_FEATURES = (1, 3, 6, 9, 12)


class VGG16Features(nn.Module):
    """``forward(x [N, 3, H, W]) -> [13 post-ReLU feature maps]``. The last
    max pool, which feeds only the classifier, is not run."""

    def __init__(self, generator: torch.Generator | None = None):
        super().__init__()
        self.plan = []
        cin, idx = 3, 0
        for v in VGG16_CFG:
            if v == "M":
                self.plan.append(None)
                continue
            self.add_module(f"conv_{idx}", plain_conv(cin, v, 3, generator=generator))
            self.plan.append(f"conv_{idx}")
            cin, idx = v, idx + 1
        self.plan = self.plan[:-1]

    def forward(self, x: torch.Tensor) -> list:
        feats = []
        for name in self.plan:
            if name is None:
                x = F.max_pool2d(x, 2)
            else:
                x = F.relu(getattr(self, name)(x))
                feats.append(x)
        return feats
