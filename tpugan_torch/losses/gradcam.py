"""Grad-CAM, Grad-CAM++ and guided backpropagation on VGG16 (counterpart of
``tpugan/losses/gradcam.py``; metric/grad_cam.py of the reference).

Images are NHWC in [-1, 1], as in ``tpugan``; the network runs NCHW. The
feature map and its gradient are the last conv's pre-ReLU output (the
reference's hooks sit on the Conv2d module, features.28), taken with
``torch.autograd.grad`` on a detached copy of that output, so the CAM's
backward never reaches a graph the images came from. Everything stays on
the images' device, in their dtype up to the masks; the colormap is an fp32
lookup table on the device (no host round trip), so the heatmaps and
overlays are fp32, as ``tpugan``'s are.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from tpugan_torch.losses.vgg import VGG16


def majority_class(logits: torch.Tensor) -> torch.Tensor:
    """argmax per image, then the most frequent class across the batch
    (grad_cam.py:91-93, ``np.argmax(np.bincount(index))``); ties go to the
    smallest class, as in ``tpugan``."""
    idx = torch.argmax(logits, dim=-1)
    return torch.argmax(F.one_hot(idx, logits.shape[-1]).sum(dim=0))


def _normalize_resize(cam: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Per-image min-max normalisation of cam [N, h, w], then a bilinear
    resize to (height, width) (grad_cam.py:108-114, cv2.resize's default;
    ``tpugan``'s ``jax.image.resize(..., "linear")``); returns [N, H, W, 1]."""
    cam = cam - cam.amin(dim=(1, 2), keepdim=True)
    cmax = cam.amax(dim=(1, 2), keepdim=True)
    cam = cam / torch.where(cmax > 0, cmax, 1.0)
    cam = F.interpolate(cam[:, None], size=(height, width), mode="bilinear", align_corners=False)
    return cam[:, 0, :, :, None]


def grad_cam(vgg: VGG16, images: torch.Tensor, index=None, plus_plus: bool = False,
             guided: bool = True) -> torch.Tensor:
    """CAM masks [N, H, W, 1] in [0, 1] for NHWC images: Grad-CAM++'s alpha
    weighting with ``plus_plus`` (grad_cam.py:157-194), plain Grad-CAM
    (:82-115) otherwise, for class ``index`` or, when None, the batch's
    majority class. ``guided`` (the default, what the reference executes:
    its GuidedBackPropagation hooks the same VGG16) takes the CAM's
    backward through guided ReLUs."""
    guided = guided or vgg.guided
    with torch.no_grad():
        logits, _, feature = vgg(images.permute(0, 3, 1, 2), return_conv_out=True, guided=guided)
    cls = majority_class(logits) if index is None else index
    with torch.enable_grad():
        f = feature.detach().requires_grad_(True)
        target = vgg.head_from_conv(f, guided=guided)[:, cls].mean()
        (gradient,) = torch.autograd.grad(target, f)  # [N, C, h, w]
    if plus_plus:
        g = gradient.clamp(min=0)
        norm = g.sum(dim=(2, 3), keepdim=True)
        inv = torch.where(norm > 0, 1.0 / torch.where(norm > 0, norm, 1.0), 0.0)
        alpha = torch.where(g > 0, 1.0, 0.0).to(g.dtype) * inv
        weight = (g * alpha).sum(dim=(2, 3))  # [N, C]
        cam = (feature * weight[:, :, None, None]).sum(dim=1)
        # CAM++ skips the ReLU (grad_cam.py:185 commented out)
    else:
        weight = gradient.mean(dim=(2, 3))
        cam = (feature * weight[:, :, None, None]).sum(dim=1).clamp(min=0)
    return _normalize_resize(cam, images.shape[1], images.shape[2])


def guided_backprop(vgg: VGG16, images: torch.Tensor, index=None) -> torch.Tensor:
    """The gradient of the class score with respect to the NHWC images,
    through guided ReLUs (grad_cam.py:196-232), for class ``index`` or the
    batch's majority class."""
    with torch.enable_grad():
        x = images.detach().requires_grad_(True)
        logits, _ = vgg(x.permute(0, 3, 1, 2), guided=True)
        cls = majority_class(logits.detach()) if index is None else index
        (grad,) = torch.autograd.grad(logits[:, cls].mean(), x)
    return grad


# cv2.COLORMAP_JET, RGB order: the exact 256x3 uint8 table
# (cv2.applyColorMap(arange(256, uint8), COLORMAP_JET)[..., ::-1]), as
# tpugan bakes it
_JET_HEX = (
    "00008000008400008800008c00009000009400009800009c0000a00000a40000"
    "a80000ac0000b00000b40000b80000bc0000c00000c40000c80000cc0000d000"
    "00d40000d80000dc0000e00000e40000e80000ec0000f00000f40000f80000fc"
    "0000ff0004ff0008ff000cff0010ff0014ff0018ff001cff0020ff0024ff0028"
    "ff002cff0030ff0034ff0038ff003cff0040ff0044ff0048ff004cff0050ff00"
    "54ff0058ff005cff0060ff0064ff0068ff006cff0070ff0074ff0078ff007cff"
    "0080ff0084ff0088ff008cff0090ff0094ff0098ff009cff00a0ff00a4ff00a8"
    "ff00acff00b0ff00b4ff00b8ff00bcff00c0ff00c4ff00c8ff00ccff00d0ff00"
    "d4ff00d8ff00dcff00e0ff00e4ff00e8ff00ecff00f0ff00f4ff00f8ff00fcff"
    "02fffe06fffa0afff60efff212ffee16ffea1affe61effe222ffde26ffda2aff"
    "d62effd232ffce36ffca3affc63effc242ffbe46ffba4affb64effb252ffae56"
    "ffaa5affa65effa262ff9e66ff9a6aff966eff9272ff8e76ff8a7aff867eff82"
    "82ff7e86ff7a8aff768eff7292ff6e96ff6a9aff669eff62a2ff5ea6ff5aaaff"
    "56aeff52b2ff4eb6ff4abaff46beff42c2ff3ec6ff3acaff36ceff32d2ff2ed6"
    "ff2adaff26deff22e2ff1ee6ff1aeaff16eeff12f2ff0ef6ff0afaff06feff01"
    "fffc00fff800fff400fff000ffec00ffe800ffe400ffe000ffdc00ffd800ffd4"
    "00ffd000ffcc00ffc800ffc400ffc000ffbc00ffb800ffb400ffb000ffac00ff"
    "a800ffa400ffa000ff9c00ff9800ff9400ff9000ff8c00ff8800ff8400ff8000"
    "ff7c00ff7800ff7400ff7000ff6c00ff6800ff6400ff6000ff5c00ff5800ff54"
    "00ff5000ff4c00ff4800ff4400ff4000ff3c00ff3800ff3400ff3000ff2c00ff"
    "2800ff2400ff2000ff1c00ff1800ff1400ff1000ff0c00ff0800ff0400ff0000"
    "fc0000f80000f40000f00000ec0000e80000e40000e00000dc0000d80000d400"
    "00d00000cc0000c80000c40000c00000bc0000b80000b40000b00000ac0000a8"
    "0000a40000a000009c00009800009400009000008c0000880000840000800000"
)
_JET_LUT = torch.from_numpy(
    np.frombuffer(bytes.fromhex("".join(_JET_HEX)), dtype=np.uint8).reshape(256, 3).astype(np.float32)
    / 255.0
)


@functools.lru_cache(maxsize=None)
def _jet_lut(device: torch.device) -> torch.Tensor:
    return _JET_LUT.to(device)


def jet_colormap(x: torch.Tensor) -> torch.Tensor:
    """cv2's COLORMAP_JET for values in [0, 1] -> RGB [..., 3] in [0, 1],
    fp32: the reference's ``cv2.applyColorMap(np.uint8(255 * x), ...)``
    (grad_cam.py:240-242), ``255 * x`` computed in x's dtype and truncated
    to uint8."""
    idx = (255.0 * x).to(torch.uint8).long()
    return _jet_lut(x.device)[idx]


def mask2cam(mask: torch.Tensor, imgs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """CAM overlays (grad_cam.py:234-251): the JET heatmap of mask [N, H, W,
    1], and heatmap + imgs [N, H, W, 3] less the batch's minimum, divided by
    each image's maximum (``tpugan``'s reading of the reference's
    ``np.max(np.min(cam), 0)``: the 0 is numpy's axis, not a clamp)."""
    heatmap = jet_colormap(mask[..., 0])
    cam = heatmap + imgs
    cam = cam - cam.min()
    cmax = cam.amax(dim=(1, 2, 3), keepdim=True)
    return heatmap, cam / torch.where(cmax > 0, cmax, 1.0)
