"""The multi-term "space loss" on images or latents (counterpart of
``tpugan/losses/space_loss.py``):

  total = 5*MSE + 3*cosine + (1 - SSIM) + 2*LPIPS        (image space)
  total = 5*MSE + 3*cosine                               (latent space)

with ``tpugan``'s quirks kept: the mean/std MSEs and the KL divergence are
computed and logged but left out of the total; the KL takes torch's legacy
implicit softmax dim and is nan/inf-guarded; the cosine distance flattens
the whole batch into one vector, with its eps inside the square roots;
images are average-pooled to at most 256 px before SSIM and LPIPS.

``info`` comes back as a :class:`SpaceLossInfo` of 0-d tensors, so callers
read them at their own cadence without a host sync per step.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from tpugan_torch.losses.ssim import ssim as ssim_fn


class SpaceLossInfo(NamedTuple):
    mse: torch.Tensor
    mse_mean: torch.Tensor
    mse_std: torch.Tensor
    kl: torch.Tensor
    cosine: torch.Tensor
    ssim: torch.Tensor
    lpips: torch.Tensor


def zero_space_info(device=None) -> SpaceLossInfo:
    """Info for loss groups a step skips (lean off-tick steps)."""
    z = torch.zeros((), device=device)
    return SpaceLossInfo(mse=z, mse_mean=z, mse_std=z, kl=z, cosine=z, ssim=z, lpips=z)


def _unbiased_std(x: torch.Tensor) -> torch.Tensor:
    n = x.numel()
    return torch.sqrt(torch.sum(torch.square(x - x.mean())) / max(n - 1, 1))


def _kl_quirk(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """KLDivLoss with torch's implicit-softmax-dim quirk (logged only):
    torch's legacy ``_get_softmax_dim`` takes dim 0 for 0-, 1- and 3-D
    inputs and dim 1 otherwise, which is the channel axis (NHWC axis -1)
    for images, dim 0 for [N, 18, 512] w-latents and dim 1 (-1) for [N, C]
    latents."""
    dim = 0 if a.dim() in (0, 1, 3) else -1
    # probabilities below fp32's smallest normal are flushed to zero, as
    # XLA does on the CPU and the TPU: a denormal pb would keep log(pb)
    # finite where the reference's KL is inf (and so guarded to 1)
    tiny = torch.finfo(torch.float32).tiny
    pa, pb = (torch.where(p < tiny, 0.0, p) for p in (torch.softmax(a, dim=dim),
                                                       torch.softmax(b, dim=dim)))
    kl = torch.mean(pa * (torch.log(pa) - torch.log(pb)))
    kl = torch.where(torch.isnan(kl), torch.zeros_like(kl), kl)
    return torch.where(torch.isinf(kl), torch.ones_like(kl), kl)


def _downscale_nhwc(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def pool_for_lpips(a: torch.Tensor) -> torch.Tensor:
    """The <=256 px average-pool ladder applied before SSIM and LPIPS, for
    callers that cache a fixed target's LPIPS features."""
    while a.shape[1] > 256:
        a = _downscale_nhwc(a)
    return a


def space_loss(
    a: torch.Tensor,
    b: torch.Tensor,
    image_space: bool = True,
    lpips_fn: Optional[Callable] = None,
    lpips_a_feats=None,
) -> tuple[torch.Tensor, SpaceLossInfo]:
    """Multi-term distance between ``a`` (target) and ``b`` (reconstruction).

    Images are NHWC in [-1, 1]; latents may be any shape. ``lpips_fn(a, b)
    -> [N]`` is the perceptual distance; None contributes 0.
    ``lpips_a_feats`` are features of ``pool_for_lpips(a)``
    (``lpips_fn.features``) for loops whose a-side is fixed.
    """
    mse = torch.mean(torch.square(a - b))
    mse_mean = torch.square(a.mean() - b.mean())
    mse_std = torch.square(_unbiased_std(a) - _unbiased_std(b))
    kl = _kl_quirk(a, b)

    af, bf = a.reshape(-1), b.reshape(-1)
    # eps inside the sqrt: d||x||/dx is 0/0 on an exactly-zero input otherwise
    denom = torch.sqrt(torch.dot(af, af) + 1e-12) * torch.sqrt(torch.dot(bf, bf) + 1e-12)
    cosine = 1.0 - torch.dot(af, bf) / denom

    zero = torch.zeros((), dtype=mse.dtype, device=mse.device)
    if image_space:
        a, b = pool_for_lpips(a), pool_for_lpips(b)
        ssim_loss = 1.0 - ssim_fn(a, b)
        if lpips_fn is None:
            lpips_val = zero
        else:
            lpips_val = torch.mean(lpips_fn(a, b, a_feats=lpips_a_feats))
    else:
        ssim_loss = lpips_val = zero

    total = 5.0 * mse + 3.0 * cosine + ssim_loss + 2.0 * lpips_val
    info = SpaceLossInfo(mse=mse, mse_mean=mse_mean, mse_std=mse_std, kl=kl,
                         cosine=cosine, ssim=ssim_loss, lpips=lpips_val)
    return total, info
