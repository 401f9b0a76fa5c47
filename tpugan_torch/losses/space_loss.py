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

With a process ``group`` (data parallelism, ``parallel/mesh.py``) ``a`` and
``b`` are this rank's rows of the batch: the cosine distance sums its dot
products over the ranks with a gradient, and ``info`` holds the whole
batch's statistics (the KL of a 3-D input softmaxes over the whole batch).

With ``space`` (a ``parallel.spatial.Rows``: the space axis) the images are
this rank's rows of its batch: the MSE's, the cosine's and the statistics'
sums run over the space group too, the average-pool ladder counts the whole
image's height, and SSIM and LPIPS run on the pooled images gathered whole
on every rank. The loss and ``info`` are then the same on every rank of
the group.
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
    latents. nan is guarded to 0 and inf to 1."""
    return _kl_guard(_kl_mean(a, b))


def _softmax_over_batch(a: torch.Tensor) -> bool:
    return a.dim() in (0, 1, 3)


def _kl_mean(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(_kl_terms(a, b))


def _kl_terms(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    dim = 0 if _softmax_over_batch(a) else -1
    # probabilities below fp32's smallest normal are flushed to zero, as
    # XLA does on the CPU and the TPU: a denormal pb would keep log(pb)
    # finite where the reference's KL is inf (and so guarded to 1)
    tiny = torch.finfo(torch.float32).tiny
    pa, pb = (torch.where(p < tiny, 0.0, p) for p in (torch.softmax(a, dim=dim),
                                                       torch.softmax(b, dim=dim)))
    return pa * (torch.log(pa) - torch.log(pb))


def _kl_guard(kl: torch.Tensor) -> torch.Tensor:
    kl = torch.where(torch.isnan(kl), torch.zeros_like(kl), kl)
    return torch.where(torch.isinf(kl), torch.ones_like(kl), kl)


def _downscale_nhwc(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def lpips_pools(height: int) -> int:
    """The 2x average pools that bring ``height`` rows to at most 256."""
    pools = 0
    while height > 256:
        height, pools = height // 2, pools + 1
    return pools


def pool_for_lpips(a: torch.Tensor, space=None) -> torch.Tensor:
    """The <=256 px average-pool ladder applied before SSIM and LPIPS, for
    callers that cache a fixed target's LPIPS features. With ``space`` (a
    ``parallel.spatial.Rows``) ``a`` is this rank's rows and the ladder is
    the whole image's, which the rows must align with."""
    pools = lpips_pools(a.shape[1] if space is None else space.total)
    if space is not None and (space.start % 2**pools or a.shape[1] % 2**pools):
        raise ValueError(f"rows [{space.start}, {space.start + a.shape[1]}) of {space.total} do not align with "
                         f"{pools} 2x pools")
    for _ in range(pools):
        a = _downscale_nhwc(a)
    return a


def pooled_whole(a: torch.Tensor, space) -> torch.Tensor:
    """``pool_for_lpips`` of the whole image on every rank of the space
    group, from this rank's rows ``a`` (``space``, a
    ``parallel.spatial.Rows``): pooled on the rows, then gathered."""
    from tpugan_torch.parallel.spatial import Rows, gather

    pools = lpips_pools(space.total)
    return gather(pool_for_lpips(a, space), Rows(space.group, space.start >> pools, space.total >> pools))


def space_loss(
    a: torch.Tensor,
    b: torch.Tensor,
    image_space: bool = True,
    lpips_fn: Optional[Callable] = None,
    lpips_a_feats=None,
    group=None,
    space=None,
) -> tuple[torch.Tensor, SpaceLossInfo]:
    """Multi-term distance between ``a`` (target) and ``b`` (reconstruction).

    Images are NHWC in [-1, 1]; latents may be any shape. ``lpips_fn(a, b)
    -> [N]`` is the perceptual distance; None contributes 0.
    ``lpips_a_feats`` are features of ``pool_for_lpips(a)``
    (``lpips_fn.features``) for loops whose a-side is fixed.

    With ``group``, the total is this rank's share: the mean terms of its
    rows and the whole batch's cosine distance. The whole batch's total is
    the mean of the shares over the ranks, and so is its gradient with
    respect to replicated parameters (``parallel.mesh.average_gradients``).

    With ``space`` (a ``parallel.spatial.Rows``), ``a`` and ``b`` are NHWC
    images of which this rank holds its rows of the space group; the total
    and ``info`` are its data rank's, the same on every rank of the group.
    ``lpips_a_feats`` are then the features of ``pooled_whole(a, space)``.
    """
    if group is not None or space is not None:
        return _space_loss_shard(a, b, image_space, lpips_fn, lpips_a_feats, group, space)
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


def _space_loss_shard(a, b, image_space, lpips_fn, lpips_a_feats, group, space):
    """:func:`space_loss` on this rank's rows of the batch (``group``) and,
    with ``space``, of its images' rows: every sum over the space group,
    then over the data group (see there)."""
    from tpugan_torch.parallel.mesh import all_sum, all_sum_grad, gather_rows, group_size

    n = group_size(group)
    rows = None if space is None else space.group
    if space is not None and a.dim() != 4:
        raise ValueError(f"row shards are NHWC images, got a {a.dim()}-D input")
    count = a.numel() if space is None else a.shape[0] * space.total * a.shape[2] * a.shape[3]
    mse = all_sum_grad(torch.sum(torch.square(a - b)), rows) / count  # this data rank's share
    af, bf = a.reshape(-1), b.reshape(-1)
    dots = all_sum_grad(all_sum_grad(torch.stack([torch.dot(af, af), torch.dot(bf, bf), torch.dot(af, bf)]), rows),
                        group)
    denom = torch.sqrt(dots[0] + 1e-12) * torch.sqrt(dots[1] + 1e-12)
    cosine = 1.0 - dots[2] / denom
    zero = torch.zeros((), dtype=mse.dtype, device=mse.device)
    if image_space:
        pa, pb = (pool_for_lpips(a), pool_for_lpips(b)) if space is None else (pooled_whole(a, space),
                                                                             pooled_whole(b, space))
        ssim_loss = 1.0 - ssim_fn(pa, pb)
        lpips_val = zero if lpips_fn is None else torch.mean(lpips_fn(pa, pb, a_feats=lpips_a_feats))
    else:
        ssim_loss = lpips_val = zero
    total = 5.0 * mse + 3.0 * cosine + ssim_loss + 2.0 * lpips_val

    # the whole batch's logged statistics
    with torch.no_grad():
        count *= n
        kl_batch = _softmax_over_batch(a)  # the KL's softmax runs over the batch (see _kl_quirk)
        local = [a.sum(), b.sum()] + ([] if kl_batch else [torch.sum(_kl_terms(a, b))])
        sums = all_sum(all_sum(torch.stack(local).to(mse.dtype), rows), group)
        mean_a, mean_b = sums[0] / count, sums[1] / count
        dev = all_sum(all_sum(torch.stack([torch.sum(torch.square(a - mean_a)), torch.sum(torch.square(b - mean_b))]),
                              rows), group)
        std_a, std_b = (torch.sqrt(d / max(count - 1, 1)) for d in dev)
        kl = _kl_quirk(gather_rows(a, group), gather_rows(b, group)) if kl_batch else _kl_guard(sums[2] / count)
        shared = all_sum(torch.stack([mse, ssim_loss, lpips_val]).detach(), group) / n
    info = SpaceLossInfo(mse=shared[0], mse_mean=torch.square(mean_a - mean_b), mse_std=torch.square(std_a - std_b),
                         kl=kl, cosine=cosine, ssim=shared[1], lpips=shared[2])
    return total, info
