"""Mis-aligned encoder training with Grad-CAM++ attention (counterpart of
``tpugan/train/e_mis_align.py``; E_mis_align_cropping_s1.py:28-343).

The attention regions come from a VGG16: Grad-CAM++ masks (the AT1 analog)
and CAM overlays (the AT2 analog), with guided-backpropagation gradients
logged. ``loss_tsa = imgs + mask + Gcam`` (:191) is logged; the update is
``0.01 * loss_w`` alone, as in the reference, which detaches every image
tensor before its losses (imgs1 and imgs2 are detached clones, the masks
and CAMs are made in numpy, :172-194).

The step's seam is :func:`~tpugan_torch.train.e_align.make_train_step`'s:
explicit draws (``draw(iteration) -> Request``), train-mode closures, the
encoder's spectral norms advanced by one power iteration a step. The whole
attention stack runs without gradient on detached images; its own
``autograd.grad`` calls (the CAM's and guided backpropagation's) start from
detached copies and never reach the encoder's graph.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from tpugan_torch.losses.gradcam import grad_cam, guided_backprop, mask2cam
from tpugan_torch.losses.space_loss import SpaceLossInfo, space_loss, zero_space_info
from tpugan_torch.losses.vgg import VGG16
from tpugan_torch.nn.spectral import power_iterate
from tpugan_torch.parallel.mesh import (
    average_gradients,
    batch_mean,
    data_group,
    gather_rows,
    group_size,
    shard_batch,
    space_group,
    take_rows,
)
from tpugan_torch.parallel.spatial import Rows, gather
from tpugan_torch.train.e_align import (
    EncoderTrainState,
    Request,
    SynthBatch,
    image_rows,
    make_align_visuals,
    nchw_to_nhwc,
)


class MisAlignInfo(NamedTuple):
    loss_imgs: SpaceLossInfo
    loss_mask: SpaceLossInfo
    loss_gcam: SpaceLossInfo
    # the guided-backpropagation gradients' distance, logged only, like the
    # reference's loss_grad (E_mis_align_cropping_s1.py:161-172)
    loss_grad: SpaceLossInfo
    loss_w: SpaceLossInfo
    loss_c: SpaceLossInfo
    loss_tsa: torch.Tensor
    loss_mtv: torch.Tensor


def _attention(vgg: VGG16, images: torch.Tensor, cam_bf16: bool, group=None, space=None):
    """The Grad-CAM++ mask [N, H, W, 1] and CAM overlay [N, H, W, 3] of
    detached images, fp32 out; with ``cam_bf16`` computed from bf16 images
    on a bf16 VGG16; with ``space`` (a ``Rows``) of this rank's rows."""
    if cam_bf16:
        images = images.to(torch.bfloat16)
    mask = grad_cam(vgg, images, plus_plus=True, group=group, space=space)
    _, cam = mask2cam(mask, images, group=group, space=space)
    return mask.float(), cam.float()


def make_mis_align_step(
    encode: Callable,
    synth: Callable[[Request], SynthBatch],
    resynth: Callable,
    draw: Callable[[int], Request],
    vgg: VGG16,
    lpips_fn=None,
    cam_bf16: bool = False,
    compute_attention_losses: bool = True,
    mesh=None,
    spatial: bool = False,
):
    """Build the Grad-CAM training step ``step(state, iteration) -> (state,
    MisAlignInfo)``, which updates ``state`` in place; the closures as
    :func:`~tpugan_torch.train.e_align.make_train_step` takes them.

    ``vgg`` computes the CAM++ masks and the guided-backpropagation
    gradients of the logged ``loss_grad``, both backwards through guided
    ReLUs, as the reference's hooks on its one VGG16 make them. With
    ``cam_bf16`` the images enter the attention stack in bf16; pass a bf16
    VGG16 (``tpugan``'s ``cast_floating(vgg_vars, bf16)``).

    ``compute_attention_losses=False`` is the lean off-tick step: no
    resynthesis, no CAM++ or guided-backpropagation passes, no image losses,
    their info zero. The attention stack is log-only, so the parameter
    trajectory is the full step's, bit for bit.

    ``mesh`` and ``spatial`` as :func:`~tpugan_torch.train.e_align.make_train_step`
    takes them; the masks, overlays and guided gradients of a rank's rows
    are those of the global batch (its majority class, its overlays'
    minimum, its class-score mean). With ``spatial`` each rank of a space
    group holds its rows of the images: ``encode`` runs on them, the
    resynthesis runs whole and is cut to the rank's rows, and the attention
    stack (VGG16's convolutions, the masks, the overlays, the guided
    gradients) and the four loss groups run on the rows
    (``losses/gradcam.py``); each rank differentiates its share of the
    latent loss and the gradients are summed over the group.
    """
    if spatial and mesh is None:
        raise ValueError("spatial=True needs a mesh with a space axis")
    group = data_group(mesh)
    space = space_group(mesh) if spatial else None
    share = 1.0 / group_size(space)

    def attention_losses(batch: SynthBatch, rows, w2, noise_g2):
        imgs2 = resynth(w2, batch, noise_g2)
        if rows is not None:
            imgs2 = take_rows(imgs2, space, 1)
        i1, i2 = batch.imgs1.detach(), imgs2.detach()
        mask1, cam1 = _attention(vgg, i1, cam_bf16, group, rows)
        mask2, cam2 = _attention(vgg, i2, cam_bf16, group, rows)
        l_imgs, i_imgs = space_loss(i1, i2, lpips_fn=lpips_fn, group=group, space=rows)
        # the masks are single-channel: tiled to 3, as the reference's
        # [n, 1, h, w] tensors are fed through space_loss
        l_mask, i_mask = space_loss(mask1.expand(-1, -1, -1, 3), mask2.expand(-1, -1, -1, 3), lpips_fn=lpips_fn,
                                    group=group, space=rows)
        l_gcam, i_gcam = space_loss(cam1, cam2, lpips_fn=lpips_fn, group=group, space=rows)
        # grad_i = gbp(imgs_i.detach().clone()) on each side, logged
        # (E_mis_align_cropping_s1.py:163-172)
        dtype = torch.bfloat16 if cam_bf16 else i1.dtype
        gb1 = guided_backprop(vgg, i1.to(dtype), group=group, space=rows).float()
        gb2 = guided_backprop(vgg, i2.to(dtype), group=group, space=rows).float()
        _, i_grad = space_loss(gb1, gb2, lpips_fn=lpips_fn, group=group, space=rows)
        return batch_mean(l_imgs + l_mask + l_gcam, group), (i_imgs, i_mask, i_gcam, i_grad)

    def step(state: EncoderTrainState, iteration: int):
        request = shard_batch(mesh, draw(iteration))
        batch, rows = image_rows(synth(request), mesh, spatial)
        power_iterate(state.encoder)
        params = list(state.encoder.parameters())
        const2, w2 = encode(batch, request.noise_e)
        if compute_attention_losses:
            with torch.no_grad():
                loss_tsa, infos = attention_losses(batch, rows, w2, request.noise_g2)
        else:
            loss_tsa = torch.zeros((), device=w2.device)
            infos = (zero_space_info(w2.device),) * 4
        l_w, i_w = space_loss(batch.w1, w2, image_space=False, group=group)
        const1 = batch.const1
        if const2.dim() == 4:
            # feature maps enter the losses NHWC, as tpugan's do
            const1, const2 = nchw_to_nhwc(const1), nchw_to_nhwc(const2)
        _, i_c = space_loss(const1, const2.detach(), image_space=False, group=group)
        loss_mtv = 0.01 * l_w
        grads = torch.autograd.grad(share * loss_mtv, params, allow_unused=True)
        state.optimizer.step(average_gradients(grads, group, space=space))
        state.step += 1
        info = MisAlignInfo(*infos, loss_w=_detached(i_w), loss_c=i_c, loss_tsa=loss_tsa,
                            loss_mtv=batch_mean(loss_mtv.detach(), group))
        return state, info

    return step


def _detached(info: SpaceLossInfo) -> SpaceLossInfo:
    return SpaceLossInfo(*(v.detach() for v in info))


def make_mis_align_visuals(encode, synth, resynth, draw, vgg: VGG16, mesh=None, spatial: bool = False):
    """The on-tick dumps (E_mis_align_cropping_s1.py:276-288): the
    iteration's imgs1 and imgs2 at its initial parameters
    (:func:`~tpugan_torch.train.e_align.make_align_visuals`), and the
    heatmaps, CAM overlays and guided-backpropagation gradients of imgs1
    then imgs2, each batch after the other, fp32. The VGG16 is fed in its
    own dtype. With ``mesh`` each rank computes its rows and every rank
    gets the global batch (with ``spatial`` its rows of the images, each
    dump then gathered whole). Returns ``visuals(state, iteration) -> dict``
    of NHWC tensors; the CLI normalises the gradients' dump on the host."""
    images = make_align_visuals(encode, synth, resynth, draw, mesh, spatial)
    group = data_group(mesh)
    space = space_group(mesh) if spatial else None

    def whole(x, rows):
        x = x.float()
        return gather_rows(x if rows is None else gather(x, rows), group)

    def visuals(state: EncoderTrainState, iteration: int):
        out = images(state, iteration)
        dtype = next(vgg.parameters()).dtype
        parts = {"heatmap": [], "cam": [], "gb": []}
        for imgs in (out["imgs1"], out["imgs2"]):
            imgs = shard_batch(mesh, imgs, spatial=spatial).to(dtype)
            rows = None if space is None else Rows.even(space, imgs.shape[1])
            with torch.no_grad():
                heatmap, cam = mask2cam(grad_cam(vgg, imgs, plus_plus=True, group=group, space=rows), imgs,
                                        group=group, space=rows)
            parts["heatmap"].append(whole(heatmap, rows))
            parts["cam"].append(whole(cam, rows))
            parts["gb"].append(whole(guided_backprop(vgg, imgs, group=group, space=rows), rows))
        out.update({key: torch.cat(value, dim=0) for key, value in parts.items()})
        return out

    return visuals
