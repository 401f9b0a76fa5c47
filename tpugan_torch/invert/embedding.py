"""Real-image inversion: fine-tune E or optimise w against a frozen G
(counterpart of ``tpugan/invert/embedding.py``; embedding_img.py:24-170 and
the embedding_v2_* variants).

* ``optimize_e=True``: fine-tune E on each image batch, from the base
  weights and a fresh optimizer every batch (embedding_img.py:82-83);
* ``optimize_e=False``: optimise the w code itself, initialised from
  E(imgs), with the base E frozen (:76-80);
* two LREQAdam updates an iteration, both from gradients taken at the
  iteration's initial parameters on one forward graph: the image loss
  ``imgs + 0.125 * (AT1 + AT2)`` with the crops detached (:95-112), then
  ``0.01 * (w + c1)`` (:117-128);
* the v2 options: a w-norm regulariser ``beta * ||w||_p`` and the crop
  weights (embedding_v2_styleGAN1.py:109,123), and the best-loss snapshot
  (:127-135);
* ``attention="gradcam"`` (embedding_v2_BigGAN.py:134-151): Grad-CAM++
  masks and CAM overlays of a VGG16 in place of the crops, ``imgs + mask +
  Gcam`` with the attention terms detached.

tpugan runs ``chunk`` iterations inside one jitted scan; here the loop is
on the host and ``chunk`` is the callback's cadence. Nothing reads a value
back to the host inside the loop: the snapshot and the histories stay on
the device until the chunk ends.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from tpugan_torch.losses.gradcam import grad_cam, mask2cam
from tpugan_torch.losses.space_loss import pool_for_lpips, pooled_whole, space_loss
from tpugan_torch.nn.spectral import SNDense, power_iterate
from tpugan_torch.optim.lreq_adam import LREQAdam, lreq_adam
from tpugan_torch.parallel.mesh import (
    SPACE_AXIS_PART2,
    all_sum,
    all_sum_grad,
    average_gradients,
    batch_mean,
    data_group,
    gather_rows,
    group_size,
    shard_batch,
    space_group,
    take_rows,
)
from tpugan_torch.parallel.spatial import Rows
from tpugan_torch.train.e_align import attention_crops_rows


@dataclasses.dataclass(frozen=True)
class EmbeddingConfig:
    iterations: int = 1500
    lr: float = 0.01
    beta2: float = 0.99
    optimize_e: bool = True
    chunk: int = 100
    # v2 options (embedding_v2_styleGAN1.py)
    beta: float = 0.0  # w-norm regularisation weight
    norm_p: float = 2.0
    crop_weight_medium: float = 0.125
    crop_weight_small: float = 0.125
    detach_crops: bool = True
    # embedding_v2_BigGAN.py: Grad-CAM mask/overlay terms in place of the
    # crops (loss_msiv = imgs + mask + Gcam, both detached, :134-151)
    attention: str = "crops"  # crops | gradcam


class InversionResult(NamedTuple):
    w: torch.Tensor  # [N, L, latent], the final w (after the last iteration)
    images: torch.Tensor  # [N, H, W, C], the reconstruction at the final w
    losses: Any  # [(loss_msiv, loss_mslv)] of each chunk's last iteration
    # the best-loss snapshot (embedding_v2_styleGAN1.py:127-135): armed at
    # iterations // 2, then taken on every 5% improvement of loss_msiv,
    # with the iteration's initial w and loss
    w_best: Optional[torch.Tensor] = None
    loss_best: Optional[torch.Tensor] = None
    iter_best: Optional[torch.Tensor] = None
    # per iteration, for loss_min.txt: loss_msiv, whether it improved the
    # snapshot, and the norm of w
    msiv_history: Optional[torch.Tensor] = None
    improved_history: Optional[torch.Tensor] = None
    wnorm_history: Optional[torch.Tensor] = None


def _encoder_state(encoder: torch.nn.Module) -> dict:
    return {name: t.detach().clone() for name, t in encoder.state_dict().items()}


def make_embedder(
    encode: Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]],
    resynth: Callable[[torch.Tensor], torch.Tensor],
    encoder: torch.nn.Module,
    cfg: EmbeddingConfig,
    lpips_fn=None,
    vgg=None,
    mesh=None,
    spatial: bool = False,
):
    """Build ``invert(imgs, chunk_callback=None) -> InversionResult``.

    ``encode(imgs) -> (const, w)`` runs ``encoder`` on NHWC images (its
    noise fixed by the caller, 4-D consts returned NHWC); ``resynth(w) ->
    imgs`` is the frozen generator, differentiable with respect to w.
    ``encoder`` holds the base weights: the parameters that fine-tune-E mode
    trains in place, and the spectral norms' ``u``/``v``, which the power
    iteration advances (twice an iteration against the live E when
    fine-tuning, E(imgs1) and E(imgs2); once against the base E when
    optimising w, E(imgs2)). Each call of ``invert`` starts from the
    encoder's state on entry, parameters and ``u``/``v``, and puts it back
    on return, so every batch starts from the base E.

    ``attention="gradcam"`` takes ``vgg``, the VGG16 of the masks.

    With ``mesh`` (``parallel.auto_mesh``; tpugan's ``mesh``), ``invert``
    still takes and returns the global batch: each rank of the data axis
    inverts its rows, with ``encode`` and ``resynth`` closed over that
    rank's rows of the noise and the condition, and the losses, the
    w-norm, the snapshot's loss and the histories are the global batch's,
    so each iteration is the one-process iteration. Fine-tuning E, the
    gradients are averaged over the ranks and the encoders stay equal;
    optimising w, each rank's rows of w take their share of the global
    gradient.

    With ``spatial`` (the mesh's ``space`` axis) each rank of a space
    group inverts its rows of its images: ``encode`` runs on a rank's rows
    (its encoder built with ``space=space_group(mesh)``), ``resynth`` whole
    on every rank, cut to the rank's rows before the losses, which sum over
    the group; every rank differentiates its share of the loss, and the
    gradients are summed over the group (``train/e_align.py::
    make_train_step``). Grad-CAM on row shards raises
    :class:`NotImplementedError` (ROADMAP A 1's part 2).
    """
    if cfg.attention not in ("crops", "gradcam"):
        raise ValueError(f"unknown attention {cfg.attention!r}")
    gradcam = cfg.attention == "gradcam"
    if gradcam and vgg is None:
        raise ValueError("attention='gradcam' needs a vgg")
    if spatial and mesh is None:
        raise ValueError("spatial=True needs a mesh with a space axis")
    if spatial and gradcam:
        raise NotImplementedError(SPACE_AXIS_PART2)
    group = data_group(mesh)
    space = space_group(mesh) if spatial else None
    share = 1.0 / group_size(space)

    def rows_of(imgs):
        return None if space is None else Rows.even(space, imgs.shape[1])
    has_sn = any(isinstance(m, SNDense) for m in encoder.modules())
    can_cache_feats = lpips_fn is not None and hasattr(lpips_fn, "features")
    half = cfg.iterations // 2

    def losses(target, imgs1, const2_fixed, cache):
        if cfg.optimize_e:
            const2, w1 = encode(imgs1)
        else:
            w1, const2 = target, const2_fixed  # encoded once per batch (:77)
        imgs2 = resynth(w1)
        rows = rows_of(imgs1)
        if rows is not None:
            imgs2 = take_rows(imgs2, space, 1)
        # the live E re-encodes imgs2 when it is fine-tuned (one module,
        # embedding_img.py:86-88); the base E when w is optimised
        const3, w2 = encode(imgs2)
        l_imgs, _ = space_loss(imgs1, imgs2, lpips_fn=lpips_fn, lpips_a_feats=cache.get("full"), group=group,
                               space=rows)
        if gradcam:
            # m2 and cam2 from the detached imgs2; m1 and cam1 are the cache's
            i2 = imgs2.detach()
            m2 = grad_cam(vgg, i2, plus_plus=True, group=group)
            _, cam2 = mask2cam(m2, i2, group=group)
            l_med, _ = space_loss(cache["m1"].expand(-1, -1, -1, 3), m2.expand(-1, -1, -1, 3),
                                  lpips_fn=lpips_fn, lpips_a_feats=cache.get("m1_feats"), group=group)
            l_small, _ = space_loss(cache["cam1"], cam2, lpips_fn=lpips_fn, lpips_a_feats=cache.get("cam1_feats"),
                                    group=group)
            # the reference's weights: imgs + mask + Gcam (embedding_v2_BigGAN.py:148)
            loss_msiv = l_imgs + l_med + l_small
        else:
            (at1_1, rows1), (at2_1, rows2) = attention_crops_rows(imgs1, rows)
            (at1_2, _), (at2_2, _) = attention_crops_rows(imgs2, rows)
            if cfg.detach_crops:
                at1_1, at2_1, at1_2, at2_2 = (x.detach() for x in (at1_1, at2_1, at1_2, at2_2))
            l_med, _ = space_loss(at1_1, at1_2, lpips_fn=lpips_fn, lpips_a_feats=cache.get("at1"), group=group,
                                  space=rows1)
            l_small, _ = space_loss(at2_1, at2_2, lpips_fn=lpips_fn, lpips_a_feats=cache.get("at2"), group=group,
                                    space=rows2)
            loss_msiv = l_imgs + cfg.crop_weight_medium * l_med + cfg.crop_weight_small * l_small
        l_w, _ = space_loss(w1, w2, image_space=False, group=group)
        l_c1, _ = space_loss(const2, const3, image_space=False, group=group)
        loss_mslv = 0.01 * (l_w + l_c1)
        if cfg.beta > 0.0:
            wnorm = all_sum_grad(torch.sum(torch.abs(w1) ** cfg.norm_p), group) ** (1.0 / cfg.norm_p)
            loss_mslv = loss_mslv + cfg.beta * wnorm
        return loss_msiv, loss_mslv, w1

    @torch.no_grad()
    def precompute_cache(imgs1):
        """The target side's work, which every iteration would otherwise
        redo (bitwise the same values): with Grad-CAM its mask m1 and overlay
        cam1 (a VGG16 forward and backward), and the LPIPS features of imgs1
        and of its crops, or of m1 and cam1."""
        cache = {}
        if gradcam:
            m1 = grad_cam(vgg, imgs1, plus_plus=True, group=group)
            cache["m1"], cache["cam1"] = m1, mask2cam(m1, imgs1, group=group)[1]
            sides = (("full", (imgs1, None)), ("m1_feats", (m1.expand(-1, -1, -1, 3), None)),
                     ("cam1_feats", (cache["cam1"], None)))
        else:
            rows = rows_of(imgs1)
            sides = (("full", (imgs1, rows)), *zip(("at1", "at2"), attention_crops_rows(imgs1, rows)))
        if can_cache_feats:
            cache.update({key: lpips_fn.features(pool_for_lpips(x) if x_rows is None else pooled_whole(x, x_rows))
                          for key, (x, x_rows) in sides})
        return cache

    def one_iteration(target, opt, imgs1, const2_fixed, cache, best, it):
        if has_sn:
            power_iterate(encoder, n_iter=2 if cfg.optimize_e else 1)
        params = opt.param_groups[0]["params"]
        loss_msiv, loss_mslv, w1 = losses(target, imgs1, const2_fixed, cache)
        # both gradients from the one forward graph, at the iteration's
        # initial parameters; then two updates, one after the other
        g1 = torch.autograd.grad(share * loss_msiv, params, retain_graph=True, allow_unused=True)
        g2 = torch.autograd.grad(share * loss_mslv, params, allow_unused=True)
        g1, g2 = (average_gradients(g, group, replicated=cfg.optimize_e, space=space) for g in (g1, g2))
        l_msiv, w1 = batch_mean(loss_msiv.detach(), group), w1.detach()

        best_loss, best_w, best_it = best
        if it == half:
            best_loss = l_msiv
        improved = (best_loss > l_msiv * 1.05) & (it > half)
        take = improved | (it == half)
        best = (torch.where(improved, l_msiv, best_loss), torch.where(take, w1, best_w),
                torch.where(take, it, best_it))
        wnorm = torch.sqrt(all_sum(torch.sum(torch.square(w1)), group))  # torch's w1.norm()
        opt.step(g1)
        opt.step(g2)
        return best, (l_msiv, batch_mean(loss_mslv.detach(), group), improved, wnorm)

    def run(imgs1, chunk_callback):
        with torch.no_grad():
            const2_fixed, w0 = encode(imgs1)
        if cfg.optimize_e:
            target = None
            opt = lreq_adam(encoder, cfg.lr, beta2=cfg.beta2)
        else:
            target = w0.clone().requires_grad_(True)
            opt = LREQAdam([target], cfg.lr, [1.0], beta2=cfg.beta2)  # tpugan's coefs=None

        @torch.no_grad()
        def current_w():
            return encode(imgs1)[1] if cfg.optimize_e else target.detach().clone()

        def reconstruct(w):
            with torch.no_grad():
                return gather_rows(resynth(w), group)

        cache = precompute_cache(imgs1)
        if chunk_callback is not None:
            chunk_callback(0, gather_rows(w0, group), reconstruct(w0))
        # whole chunks and one remainder: exactly cfg.iterations iterations
        lengths = [cfg.chunk] * (cfg.iterations // cfg.chunk)
        if cfg.iterations % cfg.chunk:
            lengths.append(cfg.iterations % cfg.chunk)
        dtype = torch.promote_types(w0.dtype, torch.float32)
        best = (torch.full((), math.inf, dtype=dtype, device=w0.device), torch.zeros_like(w0),
                torch.full((), -1, dtype=torch.int64, device=w0.device))
        records, history = [], []
        done = 0
        for length in lengths:
            for it in range(done, done + length):
                best, record = one_iteration(target, opt, imgs1, const2_fixed, cache, best, it)
                records.append(record)
            done += length
            history.append(records[-1][:2])
            if chunk_callback is not None:
                w_c = current_w()
                chunk_callback(done, gather_rows(w_c, group), reconstruct(w_c))
        w_final = current_w()
        msiv, _, improved, wnorm = (torch.stack(r) for r in zip(*records))
        return InversionResult(
            w=gather_rows(w_final, group), images=reconstruct(w_final), losses=history,
            w_best=gather_rows(best[1], group), loss_best=best[0], iter_best=best[2],
            msiv_history=msiv, improved_history=improved, wnorm_history=wnorm,
        )

    def invert(imgs1: torch.Tensor, chunk_callback=None) -> InversionResult:
        """Invert one image batch [N, H, W, C] in [-1, 1] (with a mesh, the
        global batch). ``chunk_callback(iteration, w, imgs2)`` fires at
        iteration 0 and after every chunk (the reference's per-100-iteration
        saves, embedding_img.py:142-160) with that iteration's w and its
        reconstruction."""
        base = _encoder_state(encoder)
        try:
            return run(shard_batch(mesh, imgs1, spatial=spatial), chunk_callback)
        finally:
            encoder.load_state_dict(base)

    return invert
