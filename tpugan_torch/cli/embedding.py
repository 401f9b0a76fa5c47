"""Real-image inversion CLI (counterpart of ``tpugan/cli/embedding.py``;
embedding_img.py / embedding_v2_*).

``python -m tpugan_torch.cli.embedding --mtype 2 --img_size 1024
--start_features 16 --random_init --img_dir ./faces [--optimizeE true]
[--beta 0.0002 --norm_p 2] [--bf16]`` inverts each image batch of
``--img_dir`` (batch 1, 1500 iterations, lr 0.01 by default): it fine-tunes
E (``--optimizeE true``) or optimises w from E(img), and saves per-image w
codes (.npy) and reconstructions every 100 iterations, the final w and
reconstruction, the best-loss snapshot with ``loss_min.txt``, and the
stacked ``w_all.npy``/``img_all.npy`` (embedding_img.py:163-170).

``--mtype 3`` inverts into PGGAN's z through E_PG (w is z [N, 512]).
``--mtype 4`` conditions BigGAN and E_BIG on a fixed ``--class_id`` (30 by
default) and a truncated z at 0.4 drawn from the seed ``iterations %
30000`` (embedding_v2_BigGAN.py:36-47). The noise of the encoder and of
StyleGANv1's generator is drawn once (``cli/common.py::draw_inputs``), and every
call reads the same tensors, as tpugan's fixed ``PRNGKey(0)`` gives the
same draws on every call.

``--bf16`` runs tpugan's bf16 scheme (``tpugan_torch/precision.py``): the
frozen generator as a bf16 copy, w cast down and the images cast back up;
in fine-tune-E mode the encoder computes in bf16 from its fp32 parameters
(``bf16_encode_images``), and E_BIG's condition is cast to bf16. On the
card every FIR runs the FIR kernel's bf16 form and every attention call the
attention kernels' bf16 forms, forward and backward.

As in ``tpugan``, only the final minimum's snapshot files are written, a
snapshot is taken when the tracker arms at ``iterations // 2``, and in
optimise-w mode it holds the iteration's initial w1.

``--gradcam`` (embedding_v2_BigGAN.py) replaces the crops with the
Grad-CAM++ masks and CAM overlays of a VGG16 (``cli/common.py::
build_vgg16``, random without ``--vgg_weights``, as in ``tpugan``; fp32
under ``--bf16`` too, as tpugan leaves it): ``imgs + mask + Gcam``, the
attention terms from the detached reconstruction.

The image directory is read through ``io/native.py::load_image_dir_fast``
(tpugan's loader: an all-PNG directory resized bilinearly with aligned
corners by the C++ library, else PIL), so the targets are tpugan's pixels.

Data parallel as ``cli/e_align.py``: under ``torchrun --nproc_per_node N``
(or ``--multihost``) each image batch is split over tpugan's ``auto_mesh``
of ``--batch_size`` and every iteration is the one-process iteration on the
whole batch; rank 0 writes. With ``--space_shards S`` (every mtype, with or
without ``--gradcam``) each rank of a space group of S inverts its rows of
the images (``invert/embedding.py::make_embedder``'s ``spatial``).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from tpugan_torch.cli.common import (
    GanBundle,
    add_common_args,
    build_bundle,
    build_lpips_fn,
    build_vgg16,
    data_parallel,
    draw_inputs,
    family_pipeline,
    make_result_dirs,
    spatial,
)
from tpugan_torch.invert import EmbeddingConfig, make_embedder
from tpugan_torch.parallel.mesh import data_group, gather_rows, replicate, shard_batch, space_group
from tpugan_torch.precision import BF16, bf16_encode_images, bf16_frozen
from tpugan_torch.train.e_align import nchw_to_nhwc, nhwc_to_nchw
from tpugan_torch.utils import one_hot


def str2bool(v) -> bool:
    return str(v).lower() in ("1", "true", "yes")


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="the training args")
    add_common_args(parser, training=True)
    parser.add_argument("--img_dir", default="./checkpoint/realimg_file/")
    parser.add_argument("--optimizeE", type=str2bool, default=True)
    parser.add_argument("--beta", type=float, default=0.0)
    parser.add_argument("--norm_p", type=float, default=2.0)
    parser.add_argument("--gradcam", action="store_true",
                        help="grad-cam mask/overlay attention terms instead of center crops")
    parser.add_argument("--class_id", type=int, default=30,
                        help="BigGAN's fixed class id for the inversion condition "
                             "(embedding_v2_BigGAN.py:36, 30 = frog)")
    parser.add_argument("--bf16", action="store_true",
                        help="bf16 frozen-generator compute (and the encoder's, fine-tuning E); "
                             "LPIPS is in the inversion's gradient, so the trajectory moves")
    parser.add_argument("--fp32_lpips", action="store_true",
                        help="with --bf16 and --lpips_weights: keep the LPIPS backbone fp32")
    parser.set_defaults(iterations=1500, lr=0.01, batch_size=1)
    return parser


class Inverter(NamedTuple):
    bundle: GanBundle
    invert: Callable  # (imgs, chunk_callback=None) -> InversionResult
    encode: Callable  # imgs -> (const, w), as the loop runs it
    resynth: Callable  # w -> imgs, as the loop runs it (differentiable in w)
    generator: Any  # the generator that resynth runs (the bf16 copy with --bf16)
    vgg: Any = None  # the Grad-CAM VGG16 with --gradcam
    mesh: Any = None  # the data-parallel mesh (encode and resynth take this rank's rows)

    def reconstruct(self, w: torch.Tensor) -> torch.Tensor:
        """The images of a global batch of w, without gradient (with a
        mesh, every rank resynthesises its rows and gets the batch)."""
        with torch.no_grad():
            return gather_rows(self.resynth(shard_batch(self.mesh, w)), data_group(self.mesh))


def build_inverter(args, lpips_fn=None, bundle: Optional[GanBundle] = None, vgg=None, mesh=None) -> Inverter:
    """The embedder of ``args`` on ``args.device`` (random weights from
    ``args.seed``), on :func:`draw_inputs`'s draws, with a callback every
    100 iterations (``EmbeddingConfig``'s chunk, tpugan's). ``bundle`` and
    ``vgg`` are seams for tests: the embedder over those models, on their
    device. With ``mesh`` the models are broadcast from its first rank and
    the closures hold this rank's rows of the draws; with ``--space_shards``
    the encoder runs on the rank's rows of the images."""
    bundle = bundle or build_bundle(args)
    if args.gradcam and vgg is None:
        vgg = build_vgg16(args)
    for module in (bundle.encoder, bundle.generator, bundle.mapping, vgg):
        if module is not None:
            replicate(mesh, module)
    draws = shard_batch(mesh, draw_inputs(bundle, args.batch_size, args.iterations))
    gen, enc = bundle.generator, bundle.encoder
    gen.requires_grad_(False)
    if args.bf16:
        gen = bf16_frozen(gen)
    batch = cond = None
    _, resynth_g = family_pipeline(bundle, gen, bundle.mapping, train=True)
    if args.mtype == 4:
        embeddings = bundle.generator.embeddings
        label = shard_batch(mesh, one_hot(torch.full((args.batch_size,), args.class_id, device=bundle.device),
                                          gen.config.num_classes).to(embeddings.weight.dtype))
        batch = argparse.Namespace(label=label)
        with torch.no_grad():
            cond = torch.cat([draws.zt, embeddings(label)], dim=1)
    noise_g = draws.noise_g  # StyleGANv1's; None for the others

    def resynth(w):
        if args.bf16:
            return resynth_g(w.to(BF16), batch, noise_g).float()
        return resynth_g(w, batch, noise_g)

    if args.bf16 and args.optimizeE and cond is not None:
        cond = cond.to(BF16)  # E_BIG's condition follows the compute dtype

    rows = {"space": space_group(mesh)} if spatial(args) else {}
    conditions = () if cond is None else (cond,)

    def encode(imgs):
        const, w = enc(nhwc_to_nchw(imgs), *conditions, draws.noise_e, **rows)
        return (nchw_to_nhwc(const) if const.dim() == 4 else const), w

    if args.bf16 and args.optimizeE:
        encode = bf16_encode_images(encode, enc)
    cfg = embedding_config(args)
    invert = make_embedder(encode, resynth, enc, cfg, lpips_fn=lpips_fn, vgg=vgg, mesh=mesh, spatial=bool(rows))
    return Inverter(bundle, invert, encode, resynth, gen, vgg, mesh)


def embedding_config(args, **overrides) -> EmbeddingConfig:
    """The CLI's ``EmbeddingConfig``; ``overrides`` replace fields (a
    test's callback cadence)."""
    cfg = EmbeddingConfig(iterations=args.iterations, lr=args.lr, optimize_e=args.optimizeE, beta=args.beta,
                          norm_p=args.norm_p, attention="gradcam" if args.gradcam else "crops")
    return dataclasses.replace(cfg, **overrides)


def run(inverter: Inverter, args) -> list:
    """Invert every batch of ``--img_dir`` and write the files (on the
    primary process); returns the :class:`~tpugan_torch.invert.InversionResult`
    of each batch."""
    from tpugan_torch.io.image import from_unit, save_image, save_image_grid, to_unit
    from tpugan_torch.io.native import load_image_dir_fast as load_image_dir
    from tpugan_torch.runtime import is_primary_host

    primary = is_primary_host()
    images = from_unit(load_image_dir(args.img_dir, args.img_size))
    base, imgs_dir, models_dir = make_result_dirs(args.experiment_dir, f"mtype{args.mtype}-embedding")
    device, bs = inverter.bundle.device, args.batch_size
    results, w_all, img_all = [], [], []
    for g in range(len(images) // bs):
        batch = torch.from_numpy(np.ascontiguousarray(images[g * bs:(g + 1) * bs])).to(device)

        def save_cadence(iteration, w_c, imgs2_c, g=g, batch=batch):
            # the per-100-iteration dumps (embedding_img.py:142-160)
            if not primary:
                return
            w_c, imgs2_c = w_c.cpu().numpy(), imgs2_c.cpu().numpy()
            for i in range(bs):
                np.save(os.path.join(models_dir, f"id{g}-i{i}-w{iteration}.npy"), w_c[i])
                np.save(os.path.join(models_dir, f"id{g}-i{i}-img{iteration}.npy"), imgs2_c[i])
            grid = np.concatenate([to_unit(batch), to_unit(imgs2_c)], axis=0)
            save_image_grid(os.path.join(imgs_dir, f"id{g}_ep{iteration}.jpg"), np.clip(grid, 0, 1),
                            nrow=bs)

        result = inverter.invert(batch, chunk_callback=save_cadence)
        results.append(result)
        w, rec = result.w.cpu().numpy(), result.images.cpu().numpy()
        # the best-loss snapshot (embedding_v2_styleGAN1.py:127-135): its w
        # and grid, and one loss_min.txt line per new minimum after arming
        it_b, lb = int(result.iter_best), float(result.loss_best)
        snapshot = it_b >= 0 and np.isfinite(lb)
        imgs_best = inverter.reconstruct(result.w_best) if snapshot else None
        w_all.append(w[0])
        img_all.append(rec[0])
        if not primary:
            continue
        for i in range(bs):
            np.save(os.path.join(models_dir, f"id{g}-i{i}-w.npy"), w[i])
            save_image(os.path.join(imgs_dir, f"{str(g).rjust(5, '0')}_rec.png"),
                       np.clip(to_unit(rec[i]), 0, 1))
        if snapshot:
            w_best = result.w_best.cpu().numpy()
            wn = float(np.linalg.norm(w_best))
            np.save(os.path.join(models_dir, f"id{g}-iter{it_b}-norm{wn:.6f}-imgLoss-min{lb:.6f}.npy"),
                    w_best)
            grid = np.concatenate([to_unit(batch), to_unit(imgs_best)], axis=0)
            save_image_grid(os.path.join(imgs_dir, f"id{g}_ep{it_b}-norm{wn:.2f}-imgLoss-min{lb:.6f}.jpg"),
                            np.clip(grid, 0, 1), nrow=bs)
            msiv = result.msiv_history.cpu().numpy()
            wnorms = result.wnorm_history.cpu().numpy()
            with open(os.path.join(base, "loss_min.txt"), "a") as f:
                for it_i in np.nonzero(result.improved_history.cpu().numpy())[0]:
                    f.write(f"ep{g}_iter{int(it_i)}_minImg{float(msiv[it_i]):.5f}"
                            f"_wNorm{float(wnorms[it_i]):f}\n")
        print(f"image group {g}: final losses {tuple(float(x) for x in result.losses[-1])}", flush=True)
    if primary:
        np.save(os.path.join(models_dir, "w_all.npy"), np.stack(w_all))
        np.save(os.path.join(models_dir, "img_all.npy"), np.stack(img_all))
    return results


def main(argv=None):
    args = make_parser().parse_args(argv)
    mesh, takes_part = data_parallel(args)
    if not takes_part:
        return None
    return run(build_inverter(args, build_lpips_fn(args), mesh=mesh), args)


if __name__ == "__main__":
    main()
