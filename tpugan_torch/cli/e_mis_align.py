"""Mis-aligned (Grad-CAM) encoder training (counterpart of
``tpugan/cli/e_mis_align.py``; E_mis_align_cropping_s1.py).

``python -m tpugan_torch.cli.e_mis_align --mtype 1 --img_size 256
--start_features 64 --random_init`` trains StyleGANv1 Cat256's plain E at
batch 5 (the reference's default: the common default of 2 becomes 5) with
Grad-CAM++ attention from a VGG16, random without ``--vgg_weights``, as in
``tpugan``. The update is ``0.01 * loss_w``; the attention losses (the
images, the CAM++ masks, the CAM overlays) and the guided-backpropagation
distance are logged only, and unless ``--eager_metrics`` off-tick
iterations skip them (the lean step), with the same trajectory. Every
``--log_every`` iterations a JSON record of every ``MisAlignInfo`` scalar
goes to stdout and ``Loss.txt``, the grid of imgs1 over imgs2 to
``imgs/ep*_iter*.png`` and the heatmaps, CAM overlays and guided
gradients of imgs1 and imgs2, from the iteration's initial parameters, to
``grad_cam/{heatmap,cam,gb}_<iteration>.png``.

``--bf16`` runs tpugan's bf16 scheme for the generator and encoder
(``tpugan_torch/precision.py``) and the VGG16 stack in bf16 (its
parameters cast, the images cast down at its boundary; the masks and
gradients come back fp32). The attention stack is log-only, so the
trajectory is the fp32 one's, bit for bit.

``--vgg_weights`` and ``--lpips_weights`` load converted torchvision and
LPIPS weights (``tpugan_torch/io/convert.py``). Every ``--checkpoint_every``
iterations (past iteration 0) the train state is saved to
``models/step_<N>``, and ``--resume`` continues from the newest one, bitwise
the unbroken run, as in ``tpugan/cli/e_mis_align.py:146-153``, ``:219-220``.

Data parallel as ``cli/e_align.py``: under ``torchrun --nproc_per_node N``
(or ``--multihost``) each rank trains on its rows of tpugan's ``auto_mesh``
of the batch, the masks and overlays those of the global batch; rank 0
writes.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from tpugan_torch.cli.common import (
    GanBundle,
    add_common_args,
    build_lpips_fn,
    build_vgg16,
    data_parallel,
    loss_log_of,
    make_result_dirs,
)
from tpugan_torch.cli.e_align import Pipeline, build_pipeline, resume
from tpugan_torch.io.checkpoint import save_checkpoint
from tpugan_torch.optim import lreq_adam
from tpugan_torch.parallel.mesh import SPACE_AXIS_PART2, barrier, replicate
from tpugan_torch.precision import BF16
from tpugan_torch.train.e_align import EncoderTrainState, info_scalars, init_train_state
from tpugan_torch.train.e_mis_align import make_mis_align_step, make_mis_align_visuals


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="the training args")
    add_common_args(parser, training=True)
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 compute for the generator, the encoder and the CAM++/GBP VGG16 "
                             "stack (the attention losses are log-only: the trajectory is fp32's)")
    parser.add_argument("--log_every", type=int, default=100)
    parser.add_argument("--checkpoint_every", type=int, default=5000)
    parser.add_argument("--resume", action="store_true",
                        help="resume from the latest step_<N> checkpoint in this experiment's models "
                             "dir; the continued run is bitwise the unbroken one")
    parser.add_argument("--eager_metrics", action="store_true",
                        help="compute the log-only attention and image losses on every iteration; by "
                             "default off-tick steps skip them, with the same trajectory")
    return parser


def parse_args(argv=None):
    args = make_parser().parse_args(argv)
    # the reference's default batch for the mis-align script is 5 (:307-310)
    if args.batch_size == 2:
        args.batch_size = 5
    return args


class Trainer(NamedTuple):
    bundle: GanBundle
    pipeline: Pipeline  # the closures the steps run
    state: EncoderTrainState
    step: Callable  # the full step
    lean: Optional[Callable]  # the off-tick step, or None with --eager_metrics
    visuals: Callable
    vgg: torch.nn.Module  # the VGG16 the attention runs (bf16 with --bf16)


def build_trainer(args, lpips_fn=None, draw=None, vgg=None, mesh=None) -> Trainer:
    """The encoder's train state and step functions for ``args`` (as
    :func:`parse_args` gives them), on ``args.device``, from random weights
    seeded by ``args.seed``; ``vgg`` replaces :func:`build_vgg16`'s and
    ``draw(iteration) -> Request`` the iteration's seeded draws; with
    ``mesh`` the steps and dumps take this rank's rows of them. PGGAN
    (mtype 3) raises: its const1 [N, 1] meets E_PG's features unbroadcast
    in the const loss, and tpugan's step fails the same way."""
    if args.mtype == 3:
        raise TypeError("e_mis_align's const loss takes PGGAN's const1 [N, 1] against E_PG's features "
                        "without a broadcast (tpugan's mis-align step fails the same way); use e_align --mtype 3")
    pipeline = build_pipeline(args, draw, mesh)
    bundle, encode, synth, resynth, draw = pipeline
    vgg = replicate(mesh, build_vgg16(args) if vgg is None else vgg)
    if args.bf16:
        vgg = vgg.to(BF16)  # the VGG16's parameters cast, as tpugan's cast_floating(vgg_vars)
    state = init_train_state(bundle.encoder, lreq_adam(bundle.encoder, args.lr))
    step = make_mis_align_step(encode, synth, resynth, draw, vgg, lpips_fn=lpips_fn, cam_bf16=args.bf16,
                               mesh=mesh)
    lean = None
    if not args.eager_metrics:
        lean = make_mis_align_step(encode, synth, resynth, draw, vgg, cam_bf16=args.bf16,
                                   compute_attention_losses=False, mesh=mesh)
    visuals = make_mis_align_visuals(encode, synth, resynth, draw, vgg, mesh)
    return Trainer(bundle, pipeline, state, step, lean, visuals, vgg)


def save_visuals(vis: dict, base: str, imgs_dir: str, iteration: int, nrow: int) -> None:
    """The on-tick dumps (E_mis_align_cropping_s1.py:276-288)."""
    from tpugan_torch.io.image import save_image_grid, to_unit

    host = {key: value.detach().float().cpu().numpy() for key, value in vis.items()}
    grid = np.concatenate([to_unit(host["imgs1"]), to_unit(host["imgs2"])], axis=0)
    save_image_grid(os.path.join(imgs_dir, f"ep{iteration // 30000}_iter{iteration % 30000}.png"),
                    np.clip(grid, 0, 1), nrow=nrow)
    cam_dir = os.path.join(base, "grad_cam")
    os.makedirs(cam_dir, exist_ok=True)
    for key in ("heatmap", "cam"):
        save_image_grid(os.path.join(cam_dir, f"{key}_{iteration}.png"), np.clip(host[key], 0, 1), nrow=nrow)
    # the reference's host-side normalisation of the gradients (:282-284):
    # ``grads -= np.max(np.min(grads), 0)`` subtracts the true minimum (the
    # 0 is numpy's axis), then grads /= max
    gb = host["gb"] - float(host["gb"].min())
    denom = float(gb.max())
    if denom != 0.0:
        gb = gb / denom
    save_image_grid(os.path.join(cam_dir, f"gb_{iteration}.png"), np.clip(gb, 0, 1), nrow=nrow)


def run(trainer: Trainer, args, mesh=None) -> EncoderTrainState:
    """Train for ``--iterations`` and write the records and dumps (on the
    primary process; with ``mesh`` the others wait for each checkpoint);
    returns the final state."""
    base, imgs_dir, models_dir = make_result_dirs(args.experiment_dir,
                                                  f"mtype{args.mtype}-{args.img_size}-misalign")
    state = trainer.state
    start = resume(state, models_dir, args.resume)
    with loss_log_of(base) as loss_log:
        for iteration in range(start, args.iterations):
            on_tick = iteration % args.log_every == 0
            step_fn = trainer.step if (on_tick or trainer.lean is None) else trainer.lean
            # the dumps use the iteration's initial parameters, as the
            # reference saves tensors computed before its update
            vis = trainer.visuals(state, iteration) if on_tick else None
            state, info = step_fn(state, iteration)
            if on_tick and loss_log is not None:
                rec = {"iteration": iteration, "epoch": iteration // 30000, **info_scalars(info)}
                print(json.dumps(rec), flush=True)
                loss_log.write(json.dumps(rec) + "\n")
                loss_log.flush()
                save_visuals(vis, base, imgs_dir, iteration, args.batch_size)
            if iteration % args.checkpoint_every == 0 and iteration > 0:
                if loss_log is not None:  # the primary process
                    save_checkpoint(models_dir, state, iteration)
                barrier(mesh)
    return state


def main(argv=None):
    args = parse_args(argv)
    if args.space_shards != 1:
        raise NotImplementedError(SPACE_AXIS_PART2)  # Grad-CAM over row shards
    mesh, takes_part = data_parallel(args)
    if not takes_part:
        return None
    return run(build_trainer(args, build_lpips_fn(args), mesh=mesh), args, mesh)


if __name__ == "__main__":
    main()
