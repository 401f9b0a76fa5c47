"""Aligned encoder training (counterpart of ``tpugan/cli/e_align.py``;
E_align_cropping_s1.py / E_align_s2.py).

``python -m tpugan_torch.cli.e_align --mtype 2 --img_size 1024
--start_features 16 --random_init --case {1,2} [--ablation n]`` (tpugan's
default command) trains the encoder (E in case 1, E_Blur in case 2) against
a frozen StyleGAN2-1024, config F, on its noise buffers; ``--mtype 1
--img_size 256 --start_features 64`` trains StyleGANv1 Cat256's encoder (E
in case 1, E_Blur in case 2, the ladder's encoder with ``--ablation``), and
``--mtype 4 --img_size 256 --start_features 64 --z_dim 128`` trains E_BIG
against a frozen BigGAN-deep-256, and ``--mtype 3 --img_size 1024
--start_features 16`` E_PG against a frozen PGGAN-1024 (z in, z out; its
zero const1 broadcast to E_PG's features for the const loss, as tpugan's).
Case 1 logs its image losses without
gradient and, unless ``--eager_metrics``, skips them on off-tick iterations
(the lean step); case 2 trains through them. ``--ablation n``
(ablation_utils/1..8) forces case 2 and sets the loss weights; ablation 1
(StyleGANv1 only) encodes z and re-maps it to w+ through the frozen
mapping, and ablations 7 and 8 take one update per loss group. On mtypes 2,
3 and 4 the ladder's weights apply to the usual encoder, as in ``tpugan``.
Every ``--log_every`` iterations a JSON record goes to stdout and
``Loss.txt``, and a grid of imgs1 over imgs2 to ``imgs/``.

``--bf16`` (every mtype) runs tpugan's bf16 scheme
(``tpugan_torch/precision.py``): a bf16 copy of the frozen generator (and
mapping), the encoder computing in bf16 from its fp32 parameters (E_BIG's
spectral-norm pair advanced on the fp32 weights), fp32 losses, gradients
and optimizer state; on the card every FIR is the FIR kernel's bf16 form,
forward and adjoint, and BigGAN's attention the attention kernels' bf16
forms, forward and backward.

``--remat`` and ``--remat_policy conv_outs`` (either, with or without
``--bf16``) recompute the activations of encode and resynth in the backward
(:func:`~tpugan_torch.train.e_align.rematerialised`), with the same update.

:func:`build_trainer` makes the state and the step functions; ``main``
loops and writes. Every ``--checkpoint_every`` iterations (past iteration
0) it saves the train state to ``models/step_<N>``; ``--resume`` continues
from the newest one at the iteration after it, and the run is bitwise the
unbroken one (the draws are a function of the iteration).

Data parallel: ``torchrun --nproc_per_node N -m tpugan_torch.cli.e_align
...`` (or ``--multihost`` under any launcher that sets torchrun's
environment) runs one process per GPU over tpugan's ``auto_mesh`` of the
batch (``cli/common.py::data_parallel``): each rank takes its rows of the
iteration's draws and every step is the one-process step on the global
batch (``train/e_align.py::make_train_step``). Rank 0 alone writes the log,
the grids and the checkpoints; the others wait for each save. With
``--space_shards S`` (every mtype) the mesh has tpugan's ``space`` axis:
each rank of a space group of S holds its rows of the images, on the
encoder side and in the losses, and the step is still the one-process step
(``torchrun --nproc_per_node 2 -m tpugan_torch.cli.e_align --mtype 2
--space_shards 2 --device cpu ...``).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Callable, NamedTuple, Optional

import numpy as np

from tpugan_torch.cli import infer_e
from tpugan_torch.cli.common import (
    GanBundle,
    add_common_args,
    build_bundle,
    build_lpips_fn,
    data_parallel,
    family_pipeline,
    loss_log_of,
    make_result_dirs,
    spatial,
)
from tpugan_torch.io.checkpoint import latest_step, load_checkpoint, save_checkpoint
from tpugan_torch.optim import lreq_adam
from tpugan_torch.parallel.mesh import barrier, replicate, space_group
from tpugan_torch.precision import bf16_encode, bf16_frozen, bf16_pipeline
from tpugan_torch.train.e_align import (
    EncoderTrainState,
    info_scalars,
    init_train_state,
    make_align_visuals,
    make_encode_fn,
    make_train_step,
)


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="the training args")
    add_common_args(parser, training=True)
    parser.add_argument("--case", type=int, default=1, choices=(1, 2))
    parser.add_argument("--remat", action="store_true",
                        help="rematerialise the activations of encode and resynth in the backward")
    parser.add_argument("--remat_policy", default=None, choices=("conv_outs",),
                        help="selective remat: save the convolutions' outputs, recompute the rest "
                             "in the backward")
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 compute for the generator and the encoder's forward and "
                             "backward (fp32 master weights, fp32 norm moments, fp32 losses)")
    parser.add_argument("--log_every", type=int, default=100)
    parser.add_argument("--checkpoint_every", type=int, default=5000)
    parser.add_argument("--resume", action="store_true",
                        help="resume from the latest step_<N> checkpoint in this experiment's models "
                             "dir (encoder, spectral-norm buffers, optimizer state, step); the "
                             "continued run is bitwise the unbroken one")
    parser.add_argument("--eager_metrics", action="store_true",
                        help="compute the log-only image losses on every iteration; by default "
                             "(case 1) off-tick steps skip them, with the same trajectory")
    return parser


class Trainer(NamedTuple):
    bundle: GanBundle
    state: EncoderTrainState
    step: Callable  # the full step
    lean: Optional[Callable]  # case 1's off-tick step, or None
    visuals: Callable


# the ablation ladder's loss weights, as the scripts execute them
# (tpugan/cli/e_align.py:68-101): ablations 7 and 8 weight AT1 by 5 and
# AT2 by 9 and take one update per loss group (7.E_align_x_AT1.py:83-86,
# 8.E_align_x_AT1_AT2.py:83-101)
ABLATION_IMAGE_WEIGHTS = {
    1: (1.0, 0.0, 0.0), 2: (1.0, 0.0, 0.0), 3: (1.0, 0.0, 0.0), 4: (1.0, 0.0, 0.0),
    5: (1.0, 0.0, 0.0), 6: (1.0, 0.0, 0.0), 7: (1.0, 5.0, 0.0), 8: (1.0, 5.0, 9.0),
}
ABLATION_LATENT_WEIGHTS = {
    1: (0.0, 1.0), 2: (1.0, 0.0), 3: (1.0, 0.0), 4: (1.0, 0.0),
    5: (1.0, 1.0), 6: (1.0, 1.0), 7: (1.0, 1.0), 8: (1.0, 1.0),
}
SEQUENTIAL_ABLATIONS = (7, 8)


class Pipeline(NamedTuple):
    """A trainer's models and train-mode closures: ``encode(batch, noise)``,
    ``synth(request)``, ``resynth(w2, batch, noise)`` and ``draw(iteration)
    -> Request``."""

    bundle: GanBundle
    encode: Callable
    synth: Callable
    resynth: Callable
    draw: Callable


def build_pipeline(args, draw=None, mesh=None) -> Pipeline:
    """The frozen generator (a bf16 copy with ``--bf16``), the encoder and
    the train-mode closures for ``args``, on ``args.device``, from random
    weights seeded by ``args.seed``. ``draw(iteration) -> Request`` replaces
    the iteration's seeded draws (a replay of given inputs). With ``mesh``
    the models are broadcast from its first rank, and with ``--space_shards``
    the encoder runs on the rank's rows of the images."""
    ab = args.ablation
    if ab == 1 and args.mtype != 1:
        raise ValueError("ablation 1 (z re-mapping) is StyleGANv1-only")
    bundle = build_bundle(args)
    for module in (bundle.encoder, bundle.generator, bundle.mapping):
        if module is not None:
            replicate(mesh, module)
    bundle.generator.requires_grad_(False)
    if args.bf16:
        # the fp32 mapping stays with bundle.remap (ablation 1), as tpugan's
        # remap reads the fp32 tree
        mapping = None if bundle.mapping is None else bf16_frozen(bundle.mapping)
        bundle = bundle._replace(generator=bf16_frozen(bundle.generator), mapping=mapping)
    synth_fn, resynth = family_pipeline(bundle, bundle.generator, bundle.mapping, train=True)
    encode = make_encode_fn(bundle.encoder, conditional=args.mtype == 4, train=True,
                            space=space_group(mesh) if spatial(args) else None)
    if ab == 1:
        # E_Blur_Z: const1 is z and the encoder's z2 is re-mapped to w+
        # (1.E_align_z.py:62-67)
        synth_g, encode_z = synth_fn, encode

        def synth_fn(z, noise=None):
            return synth_g(z, noise)._replace(const1=z)

        def encode(batch, noise=None):
            _, z2 = encode_z(batch, noise)
            return z2, bundle.remap(z2)
    if args.bf16:
        synth_fn, resynth = bf16_pipeline(synth_fn, resynth)
        encode = bf16_encode(encode, bundle.encoder)

    def synth(request):
        if args.mtype == 4:
            return synth_fn(request.z, request.label)
        if args.mtype in (2, 3):
            return synth_fn(request.z)
        return synth_fn(request.z, request.noise_g)

    if draw is None:
        def draw(iteration):
            return infer_e.draw_request(bundle, args.batch_size, iteration)

    return Pipeline(bundle, encode, synth, resynth, draw)


def build_trainer(args, lpips_fn=None, draw=None, mesh=None) -> Trainer:
    """The encoder's train state and step functions for ``args``, on
    ``args.device``, from random weights seeded by ``args.seed``. ``draw(
    iteration) -> Request`` replaces the iteration's seeded draws (a replay
    of given inputs); with ``mesh`` (:func:`~tpugan_torch.cli.common.
    data_parallel`) the steps and the grid take this rank's rows of them.
    With ``--bf16`` the trainer's bundle holds the bf16 copies of the
    generator and mapping that the step runs."""
    bundle, encode, synth, resynth, draw = build_pipeline(args, draw, mesh)
    ab = args.ablation
    case = 2 if ab else args.case  # every ablation script trains through its image losses
    weights = {}
    if ab:
        weights = dict(image_weights=ABLATION_IMAGE_WEIGHTS[ab],
                       latent_weights=ABLATION_LATENT_WEIGHTS[ab],
                       sequential_image_steps=ab in SEQUENTIAL_ABLATIONS)
    sharded = spatial(args)
    remat = dict(remat=args.remat, remat_policy=args.remat_policy, mesh=mesh, spatial=sharded)
    state = init_train_state(bundle.encoder, lreq_adam(bundle.encoder, args.lr))
    step = make_train_step(encode, synth, resynth, draw, case=case, lpips_fn=lpips_fn, **weights, **remat)
    lean = None
    if case == 1 and not args.eager_metrics:
        lean = make_train_step(encode, synth, resynth, draw, case=1, compute_image_losses=False, **remat)
    return Trainer(bundle, state, step, lean, make_align_visuals(encode, synth, resynth, draw, mesh, sharded))


def resume(state: EncoderTrainState, models_dir: str, wanted: bool) -> int:
    """With ``--resume``, load the newest ``step_<N>`` under ``models_dir``
    into ``state`` and return N + 1, the iteration to go on from; else, or
    when there is none, 0 (``tpugan/cli/e_align.py:176-183``)."""
    if not wanted:
        return 0
    last = latest_step(models_dir)
    if last is None:
        print(f"--resume: no step_<N> checkpoint under {models_dir}, starting fresh")
        return 0
    _, last = load_checkpoint(models_dir, state, last)
    print(f"resumed from {models_dir}/step_{last} (next iteration {last + 1})")
    return last + 1


def main(argv=None):
    args = make_parser().parse_args(argv)
    mesh, takes_part = data_parallel(args)
    if not takes_part:
        return None
    from tpugan_torch.io.image import save_image_grid, to_unit

    trainer = build_trainer(args, build_lpips_fn(args), mesh=mesh)
    name = f"mtype{args.mtype}-{args.img_size}-case{args.case}" + (
        f"-ab{args.ablation}" if args.ablation else "")
    base, imgs_dir, models_dir = make_result_dirs(args.experiment_dir, name)
    state = trainer.state
    start = resume(state, models_dir, args.resume)
    with loss_log_of(base) as loss_log:
        for iteration in range(start, args.iterations):
            on_tick = iteration % args.log_every == 0
            step_fn = trainer.step if (on_tick or trainer.lean is None) else trainer.lean
            vis = trainer.visuals(state, iteration) if on_tick else None
            state, info = step_fn(state, iteration)
            if on_tick and loss_log is not None:
                rec = {"iteration": iteration, "epoch": iteration // 30000, **info_scalars(info)}
                print(json.dumps(rec), flush=True)
                loss_log.write(json.dumps(rec) + "\n")
                loss_log.flush()
                grid = np.concatenate([to_unit(vis["imgs1"]), to_unit(vis["imgs2"])], axis=0)
                save_image_grid(
                    os.path.join(imgs_dir, f"ep{iteration // 30000}_iter{iteration % 30000}.jpg"),
                    np.clip(grid, 0, 1), nrow=args.batch_size,
                )
            if iteration % args.checkpoint_every == 0 and iteration > 0:
                if loss_log is not None:  # the primary process
                    save_checkpoint(models_dir, state, iteration)
                barrier(mesh)
    return state


if __name__ == "__main__":
    main()
