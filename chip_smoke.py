#!/usr/bin/env python3
"""Drive tpugan_torch's serving, training and eval paths on one NVIDIA GPU and check its kernels.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
card and ``nvcc``: it builds ``tpugan_torch/csrc`` from the checkout. Any
failure ends the run with a non-zero exit code and no result line, as does
a machine without a GPU or a directory without the repository.

Phases:
  1. the card (name and power limit, from nvidia-smi) and the kernel build;
  2. each kernel against its plain PyTorch version on the card, at the main
     paths' shapes and at the TPU kernels' contract cases (TF32 off), the
     FIR kernel also at its tiles' edge cases and slice 3's FIRs, its
     adjoint (upfirdn2d's gradient) against autograd of the plain version,
     the attention forward and backward at every template instance (both
     against the plain version run in float64; the forward's three runs
     bitwise equal), and
     out-of-contract calls (and FIR launch plans) refused; then B3's and
     B4's times at the BigGAN-256 paths' shape, before any path is
     profiled;
  3. the StyleGANv1 Cat256 path: the bundle (random weights from a seed,
     batch 2) answers requests through ``tpugan_torch.cli.infer_e.run``
     while the kernels' launches are counted; one request is replayed on
     the CPU, where the plain versions run, and compared; a gradient through
     G -> E_Blur -> G with its FIR launches, forward and adjoint, counted,
     held to the CPU in float64;
  4. its times: request latency, the device time of a request by kernel,
     and the FIR kernel's device time at each blur shape beside its plain
     version, one library call for the same function and the least time
     the card could take (its bound), the two largest also with L2
     flushed, summed for B1 and B2; slice 3's FIRs timed for the record;
  5. the BigGAN-deep-256 + E_BIG path (mtype 4) the same way: the attention
     kernel on the path's own q/k/v, requests with launch counts, a request
     replayed on the CPU with every SelfAttn gamma set non-zero, latency
     and device time by kernel;
  6. the E_BIG train step of ``tpugan_torch.cli.e_align`` (mtype 4, full
     width, batch 2): one case-2 step on the CLI's own weights, then case 2
     with every gamma at 1 and E_BIG's z head scaled, with launch counts,
     the attention backward kernels on the step's own inputs (against the
     plain version in float64, and twice, bitwise equal), case 1 and its
     lean step as ``tpugan``'s scripts/bench_biggan256.py measures them, a
     case-2 step replayed on the CPU at a reduced width, step times, device
     time by kernel and peak memory;
  7. the StyleGAN2-1024 path (mtype 2, ``tpugan``'s default request, full
     width, batch 2): requests with the FIR launches counted in total and
     by the TPU kernel each replaces, against counts derived from the
     generator; the FIR kernel on the path's own inputs against its plain
     version and a library call, each distinct FIR shape timed warm and
     with L2 flushed beside its bound; a request replayed on the CPU;
     latency, device time by kernel and peak memory;
  8. the StyleGANv1 Cat256 train step of ``tpugan_torch.cli.e_align``
     (mtype 1, full width, batch 2): case 1 and its lean step, case 2 with
     E_Blur, ablations 8 (one update per loss group) and 1 (E_Blur_Z, z
     re-mapped), with the FIR launches of each step counted forward and
     adjoint, in total and by the TPU kernel each replaces, against counts
     derived from the modules; a case-2 step of a reduced width replayed on
     the CPU and held to a float64 run there; step times, device time by
     kernel and peak memory;
  9. the StyleGAN2-1024 train step of ``tpugan_torch.cli.e_align``
     (mtype 2, full width, batch 2): case 1 and its lean step, case 2 with
     E_Blur and ablation 8 (the plain E), with the FIR launches of each step
     counted forward and adjoint by TPU kernel against counts derived from
     the modules, the encoder moving and the generator frozen; every FIR of
     a case-2 step on the step's own inputs against the plain version and
     timed, forward and adjoint; a case-2 step at 256 px replayed on the CPU
     and held to a float64 run there; step times, device time by kernel and
     peak memory;
 10. bf16, ``e_align --bf16`` (tpugan's bf16 scheme): the FIR kernel's bf16
     form at phase 2's cases, forward and adjoint, within one bf16 ulp of
     its plain version and bitwise the fp32 kernel rounded to bf16; the
     StyleGAN2-1024 train step (case 2, case 1, lean, ablation 8) and SGv1
     Cat256's (case 2, ablation 8) in bf16 with the FIR launches of each
     step, forward and adjoint by TPU kernel, all on the bf16 form, against
     the counts derived from the modules; the encoder moving on fp32 master
     parameters, the bf16 generator frozen; every FIR of each case-2 step on
     its own inputs held to the plain version and the fp32 kernel and timed
     beside them, a bf16 library call and the bound; step times, device time
     by kernel (bf16 convolutions, the FIR) and peak memory beside the fp32
     steps of phases 8 and 9; ten case-2 steps at tpugan's bf16 gate
     configuration and full-width request images held to a CPU replay, the
     first full-width step to tpugan's 3%, tpugan's other bf16 gates
     printed;
 11. bf16 on the BigGAN-deep-256 path, ``e_align --mtype 4 --bf16``: the
     attention kernels' bf16 forms (B3 at phase 2's cases and at widths and
     bases that take each of its loads, B4 at phase 2's backward cases)
     bitwise the fp32 kernels on the widened inputs rounded to bf16, within
     one bf16 ulp plus the fp32 tolerance of the plain version in float64,
     two runs bitwise equal, mixed dtypes refused; both timed at the path's
     shape beside the fp32 kernel, the plain version, SDPA on fp32 and on
     bf16, and their bounds (timed with phase 2's, before any path is
     profiled); E_BIG case 2 (every gamma of the bf16
     generator at 1, the z head scaled), case 1 and its lean step at full
     width with the launches of each step against the modules' (no fp32
     attention, no plain version on a CUDA tensor), the kernels on a step's
     own inputs, the encoder moving on fp32 masters, the bf16 generator
     frozen; step times, device time by kernel and peak memory beside phase
     6's fp32 steps; a bf16 case-2 step at phase 6's reduced width held to
     its CPU replay by twice the CPU's bf16 distance from fp32;
 12. real-image inversion, ``tpugan_torch.cli.embedding`` at batch 1 (its
     default), each form on a target PNG that the script writes (the
     bundle's own image at a held-out seed) and reads back through
     ``io/image.load_image_dir``, 4 iterations in chunks of 2, random LPIPS:
     StyleGAN2-1024 fine-tuning E, optimising w, and fine-tuning E in bf16
     (every FIR on the bf16 form, none on the fp32 one; fp32 encoder
     masters, the bf16 generator frozen), BigGAN-deep-256 fine-tuning E_BIG
     (at E_BIG's training lr 0.0015: at 0.01 a random E_BIG's first update
     sends BigGAN to NaN, on the CPU in float64 too; gamma 1, the z head
     scaled, as phase 6) and SGv1 Cat256 fine-tuning E; each run's
     launches, forward and adjoint by TPU kernel, and each timed
     iteration's, against the counts derived from the modules, its files,
     w moving, the encoder restored and the generator frozen; every FIR of
     one iteration (fp32 and bf16), and B3 and B4, held to the plain
     version on the iteration's own inputs at batch 1; the iteration's
     host-clock time, its device time by kernel, the busy share and the
     peak memory; the inversion replayed at tpugan's bf16 gate
     configuration on the card and the CPU, held to float64 by twice the
     CPU's distance (a card run in TF32 the control that fails it; bf16 by
     twice the CPU's distance from fp32), with baseline_i2s's Adam;
     ``rec_real_img``, ``edit`` and ``baseline_i2s`` at StyleGAN2-1024, one
     call each with its files and launches, the first two replayed at 32 px
     on the CPU. Its budget is about 90 s.
 13. Grad-CAM: ``tpugan_torch.cli.e_mis_align`` at tpugan's mis-align
     configuration (SGv1 Cat256, the plain E, batch 5, a random 1000-class
     VGG16): the CLI's loop (a full step on the log tick with its Loss.txt
     and dumps, then a lean step), three full steps bitwise full, lean, lean,
     a cam_bf16-only step bitwise the fp32 step, and the --bf16 trainer's
     full and lean steps (every FIR on the bf16 form), each step's FIR
     launches by TPU kernel against the counts derived from the modules (no
     adjoint: the attention stack runs on detached images), the encoder
     moving, the generator, mapping and VGG16 frozen; every FIR of a full
     step on its own batch-5 inputs against the plain version; step times,
     device time by kernel, the four VGG16 passes' share, busy share and
     peak memory, full and lean; a full step at a reduced width replayed on
     the CPU and held to float64 (its CAM++ masks at the float64 run's
     majority class); ``infer_e --gradcam``, one request with its CAM dump
     and launches, its mask replayed on the CPU; ``embedding --gradcam`` on
     BigGAN-deep-256 as phase 12's BigGAN form, its B3 and B4 launches per
     iteration and on the iteration's own inputs. Its budget is about 90 s.
 14. slice 7a, tpugan's commands at their defaults: ``--resume`` through
     the training CLIs' own ``main`` (4 unbroken iterations against 3, a
     save and ``--resume`` to 4, bitwise with cuDNN deterministic) for
     ``e_align --mtype 2 --case 2`` at StyleGAN2-1024, ``e_align --mtype 4
     --case 2`` at BigGAN-deep-256 (B3/B4) and ``e_mis_align`` at batch 5,
     the resumed step's launches against the counts derived from the
     modules; the SG2-1024 case-2 step plain, with ``--remat`` and with
     ``--remat_policy conv_outs``, fp32 and bf16: the FIR launches forward
     and adjoint with the recompute, the update bitwise the plain step's,
     step time, device time and peak memory; converted weights
     (reference-named state dicts at full width from the seed, written with
     ``torch.save``): ``infer_e --mtype 2`` and ``--mtype 4`` requests held
     to CPU loads of the same files, one ``e_align --lpips_weights`` step
     and one ``e_mis_align --vgg_weights --lpips_weights`` step with their
     launches and the converted LPIPS and VGG16 held to their CPU loads.
 15. slice 7b, eval and PGGAN: ``synthesize`` through its own ``main``, one
     seed each, on StyleGAN2-1024, BigGAN-deep-256 (E_BIG's z head scaled
     and gamma set, as phase 5) and PGGAN-1024, in the default form (bf16
     generators on the card) and with ``--fp32``: the files, and the
     launches by TPU kernel against the counts derived from the modules
     (StyleGAN2 32 FIRs a seed, BigGAN 2 attention calls, on the bf16 forms
     by default and the fp32 ones with --fp32; PGGAN none); each fp32 seed
     held to its CPU replay, each bf16 seed to the fp32 one within twice
     the CPU's bf16 distance; per-seed times; ``compare`` through its own
     ``main`` over one grid's imgs1 against its imgs2, on the card against
     the CPU, with and without ``--lpips_weights``; PGGAN-1024 with E_PG
     (``--mtype 3``): ``infer_e`` requests (no kernel of this repo runs),
     one replayed on the CPU, latency, device time and peak memory (timed
     with PyTorch's defaults, TF32 convolutions: with TF32 off cuDNN runs
     one of PGGAN's shapes as an FFT of 0.3 s, timed as synthesize's fp32
     seed); ``e_align`` case 1, its lean step and case 2 with step times and
     device time (PyTorch's defaults), a case-2 step at 256 px held to
     float64 with TF32 off, on the card with cuDNN off (PyTorch's own
     convolutions), the run with cuDNN's deterministic algorithms measured
     beside it and not held; ``embedding`` for 2 iterations with its files; an
     ``infer_e`` request on converted reference-named files held to their
     CPU load.
 16. slice 7c, StyleGANv1 adversarial training (``tpugan_torch.train.gan``)
     at SGv1 Cat256's full width, lod 6, batch 16, random weights from the
     seed: three D + G step pairs (D with the R1 penalty) each followed by
     ``ema_params`` onto a smoothed G, and one pair at a fade-in blend of
     ``LODSchedule`` (decode2), every step's FIR launches counted forward,
     adjoint and second order (R1's adjoint of the adjoint) by TPU kernel
     against the counts derived from the modules; every FIR of a D step and
     of a G step on its own inputs against the plain version; step times,
     device time by kernel, the FIR's share, the forward convolutions'
     FLOPs and peak memory; decode3 at lod 6 and Mapping2 (both ways),
     Mapping3 and Mapping4 against the CPU; a D step and a G step at 256 px,
     batch 4, replayed on the CPU and held to float64 (GAN_REPLAY_SIZE's
     comment).
 17. slice 7d, ``tpugan_torch.cli.export_model``'s own ``main`` with
     ``--check`` at full width (random weights from the seed, batch 2):
     SGv1 Cat256 synthesis, its E_Blur encode (``--ablation 8``),
     StyleGAN2-1024 synthesis fp32 and ``--bf16``, BigGAN-deep-256
     synthesis fp32 and ``--bf16`` (gamma set as phase 5), PGGAN-1024
     synthesis and E_BIG encode (``torch.export`` artifacts in which every
     kernel is a ``torch.ops.tpugan_torch`` node): exporting launches
     nothing, the graph's operator nodes and a call's launches (on the
     form of its dtype, FIRs by TPU kernel) equal the counts derived from
     the modules, no plain version runs on a CUDA tensor, the artifact is
     bitwise the live function and timed beside it; the SGv1 artifact
     loaded in a fresh process that imports ``tpugan_torch.io.export``
     alone and held to the CPU run of its weights; ``profiling.
     trace_roofline`` and ``op_table`` on the StyleGAN2 artifact (CUPTI's
     counters, or the GPU driver's refusal); the operators' host cost a call
     beside the ctypes launch; PGGAN's discriminator (lods 0 and 0.5, on G's
     images) and the Pro-GAN stack at its defaults held to the CPU.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

# (name substring, memory bytes/s, fp32 FLOP/s outside the tensor cores,
# dense TF32 and dense bf16 tensor-core FLOP/s), first match wins; NVIDIA
# data sheets, dense rates (the sheets' tensor-core figures are with
# sparsity, twice these)
CARD_SPECS = (
    ("H100 PCIe", 2.0e12, 51e12, 378e12, 756e12),
    ("H100 NVL", 3.9e12, 60e12, 417.5e12, 835e12),
    ("H100", 3.35e12, 67e12, 495e12, 989.4e12),
    ("H200", 4.8e12, 67e12, 495e12, 989.4e12),
)
CARD = "cuda"  # the device every phase runs on; the replays' second side is the CPU
SEED = 0
REQUEST_SEEDS = (30000, 30001, 30002)  # infer_e's --seed_eval default and the next two
BATCH = 2
IMG_SIZE = 256
# the six same-size 3x3 blurs of one Cat256 decode: (channels, side)
PATH_BLURS = ((512, 8), (512, 16), (512, 32), (256, 64), (128, 128), (64, 256))
# tests/test_pallas_kernels.py's cases, NHWC shapes as written there
B1_CASES = (
    (1, 1, (1, 2, 1), (1, 1), (2, 8, 8, 4)),
    (1, 1, (1, 2, 1), (1, 1), (1, 16, 12, 8)),
    (2, 1, (1, 3, 3, 1), (3, 1), (2, 8, 8, 4)),
    (1, 2, (1, 3, 3, 1), (1, 1), (2, 16, 16, 4)),
    (1, 1, (1, 3, 3, 1), (2, 1), (1, 8, 8, 4)),
    (2, 1, (1, 2, 1), (2, 0), (1, 6, 6, 2)),
    (2, 1, (1, 3, 3, 1), (3, 1), (1, 32, 8, 4)),  # the multi-tile case
)
B2_CASES = (
    ((1, 2, 1), (1, 1), (2, 16, 16, 16)),
    ((1, 3, 3, 1), (2, 1), (1, 32, 24, 8)),
    ((1, 2, 1), (1, 1), (2, 9, 11, 4)),
)
# the rest of the kernel's contract: up and down together, a gain, 8 taps
# (up, down, taps, pad, NHWC shape, gain)
EXTRA_CASES = (
    (2, 2, (1, 3, 3, 1), (2, 2), (1, 7, 7, 3), 1.0),
    (2, 1, (1, 3, 3, 1), (2, 1), (2, 5, 5, 3), 4.0),
    (1, 1, (1, 7, 21, 35, 35, 21, 7, 1), (4, 3), (1, 12, 10, 5), 1.0),
)
TAPS8 = (1, 7, 21, 35, 35, 21, 7, 1)
# the tiled design's edges (label, up, down, taps, pad, NHWC shape, gain):
# rows and plane bases off 16-byte boundaries (4-byte copies), a tall
# narrow plane (row bands, the last one short) and a wide short one (2-D
# tiles), 512 + 3 small planes (the last block holds fewer), 8x8 taps with
# up 2 (both pad parities) and down 2 (odd sizes), a pad past the taps,
# and non-separable taps with kh != kw
TILE_CASES = (
    ("planes 5x7", 1, 1, (1, 2, 1), (1, 1), (2, 5, 7, 6), 1.0),
    ("planes 9x11", 1, 1, (1, 2, 1), (1, 1), (1, 9, 11, 64), 1.0),
    ("tall narrow", 1, 1, (1, 2, 1), (1, 1), (1, 300, 20, 3), 1.0),
    ("wide short", 1, 1, (1, 2, 1), (1, 1), (1, 3, 1030, 3), 1.0),
    ("515 planes", 1, 1, (1, 2, 1), (1, 1), (1, 8, 8, 515), 1.0),
    ("8x8 taps up2", 2, 1, TAPS8, (4, 3), (2, 19, 23, 5), 4.0),
    ("8x8 taps up2 odd pad", 2, 1, TAPS8, (3, 4), (1, 16, 12, 3), 4.0),
    ("8x8 taps down2", 1, 2, TAPS8, (3, 3), (2, 37, 29, 5), 1.0),
    ("8x8 taps up2 down2", 2, 2, TAPS8, (3, 4), (1, 13, 11, 3), 1.0),
    ("pad (5, 4)", 1, 1, (1, 2, 1), (5, 4), (2, 12, 16, 4), 1.0),
    ("taps 3x5", 1, 1, ((1, 2, 0, -1, 3), (2, 4, 1, 0, 1), (0, 1, 5, 2, 1)), (2, 3), (2, 17, 36, 3), 1.0),
    ("taps 2x7 up2", 2, 1, ((1, 2, 3, 4, 3, 2, 1), (0, 1, 1, 2, 1, 1, 0)), (3, 3), (1, 10, 9, 3), 4.0),
)
# slice 3's FIRs at their sizes (label, up, down, taps, pad, NCHW shape,
# gain): the same-size 4-tap FIR after SG2-1024's transposed conv
# (tpugan/models/stylegan2.py:233-244), the ToRGB skip's up-2 (:424),
# E_Blur's blur, and a down-2 4-tap FIR; held to the plain version and
# timed for the record
SLICE3_FIRS = (
    ("SG2 4-tap FIR", 1, 1, (1, 3, 3, 1), (1, 1), (2, 32, 1025, 1025), 4.0),
    ("SG2 ToRGB skip up-2", 2, 1, (1, 3, 3, 1), (2, 1), (2, 3, 512, 512), 4.0),
    ("E_Blur blur", 1, 1, (1, 2, 1), (1, 1), (2, 16, 1024, 1024), 1.0),
    ("down-2 4-tap FIR", 1, 2, (1, 3, 3, 1), (1, 1), (2, 3, 1024, 1024), 1.0),
)
# the FIR adjoint's other cases (label, up, down, taps, pad, NCHW shape,
# gain): a pad past the taps (a negative adjoint pad, cropped in torch), and
# kh != kw at up 2 (unequal front pads of H and W: stuffed and padded in
# torch, then one launch at up 1)
ADJOINT_CASES = (
    ("pad past the taps", 1, 1, (1, 2, 1), (4, 3), (2, 16, 12, 10), 1.0),
    ("taps 3x2 up2", 2, 1, ((1, 2), (3, 1), (0, 2)), (1, 1), (2, 3, 9, 7), 4.0),
)
# the blur shapes also timed with L2 flushed before each call (their inputs
# and outputs are 33.6 and 67.1 MB; the L2 holds 50 MB)
FLUSHED_BLURS = ((128, 128), (64, 256))
FLUSH_BYTES = 256 * 2**20
KERNEL_TOL = 1e-5  # abs and rel, the Pallas kernels' own contract
CPU_GPU_ATOL = 1e-3  # whole request, fp32 on both sides: cuDNN vs CPU conv summation order
# Every replay that takes a gradient on the card runs under
# cudnn_deterministic: cuDNN's default weight-gradient algorithms (its
# wgrad_alg0_engine adds with atomics) sum in another order each run, and an
# ill-conditioned gradient or an optimiser's sign-like first update turns
# that into a distance that is now and then several times its usual size.
# tpugan_torch/tools/replay_spread.py on an H100: phase 8's SGv1 step
# gradient, median 8.696e-2 from float64 and 1 run in 20 at 3.995e-1, over
# its limit of 2.030e-1; phase 12's baseline_i2s, median 4.598e-7 and 1 run
# in 100 at 2.243e-5, over 2.593e-6. Deterministic, every run gave one
# result (5.703e-2 and 4.714e-7).
# tests/test_attention.py's cases: (q, k, v shapes, input scale, rtol, atol, check lse);
# then lengths that are not multiples of the kernel's 128-row blocks and 32-key tiles,
# widths that are not multiples of 4 (4-byte copies), BigGAN-128's head widths (dk 32,
# dv 128) at its attention layer (64x64x256), the instances that the rest leave out
# (padded dk 64 and 128 by slices of dv padded to 32 and 64), and BigGAN-256's widths
# (the BigGAN-256 paths' shape, randn inputs): with the others, every
# instance of csrc/sagan_attention.cu, padded dk 32, 64 or 128 by slice width 32, 64 or
# 128 (dk 128 with one stage of split key tiles, the others with two)
ATTENTION_CASES = (
    ((2, 256, 32), (2, 128, 32), (2, 128, 64), 1.0, 2e-5, 2e-5, False),
    ((1, 512, 16), (1, 512, 16), (1, 512, 32), 3.0, 2e-4, 2e-5, False),
    ((2, 256, 16), (2, 256, 16), (2, 256, 32), 2.0, 2e-5, 2e-5, True),
    ((1, 37, 8), (1, 19, 8), (1, 19, 24), 2.0, 2e-5, 2e-5, True),
    ((2, 100, 16), (2, 25, 16), (2, 25, 40), 2.0, 2e-5, 2e-5, True),
    ((1, 5, 4), (1, 1, 4), (1, 1, 4), 1.0, 2e-5, 2e-5, True),
    ((1, 130, 128), (1, 70, 128), (1, 70, 256), 0.3, 2e-5, 2e-5, True),
    ((1, 50, 13), (1, 33, 13), (1, 33, 30), 1.0, 2e-5, 2e-5, True),
    ((2, 70, 20), (2, 45, 20), (2, 45, 130), 1.0, 2e-5, 2e-5, True),
    ((2, 4096, 32), (2, 1024, 32), (2, 1024, 128), 1.0, 2e-5, 2e-5, True),
    ((1, 100, 64), (1, 80, 64), (1, 80, 32), 0.5, 2e-5, 2e-5, True),
    ((1, 100, 64), (1, 80, 64), (1, 80, 64), 0.5, 2e-5, 2e-5, True),
    ((1, 100, 128), (1, 80, 128), (1, 80, 32), 0.5, 2e-5, 2e-5, True),
    ((1, 100, 128), (1, 80, 128), (1, 80, 64), 0.5, 2e-5, 2e-5, True),
    ((2, 4096, 64), (2, 1024, 64), (2, 1024, 256), 1.0, 2e-5, 2e-5, True),
)
LSE_TOL = 1e-5  # tests/test_attention.py:54
# the attention backward: tests/test_attention.py:59-80's case, then odd
# lengths, one key, widths that are not multiples of 4, dk 128 with dv 256,
# 64 and 128 and dk 64 with dv 128 (with the rest, every template instance
# of the dq kernel: padded widths dk 64 or 128 by dv 64, 128 or 256),
# BigGAN-128's widths and BigGAN-256's (the path's instance, at O(1)
# values), and the path's widths at lengths that are not multiples of the
# kernels' 32- and 64-row tiles: (q, k, v shapes, input scale)
ATTENTION_BWD_CASES = (
    ((2, 256, 16), (2, 384, 16), (2, 384, 32), 2.0),
    ((1, 37, 8), (1, 19, 8), (1, 19, 24), 2.0),
    ((2, 100, 16), (2, 25, 16), (2, 25, 40), 2.0),
    ((1, 5, 4), (1, 1, 4), (1, 1, 4), 1.0),
    ((1, 50, 13), (1, 33, 13), (1, 33, 30), 1.0),
    ((2, 70, 20), (2, 45, 20), (2, 45, 130), 1.0),
    ((1, 130, 128), (1, 70, 128), (1, 70, 256), 0.3),
    ((1, 100, 128), (1, 80, 128), (1, 80, 64), 0.5),
    ((1, 100, 128), (1, 80, 128), (1, 80, 128), 0.5),
    ((1, 100, 64), (1, 80, 64), (1, 80, 128), 0.5),
    ((2, 4096, 32), (2, 1024, 32), (2, 1024, 128), 1.0),
    ((2, 4096, 64), (2, 1024, 64), (2, 1024, 256), 1.0),
    ((1, 4100, 64), (1, 1000, 64), (1, 1000, 256), 1.0),
)
BWD_TOL = 2e-4  # abs and rel, tests/test_attention.py:78
# and max |err| of each gradient at most this share of the size of its summed
# terms (compare_attention_bwd), which holds the kernel where the values are
# far below BWD_TOL, as on a step's own inputs
BWD_MAX_SHARE = 1e-3
# B4's kernels: their launch counters, and their symbols in a profiler trace
B4_KERNELS = ("sagan_attention_bwd_pack", "sagan_attention_bwd_dq", "sagan_attention_bwd_dkv")
B4_SYMBOLS = ("attention_pack_kernel", "attention_dq_kernel", "attention_dkv_kernel")
# the attention layer's shape on the BigGAN-256 paths (64 x 64 positions of
# 512 channels, keys max-pooled to 32 x 32; batch 2): q, k, v
ATTN_PATH_SHAPE = ((BATCH, 4096, 64), (BATCH, 1024, 64), (BATCH, 1024, 256))
BIGGAN_SIZE = 256
BIGGAN_Z_DIM = 128
ATTN_GAMMA = 1.0  # every SelfAttn.gamma in the CUDA-vs-CPU BigGAN check (random init gives 0)
TRAIN_STEPS = 3  # counted steps of each train-step variant
TIMED_STEPS = 8  # host-clock steps of each variant, after 2 warm-up steps
# the CPU replay of a case-2 step: BigGAN-deep-256's layout at channel width
# 32 (the path has 128) and E_BIG at start_features 16 (64), so the host's
# CPU runs it in seconds; the card runs the same configuration
REPLAY_CHANNEL_WIDTH = 32
REPLAY_START_FEATURES = 16
REPLAY_LOSS_RTOL = 1e-4  # loss_tsa, fp32 on both sides
REPLAY_GRAD_TOL = 1e-3  # max |err| of a gradient leaf over its max |value|
REPLAY_LEAVES = ("block_0.conv_1.weight", "new_final_2.weight")
# the StyleGAN2 path: tpugan's infer_e defaults (tpugan/cli/common.py:39-43)
SG2_SIZE = 1024
SG2_START_FEATURES = 16
# the device-side sleep of queued_ms: cycles per ms, above the H100's boost
# clock (1.98 GHz), so that a sleep lasts at least as long as asked
SLEEP_CYCLES_PER_MS = 2.0e6
# pauses (s) before the retakes of a profiler trace that saw no device time or
# missed launches: on an H100, CUPTI returned 9 of 2,851 traces with no device
# time, each alone (tpugan_torch/tools/profiler_gaps.py), and once three in a row
PROFILER_RETAKE_PAUSES = (0.5, 2.0, 5.0)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def say(*parts):
    print(*parts, flush=True)


@contextlib.contextmanager
def cudnn_deterministic(torch):
    """cuDNN's deterministic algorithms inside, its setting before restored
    after: its default weight-gradient algorithms may sum in another order
    from run to run."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def expected_launches(**counts):
    """Launch counts of every kernel: the ones given, 0 for the others."""
    from tpugan_torch.ops import cuda

    return {name: counts.get(name, 0) for name in cuda.KERNELS}


def card_specs(name):
    for key, *peaks in CARD_SPECS:
        if key in name:
            return peaks
    raise RuntimeError(f"chip_smoke: no memory/compute peaks known for {name!r}")


def time_ms(torch, fn, iters=50, warmup=5):
    """Mean time per call of ``iters`` calls back to back, from CUDA events:
    the device time, or the host's issue time where that is longer."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_kernels(torch, fn, iters, expect=(), warmup=True, host=True):
    """Device time (ms) and count per call of each kernel and copy that
    ``iters`` calls of ``fn`` ran, from torch.profiler (CUPTI), after one
    call of ``fn`` unless ``warmup`` is false; with ``host`` false the trace
    records the device alone (a host-bound loop's CPU ops cost seconds to
    record). User
    annotations (``Optimizer.step#...``) span kernels already counted and are
    left out. A trace with no device time at all, or one that holds fewer
    than one launch per call of a kernel whose symbol is in ``expect``, is
    taken again after each pause of PROFILER_RETAKE_PAUSES, and each retake
    prints a line. When every trace missed, raises MissedLaunches with the
    last one (empty where none saw device time)."""
    from torch.profiler import ProfilerActivity, profile

    if warmup:
        fn()
    torch.cuda.synchronize()
    takes = len(PROFILER_RETAKE_PAUSES) + 1
    for attempt, pause in enumerate((0.0,) + PROFILER_RETAKE_PAUSES, start=1):
        time.sleep(pause)
        activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host else [ProfilerActivity.CUDA]
        with profile(activities=activities) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        found = {
            e.key: (e.device_time_total / iters / 1e3, e.count / iters)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0
            and not getattr(e, "is_user_annotation", False)
        }
        short = [sym for sym in expect if sum(n for key, (_, n) in found.items() if sym in key) < 1]
        if found and not short:
            return found
        say(f"profiler: trace {attempt} of {takes} " + (f"missed launches of {short}" if found else
                                                        "saw no device time")
            + (f"; taking it again in {PROFILER_RETAKE_PAUSES[attempt - 1]} s" if attempt < takes else ""))
    raise MissedLaunches(found)


class MissedLaunches(RuntimeError):
    """Every trace of a ``device_kernels`` call missed: ``found`` is the
    last trace's kernels, empty where no trace saw device time."""

    def __init__(self, found):
        super().__init__(f"chip_smoke: {len(PROFILER_RETAKE_PAUSES) + 1} profiler traces in a row "
                         + ("missed kernel launches" if found else "saw no device time"))
        self.found = found


def kernel_ms(torch, fn, expect, device_bound=False):
    """Device time per call of ``fn`` (ms), the kernels a trace of it saw,
    and where the time comes from: torch.profiler, or CUDA events around 20
    back-to-back calls where every trace saw no device time or missed
    launches of a kernel in ``expect``. On the card, traces taken after the
    paths' profiled requests and steps recorded 1 launch of 20, none, or 20
    launches at half the kernel's time, while the same calls traced alone
    record all 20; and CUPTI has returned runs of traces with no device
    time at all. For a call whose back-to-back time is the device's
    (``device_bound``: long kernels, not the small blurs, whose back-to-back
    time is the host's), a trace under 0.9 of that time is taken again too."""
    events = time_ms(torch, fn, iters=20)
    kernels = {}
    for attempt in range(1, 4):
        try:
            kernels = device_kernels(torch, fn, iters=20, expect=expect)
        except MissedLaunches as missed:
            kernels = missed.found
            break
        total = sum(ms for ms, _ in kernels.values())
        if not device_bound or total >= 0.9 * events:
            return total, kernels, "torch.profiler"
        say(f"profiler: trace {attempt} of 3 held {total * 1e3:.2f} us per call, under 0.9 of the "
            f"CUDA events' {events * 1e3:.2f} us; taking it again")
    say(f"profiler: no complete trace of {list(expect) or 'the call'}; CUDA events instead: "
        f"{events * 1e3:.2f} us per call")
    return events, kernels, "CUDA events"


def request_latency(torch, run, seed, label, requests=20):
    """Host-clock latency of ``requests`` requests ``run(seed + i)``, each
    ending in a synchronize, after two warm-up requests; returns the median
    (ms)."""
    lat = []
    for i in range(requests + 2):
        t0 = time.perf_counter()
        run(seed + i)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    lat = sorted(lat[2:])
    say(f"request latency, {label} ({len(lat)} requests): median {statistics.median(lat):.3f} ms, "
        f"min {lat[0]:.3f}, max {lat[-1]:.3f}")
    return statistics.median(lat)


def request_device_time(torch, run, seed, median, symbol, name, iters=5):
    """A request's device time by kernel (torch.profiler over ``iters`` requests, the device alone),
    the share of the kernel whose symbol contains ``symbol`` (none where it
    is None), and the request's peak device memory; returns the device time
    and the peak (the peak alone, with a line, where no trace saw device
    time)."""
    out = {}
    try:
        kernels = device_kernels(torch, lambda: run(seed), iters=iters, host=False)
    except MissedLaunches as missed:
        say(f"device time per request: not measured ({missed})")
    else:
        busy = sum(ms for ms, _ in kernels.values())
        say(f"device time per request {busy:.3f} ms over {sum(n for _, n in kernels.values()):.0f} "
            f"kernels and copies = {busy / median * 100:.1f}% of the median latency; by name:")
        for kname, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]:
            say(f"  {ms:8.3f} ms  x{n:5.0f}  {kname[:100]}")
        if symbol is not None:
            own = sum(ms for kname, (ms, _) in kernels.items() if symbol in kname)
            say(f"{name} kernel: {own:.3f} ms per request, {own / busy * 100:.2f}% of device time")
        out["device_ms"] = busy
    torch.cuda.reset_peak_memory_stats()
    run(seed)
    out["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    say(f"peak device memory of a request: {out['peak_mib']:.1f} MiB")
    return out


def attention_tiers():
    """The padded dk and the slice widths of dv that csrc/sagan_attention.cu
    dispatches to, read from its source (``launch_dv<T, CK>``, ``launch<T,
    CK, CV>``): every pair of them is an instance of its kernel, for each
    element type T."""
    import re
    from pathlib import Path

    source = (Path(__file__).resolve().parent / "tpugan_torch/csrc/sagan_attention.cu").read_text()
    return ({int(x) for x in re.findall(r"launch_dv<T, (\d+)>", source)},
            {int(x) for x in re.findall(r"launch<T, CK, (\d+)>", source)})


def launched_instance():
    """The instance (padded dk, slice width, stages) of the last attention
    launch, as csrc/sagan_attention.cu's entry point recorded it."""
    import ctypes

    from tpugan_torch.ops import cuda

    out = (ctypes.c_int * 3)()
    cuda.helper("sagan_attention_last_instance")(out)
    return tuple(out)


def compare_attention(torch, label, q, k, v, rtol, atol, with_lse):
    """The attention kernel against its plain version on one input; returns
    the max |err| of the output (and of the logsumexp, when checked).

    The plain version's arithmetic (the score matrix, softmax, the second
    product; logsumexp) runs in float64 on the same fp32 inputs and its
    result is rounded to fp32: at the path's widths the fp32 plain version
    (cuBLAS) is itself further from that result than the kernel (1.6e-5
    against 7.3e-6 with randn inputs), so a comparison with it would measure
    two summation orders and not the kernel's error. The fp32 plain
    version's own error, and the kernel's against it, are printed."""
    from tpugan_torch.ops.attention import sagan_attention_cuda, sagan_attention_plain

    got = sagan_attention_cuda(q, k, v, return_lse=with_lse)
    fp32 = sagan_attention_plain(q, k, v, return_lse=with_lse)
    s64 = torch.bmm(q.double(), k.double().transpose(1, 2))
    want = torch.bmm(torch.softmax(s64, dim=-1), v.double()).float()
    torch.cuda.synchronize()
    if with_lse:
        (got, got_lse), (fp32, fp32_lse) = got, fp32
    check(got.shape == want.shape, f"{label}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
    err = (got - want).abs().max().item()
    check(torch.allclose(got, want, rtol=rtol, atol=atol),
          f"{label}: kernel disagrees with the plain version in float64, max |err| {err:.3e} "
          f"(rtol {rtol:g}, atol {atol:g})")
    msg = (f"parity {label}: max |err| against the plain version in float64 {err:.3e} (rtol {rtol:g}, "
           f"atol {atol:g}); the fp32 plain version's own {(fp32 - want).abs().max().item():.3e}, the "
           f"kernel's against it {(got - fp32).abs().max().item():.3e}")
    if with_lse:
        want_lse = torch.logsumexp(s64, dim=-1, keepdim=True).float()
        lse_err = (got_lse - want_lse).abs().max().item()
        check(got_lse.shape == want_lse.shape == (q.shape[0], q.shape[1], 1), f"{label}: lse shape")
        check(torch.allclose(got_lse, want_lse, rtol=LSE_TOL, atol=LSE_TOL),
              f"{label}: kernel logsumexp disagrees, max |err| {lse_err:.3e}")
        msg += (f"; lse {lse_err:.3e} ({LSE_TOL:g}), the fp32 plain version's own "
                f"{(fp32_lse - want_lse).abs().max().item():.3e}, the kernel's against it "
                f"{(got_lse - fp32_lse).abs().max().item():.3e}")
        err = max(err, lse_err)
    say(msg)
    del s64, want
    return err


def attention_parity(torch, dev, gen):
    """The attention kernel against its plain version (in float64) on
    ATTENTION_CASES, and out-of-contract calls refused; returns the max |err|."""
    from tpugan_torch.ops import cuda
    from tpugan_torch.ops.attention import sagan_attention_cuda

    before = cuda.launches["sagan_attention"]
    max_err, instances = 0.0, set()
    for q_shape, k_shape, v_shape, scale, rtol, atol, with_lse in ATTENTION_CASES:
        q = torch.randn(q_shape, device=dev, generator=gen) * scale
        k = torch.randn(k_shape, device=dev, generator=gen) * scale
        v = torch.randn(v_shape, device=dev, generator=gen)
        err = compare_attention(torch, f"attention q{q_shape} k{k_shape} v{v_shape} x{scale:g}", q, k, v,
                                rtol, atol, with_lse)
        instance = launched_instance()
        say(f"  ran the instance {instance} (padded dk, slice width, stages)")
        instances.add(instance)
        max_err = max(max_err, err)
    # every instance ran, as the entry point recorded its launches
    cks, cvs = attention_tiers()
    ran = {(ck, cv) for ck, cv, _ in instances}
    check(len(cks) == len(cvs) == 3 and ran == {(ck, cv) for ck in cks for cv in cvs},
          f"the attention cases ran the instances {sorted(instances)}, not every pair of padded dk "
          f"{sorted(cks)} and slice width {sorted(cvs)} that csrc/sagan_attention.cu dispatches to")
    check({stages for *_, stages in instances} == {1, 2},
          f"the attention cases ran the instances {sorted(instances)}: not both one and two stages")
    # no atomics: two runs at the path's shape, and the two forms, bitwise equal
    q, k, v = (torch.randn(shape, device=dev, generator=gen) for shape in ATTN_PATH_SHAPE)
    first = sagan_attention_cuda(q, k, v)
    again, _ = sagan_attention_cuda(q, k, v, return_lse=True)
    third = sagan_attention_cuda(q, k, v)
    torch.cuda.synchronize()
    check(torch.equal(first, third) and torch.equal(first, again),
          "two runs of the attention kernel on the same inputs differ")
    say(f"attention at the path's shape {ATTN_PATH_SHAPE}: three runs (one with lse) bitwise equal")
    del q, k, v, first, again, third
    check(cuda.launches["sagan_attention"] - before == len(ATTENTION_CASES) + 3,
          f"attention launch count {cuda.launches}")
    x = torch.randn(2, 8, 16, device=dev, generator=gen)
    refused = {
        "fp16": lambda: sagan_attention_cuda(x.half(), x.half(), x.half()),
        "non-contiguous": lambda: sagan_attention_cuda(x.transpose(0, 1), x, x),
        "dk 129": lambda: sagan_attention_cuda(x.new_zeros(2, 8, 129), x.new_zeros(2, 8, 129), x),
        "dv 257": lambda: sagan_attention_cuda(x, x, x.new_zeros(2, 8, 257)),
        "CPU tensors": lambda: sagan_attention_cuda(x.cpu(), x.cpu(), x.cpu()),
    }
    for name, call in refused.items():
        try:
            call()
        except (TypeError, ValueError):
            continue
        raise RuntimeError(f"chip_smoke: out-of-contract attention call ({name}) was not refused")
    check(cuda.launches["sagan_attention"] - before == len(ATTENTION_CASES) + 3, "a refused call launched")
    say(f"attention parity: {len(ATTENTION_CASES)} cases over the instances {sorted(instances)} (padded "
        f"dk, slice width, stages, as the entry point recorded them; max |err| {max_err:.3e}); "
        f"{len(refused)} out-of-contract calls refused: {', '.join(refused)}")
    return max_err


def set_attention_gamma(torch, model, value):
    from tpugan_torch.models import SelfAttn

    layers = [m for m in model.modules() if isinstance(m, SelfAttn)]
    with torch.no_grad():
        for m in layers:
            m.gamma.fill_(value)
    return len(layers)


def latent_stds(torch, infer_e, bundle, seed):
    """The std of one request's truncated latents zt and of E_BIG's z2 for
    them. A trained E_BIG returns z2 close to zt; with flax's random init
    z2 comes out far wider, and BigGAN's conditional batch norms, which
    scale by 1 + a linear map of [z2, embedding], then overflow fp32 in the
    resynthesis pass (tpugan's own init does the same:
    tests/test_torch_init.py)."""
    request = infer_e.draw_request(bundle, BATCH, seed)
    batch = bundle.synth(request.z, request.label)
    _, z2 = bundle.encode(batch, request.noise_e)
    return request.z.std().item(), z2.std().item()


def scale_z_head(torch, encoder, factor):
    with torch.no_grad():
        encoder.new_final_2.weight.mul_(factor)
        encoder.new_final_2.bias.mul_(factor)


def biggan_path(torch, dev, parser, smi):
    """Phase 5: the mtype-4 path (BigGAN-deep-256 + E_BIG, batch 2). Returns
    the attention kernel's launches on the path and its max |err|."""
    from tpugan_torch.cli import common, infer_e
    from tpugan_torch.models import biggan as biggan_model
    from tpugan_torch.ops import cuda

    argv = ["--mtype", "4", "--img_size", str(BIGGAN_SIZE), "--start_features", "64",
            "--z_dim", str(BIGGAN_Z_DIM), "--random_init", "--batch_size", str(BATCH),
            "--seed", str(SEED)]
    t0 = time.perf_counter()
    bundle = common.build_bundle(parser.parse_args(argv + ["--device", CARD]))
    torch.cuda.synchronize()
    cfg = bundle.generator.config
    say(f"bundle: mtype 4, BigGAN-deep-{cfg.output_dim} (channel_width {cfg.channel_width}, "
        f"{len(cfg.layers)} GenBlocks, SelfAttn at position {cfg.attention_layer_position}, "
        f"{cfg.num_classes} classes, n_stats {cfg.n_stats}, z_dim {cfg.z_dim}) + E_BIG (startf 64, "
        f"maxf 512, layer_count {bundle.layer_count}) built in {time.perf_counter() - t0:.2f} s")
    seed = REQUEST_SEEDS[0]
    # the CLI's own weights first: the synthesis is finite, the resynthesis
    # from E_BIG's wide z2 overflows
    imgs1, imgs2 = infer_e.run(bundle, BATCH, seed)
    check(bool(torch.isfinite(imgs1).all()), "BigGAN imgs1 of the CLI's weights is not finite")
    not_finite = (~torch.isfinite(imgs2)).float().mean().item()
    zt_std, z2_std = latent_stds(torch, infer_e, bundle, seed)
    say(f"the CLI's weights (flax's random init): z2 std {z2_std:.4f} against zt std {zt_std:.4f}; "
        f"imgs1 finite, {not_finite * 100:.2f}% of imgs2 not finite (a wide z2 overflows fp32 in "
        "BigGAN's conditional batch norms, with tpugan's own init too: tests/test_torch_init.py)")
    factor = zt_std / z2_std
    scale_z_head(torch, bundle.encoder, factor)
    say(f"from here on E_BIG's z head (new_final_2) is scaled by {factor:.4e}, so z2 has zt's std "
        "(a trained E_BIG returns z2 close to zt)")

    # the kernel on the path's own q/k/v, captured from one request
    captured = []
    real = biggan_model.sagan_attention

    def capture(q, k, v):
        captured.append((q.clone(), k.clone(), v.clone()))
        return real(q, k, v)

    biggan_model.sagan_attention = capture
    try:
        infer_e.run(bundle, BATCH, seed)
    finally:
        biggan_model.sagan_attention = real
    check(len(captured) == 2, f"a request called the attention {len(captured)} times, not 2")
    max_err = 0.0
    for name, (q, k, v) in zip(("synthesis", "resynthesis"), captured):
        scores = torch.bmm(q, k.transpose(1, 2)).abs().max().item()
        label = (f"attention, the path's own q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)} "
                 f"({name} pass, max |q k^T| {scores:.2f})")
        max_err = max(max_err, compare_attention(torch, label, q, k, v, 2e-5, 2e-5, True))

    # the main path: launches counted from 0
    cuda.reset_launches()
    for s in REQUEST_SEEDS:
        imgs1, imgs2 = infer_e.run(bundle, BATCH, s)
        torch.cuda.synchronize()
        for label, img in (("imgs1", imgs1), ("imgs2", imgs2)):
            check(tuple(img.shape) == (BATCH, BIGGAN_SIZE, BIGGAN_SIZE, 3),
                  f"BigGAN {label} shape {tuple(img.shape)}")
            check(bool(torch.isfinite(img).all()), f"BigGAN {label} of seed {s} is not finite")
    launches = dict(cuda.launches)
    want = expected_launches(sagan_attention=2 * len(REQUEST_SEEDS))
    check(launches == want, f"BigGAN path launches {launches}, expected {want}")
    say(f"BigGAN path: {len(REQUEST_SEEDS)} requests, launches {launches} "
        "(2 per request: the synthesis and the resynthesis pass)")

    # one request on the card and on the CPU, with the attention in the images
    cpu = common.build_bundle(parser.parse_args(argv + ["--device", "cpu"]))
    scale_z_head(torch, cpu.encoder, factor)
    request = infer_e.draw_request(cpu, BATCH, seed)
    zero_gamma = infer_e.serve(bundle, request.to(dev))
    for b in (bundle, cpu):
        check(set_attention_gamma(torch, b.generator, ATTN_GAMMA) == 1, "expected one SelfAttn")
    cuda.reset_launches()
    on_gpu = infer_e.serve(bundle, request.to(dev))
    torch.cuda.synchronize()
    check(cuda.launches["sagan_attention"] == 2, f"cuda request launches {cuda.launches}")
    on_cpu = infer_e.serve(cpu, request)
    check(cuda.launches["sagan_attention"] == 2, "the CPU request launched the kernel")
    moved = max((a - b).abs().max().item() for a, b in zip(on_gpu, zero_gamma))
    say(f"cuda vs cpu (BigGAN): SelfAttn.gamma set to {ATTN_GAMMA:g} on both bundles (random "
        f"init gives 0, which keeps the attention out of the images); the images moved by up to "
        f"{moved:.3f} against gamma 0")
    check(moved > 1e-2, "gamma did not change the images")
    for label, g, c in zip(("imgs1", "imgs2"), on_gpu, on_cpu):
        err = (g.cpu() - c).abs().max().item()
        say(f"cuda vs cpu (BigGAN) {label}: max |err| {err:.3e} (max |ref| {c.abs().max().item():.3f})")
        check(err <= CPU_GPU_ATOL, f"BigGAN {label}: cuda and cpu differ by {err:.3e} > {CPU_GPU_ATOL:g}")
    set_attention_gamma(torch, bundle.generator, 0.0)  # back to the CLI's init for the times
    del cpu

    say(f"BigGAN times below: {smi}; device times from torch.profiler, request times from the host clock")
    run = lambda s: infer_e.run(bundle, BATCH, s)  # noqa: E731
    median = request_latency(torch, run, seed, f"BigGAN-deep-{BIGGAN_SIZE} + E_BIG, fp32, TF32 off")
    request_device_time(torch, run, seed, median, "sagan_attention_kernel", "sagan_attention")

    return {"launches": launches["sagan_attention"], "max_abs_err": max_err}


def compare_attention_bwd(torch, label, q, k, v, o, lse, do):
    """The attention backward kernels against their plain version on one
    input (the forward's o and lse given); returns the max |err| over dq, dk
    and dv.

    The plain version runs in float64 on the same fp32 inputs and its result
    is rounded to fp32: the kernels sum in another order than cuBLAS, and at
    the path's widths the fp32 plain version is itself up to about 2e-4 from
    that result (printed as "fp32 plain"), so a comparison with it would
    measure two summation orders and not the kernels' error."""
    from tpugan_torch.ops.attention import sagan_attention_bwd_cuda, sagan_attention_bwd_plain

    got = sagan_attention_bwd_cuda(q, k, v, o, lse, do)
    fp32 = sagan_attention_bwd_plain(q, k, v, o, lse, do)
    want = [x.float() for x in sagan_attention_bwd_plain(*(x.double() for x in (q, k, v, o, lse, do)))]
    # the size of each gradient's summed terms before they cancel, which is
    # what fp32 rounding scales with: a gradient that is zero by construction
    # (one key: ds = p (dp - delta) = 0) has a max |value| of rounding noise
    p = torch.exp(torch.bmm(q, k.transpose(1, 2)) - lse)
    ds_terms = p * (torch.bmm(do.abs(), v.abs().transpose(1, 2)) + (do * o).sum(-1, keepdim=True).abs())
    terms = (torch.bmm(ds_terms, k.abs()), torch.bmm(ds_terms.transpose(1, 2), q.abs()),
             torch.bmm(p.transpose(1, 2), do.abs()))
    torch.cuda.synchronize()
    errs, parts = [], []
    for name, g, w, f, t in zip(("dq", "dk", "dv"), got, want, fp32, terms):
        check(g.shape == w.shape, f"{label}: {name} shape {tuple(g.shape)} vs {tuple(w.shape)}")
        err = (g - w).abs().max().item()
        scale, term = w.abs().max().item(), t.max().item()
        check(torch.allclose(g, w, rtol=BWD_TOL, atol=BWD_TOL) and err <= BWD_MAX_SHARE * term,
              f"{label}: {name} disagrees with the plain version, max |err| {err:.3e}; max |value| "
              f"{scale:.3e}, terms {term:.3e}")
        errs.append(err)
        parts.append(f"{name} {err:.3e} ({scale:.3e}, {term:.3e}; fp32 plain {(f - w).abs().max().item():.3e}, "
                     f"kernel vs fp32 plain {(g - f).abs().max().item():.3e})")
    del p, ds_terms, terms
    say(f"parity {label}: max |err| against the plain version in float64 (max |value|, terms; the "
        "fp32 plain version's own max |err|, and the kernel's against it) " + ", ".join(parts)
        + f" (rtol and atol {BWD_TOL:g}, and at most {BWD_MAX_SHARE:g} of the terms)")
    return max(errs)


def attention_bwd_parity(torch, dev, gen):
    """The attention backward kernels against their plain version (TF32 off)
    on ATTENTION_BWD_CASES, and out-of-contract calls refused; returns the
    max |err|."""
    from tpugan_torch.ops import cuda
    from tpugan_torch.ops.attention import sagan_attention_bwd_cuda, sagan_attention_plain

    cuda.reset_launches()
    max_err = 0.0
    for q_shape, k_shape, v_shape, scale in ATTENTION_BWD_CASES:
        q = torch.randn(q_shape, device=dev, generator=gen) * scale
        k = torch.randn(k_shape, device=dev, generator=gen) * scale
        v = torch.randn(v_shape, device=dev, generator=gen)
        do = torch.randn(q_shape[0], q_shape[1], v_shape[2], device=dev, generator=gen)
        o, lse = sagan_attention_plain(q, k, v, return_lse=True)
        label = f"attention backward q{q_shape} k{k_shape} v{v_shape} x{scale:g}"
        max_err = max(max_err, compare_attention_bwd(torch, label, q, k, v, o, lse, do))
    n = len(ATTENTION_BWD_CASES)
    want = {name: n for name in B4_KERNELS}
    instances = {(64 if q_[2] <= 64 else 128, 64 if v_[2] <= 64 else 128 if v_[2] <= 128 else 256)
                 for q_, _, v_, _ in ATTENTION_BWD_CASES}
    check(len(instances) == 6, f"the backward cases reach the instances {sorted(instances)}, not all 6")
    check({k_: cuda.launches[k_] for k_ in want} == want, f"backward launch count {cuda.launches}")
    q = torch.randn(2, 8, 16, device=dev, generator=gen)
    o, lse = sagan_attention_plain(q, q, q, return_lse=True)
    refused = {
        "fp16 do": lambda: sagan_attention_bwd_cuda(q, q, q, o, lse, o.half()),
        "non-contiguous o": lambda: sagan_attention_bwd_cuda(q, q, q, o.transpose(0, 1), lse, o),
        "dk 129": lambda: sagan_attention_bwd_cuda(q.new_zeros(2, 8, 129), q.new_zeros(2, 8, 129),
                                                   q, o, lse, o),
        "dv 257": lambda: sagan_attention_bwd_cuda(q, q, q.new_zeros(2, 8, 257), q.new_zeros(2, 8, 257),
                                                   lse, q.new_zeros(2, 8, 257)),
        "CPU tensors": lambda: sagan_attention_bwd_cuda(q.cpu(), q.cpu(), q.cpu(), o.cpu(), lse.cpu(),
                                                        o.cpu()),
    }
    for name, call in refused.items():
        try:
            call()
        except (TypeError, ValueError):
            continue
        raise RuntimeError(f"chip_smoke: out-of-contract backward call ({name}) was not refused")
    check({k_: cuda.launches[k_] for k_ in want} == want, "a refused backward call launched")
    say(f"attention backward parity: {n} cases over the dq kernel's instances {sorted(instances)} "
        f"(max |err| {max_err:.3e}); {len(refused)} out-of-contract calls refused: {', '.join(refused)}")
    return max_err


def time_calls(torch, calls, expect):
    """Device time per call of each of ``calls`` ({key: fn}): the kernel's
    (key "ms", and "fp32_ms" for the fp32 kernel beside a bf16 one) from
    ``kernel_ms`` (``expect``: its symbols), the others' summed over a
    trace of 20 calls (``kernel_ms`` with no symbols). Returns the times
    (each with its source, "<key>_from"), the kernels each call ran by name
    (longest first) and by key, and each call's back-to-back time from CUDA
    events."""
    row, names, kernels_of = {}, {}, {}
    for key, fn in calls.items():
        row[key], kernels, row[f"{key}_from"] = kernel_ms(
            torch, fn, expect if key in ("ms", "fp32_ms") else (), device_bound=key in ("ms", "fp32_ms"))
        names[key] = sorted(kernels, key=lambda name: -kernels[name][0])
        kernels_of[key] = kernels
    issue = {key: time_ms(torch, fn, iters=20) for key, fn in calls.items()}
    return row, names, kernels_of, issue


def attention_times(torch, dev, gen, bandwidth, fp32_peak, tf32_peak):
    """B3 and B4 at the BigGAN-256 paths' shape (ATTN_PATH_SHAPE, randn
    inputs from the seed), timed before any path runs: traces taken after the
    paths' profiled requests and steps have missed their launches (PR 5), so
    the profiler sees these calls first. Each beside its plain version, one
    library call for the same function and its bound. Returns the two kernel
    table rows' timing keys."""
    import torch.nn.functional as F

    from tpugan_torch.ops import attention
    from tpugan_torch.ops.attention import (
        sagan_attention_bwd_cuda,
        sagan_attention_bwd_plain,
        sagan_attention_cuda,
        sagan_attention_plain,
    )

    (n, lq, dk), (_, lk, _), (_, _, dv) = ATTN_PATH_SHAPE
    q, k, v = (torch.randn(shape, device=dev, generator=gen) for shape in ATTN_PATH_SHAPE)
    do = torch.randn(n, lq, dv, device=dev, generator=gen)
    o, lse = sagan_attention_plain(q, k, v, return_lse=True)
    shape = f"q [{n}, {lq}, {dk}], k [{n}, {lk}, {dk}], v [{n}, {lk}, {dv}]"

    # B3: softmax(q k^T) v
    library = lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0)  # noqa: E731
    lib_err = (library() - sagan_attention_plain(q, k, v)).abs().max().item()
    check(lib_err < 1e-3, f"scaled_dot_product_attention differs by {lib_err:.3e}")
    b3, names, _, issue = time_calls(torch, {
        "ms": lambda: sagan_attention_cuda(q, k, v),
        "plain_ms": lambda: sagan_attention_plain(q, k, v),
        "library_ms": library,
    }, ("sagan_attention_kernel",))
    nbytes = 4 * (q.numel() + k.numel() + v.numel() + n * lq * dv)
    # the function's two products, each fp32-accurate product three TF32
    # ones on the tensor cores (3xTF32); beside it the fp32-FMA bound of
    # earlier PRs, and this design's floor: s computed once for each slice
    # of dv, at the larger of its 3xTF32 operations and its bytes
    flops = 2 * n * lq * lk * (dk + dv)
    b3["bound_ms"] = max(nbytes / bandwidth, 3 * flops / tf32_peak) * 1e3
    b3["bound_by"] = "bytes" if nbytes / bandwidth >= 3 * flops / tf32_peak else "operations"
    bound_fp32 = max(nbytes / bandwidth, flops / fp32_peak) * 1e3
    slices = -(-dv // 128)
    design_flops = 2 * n * lq * lk * (slices * dk + dv)
    floor = max(nbytes / bandwidth, 3 * design_flops / tf32_peak) * 1e3
    say(f"attention at the path's shape ({shape}), {b3['ms_from']}: device time kernel "
        f"{b3['ms'] * 1e3:.2f} us, plain {b3['plain_ms'] * 1e3:.2f} us, library "
        f"{b3['library_ms'] * 1e3:.2f} us; back to back per call: "
        + ", ".join(f"{k_} {v_ * 1e3:.2f} us" for k_, v_ in issue.items()))
    say(f"  bound {b3['bound_ms'] * 1e3:.2f} us ({b3['bound_by']}: 3 x {flops / 1e9:.3f} GFLOP, the "
        f"function's products in 3xTF32, at {tf32_peak / 1e12:g} TFLOP/s dense TF32; {nbytes / 1e6:.3f} MB "
        f"at {bandwidth / 1e12:.2f} TB/s), {b3['bound_ms'] / b3['ms'] * 100:.1f}% of it; the fp32-FMA "
        f"bound of earlier PRs {bound_fp32 * 1e3:.2f} us ({flops / 1e9:.3f} GFLOP at "
        f"{fp32_peak / 1e12:.0f} TFLOP/s fp32 outside the tensor cores), {bound_fp32 / b3['ms'] * 100:.1f}% "
        f"of it; this design's floor {floor * 1e3:.2f} us (s once for each of {slices} "
        f"slices of dv: 3 x {design_flops / 1e9:.3f} GFLOP), {floor / b3['ms'] * 100:.1f}% of it; "
        f"{flops / b3['ms'] / 1e9:.1f} TFLOP/s of the function, {3 * design_flops / b3['ms'] / 1e9:.1f} "
        "TFLOP/s of TF32 products")
    say(f"  library call: scaled_dot_product_attention(q, k, v, scale=1.0) ran "
        f"{', '.join(name[:80] for name in names['library_ms'])} (max |err| {lib_err:.3e} against "
        "the plain version)")
    b3["library_kernels"] = [name[:100] for name in names["library_ms"]]
    b3["design"] = ("wgmma TF32 in 3xTF32 (hi hi chains of 32 from zero, corrections apart); a block of two "
                    "warpgroups takes 128 query rows and a slice of at most 128 of dv's columns; key tiles "
                    "of 32 staged with cp.async and split in shared memory (v transposed), two stages of "
                    "split tiles at padded dk <= 64")
    b3["times_are"] = (f"one call at the BigGAN-{BIGGAN_SIZE} paths' shape ({shape}), randn inputs; bound_ms "
                       "counts the function's products in 3xTF32 at the dense TF32 rate")

    # B4: dq, dk, dv
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, scale=1.0)
    library = lambda: torch.autograd.grad(sdpa_out, (qg, kg, vg), do, retain_graph=True)  # noqa: E731
    lib_err = max((a - b).abs().max().item() / b.abs().max().item()
                  for a, b in zip(library(), sagan_attention_bwd_plain(q, k, v, o, lse, do)))
    check(lib_err < 1e-4, f"scaled_dot_product_attention's backward differs by {lib_err:.3e} (rel)")
    b4, names, kernels_of, issue = time_calls(torch, {
        "ms": lambda: sagan_attention_bwd_cuda(q, k, v, o, lse, do),
        "plain_ms": lambda: sagan_attention_bwd_plain(q, k, v, o, lse, do),
        "library_ms": library,
    }, B4_SYMBOLS)
    nbytes = 4 * (2 * q.numel() + 2 * k.numel() + 2 * v.numel() + o.numel() + do.numel() + lse.numel())
    # the backward's own products: s = q k^T, dp = do v^T, dv = p^T do,
    # dq = ds k, dk = ds^T q, each fp32-accurate product three TF32 ones on
    # the tensor cores (3xTF32); beside it the fp32-FMA bound of earlier PRs
    flops = 2 * n * lq * lk * (3 * dk + 2 * dv)
    b4["bound_ms"] = max(nbytes / bandwidth, 3 * flops / tf32_peak) * 1e3
    b4["bound_by"] = "bytes" if nbytes / bandwidth >= 3 * flops / tf32_peak else "operations"
    bound_fp32 = max(nbytes / bandwidth, flops / fp32_peak) * 1e3
    # this design's floor: pack (reads q, k, v, do; writes k, v, k^T, q^T
    # and do^T, hi and lo), dq (s, dp, dq; reads q, do, lse, delta and the
    # packed k, v and k^T, writes dq, and p and ds to the scratch) and dkv
    # (dv, dk; reads the scratch and the packed do^T and q^T, writes dk and
    # dv), each at the larger of its 3xTF32 operations and its bytes
    packed = 2 * 4 * (q.numel() + 2 * k.numel() + v.numel() + do.numel())
    scratch = 8 * n * -(-lq // attention.SCRATCH_ROWS) * attention.SCRATCH_ROWS \
        * -(-lk // attention.SCRATCH_KEYS) * attention.SCRATCH_KEYS
    kernels_work = (
        (0, 4 * (q.numel() + k.numel() + v.numel() + do.numel()) + packed),
        (3 * 2 * n * lq * lk * (2 * dk + dv),
         4 * (2 * q.numel() + do.numel() + 2 * lse.numel()) + 2 * 4 * (2 * k.numel() + v.numel()) + scratch),
        (3 * 2 * n * lq * lk * (dk + dv),
         scratch + 2 * 4 * (q.numel() + do.numel()) + 4 * (k.numel() + v.numel())),
    )
    floor = sum(max(ops / tf32_peak, b / bandwidth) for ops, b in kernels_work) * 1e3
    b4["split_ms"] = None
    say(f"attention backward at the path's shape ({shape}), {b4['ms_from']}: device time kernel "
        f"{b4['ms'] * 1e3:.2f} us, plain {b4['plain_ms'] * 1e3:.2f} us, library "
        f"{b4['library_ms'] * 1e3:.2f} us; back to back per call: "
        + ", ".join(f"{k_} {v_ * 1e3:.2f} us" for k_, v_ in issue.items()))
    say(f"  bound {b4['bound_ms'] * 1e3:.2f} us ({b4['bound_by']}: 3 x {flops / 1e9:.3f} GFLOP, the "
        f"function's products in 3xTF32, at {tf32_peak / 1e12:g} TFLOP/s dense TF32; "
        f"{nbytes / 1e6:.3f} MB at {bandwidth / 1e12:.2f} TB/s); the fp32-FMA bound of earlier PRs "
        f"{bound_fp32 * 1e3:.2f} us ({flops / 1e9:.3f} GFLOP at {fp32_peak / 1e12:.0f} "
        f"TFLOP/s fp32 outside the tensor cores); this design's floor {floor * 1e3:.2f} "
        f"us (pack, dq, dkv, each at the larger of its 3xTF32 operations and its bytes: the packed "
        f"operands {packed / 1e6:.3f} MB, the p/ds scratch {scratch / 1e6:.3f} MB)")
    if b4["ms_from"] == "torch.profiler":  # the call's time by kernel
        b4["split_ms"] = {"pack": 0.0, "dq": 0.0, "dkv": 0.0, "delta": 0.0}
        for kname, (ms, _) in sorted(kernels_of["ms"].items(), key=lambda kv: -kv[1][0]):
            say(f"  kernel call's device time: {ms * 1e3:8.2f} us  {kname[:90]}")
            part = next((p_ for p_ in ("pack", "dq", "dkv") if f"attention_{p_}_kernel" in kname), "delta")
            b4["split_ms"][part] += ms
        useful = flops / (b4["split_ms"]["dq"] + b4["split_ms"]["dkv"]) / 1e9
        say("  " + ", ".join(f"{k_} {v_ * 1e3:.2f} us" for k_, v_ in b4["split_ms"].items())
            + f"; the function's {flops / 1e9:.3f} GFLOP at {useful:.1f} TFLOP/s ({3 * useful:.1f} "
            "TFLOP/s of TF32 products) over dq and dkv")
    say(f"  {b4['bound_ms'] / b4['ms'] * 100:.1f}% of the bound, "
        f"{floor / b4['ms'] * 100:.1f}% of the design's floor")
    say(f"  library call: the backward of scaled_dot_product_attention(q, k, v, scale=1.0) ran "
        f"{', '.join(name[:70] for name in names['library_ms'][:6])} (max |err| {lib_err:.3e} "
        "of max |value| against the plain version)")
    say(f"  plain version ran {', '.join(name[:60] for name in names['plain_ms'][:6])}")
    b4["library_kernels"] = [name[:100] for name in names["library_ms"]]
    b4["times_are"] = (f"one call (delta, pack, dq and dkv) at the BigGAN-{BIGGAN_SIZE} case-2 step's "
                       f"shape ({shape}), randn inputs; bound_ms counts the function's products in "
                       "3xTF32 at the dense TF32 rate")
    del sdpa_out, qg, kg, vg
    torch.cuda.empty_cache()
    return b3, b4


def step_times(torch, step, state, label, first, steps=None):
    """Host-clock time of ``steps`` (TIMED_STEPS unless given) train steps,
    each ending in a synchronize, after two warm-up steps; returns the
    median (ms)."""
    lat = []
    for i in range((steps or TIMED_STEPS) + 2):
        t0 = time.perf_counter()
        step(state, first + i)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    lat = sorted(lat[2:])
    say(f"step time, {label} ({len(lat)} steps): median {statistics.median(lat):.3f} ms, "
        f"min {lat[0]:.3f}, max {lat[-1]:.3f}")
    return statistics.median(lat)


def step_device_time(torch, step, state, median, first,
                     symbols=("sagan_attention_kernel",) + B4_SYMBOLS, keep_kernels=False, iters=1):
    """A step's device time by kernel (torch.profiler over ``iters``
    steps, one unless given, the device alone: recording a step's host ops
    costs seconds a trace, and a step's device time varies little), the share of the kernels whose symbols contain ``symbols`` (B3/B4 unless given), and the step's
    peak device memory; with ``keep_kernels`` also every kernel's time and
    count per step by name. Where no trace saw device time, the peak alone,
    with a line."""
    it = iter(range(first, first + 100))
    out = {}
    try:
        kernels = device_kernels(torch, lambda: step(state, next(it)), iters=iters, host=False)
    except MissedLaunches as missed:
        say(f"device time per step: not measured ({missed})")
    else:
        busy = sum(ms for ms, _ in kernels.values())
        say(f"device time per step {busy:.3f} ms over {sum(n for _, n in kernels.values()):.0f} kernels "
            f"and copies = {busy / median * 100:.1f}% of the median step time; by name:")
        for kname, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]:
            say(f"  {ms:8.3f} ms  x{n:5.0f}  {kname[:100]}")
        shares = {}
        for symbol in symbols:
            own = sum(ms for kname, (ms, _) in kernels.items() if symbol in kname)
            shares[symbol] = own
            say(f"  {symbol}: {own:.3f} ms per step, {own / busy * 100:.2f}% of device time")
        out.update(device_ms=busy, kernel_ms=shares)
        if keep_kernels:
            out["kernels"] = kernels
    torch.cuda.reset_peak_memory_stats()
    step(state, next(it))
    torch.cuda.synchronize()
    out["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    say(f"peak device memory of a step: {out['peak_mib']:.1f} MiB")
    return out


def encoder_snapshot(encoder):
    params = {n: p.detach().clone() for n, p in encoder.named_parameters()}
    uv = {n: b.clone() for n, b in encoder.named_buffers() if n.endswith((".u", ".v"))}
    return params, uv


def replay_steps(torch, dev, e_align, forms):
    """One case-2 step of a reduced configuration (BigGAN-deep-BIGGAN_SIZE's
    layout at channel width REPLAY_CHANNEL_WIDTH, E_BIG at
    REPLAY_START_FEATURES, batch BATCH; gamma ATTN_GAMMA, the z head scaled)
    in each of ``forms``, (name, device, bf16), on the same explicit inputs.
    Returns the z head's factor and, by name, loss_tsa, the first gradient
    (of loss_tsa) of REPLAY_LEAVES and the step's seconds."""
    import tempfile

    from tpugan_torch.cli import infer_e
    from tpugan_torch.losses.lpips import random_lpips_fn
    from tpugan_torch.models import BigGANConfig
    from tpugan_torch.ops import cuda
    from tpugan_torch.runtime import resolve_device
    from tpugan_torch.train.e_align import info_scalars

    cfg = BigGANConfig.for_resolution(BIGGAN_SIZE, z_dim=BIGGAN_Z_DIM, channel_width=REPLAY_CHANNEL_WIDTH)
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        config = f"{tmp}/config.json"
        with open(config, "w") as f:
            f.write(cfg.to_json_string())
        argv = ["--mtype", "4", "--img_size", str(BIGGAN_SIZE), "--start_features",
                str(REPLAY_START_FEATURES), "--z_dim", str(BIGGAN_Z_DIM), "--random_init",
                "--config_dir", config, "--case", "2", "--iterations", "1", "--batch_size",
                str(BATCH), "--seed", str(SEED)]
        parser = e_align.make_parser()
        probe = e_align.build_trainer(parser.parse_args(argv + ["--device", "cpu"]))
        zt_std, z2_std = latent_stds(torch, infer_e, probe.bundle, REQUEST_SEEDS[0])
        factor = zt_std / z2_std
        request = infer_e.draw_request(probe.bundle, BATCH, 0)
        del probe
        for name, device, bf16 in forms:
            req = request.to(dev) if device == CARD else request
            args = parser.parse_args(argv + ["--device", device] + (["--bf16"] if bf16 else []))
            lpips = random_lpips_fn(resolve_device(device), dtype=torch.bfloat16 if bf16 else None)
            trainer = e_align.build_trainer(args, lpips, draw=lambda it, r=req: r)
            scale_z_head(torch, trainer.state.encoder, factor)
            set_attention_gamma(torch, trainer.bundle.generator, ATTN_GAMMA)
            names = [n for n, _ in trainer.state.encoder.named_parameters()]
            grads = []
            opt_step = trainer.state.optimizer.step
            trainer.state.optimizer.step = lambda g=None: (grads.append(g), opt_step(g))
            cuda.reset_launches()
            t0 = time.perf_counter()
            _, info = trainer.step(trainer.state, 0)
            if device == CARD:
                torch.cuda.synchronize()
                form, other = ("_bf16", "") if bf16 else ("", "_bf16")
                check(cuda.launches[f"sagan_attention_bwd_dkv{form}"] == 1
                      and cuda.launches[f"sagan_attention{other}"] == 0, f"{name} replay launches {cuda.launches}")
            else:
                check(not any(cuda.launches.values()), "the CPU replay launched a kernel")
            runs[name] = (info_scalars(info)["loss_tsa"],
                          {n: grads[0][names.index(n)].detach().cpu() for n in REPLAY_LEAVES},
                          time.perf_counter() - t0)
            del trainer
    return factor, runs


def replay_case2_on_cpu(torch, dev, e_align):
    """replay_steps on the card and on the CPU, in fp32: loss_tsa and the
    first gradients within REPLAY_LOSS_RTOL and REPLAY_GRAD_TOL."""
    factor, runs = replay_steps(torch, dev, e_align, (("card", CARD, False), ("cpu", "cpu", False)))
    (loss_g, grads_g, sec_g), (loss_c, grads_c, sec_c) = runs["card"], runs["cpu"]
    say(f"replay of a case-2 step on the CPU: BigGAN-deep-{BIGGAN_SIZE}'s layout at channel width "
        f"{REPLAY_CHANNEL_WIDTH}, E_BIG at start_features {REPLAY_START_FEATURES}, batch {BATCH}, "
        f"random LPIPS, gamma {ATTN_GAMMA:g}, z head scaled by {factor:.4e}; the step took "
        f"{sec_g:.2f} s on the card (first call) and {sec_c:.2f} s on the CPU")
    loss_err = abs(loss_g - loss_c) / abs(loss_c)
    say(f"  loss_tsa cuda {loss_g:.6f}, cpu {loss_c:.6f}: rel err {loss_err:.3e} (limit {REPLAY_LOSS_RTOL:g})")
    check(math.isfinite(loss_c) and loss_err <= REPLAY_LOSS_RTOL, "the replayed loss_tsa disagrees")
    for name in REPLAY_LEAVES:
        g, c = grads_g[name], grads_c[name]
        scale = c.abs().max().item()
        err = (g - c).abs().max().item()
        say(f"  first gradient (of loss_tsa) of {name}: max |err| {err:.3e} against max |g| "
            f"{scale:.3e} (limit {REPLAY_GRAD_TOL:g} of it)")
        check(scale > 0 and err <= REPLAY_GRAD_TOL * scale, f"the replayed gradient of {name} disagrees")


def training_path(torch, dev, smi):
    """Phase 6: the E_BIG train step (mtype 4, full width, batch 2). Returns
    the attention backward's launches on the path and its max |err|."""
    from tpugan_torch.cli import e_align, infer_e
    from tpugan_torch.losses.lpips import random_lpips_fn
    from tpugan_torch.ops import attention, cuda
    from tpugan_torch.ops.attention import sagan_attention_bwd_cuda
    from tpugan_torch.train.e_align import info_scalars

    parser = e_align.make_parser()
    argv = ["--mtype", "4", "--img_size", str(BIGGAN_SIZE), "--start_features", "64",
            "--z_dim", str(BIGGAN_Z_DIM), "--random_init", "--iterations", "1000",
            "--batch_size", str(BATCH), "--seed", str(SEED), "--device", CARD]
    lpips = random_lpips_fn(dev)
    seed = REQUEST_SEEDS[0]

    # the CLI's own weights: one case-2 step
    t0 = time.perf_counter()
    trainer = e_align.build_trainer(parser.parse_args(argv + ["--case", "2"]), lpips)
    torch.cuda.synchronize()
    say(f"trainer: mtype 4, case 2, BigGAN-deep-{BIGGAN_SIZE} frozen + E_BIG (startf 64) training, "
        f"built in {time.perf_counter() - t0:.2f} s")
    zt_std, z2_std = latent_stds(torch, infer_e, trainer.bundle, seed)
    factor = zt_std / z2_std
    _, info = trainer.step(trainer.state, 0)
    scalars = info_scalars(info)
    params_finite = all(bool(torch.isfinite(p).all()) for p in trainer.state.encoder.parameters())
    say(f"case 2 on the CLI's weights (flax's init, every gamma 0, z2 std {z2_std:.4f}): loss_tsa "
        f"{scalars['loss_tsa']}, loss_mtv {scalars['loss_mtv']}; E_BIG's parameters finite after "
        f"the step: {params_finite} (the resynthesis overflows fp32, in tpugan too)")
    del trainer, info

    # case 2 with the attention in the images and a z2 of zt's spread
    trainer = e_align.build_trainer(parser.parse_args(argv + ["--case", "2"]), lpips)
    state, gen = trainer.state, trainer.bundle.generator
    scale_z_head(torch, state.encoder, factor)
    check(set_attention_gamma(torch, gen, ATTN_GAMMA) == 1, "expected one SelfAttn")
    say(f"case 2 from here on: every SelfAttn gamma {ATTN_GAMMA:g}, E_BIG's z head scaled by "
        f"{factor:.4e}")
    captured = []
    real_bwd = attention.sagan_attention_bwd_cuda

    def capture(*args):
        captured.append(tuple(x.detach().clone() for x in args))
        return real_bwd(*args)

    attention.sagan_attention_bwd_cuda = capture
    try:
        trainer.step(state, 1)
    finally:
        attention.sagan_attention_bwd_cuda = real_bwd
    check(len(captured) == 1, f"a case-2 step ran the attention backward {len(captured)} times")
    q, k, v, o, lse, do = captured[0]
    scores = torch.bmm(q, k.transpose(1, 2)).abs().max().item()
    say(f"the step's own backward inputs: q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}, "
        f"max |q k^T| {scores:.2f}, max |do| {do.abs().max().item():.3e}")
    check(do.abs().max().item() > 0, "the attention's upstream gradient is zero")
    bwd_err = compare_attention_bwd(torch, "attention backward, the case-2 step's own inputs",
                                    q, k, v, o, lse, do)
    first, again = (sagan_attention_bwd_cuda(q, k, v, o, lse, do) for _ in range(2))
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(first, again)),
          "two runs of the attention backward on the same inputs differ")
    say("attention backward, the case-2 step's own inputs: two runs bitwise equal (no atomics; the "
        "cluster sums in rank order)")
    del first, again

    # the main path: counted steps
    params0, uv0 = encoder_snapshot(state.encoder)
    gen0 = [p.detach().clone() for p in gen.parameters()]
    lse_flags = []
    real_fwd = attention.sagan_attention_cuda

    def spy(q_, k_, v_, return_lse=False):
        lse_flags.append(return_lse)
        return real_fwd(q_, k_, v_, return_lse)

    attention.sagan_attention_cuda = spy
    cuda.reset_launches()
    try:
        for it in range(2, 2 + TRAIN_STEPS):
            _, info = trainer.step(state, it)
            scalars = info_scalars(info)
            check(all(math.isfinite(x) for x in scalars.values()), f"case-2 step {it}: a loss is not finite")
    finally:
        attention.sagan_attention_cuda = real_fwd
    torch.cuda.synchronize()
    launches = dict(cuda.launches)
    want = expected_launches(sagan_attention=2 * TRAIN_STEPS, sagan_attention_bwd_pack=TRAIN_STEPS,
                             sagan_attention_bwd_dq=TRAIN_STEPS, sagan_attention_bwd_dkv=TRAIN_STEPS)
    check(launches == want, f"case-2 launches {launches}, expected {want}")
    b4_launches = sum(launches[name] for name in B4_KERNELS)
    check(lse_flags == [False, True] * TRAIN_STEPS, f"forward forms per step {lse_flags}")
    moved = sum(not torch.equal(p, params0[n]) for n, p in state.encoder.named_parameters())
    uv_moved = sum(not torch.equal(b, uv0[n]) for n, b in state.encoder.named_buffers() if n in uv0)
    check(moved == len(params0) and uv_moved == len(uv0), f"E_BIG moved {moved}/{len(params0)} "
          f"parameters and {uv_moved}/{len(uv0)} u/v buffers")
    check(all(torch.equal(a, b) and b.grad is None for a, b in zip(gen0, gen.parameters())),
          "the frozen BigGAN moved")
    say(f"case-2 path: {TRAIN_STEPS} steps, launches {launches} (per step: the synthesis's forward "
        f"without lse, the resynthesis's with lse, one pack, one dq and one dkv); loss_tsa "
        f"{scalars['loss_tsa']:.4f}, loss_mtv {scalars['loss_mtv']:.4f}; all {moved} E_BIG parameters and "
        f"{uv_moved} u/v "
        f"buffers moved, BigGAN's {len(gen0)} did not")
    del gen0

    say(f"training times below: {smi}; step times from the host clock, device times from torch.profiler")
    times = {}
    median = step_times(torch, trainer.step, state, "case 2, fp32, TF32 off", 100)
    times["case 2"] = {"median_ms": median, **step_device_time(torch, trainer.step, state, median, 200)}

    del trainer, state
    torch.cuda.empty_cache()

    # case 1 and its lean step, as scripts/bench_biggan256.py measures them:
    # the CLI's weights, random-weight LPIPS
    trainer = e_align.build_trainer(parser.parse_args(argv + ["--case", "1"]), lpips)
    state = trainer.state
    params0, uv0 = encoder_snapshot(state.encoder)
    for label, step, per_step in (("full", trainer.step, 2), ("lean", trainer.lean, 1)):
        cuda.reset_launches()
        for it in range(TRAIN_STEPS):
            _, info = step(state, 300 + it)
        torch.cuda.synchronize()
        launches = dict(cuda.launches)
        want = expected_launches(sagan_attention=per_step * TRAIN_STEPS)
        check(launches == want, f"case-1 {label} launches {launches}, expected {want}")
        scalars = info_scalars(info)
        check(math.isfinite(scalars["loss_mtv"]), f"case-1 {label}: loss_mtv is not finite")
        images = [key for key in scalars if key.startswith(("loss_imgs", "loss_medium", "loss_small"))]
        say(f"case-1 {label} path: {TRAIN_STEPS} steps, launches {launches}; loss_mtv "
            f"{scalars['loss_mtv']:.4f}; {sum(math.isfinite(scalars[k_]) for k_ in images)} of "
            f"{len(images)} log-only image scalars finite on the CLI's weights")
    moved = sum(not torch.equal(p, params0[n]) for n, p in state.encoder.named_parameters())
    check(moved > 0 and all(bool(torch.isfinite(p).all()) for p in state.encoder.parameters()),
          "case 1 did not train E_BIG, or left it not finite")
    median = step_times(torch, trainer.step, state, "case 1 full, fp32, TF32 off", 400)
    times["case 1"] = {"median_ms": median, **step_device_time(torch, trainer.step, state, median, 500)}
    median = step_times(torch, trainer.lean, state, "case 1 lean, fp32, TF32 off", 600)
    times["case 1 lean"] = {"median_ms": median, **step_device_time(torch, trainer.lean, state, median, 700)}
    del trainer, state
    torch.cuda.empty_cache()

    with cudnn_deterministic(torch):  # the comment at CPU_GPU_ATOL
        replay_case2_on_cpu(torch, dev, e_align)
    return {"launches": b4_launches, "max_abs_err": bwd_err, "times": times}


def contract_cases():
    """The FIR cases held to the plain version: the path's blurs, the Pallas
    kernels' contract cases, the rest of the kernel's contract, the tiled
    design's edges and slice 3's FIRs, as (label, up, down, taps, pad, NHWC
    shape, gain)."""
    cases = [(f"blur {c}x{r}x{r}", 1, 1, (1, 2, 1), (1, 1), (BATCH, r, r, c), 1.0)
             for c, r in PATH_BLURS]
    cases += [(f"B1 up{u} down{d}", u, d, t, p, s, 1.0) for u, d, t, p, s in B1_CASES]
    cases += [("B2", 1, 1, t, p, s, 1.0) for t, p, s in B2_CASES]
    cases += [(f"up{u} down{d} gain{g:g}", u, d, t, p, s, g) for u, d, t, p, s, g in EXTRA_CASES]
    cases += list(TILE_CASES)
    cases += [(label, u, d, t, p, (n, h, w, c), g) for label, u, d, t, p, (n, c, h, w), g in SLICE3_FIRS]
    return cases


def fir_parity(torch, dev, gen):
    """The FIR kernel against its plain version on the path's blurs, the
    Pallas kernels' contract cases, the tiled design's edges and slice 3's
    FIRs at their sizes; out-of-contract calls and plans refused. Returns
    the max |err|."""
    from tpugan_torch.ops import cuda, upfirdn
    from tpugan_torch.ops.upfirdn import setup_fir_kernel, upfirdn2d_cuda, upfirdn2d_plain

    cases = contract_cases()
    max_err = 0.0
    cuda.reset_launches()
    for label, up, down, taps, pad, (n, h, w, c), gain in cases:
        x = torch.randn(n, c, h, w, device=dev, generator=gen)
        taps = setup_fir_kernel(taps)
        kh, kw = taps.shape
        plan = upfirdn.fir_plan(n * c, h, w, up, down, pad[0], kh, kw, (h * up + sum(pad) - kh) // down + 1,
                                (w * up + sum(pad) - kw) // down + 1, min_blocks=upfirdn.min_blocks(dev))
        label = (f"{label} taps{taps.shape[0]}x{taps.shape[1]} pad{pad} NCHW{(n, c, h, w)} (strips "
                 f"{plan.rh}x{plan.rw}, tile {plan.tile_rows}x{plan.tile_cols}, {plan.planes_per_block} "
                 f"plane(s) a block, {plan.blocks} blocks, {'16' if plan.vec else '4'}-byte copies)")
        got = upfirdn2d_cuda(x, taps, up, down, pad, gain)
        want = upfirdn2d_plain(x, taps, up, down, pad, gain)
        torch.cuda.synchronize()
        check(got.shape == want.shape, f"{label}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
        err = (got - want).abs().max().item()
        max_err = max(max_err, err)
        check(torch.allclose(got, want, rtol=KERNEL_TOL, atol=KERNEL_TOL),
              f"{label}: kernel disagrees with plain version, max |err| {err:.3e}")
        say(f"parity {label}: max |err| {err:.3e}")
        del x, got, want
    check(cuda.launches["upfirdn2d"] == len(cases), f"launch count {cuda.launches} != {len(cases)}")
    blur = setup_fir_kernel((1, 2, 1))
    x = torch.randn(1, 4, 8, 8, device=dev, generator=gen)
    refused = [
        lambda: upfirdn2d_cuda(x.half(), blur, pad=(1, 1)),
        lambda: upfirdn2d_cuda(x.transpose(2, 3), blur, pad=(1, 1)),
        lambda: upfirdn2d_cuda(x, blur, up=3, pad=(1, 1)),
        lambda: upfirdn2d_cuda(x, setup_fir_kernel([1.0] * 9), pad=(4, 4)),
        lambda: upfirdn2d_cuda(x, blur, pad=(-1, 1)),
    ]
    for i, call in enumerate(refused):
        try:
            call()
        except (TypeError, ValueError):
            continue
        raise RuntimeError(f"chip_smoke: out-of-contract call {i} was not refused")
    # plans the kernel cannot run, handed to the C entry point: it refuses
    # them (cudaErrorInvalidValue) and launches nothing
    fields = list(upfirdn.FirPlan.__dataclass_fields__)
    y = torch.full_like(x, 7.0)
    taps = upfirdn._taps(blur, 1.0)
    good = upfirdn.fir_plan(4, 8, 8, 1, 1, 1, 3, 3, 8, 8, min_blocks=upfirdn.min_blocks(dev)).as_array()
    bad_plans = {"a staged row short": ("in_rows", -1), "threads short": ("threads", -32),
                 "a tile row short": ("tile_rows", -4), "odd phase at up 1": ("phase", 1)}
    for name, (field, delta) in bad_plans.items():
        plan = good.copy()
        plan[fields.index(field)] += delta
        rc = launch_plan(torch, x, y, taps, 1, 1, 1, plan)
        check(rc == 1, f"the C entry point took a plan with {name} (rc {rc})")
    torch.cuda.synchronize()
    check(bool((y == 7.0).all()), "a refused plan wrote the output")
    check(cuda.launches["upfirdn2d"] == len(cases), "a refused call launched")
    say(f"parity: {len(cases)} cases within {KERNEL_TOL:g} (max |err| {max_err:.3e}); "
        f"{len(refused)} out-of-contract calls and {len(bad_plans)} plans refused "
        f"({', '.join(bad_plans)})")
    return max_err


def fir_adjoint(torch, dev, gen, bandwidth):
    """The FIR's gradient (upfirdn2d's adjoint, one more launch of the
    kernel) against torch.autograd of the plain version, within
    KERNEL_TOL, at the path's blur shapes, slice 3's FIRs and ADJOINT_CASES;
    the adjoint alone timed at the blur and slice-3 shapes. Returns the max
    |err| and the timed rows."""
    import numpy as np

    from tpugan_torch.ops import cuda, upfirdn
    from tpugan_torch.ops.upfirdn import setup_fir_kernel, upfirdn2d, upfirdn2d_plain

    cases = [(f"blur {c}x{r}x{r}", 1, 1, (1, 2, 1), (1, 1), (BATCH, c, r, r), 1.0, True)
             for c, r in PATH_BLURS]
    cases += [(*case, True) for case in SLICE3_FIRS]
    cases += [(*case, False) for case in ADJOINT_CASES]
    max_err, rows = 0.0, []
    for label, up, down, taps, pad, shape, gain, timed in cases:
        k = np.asarray(taps, np.float32)
        k = setup_fir_kernel(taps) if k.ndim == 1 else k / k.sum()
        x = torch.randn(shape, device=dev, generator=gen).requires_grad_()
        cuda.reset_launches()
        upfirdn.reset_layout_launches()
        y = upfirdn2d(x, k, up, down, pad, gain)
        fwd = dict(upfirdn.layout_launches)
        g = torch.randn(y.shape, device=dev, generator=gen)
        (got,) = torch.autograd.grad(y, x, g)
        torch.cuda.synchronize()
        adj = {key: n - fwd[key] for key, n in upfirdn.layout_launches.items()}
        check(cuda.launches["upfirdn2d"] == 2, f"{label}: {cuda.launches['upfirdn2d']} FIR launches, not 2")
        xr = x.detach().requires_grad_()
        (want,) = torch.autograd.grad(upfirdn2d_plain(xr, k, up, down, pad, gain), xr, g)
        err = (got - want).abs().max().item()
        max_err = max(max_err, err)
        check(torch.allclose(got, want, rtol=KERNEL_TOL, atol=KERNEL_TOL),
              f"adjoint {label}: the kernel's gradient disagrees with the plain version's, "
              f"max |err| {err:.3e}")
        n, c, h, w = shape
        adjoint = upfirdn.adjoint(h, w, y.shape[2], y.shape[3], upfirdn._taps(k, gain), up, down,
                                  (pad[0], pad[1], pad[0], pad[1]))
        key = next(key_ for key_, n_ in adj.items() if n_)
        msg = (f"adjoint {label} taps{k.shape[0]}x{k.shape[1]} up{up} down{down} pad{pad} NCHW{shape}: "
               f"max |err| {err:.3e}; forward on {[k_ for k_, n_ in fwd.items() if n_]}, adjoint (up "
               f"{adjoint[1]}, down {adjoint[2]}, pads {adjoint[3]}) on {key}")
        if timed:
            with torch.no_grad():
                fn = lambda: upfirdn._fir(g, *adjoint)  # noqa: E731
                ms, _, ms_from = kernel_ms(torch, fn, ("upfirdn2d_kernel",))
            bound = 4 * (g.numel() + x.numel()) / bandwidth * 1e3
            rows.append({"label": label, "shape": list(shape), "up": up, "down": down, "pad": list(pad),
                         "kernel": key, "ms": ms, "ms_from": ms_from, "bound_ms": bound})
            msg += f"; the adjoint alone {ms * 1e3:.2f} us ({ms_from}), bound {bound * 1e3:.2f} us (bytes)"
        say(msg)
        del x, y, g, got, want, xr
    torch.cuda.empty_cache()
    say(f"FIR adjoint parity: {len(cases)} cases within {KERNEL_TOL:g} of autograd of the plain "
        f"version (max |err| {max_err:.3e}), one forward and one adjoint launch each")
    return max_err, rows


def sgv1_gradient(torch, dev, parser, argv):
    """A full-width gradient through SGv1 Cat256's G -> E_Blur -> G: an MSE
    between the resynthesis and the first pass, differentiated with respect
    to every parameter of E_Blur (the case-2 encoder, a blur in every
    block), from the same explicit inputs (the first pass's images drawn on
    the CPU) on the card, on the CPU and on the CPU in float64, with the FIR
    launches of the forward and of the backward counted on the card.

    The reference is the float64 run: the gradient is ill-conditioned at
    this size (the CPU's own fp32 gradient is about 1e-2 from it here, 7e-4
    at 128 px, 1e-6 at 32 px), so the card's fp32 gradient is held within
    CPU_GPU_ATOL or twice the CPU's fp32 error of it, whichever is larger.
    Returns the launch counts."""
    from tpugan_torch.cli import common, infer_e
    from tpugan_torch.ops import cuda, upfirdn

    bundles = []
    for device in (CARD, "cpu"):
        args = parser.parse_args(argv + ["--device", device])
        args.case = 2  # E_Blur
        bundles.append(common.build_bundle(args))
    request = infer_e.draw_request(bundles[1], BATCH, REQUEST_SEEDS[0])
    imgs = bundles[1].synth(request.z, request.noise_g).imgs1.permute(0, 3, 1, 2).contiguous()
    runs = []
    for bundle, device, dtype in ((bundles[0], dev, torch.float32), (bundles[1], "cpu", torch.float32),
                                  (bundles[1], "cpu", torch.float64)):
        bundle.encoder.to(dtype)
        bundle.generator.to(dtype)
        cast = lambda blocks: [tuple(n.to(device, dtype) for n in b_) for b_ in blocks]  # noqa: E731
        x = imgs.to(device, dtype)
        cuda.reset_launches()
        upfirdn.reset_layout_launches()
        _, w2 = bundle.encoder(x, cast(request.noise_e))
        imgs2 = bundle.generator(w2, bundle.layer_count - 1, cast(request.noise_g2))
        loss = (imgs2 - x).square().mean()
        fwd = (cuda.launches["upfirdn2d"], dict(upfirdn.layout_launches))
        names, params = zip(*bundle.encoder.named_parameters())
        grads = torch.autograd.grad(loss, params)
        if device == dev:
            torch.cuda.synchronize()
        adj = (cuda.launches["upfirdn2d"] - fwd[0],
               {key: n - fwd[1][key] for key, n in upfirdn.layout_launches.items()})
        runs.append((loss.item(), [g_.detach().double().cpu() for g_ in grads], fwd, adj))
        del w2, imgs2, loss, grads
    (loss_g, grads_g, fwd, adj), (loss_c, grads_c, fwd_c, adj_c), (loss_r, grads_r, _, _) = runs
    check(fwd_c[0] == adj_c[0] == 0, "the CPU's gradient launched the kernel")
    blocks = sum(bundles[1].encoder.fused)
    say(f"SGv1 Cat256 G -> E_Blur -> G gradient (batch {BATCH}, MSE of the resynthesis against the "
        f"first pass, {len(names)} E_Blur parameters): FIR launches forward {fwd[0]} {fwd[1]}, "
        f"adjoint {adj[0]} {adj[1]} ({len(PATH_BLURS)} in G's resynthesis, the rest in E_Blur's "
        f"{bundles[1].layer_count} blocks, {blocks} with fused downsampling)")
    check(fwd[0] > len(PATH_BLURS) and adj == fwd, "the backward's FIR launches are not the forward's, one "
          "adjoint for each FIR (the blur at pad (1, 1) is its own adjoint, so under the same TPU kernel)")
    scale = max(r.abs().max().item() for r in grads_r)
    errs = {}
    for label, loss, grads in (("cuda", loss_g, grads_g), ("cpu fp32", loss_c, grads_c)):
        worst = max(zip(((a - r).abs().max().item() for a, r in zip(grads, grads_r)), names))
        errs[label] = worst[0]
        say(f"  {label} vs cpu float64: loss {loss:.6f} against {loss_r:.6f} (rel err "
            f"{abs(loss - loss_r) / abs(loss_r):.3e}); gradients max |err| {worst[0]:.3e} (at {worst[1]}) "
            f"against max |g| {scale:.3e}")
    limit = max(CPU_GPU_ATOL, 2 * errs["cpu fp32"])
    check(abs(loss_g - loss_r) / abs(loss_r) <= REPLAY_LOSS_RTOL and scale > 0 and errs["cuda"] <= limit,
          f"the card's SGv1 gradient is {errs['cuda']:.3e} from float64, over {limit:.3e}")
    say(f"  the card's gradient within {limit:.3e} of float64 (CPU_GPU_ATOL {CPU_GPU_ATOL:g}, or twice the "
        "CPU fp32 run's own error)")
    del bundles
    return {"forward": fwd[0], "adjoint": adj[0], "adjoint_by_tpu_kernel": adj[1]}


def launch_plan(torch, x, y, taps, up, down, pad0, plan):
    """The FIR kernel's C entry point of x's dtype on ``plan`` (an int
    array), uncounted: for plans that upfirdn2d_cuda would not make.
    Returns its cudaError."""
    from tpugan_torch.ops import cuda, upfirdn

    n, c, h, w = x.shape
    kh, kw = taps.shape
    return cuda.kernel(upfirdn.KERNEL_OF_DTYPE[x.dtype])(
        x.data_ptr(), y.data_ptr(), n * c, h, w, y.shape[2], y.shape[3], up, down, pad0, kh, kw,
        taps.ctypes.data, plan.ctypes.data, x.device.index, torch.cuda.current_stream(x.device).cuda_stream)


def flushed_ms(torch, fn, flush, expect):
    """Device time per call of ``fn`` with L2 flushed before each call by a
    write of ``flush`` (FLUSH_BYTES, five times the L2), from torch.profiler
    over 20 (write, call) pairs with the write's fill kernel left out; the
    wrapper's host time per call is longer than the write, so CUDA events
    around a call would time the host. None, with a line, where every trace
    saw no device time or missed launches of a kernel in ``expect``."""
    try:
        kernels = device_kernels(torch, lambda: (flush.zero_(), fn()), iters=20, expect=expect)
    except MissedLaunches as missed:
        say(f"profiler: L2-flushed calls of {list(expect)}: {missed}")
        return None
    return sum(ms for name, (ms, _) in kernels.items() if "FillFunctor" not in name)


def fir_row(torch, calls, nbytes, flops, bandwidth, fp32_peak):
    """Device times (ms) of the kernel, plain and library calls in ``calls``
    (a library call where given), each with its source (``kernel_ms``), and
    the bound of one call."""
    row = {}
    for key, fn in calls.items():
        row[key], _, row[f"{key}_from"] = kernel_ms(torch, fn, ("upfirdn2d_kernel",) if key == "ms" else ())
    row["bound_ms"] = max(nbytes / bandwidth, flops / fp32_peak) * 1e3
    row["bound_by"] = "bytes" if nbytes / bandwidth >= flops / fp32_peak else "operations"
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    return row


def fir_times(torch, dev, gen, bandwidth, fp32_peak):
    """The FIR kernel at the path's six blur shapes beside its plain version,
    cuDNN's depthwise conv and its bound, and with the other strip width
    (1 and 4 columns); the largest two also with L2 flushed; B1's and B2's
    sums; and, for the record, slice 3's FIRs. Timed before any path is
    profiled: traces taken after the paths' profiled requests miss launches.
    Returns the kernel table's timing keys (the caller adds B1's and B2's
    launches on the main path)."""
    import torch.nn.functional as F

    from tpugan_torch.ops import upfirdn
    from tpugan_torch.ops.upfirdn import setup_fir_kernel, upfirdn2d_cuda, upfirdn2d_plain

    blur = setup_fir_kernel((1, 2, 1))
    flush = torch.empty(FLUSH_BYTES // 4, device=dev)
    rows = []
    for c, r in PATH_BLURS:
        x = torch.randn(BATCH, c, r, r, device=dev, generator=gen)
        w = torch.from_numpy(blur).to(dev).expand(c, 1, 3, 3).contiguous()
        got = upfirdn2d_cuda(x, blur, pad=(1, 1))
        check(torch.allclose(F.conv2d(x, w, padding=1, groups=c), got, rtol=KERNEL_TOL,
                             atol=KERNEL_TOL), f"library call differs at {c}x{r}")
        calls = {
            "ms": lambda: upfirdn2d_cuda(x, blur, pad=(1, 1)),
            "plain_ms": lambda: upfirdn2d_plain(x, blur, pad=(1, 1)),
            "library_ms": lambda: F.conv2d(x, w, padding=1, groups=c),
        }
        nbytes = 2 * x.numel() * x.element_size()
        plan = upfirdn.fir_plan(BATCH * c, r, r, 1, 1, 1, 3, 3, r, r, min_blocks=upfirdn.min_blocks(dev))
        row = {"shape": [BATCH, c, r, r], "kernel": upfirdn.tpu_layout(c, 1, 1, 3, 3),
               **fir_row(torch, calls, nbytes, 2 * 9 * x.numel(), bandwidth, fp32_peak),
               "plan": {k: getattr(plan, k) for k in ("rw", "tile_rows", "tile_cols",
                                                       "planes_per_block", "blocks", "threads")}}
        # the same blur with the other strip width, through the C entry point
        other = upfirdn.fir_plan(BATCH * c, r, r, 1, 1, 1, 3, 3, r, r, min_blocks=upfirdn.min_blocks(dev),
                                 rw=5 - plan.rw).as_array()
        y = torch.empty_like(x)
        taps = upfirdn._taps(blur, 1.0)
        check(launch_plan(torch, x, y, taps, 1, 1, 1, other) == 0, f"strips of {5 - plan.rw} at {c}x{r}")
        torch.cuda.synchronize()
        check(torch.allclose(y, got, rtol=KERNEL_TOL, atol=KERNEL_TOL),
              f"strips of {5 - plan.rw} at {c}x{r} differ from strips of {plan.rw}")
        row["other_strip_ms"], _, row["other_strip_ms_from"] = kernel_ms(
            torch, lambda: launch_plan(torch, x, y, taps, 1, 1, 1, other), ("upfirdn2d_kernel",))
        issue = {key: time_ms(torch, fn) for key, fn in calls.items()}
        flushed = ""
        if (c, r) in FLUSHED_BLURS:
            try:
                library = tuple(device_kernels(torch, calls["library_ms"], iters=5))
            except MissedLaunches as missed:
                library = tuple(missed.found)
            row["flushed_ms"] = flushed_ms(torch, calls["ms"], flush, ("upfirdn2d_kernel",))
            row["library_flushed_ms"] = flushed_ms(torch, calls["library_ms"], flush, library)
            flushed = "; L2 flushed: " + ", ".join(
                f"{name} {'not measured' if v is None else f'{v * 1e3:.2f} us'}" for name, v in
                (("kernel", row["flushed_ms"]), ("library", row["library_flushed_ms"])))
        rows.append(row)
        say(f"blur {c}x{r}x{r} ({row['kernel']}): device time kernel {row['ms'] * 1e3:.2f} us, plain "
            f"{row['plain_ms'] * 1e3:.2f} us, library {row['library_ms'] * 1e3:.2f} us; bound "
            f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}, {nbytes / 1e6:.3f} MB), "
            f"{row['share_of_bound'] * 100:.1f}% of it{flushed}; plan {row['plan']}; strips of "
            f"{5 - plan.rw} column(s) {row['other_strip_ms'] * 1e3:.2f} us; back to back per call: "
            + ", ".join(f"{k} {v * 1e3:.2f} us" for k, v in issue.items()))
        del x, w, got, y
    keys = ("ms", "plain_ms", "library_ms", "bound_ms")
    per_decode = {k: sum(r[k] for r in rows) for k in keys}
    split = {name: {k: sum(r[k] for r in rows if r["kernel"] == name) for k in keys}
             for name in ("B1", "B2")}
    say(f"per decode ({len(PATH_BLURS)} blurs): kernel {per_decode['ms'] * 1e3:.2f} us, plain "
        f"{per_decode['plain_ms'] * 1e3:.2f} us, library {per_decode['library_ms'] * 1e3:.2f} us, "
        f"bound {per_decode['bound_ms'] * 1e3:.2f} us; " + "; ".join(
            f"{name} ({sum(r['kernel'] == name for r in rows)} shapes) kernel {p_['ms'] * 1e3:.2f} us, "
            f"library {p_['library_ms'] * 1e3:.2f} us, bound "
            f"{p_['bound_ms'] * 1e3:.2f} us" for name, p_ in split.items()))

    record = []
    for label, up, down, taps, pad, shape, gain in SLICE3_FIRS:
        x = torch.randn(shape, device=dev, generator=gen)
        k = setup_fir_kernel(taps)
        out = upfirdn2d_cuda(x, k, up, down, pad, gain)
        calls = {
            "ms": lambda: upfirdn2d_cuda(x, k, up, down, pad, gain),
            "plain_ms": lambda: upfirdn2d_plain(x, k, up, down, pad, gain),
        }
        nbytes = 4 * (x.numel() + out.numel())
        flops = 2 * out.numel() * k.size // (up * up)  # the taps on real samples
        row = {"label": label, "shape": list(shape), "up": up, "down": down, "taps": len(taps),
               "pad": list(pad), "gain": gain,
               **fir_row(torch, calls, nbytes, flops, bandwidth, fp32_peak)}
        record.append(row)
        say(f"record only, {label} {list(shape)} up{up} down{down} taps{len(taps)} pad{pad}: kernel "
            f"{row['ms'] * 1e3:.2f} us, plain {row['plain_ms'] * 1e3:.2f} us, bound "
            f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}, {nbytes / 1e6:.3f} MB), "
            f"{row['share_of_bound'] * 100:.1f}% of it")
        del x, out
    del flush
    torch.cuda.empty_cache()
    return {
        "ms": per_decode["ms"],
        "plain_ms": per_decode["plain_ms"],
        "bound_ms": per_decode["bound_ms"],
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rows) else "operations",
        "library_ms": per_decode["library_ms"],
        "times_are": f"sum over the {len(PATH_BLURS)} blur shapes of one decode at batch {BATCH}; "
                     "B1 and B2 split them as tpugan's dispatch does, and each one's launches are "
                     "the main path's, counted by that key (upfirdn.layout_launches)",
        "split": split,
        "per_shape": rows,
        "record_only": record,
    }


def sg2_decode_firs(generator):
    """One StyleGAN2 decode's FIR launches by the TPU kernel that tpugan's
    dispatch gives each (``upfirdn.tpu_layout``), derived from the
    generator's layers: the 4-tap FIR after each up-sampling conv, on its
    output channels, and in the skip architecture the image's up-2 before
    each ToRGB layer but the first, on the image's channels."""
    from tpugan_torch.models.stylegan2 import ModulatedConv, SG2ConvBlock
    from tpugan_torch.ops import upfirdn

    synthesis = generator.synthesis
    keys = [upfirdn.tpu_layout(m.weight.shape[0], 1, 1, 4, 4) for m in synthesis.modules()
            if isinstance(m, (ModulatedConv, SG2ConvBlock)) and m.scale_factor == 2]
    if synthesis.architecture == "skip":
        outputs = [m for name, m in synthesis.named_children() if name.startswith("output")]
        keys += [upfirdn.tpu_layout(m.weight.shape[0], 2, 1, 4, 4) for m in outputs[1:]]
    return {key: keys.count(key) for key in upfirdn.layout_launches}


def queued_ms(torch, fn, flush=None, iters=20):
    """Device time per call of ``fn``: CUDA events around ``iters`` calls
    that the host queues behind a device-side sleep (``torch.cuda._sleep``)
    three times as long as the host took to launch them, so that the events
    time the device and not the host, however small the call. (After the
    paths' profiled requests and steps, torch.profiler's traces of single
    calls saw no device time.) With ``flush``, a write of it (L2 flushed)
    comes before each call, and the writes' own time, taken the same way,
    is subtracted."""
    def run(step):
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(3 * host_ms * SLEEP_CYCLES_PER_MS))
        start.record()
        for _ in range(iters):
            step()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    if flush is None:
        return run(fn)
    return run(lambda: (flush.zero_(), fn())) - run(flush.zero_)


def sg2_fir_times(torch, dev, captured, bandwidth, fp32_peak):
    """The FIR kernel on the SG2 path's own inputs (``captured``: one input
    of each distinct FIR of a decode): held to its plain version within
    KERNEL_TOL, and timed (``queued_ms``) warm and with L2 flushed beside
    its plain version, one library call (``F.conv2d(..., groups=C)`` for
    the same-size FIR, a depthwise ``F.conv_transpose2d`` for the image's
    up-2, each checked against the kernel first) and its bound. Returns the
    rows and the max |err|."""
    import torch.nn.functional as F

    from tpugan_torch.models.stylegan2 import _FIR
    from tpugan_torch.ops import upfirdn
    from tpugan_torch.ops.upfirdn import upfirdn2d_cuda, upfirdn2d_plain

    flush = torch.empty(FLUSH_BYTES // 4, device=dev)
    rows, max_err = [], 0.0
    for (shape, up, down, pad, gain), x in sorted(captured.items(), key=lambda kv: (kv[0][1], kv[0][0])):
        n, c, h, w = shape
        taps = torch.from_numpy(_FIR * gain).to(dev)
        if (up, down, pad) == (1, 1, (1, 1)):
            weight = taps.expand(c, 1, *taps.shape).contiguous()
            library = lambda: F.conv2d(x, weight, padding=1, groups=c)  # noqa: E731
        else:
            check((up, down, pad) == (2, 1, (2, 1)), f"an SG2 FIR with up {up}, down {down}, pad {pad}")
            weight = taps.flip(0, 1).expand(c, 1, *taps.shape).contiguous()
            library = lambda: F.conv_transpose2d(x, weight, stride=2, padding=1, groups=c)  # noqa: E731
        calls = {
            "ms": lambda: upfirdn2d_cuda(x, _FIR, up, down, pad, gain),
            "plain_ms": lambda: upfirdn2d_plain(x, _FIR, up, down, pad, gain),
            "library_ms": library,
        }
        got, want, lib = (fn() for fn in calls.values())
        torch.cuda.synchronize()
        label = f"SG2 FIR {list(shape)} up{up} pad{pad} gain{gain:g}"
        err, lib_err = (got - want).abs().max().item(), (lib - got).abs().max().item()
        check(got.shape == want.shape == lib.shape, f"{label}: shapes {got.shape}, {want.shape}, {lib.shape}")
        check(torch.allclose(got, want, rtol=KERNEL_TOL, atol=KERNEL_TOL),
              f"{label}: kernel disagrees with the plain version, max |err| {err:.3e}")
        check(torch.allclose(lib, got, rtol=KERNEL_TOL, atol=KERNEL_TOL),
              f"{label}: the library call differs from the kernel by {lib_err:.3e}")
        max_err = max(max_err, err)
        nbytes = 4 * (x.numel() + got.numel())
        flops = 2 * got.numel() * _FIR.size // (up * up)  # the taps on real samples
        row = {"shape": list(shape), "up": up, "pad": list(pad), "gain": gain,
               "kernel": upfirdn.tpu_layout(c, up, down, 4, 4, pad)}
        row.update({key: queued_ms(torch, fn) for key, fn in calls.items()})
        row["flushed_ms"] = queued_ms(torch, calls["ms"], flush)
        row["library_flushed_ms"] = queued_ms(torch, library, flush)
        row["bound_ms"] = max(nbytes / bandwidth, flops / fp32_peak) * 1e3
        row["bound_by"] = "bytes" if nbytes / bandwidth >= flops / fp32_peak else "operations"
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        rows.append(row)
        say(f"{label} ({row['kernel']}): max |err| {err:.3e}, library {lib_err:.3e}; device time kernel "
            f"{row['ms'] * 1e3:.2f} us, plain {row['plain_ms'] * 1e3:.2f} us, library "
            f"{row['library_ms'] * 1e3:.2f} us; bound {row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}, "
            f"{nbytes / 1e6:.3f} MB), {row['share_of_bound'] * 100:.1f}% of it; L2 flushed: kernel "
            f"{row['flushed_ms'] * 1e3:.2f} us, library {row['library_flushed_ms'] * 1e3:.2f} us")
        del got, want, lib, weight
    del flush
    torch.cuda.empty_cache()
    return rows, max_err


def sg2_serving_path(torch, dev, parser, smi, bandwidth, fp32_peak):
    """Phase 7: ``infer_e --mtype 2 --img_size 1024 --start_features 16``,
    tpugan's default request, at full width and batch 2 on random weights
    from the seed. Returns the FIR launches of its counted requests, by the
    TPU kernel each replaces, the FIR kernel's max |err| on the path's own
    inputs and the timed rows."""
    from tpugan_torch.cli import common, infer_e
    from tpugan_torch.models import stylegan2 as sg2_model
    from tpugan_torch.ops import cuda, upfirdn

    argv = ["--mtype", "2", "--img_size", str(SG2_SIZE), "--start_features", str(SG2_START_FEATURES),
            "--random_init", "--batch_size", str(BATCH), "--seed", str(SEED)]
    t0 = time.perf_counter()
    bundle = common.build_bundle(parser.parse_args(argv + ["--device", CARD]))
    torch.cuda.synchronize()
    synthesis = bundle.generator.synthesis
    channels = [synthesis.get_nf(2**r) for r in range(2, int(math.log2(SG2_SIZE)) + 1)]
    say(f"bundle: mtype 2, StyleGAN2-{SG2_SIZE} config F ({synthesis.architecture}, "
        f"{bundle.generator.num_layers} style layers, channels {channels} at 4-{SG2_SIZE} px) + the "
        f"case-1 encoder (startf {SG2_START_FEATURES}, maxf 512, layer_count {bundle.layer_count}) built "
        f"in {time.perf_counter() - t0:.2f} s")
    per_request = {key: 2 * n for key, n in sg2_decode_firs(bundle.generator).items()}
    firs = sum(per_request.values())

    # the main path: launches counted from 0
    cuda.reset_launches()
    upfirdn.reset_layout_launches()
    for s in REQUEST_SEEDS:
        imgs1, imgs2 = infer_e.run(bundle, BATCH, s)
        torch.cuda.synchronize()
        for label, img in (("imgs1", imgs1), ("imgs2", imgs2)):
            check(tuple(img.shape) == (BATCH, SG2_SIZE, SG2_SIZE, 3), f"SG2 {label} shape {tuple(img.shape)}")
            check(bool(torch.isfinite(img).all()), f"SG2 {label} of seed {s} is not finite")
        say(f"SG2 request of seed {s}: imgs1 in [{imgs1.min().item():.4f}, {imgs1.max().item():.4f}], "
            f"imgs2 in [{imgs2.min().item():.4f}, {imgs2.max().item():.4f}]")
    launches = dict(cuda.launches)
    layouts = dict(upfirdn.layout_launches)
    want = expected_launches(upfirdn2d=firs * len(REQUEST_SEEDS))
    check(launches == want, f"SG2 path launches {launches}, expected {want}")
    want_layouts = {key: n * len(REQUEST_SEEDS) for key, n in per_request.items()}
    check(layouts == want_layouts, f"SG2 path FIR launches by TPU kernel {layouts}, expected {want_layouts}")
    say(f"SG2 path: {len(REQUEST_SEEDS)} requests, launches {launches} ({firs} per request, two decodes); "
        f"upfirdn2d by the TPU kernel it replaces {layouts}, as derived from the generator: "
        f"{per_request} per request")

    # one input of each distinct FIR of a decode, captured from a request
    captured = {}
    real = sg2_model.upfirdn2d

    def capture(x, kernel, up=1, down=1, pad=(0, 0), gain=1.0):
        captured.setdefault((tuple(x.shape), up, down, tuple(pad), gain), x.clone())
        return real(x, kernel, up, down, pad, gain)

    sg2_model.upfirdn2d = capture
    try:
        infer_e.run(bundle, BATCH, REQUEST_SEEDS[0])
    finally:
        sg2_model.upfirdn2d = real
    check(len(captured) == firs // 2, f"a decode ran {len(captured)} distinct FIRs, not {firs // 2}")
    say(f"SG2 FIR times below, on the path's own inputs: {smi}; device times from CUDA events around "
        "20 calls queued behind a device-side sleep")
    rows, max_err = sg2_fir_times(torch, dev, captured, bandwidth, fp32_peak)
    del captured
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "flushed_ms", "library_flushed_ms")
    request_sums = {key: 2 * sum(r[key] for r in rows) for key in keys}
    split = {name: {key: 2 * sum(r[key] for r in rows if r["kernel"] == name) for key in keys}
             for name in per_request}
    for name, part in split.items():
        part["launches"] = layouts[name]
    say(f"SG2 FIRs per request ({firs}, each shape twice): " + ", ".join(
        f"{key} {v * 1e3:.2f} us" for key, v in request_sums.items()) + "; by TPU kernel: " + "; ".join(
        f"{name} kernel {p_['ms'] * 1e3:.2f} us, flushed {p_['flushed_ms'] * 1e3:.2f} us, library "
        f"{p_['library_ms'] * 1e3:.2f} us, bound {p_['bound_ms'] * 1e3:.2f} us" for name, p_ in split.items()))

    # the same explicit request, drawn on the CPU, through the plain versions there
    cpu = common.build_bundle(parser.parse_args(argv + ["--device", "cpu"]))
    seed = REQUEST_SEEDS[0]
    request = infer_e.draw_request(cpu, BATCH, seed)
    cuda.reset_launches()
    on_gpu = infer_e.serve(bundle, request.to(dev))
    torch.cuda.synchronize()
    check(cuda.launches["upfirdn2d"] == firs, f"cuda SG2 request launches {cuda.launches}")
    t0 = time.perf_counter()
    on_cpu = infer_e.serve(cpu, request)
    cpu_seconds = time.perf_counter() - t0
    check(cuda.launches["upfirdn2d"] == firs, "the CPU request launched the kernel")
    say(f"cuda vs cpu (SG2): the request of seed {seed} took {cpu_seconds:.2f} s on the CPU")
    for label, g, c in zip(("imgs1", "imgs2"), on_gpu, on_cpu):
        err, ref = (g.cpu() - c).abs().max().item(), c.abs().max().item()
        limit = CPU_GPU_ATOL * max(1.0, ref)
        say(f"cuda vs cpu (SG2) {label}: max |err| {err:.3e}, limit {limit:.3e} (CPU_GPU_ATOL "
            f"{CPU_GPU_ATOL:g} x max(1, max |ref| {ref:.3f}))")
        check(err <= limit, f"SG2 {label}: cuda and cpu differ by {err:.3e} > {limit:.3e}")
    del cpu, on_gpu, on_cpu

    say(f"SG2 request times below: {smi}; device times from torch.profiler, request times from the host "
        "clock")
    run = lambda s: infer_e.run(bundle, BATCH, s)  # noqa: E731
    median = request_latency(torch, run, seed, f"StyleGAN2-{SG2_SIZE} + E, fp32, TF32 off")
    request_device_time(torch, run, seed, median, "upfirdn2d_kernel", "upfirdn2d")
    del bundle
    torch.cuda.empty_cache()
    return {"launches": launches["upfirdn2d"], "max_abs_err": max_err, "per_request": request_sums,
            "split": split, "per_shape": rows}


# phase 8, SGv1 Cat256 training: the forms driven (label, e_align flags)
SGV1_TRAIN_FORMS = (
    ("case 1", ("--case", "1")),
    ("case 1 lean", ("--case", "1")),
    ("case 2", ("--case", "2")),
    ("ablation 8", ("--ablation", "8")),
    ("ablation 1", ("--ablation", "1")),
)
SGV1_TIMED_FORMS = ("case 1", "case 1 lean", "case 2", "ablation 8")
# the CPU replay of an SGv1 case-2 step: Cat256 at start_features 16 (the
# path has 64; maxf stays 512), on the card, on the CPU and on the CPU in
# float64, which is the reference (the gradient is ill-conditioned at 256 px,
# as sgv1_gradient says): loss_tsa within REPLAY_LOSS_RTOL of float64, every
# gradient of the step (of loss_tsa and of 0.01 loss_w) within CPU_GPU_ATOL
# x max(1, max |g|), or within twice the CPU fp32 run's own error, of
# float64, whichever is larger (the step's gradients reach 2e2, where an
# absolute 1e-3 is below fp32's own rounding)
SGV1_REPLAY_START_FEATURES = 16


def step_image_gradients(e_align, args):
    """The image-loss gradients an e_align step takes: none in case 1 (its
    image losses are detached), one in case 2 and in every ablation (of
    loss_tsa), one per image group of non-zero weight in the sequential
    ablations (7 and 8)."""
    if args.ablation in e_align.SEQUENTIAL_ABLATIONS:
        return sum(w != 0.0 for w in e_align.ABLATION_IMAGE_WEIGHTS[args.ablation])
    return int(bool(args.ablation) or args.case == 2)


def sgv1_decode_firs(generator):
    """One StyleGANv1 decode's FIR launches by TPU kernel: the same-size 3x3
    blur after each up-sampling conv (every block but the first) on its
    output channels. Its adjoint is the same blur, so a decode's adjoints
    count the same."""
    from tpugan_torch.ops import upfirdn

    blocks = [getattr(generator, f"decode_block_{i}") for i in range(generator.layer_count)]
    keys = [upfirdn.tpu_layout(b.bias_1.shape[0], 1, 1, 3, 3, (1, 1)) for b in blocks if b.has_first_conv]
    return {key: keys.count(key) for key in upfirdn.layout_launches}


def sgv1_step_firs(trainer, image_gradients, resynthesis):
    """One SGv1 train step's FIR launches by the TPU kernel that tpugan's
    dispatch gives each (``upfirdn.tpu_layout``), forward and adjoint,
    derived from the modules and the step's ``image_gradients``
    (:func:`step_image_gradients`): the same-size blur after each up-sampling
    conv of the generator (every block but the first) on its output
    channels, once in the synthesis and once in the resynthesis, and
    E_Blur's blur before each block's downsampling conv on the block's
    input channels; in the backward one adjoint of each blur that a
    gradient passes through: each image-loss gradient passes through the
    resynthesis and the encoder, the latent loss's gradient through the
    encoder alone (every block's style heads, or E_Blur_Z's z head, read
    the output of every earlier block's blur)."""
    decode = sgv1_decode_firs(trainer.bundle.generator)
    encoder = e_blur_firs(trainer.bundle.encoder)
    forward = {key: decode[key] * (1 + resynthesis) + encoder[key] for key in decode}
    adjoint = {key: image_gradients * (decode[key] + encoder[key]) + encoder[key] for key in decode}
    return forward, adjoint


class AdjointCount:
    """Counts the FIR launches made inside upfirdn2d's backward (the
    adjoint), by TPU kernel, while it is entered; the rest are forward."""

    def __init__(self):
        from tpugan_torch.ops import upfirdn

        self.upfirdn = upfirdn
        self.counts = {key: 0 for key in upfirdn.layout_launches}

    def __enter__(self):
        fn = self.upfirdn._UpFirDn2d
        self.real = fn.backward
        real, counts, layouts = self.real, self.counts, self.upfirdn.layout_launches

        def counted(ctx, g):
            before = dict(layouts)
            out = real(ctx, g)
            for key in counts:
                counts[key] += layouts[key] - before[key]
            return out

        fn.backward = staticmethod(counted)
        return self

    def __exit__(self, *exc):
        self.upfirdn._UpFirDn2d.backward = staticmethod(self.real)


def sgv1_replay_request(torch, e_align):
    """The SGv1 replay's arguments and its explicit inputs, drawn on the CPU."""
    from tpugan_torch.cli import infer_e

    argv = ["--mtype", "1", "--img_size", str(IMG_SIZE), "--start_features", str(SGV1_REPLAY_START_FEATURES),
            "--random_init", "--case", "2", "--iterations", "1", "--batch_size", str(BATCH),
            "--seed", str(SEED)]
    probe = e_align.build_trainer(e_align.make_parser().parse_args(argv + ["--device", "cpu"]))
    return argv, infer_e.draw_request(probe.bundle, BATCH, 0)


def sgv1_replay_step(torch, e_align, argv, request, device, place, dtype):
    """One SGv1 case-2 step of the replay on ``device`` in ``dtype``:
    loss_tsa, both gradients (float64, on the CPU), the seconds it took and
    the encoder's parameter names."""
    from tpugan_torch.losses.lpips import make_lpips_fn, random_params
    from tpugan_torch.ops import cuda
    from tpugan_torch.train.e_align import info_scalars

    lpips = make_lpips_fn(random_params(torch.Generator().manual_seed(7)).to(place, dtype))
    req = request.to(place)
    req = req._replace(z=req.z.to(dtype), noise_g=[tuple(n.to(dtype) for n in b) for b in req.noise_g],
                       noise_e=[tuple(n.to(dtype) for n in b) for b in req.noise_e],
                       noise_g2=[tuple(n.to(dtype) for n in b) for b in req.noise_g2])
    trainer = e_align.build_trainer(e_align.make_parser().parse_args(argv + ["--device", device]), lpips,
                                    draw=lambda it, r=req: r)
    for module in (trainer.bundle.generator, trainer.bundle.mapping, trainer.bundle.encoder):
        module.to(dtype)
    names = [n for n, _ in trainer.state.encoder.named_parameters()]
    grads = []
    opt_step = trainer.state.optimizer.step
    trainer.state.optimizer.step = lambda g=None: (grads.append(g), opt_step(g))
    cuda.reset_launches()
    t0 = time.perf_counter()
    _, info = trainer.step(trainer.state, 0)
    if device == CARD:
        torch.cuda.synchronize()
        check(cuda.launches["upfirdn2d"] > 0, f"replay launches {cuda.launches}")
    else:
        check(not any(cuda.launches.values()), "the CPU replay launched a kernel")
    seconds = time.perf_counter() - t0
    check(len(grads) == 2, f"a case-2 step took {len(grads)} updates")
    return (info_scalars(info)["loss_tsa"], [[g_.detach().double().cpu() for g_ in g] for g in grads], seconds,
            names)


def replay_sgv1_case2_on_cpu(torch, dev, e_align):
    """One SGv1 case-2 step of Cat256 at SGV1_REPLAY_START_FEATURES on the
    card, on the CPU and on the CPU in float64, from the same explicit
    inputs (drawn on the CPU): loss_tsa and both gradients of the step, held
    to the float64 run. Run it under :func:`cudnn_deterministic`."""
    argv, request = sgv1_replay_request(torch, e_align)
    cpu = torch.device("cpu")
    runs = [sgv1_replay_step(torch, e_align, argv, request, device, place, dtype)
            for device, place, dtype in ((CARD, dev, torch.float32), ("cpu", cpu, torch.float32),
                                         ("cpu", cpu, torch.float64))]
    (loss_g, grads_g, sec_g, names), (loss_c, grads_c, sec_c, _), (loss_r, grads_r, sec_r, _) = runs
    say(f"replay of an SGv1 case-2 step: Cat256 at start_features {SGV1_REPLAY_START_FEATURES}, batch {BATCH}, "
        f"random LPIPS; {sec_g:.2f} s on the card (first call), {sec_c:.2f} s on the CPU, {sec_r:.2f} s "
        "on the CPU in float64")
    scale = max(r.abs().max().item() for g in grads_r for r in g)
    errs = {}
    for label, loss, grads in (("cuda", loss_g, grads_g), ("cpu fp32", loss_c, grads_c)):
        worst = max((((a - r).abs().max().item()), f"gradient {k} of {names[i]}")
                    for k, (ga, gr) in enumerate(zip(grads, grads_r))
                    for i, (a, r) in enumerate(zip(ga, gr)))
        errs[label] = (abs(loss - loss_r) / abs(loss_r), worst[0])
        say(f"  {label} vs cpu float64: loss_tsa {loss:.6f} against {loss_r:.6f} (rel err "
            f"{errs[label][0]:.3e}, limit {REPLAY_LOSS_RTOL:g}); gradients max |err| {worst[0]:.3e} (at "
            f"{worst[1]}) against max |g| {scale:.3e}")
    limit = max(CPU_GPU_ATOL * max(1.0, scale), 2 * errs["cpu fp32"][1])
    check(math.isfinite(loss_r) and errs["cuda"][0] <= REPLAY_LOSS_RTOL, "the replayed loss_tsa disagrees")
    check(scale > 0 and errs["cuda"][1] <= limit,
          f"the card's SGv1 step gradients are {errs['cuda'][1]:.3e} from float64, over {limit:.3e}")
    say(f"  the card's gradients within {limit:.3e} of float64 (CPU_GPU_ATOL {CPU_GPU_ATOL:g} x max(1, max |g|), "
        "or twice the CPU fp32 run's own error)")
    return {"loss_rel_err": errs["cuda"][0], "grad_max_abs_err": errs["cuda"][1], "limit": limit}


def sgv1_training_path(torch, dev, smi):
    """Phase 8: ``e_align --mtype 1 --img_size 256 --start_features 64``'s
    train step at full width, batch 2, random weights from the seed: case 1
    and its lean step, case 2 (E_Blur), ablations 8 and 1, with their FIR
    launches per step, forward and adjoint, by TPU kernel, against the
    counts derived from the modules; a case-2 step replayed on the CPU; step
    times, device time by kernel and peak memory. Returns the FIR launches
    of the counted steps and the timed rows."""
    from tpugan_torch.cli import e_align
    from tpugan_torch.losses.lpips import random_lpips_fn
    from tpugan_torch.ops import cuda, upfirdn
    from tpugan_torch.train.e_align import info_scalars

    parser = e_align.make_parser()
    argv = ["--mtype", "1", "--img_size", str(IMG_SIZE), "--start_features", "64", "--random_init",
            "--iterations", "1000", "--batch_size", str(BATCH), "--seed", str(SEED), "--device", CARD]
    lpips = random_lpips_fn(dev)
    launches, per_step, times = 0, {}, {}
    trainer = None
    for label, flags in SGV1_TRAIN_FORMS:
        lean = label == "case 1 lean"  # case 1's trainer's off-tick step
        args = parser.parse_args(argv + list(flags))
        if not lean:
            del trainer
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            trainer = e_align.build_trainer(args, lpips)
            torch.cuda.synchronize()
            enc = trainer.state.encoder
            say(f"trainer: mtype 1, {label} ({' '.join(flags)}), SGv1 Cat256 frozen + "
                f"{type(enc).__name__} (blur {enc.block_0.use_blur}, noise {enc.block_0.use_noise}, styles "
                f"{enc.style_mode}) training, built in {time.perf_counter() - t0:.2f} s")
        step = trainer.lean if lean else trainer.step
        check(step is not None, f"{label}: no step")
        state = trainer.state
        frozen = [*trainer.bundle.generator.parameters(), *trainer.bundle.mapping.parameters()]
        frozen0 = [p.detach().clone() for p in frozen]
        params0 = {n: p.detach().clone() for n, p in state.encoder.named_parameters()}
        fwd_want, adj_want = sgv1_step_firs(trainer, step_image_gradients(e_align, args), not lean)

        # the main path: launches counted from 0
        cuda.reset_launches()
        upfirdn.reset_layout_launches()
        with AdjointCount() as adjoint:
            for it in range(TRAIN_STEPS):
                _, info = step(state, it)
                scalars = info_scalars(info)
                check(all(math.isfinite(x) for x in scalars.values()), f"{label} step {it}: a loss is not finite")
            torch.cuda.synchronize()
        counted = dict(cuda.launches)
        total = dict(upfirdn.layout_launches)
        adj = dict(adjoint.counts)
        fwd = {key: total[key] - adj[key] for key in total}
        firs = sum(fwd_want.values()) + sum(adj_want.values())
        check(counted == expected_launches(upfirdn2d=firs * TRAIN_STEPS),
              f"{label}: launches {counted}, expected {firs * TRAIN_STEPS} upfirdn2d and no attention")
        want_fwd = {key: n * TRAIN_STEPS for key, n in fwd_want.items()}
        want_adj = {key: n * TRAIN_STEPS for key, n in adj_want.items()}
        check(fwd == want_fwd and adj == want_adj, f"{label}: FIR launches forward {fwd}, adjoint {adj}; "
              f"derived from the modules: forward {want_fwd}, adjoint {want_adj}")
        launches += counted["upfirdn2d"]
        per_step[label] = {"forward": fwd_want, "adjoint": adj_want}
        moved = sum(not torch.equal(p, params0[n]) for n, p in state.encoder.named_parameters())
        check(moved > 0 and all(bool(torch.isfinite(p).all()) for p in state.encoder.parameters()),
              f"{label}: the encoder did not train, or is not finite")
        check(all(torch.equal(a, b) and a.grad is None for a, b in zip(frozen, frozen0)),
              f"{label}: the frozen generator or mapping moved")
        say(f"SGv1 {label} path: {TRAIN_STEPS} steps, launches {counted}; per step FIR forward "
            f"{fwd_want}, adjoint {adj_want}, as derived from the modules; loss_tsa "
            f"{scalars['loss_tsa']:.4f}, loss_mtv {scalars['loss_mtv']:.4f}; {moved} of {len(params0)} "
            f"encoder parameters moved, the generator and mapping did not")
        if label in SGV1_TIMED_FORMS:
            say(f"SGv1 training times below: {smi}; step times from the host clock, device times from "
                "torch.profiler")
            median = step_times(torch, step, state, f"SGv1 {label}, fp32, TF32 off", 100)
            times[label] = {"median_ms": median, **step_device_time(torch, step, state, median, 200,
                                                                    symbols=("upfirdn2d_kernel",))}
    del trainer
    torch.cuda.empty_cache()
    with cudnn_deterministic(torch):  # the comment at CPU_GPU_ATOL
        replay = replay_sgv1_case2_on_cpu(torch, dev, e_align)
    return {"launches": launches, "per_step": per_step, "times": times, "replay": replay}


# phase 9, StyleGAN2-1024 training: the forms driven (label, e_align flags);
# ablation 8 runs on the plain E, as tpugan builds it on mtype 2
SG2_TRAIN_FORMS = (
    ("case 1", ("--case", "1")),
    ("case 1 lean", ("--case", "1")),
    ("case 2", ("--case", "2")),
    ("ablation 8", ("--ablation", "8")),
)
SG2_TIMED_FORMS = ("case 1", "case 1 lean", "case 2")
# the CPU replay of an SG2 case-2 step: bench.py's 256 preset
# (_sg2_modules_and_vars: config F at 256 px, E_Blur at start_features 64),
# on the card, on the CPU and on the CPU in float64, the reference; held by
# phase 8's rule: loss_tsa within REPLAY_LOSS_RTOL of float64, every
# gradient of the step within CPU_GPU_ATOL x max(1, max |g|), or within
# twice the CPU fp32 run's own error, of float64, whichever is larger
SG2_REPLAY_SIZE = 256
SG2_REPLAY_START_FEATURES = 64


def sg2_decode_adjoint_firs(generator):
    """The adjoints of one StyleGAN2 decode's FIRs (:func:`sg2_decode_firs`)
    by the TPU kernel that ``upfirdn._fir_cuda`` counts each under: up and
    down swapped and the pads of ``upfirdn.adjoint`` at the layer's sizes.
    The 4-tap FIR after an up-sampling conv maps the transposed conv's
    r + k - 2 rows to the layer's r; the skip architecture's up-2 maps the
    image's r / 2 rows to r."""
    from tpugan_torch.models.stylegan2 import _FIR, ModulatedConv
    from tpugan_torch.ops import upfirdn

    synthesis = generator.synthesis
    firs = []  # (channels, input side, output side, up, pads)
    for m in synthesis.modules():
        if isinstance(m, ModulatedConv) and m.scale_factor == 2:
            k = m.weight.shape[-1]
            p = _FIR.shape[0] - 1 + (2 - k)
            firs.append((m.weight.shape[0], m.resolution + k - 2, m.resolution, 1, ((p + 1) // 2, p // 2)))
    if synthesis.architecture == "skip":
        outputs = [m for name, m in synthesis.named_children() if name.startswith("output")]
        firs += [(m.weight.shape[0], m.resolution // 2, m.resolution, 2, (2, 1)) for m in outputs[1:]]
    keys = []
    for c, side, out, up, (p0, p1) in firs:
        taps, a_up, a_down, (py0, py1, px0, px1) = upfirdn.adjoint(side, side, out, out, _FIR, up, 1,
                                                                   (p0, p1, p0, p1))
        keys.append(upfirdn.tpu_layout(c, a_up, a_down, *taps.shape, (py0, py1))
                    if (py0, py1) == (px0, px1) else "XLA")
    return {key: keys.count(key) for key in upfirdn.layout_launches}


def sg2_step_firs(trainer, image_gradients, resynthesis):
    """One StyleGAN2 train step's FIR launches by TPU kernel, forward and
    adjoint, derived from the modules and the step's ``image_gradients``
    (:func:`step_image_gradients`): a decode's FIRs (:func:`sg2_decode_firs`)
    in the synthesis and, unless the step is lean, in the resynthesis, and
    E_Blur's blur before each block's downsampling conv on the block's input
    channels (the rule of :func:`sgv1_step_firs`); in the backward one
    adjoint of each FIR that a gradient passes through
    (:func:`sg2_decode_adjoint_firs` for the resynthesis): each image-loss
    gradient passes through the resynthesis and the encoder, the latent
    loss's gradient through the encoder alone."""
    from tpugan_torch.ops import upfirdn

    gen, enc = trainer.bundle.generator, trainer.bundle.encoder
    decode, decode_adjoint = sg2_decode_firs(gen), sg2_decode_adjoint_firs(gen)
    check(sum(decode.values()) == sum(decode_adjoint.values()), "a decode's FIRs and their adjoints differ in number")
    blocks = [getattr(enc, f"block_{i}") for i in range(enc.layer_count)]
    blurs = [upfirdn.tpu_layout(b.conv_1.weight.shape[0], 1, 1, 3, 3, (1, 1)) for b in blocks
             if b.use_blur and b.has_last_conv and b.block_version == 2]
    encoder = {key: blurs.count(key) for key in upfirdn.layout_launches}
    forward = {key: decode[key] * (1 + resynthesis) + encoder[key] for key in decode}
    adjoint = {key: image_gradients * (decode_adjoint[key] + encoder[key]) + encoder[key] for key in decode}
    return forward, adjoint


class FirCapture:
    """Keeps one input of each distinct FIR launch (shape, taps, up, down,
    pads) made while it is entered, with the number of launches of each, by
    direction: "forward", "adjoint" (inside upfirdn2d's backward) and
    "second order" (the backward of an upfirdn2d node that an adjoint made
    while a graph was being built, as the R1 penalty's
    ``autograd.grad(..., create_graph=True)`` makes them). With ``keep``
    false it counts and keeps no input."""

    def __init__(self, keep=True):
        from tpugan_torch.ops import upfirdn

        self.upfirdn = upfirdn
        self.keep = keep
        self.firs = {}  # (direction, shape, taps bytes, up, down, pads) -> [x, taps, launches]
        self.direction = "forward"

    def __enter__(self):
        upfirdn, fn = self.upfirdn, self.upfirdn._UpFirDn2d
        self.real_fir, self.real_forward, self.real_backward = upfirdn._fir_cuda, fn.forward, fn.backward

        def fir_cuda(x, taps, up, down, pads):
            key = (self.direction, tuple(x.shape), taps.tobytes(), up, down, tuple(pads))
            entry = self.firs.setdefault(key, [x.detach().clone() if self.keep else None, taps, 0])
            entry[2] += 1
            return self.real_fir(x, taps, up, down, pads)

        def forward(ctx, *args):
            ctx.second_order = self.direction != "forward"  # made inside a backward
            return self.real_forward(ctx, *args)

        def backward(ctx, g):
            self.direction = "second order" if getattr(ctx, "second_order", False) else "adjoint"
            try:
                return self.real_backward(ctx, g)
            finally:
                self.direction = "forward"

        upfirdn._fir_cuda = fir_cuda
        fn.forward = staticmethod(forward)
        fn.backward = staticmethod(backward)
        return self

    def __exit__(self, *exc):
        self.upfirdn._fir_cuda = self.real_fir
        self.upfirdn._UpFirDn2d.forward = staticmethod(self.real_forward)
        self.upfirdn._UpFirDn2d.backward = staticmethod(self.real_backward)

    def counts(self):
        """Launches by direction and by the TPU kernel that tpugan's dispatch
        gives each (:func:`fir_tpu_key`)."""
        out = {}
        for (direction, shape, _, up, down, pads), (_, taps, n) in self.firs.items():
            by_key = out.setdefault(direction, {key: 0 for key in self.upfirdn.layout_launches})
            by_key[fir_tpu_key(shape, taps, up, down, pads)] += n
        return out


def fir_tpu_key(shape, taps, up, down, pads):
    """The TPU kernel that ``upfirdn._fir_cuda`` counts a FIR under: tpugan's
    own where the pads of H and W agree, else its XLA form."""
    from tpugan_torch.ops import upfirdn

    py0, py1, px0, px1 = pads
    kh, kw = taps.shape
    return upfirdn.tpu_layout(shape[1], up, down, kh, kw, (py0, py1)) if (py0, py1) == (px0, px1) else "XLA"


def sg2_step_fir_times(torch, step, state, first, bandwidth, fp32_peak):
    """Every FIR of one step, forward and adjoint, on the step's own inputs
    (:class:`FirCapture`): the kernel held to its plain version within
    KERNEL_TOL and timed (``queued_ms``) beside the plain version, one
    library call (``fir_library``) and its bound (each input read once and
    each output written once at the card's memory rate, or the taps on real
    samples at its fp32 rate). Returns the rows, the sums per step by
    direction and TPU kernel, and the max |err|."""
    from tpugan_torch.ops import upfirdn

    with FirCapture() as capture:
        step(state, first)
        torch.cuda.synchronize()
    rows, sums, max_err = [], {}, 0.0
    for (direction, shape, _, up, down, pads), (x, taps, n) in capture.firs.items():
        key = fir_tpu_key(shape, taps, up, down, pads)
        calls = {"ms": lambda: upfirdn._fir_cuda(x, taps, up, down, pads),
                 "plain_ms": lambda: upfirdn._fir_plain(x, taps, up, down, pads)}
        library = fir_library(torch, x, taps, up, down, pads)
        if library is not None:
            calls["library_ms"] = library
        got, want = (calls[k]() for k in ("ms", "plain_ms"))
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        label = f"SG2 step FIR {direction} {list(shape)} -> {list(got.shape)} up{up} down{down} pads {list(pads)}"
        check(got.shape == want.shape and torch.allclose(got, want, rtol=KERNEL_TOL, atol=KERNEL_TOL),
              f"{label}: kernel disagrees with the plain version, max |err| {err:.3e}")
        max_err = max(max_err, err)
        nbytes = 4 * (x.numel() + got.numel())
        flops = 2 * got.numel() * taps.size // (up * up)
        row = {"direction": direction, "shape": list(shape), "out": list(got.shape), "up": up, "down": down,
               "pads": list(pads), "kernel": key, "per_step": n}
        row.update({name: queued_ms(torch, fn) for name, fn in calls.items()})
        row.setdefault("library_ms", None)
        row["bound_ms"] = max(nbytes / bandwidth, flops / fp32_peak) * 1e3
        row["bound_by"] = "bytes" if nbytes / bandwidth >= flops / fp32_peak else "operations"
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        rows.append(row)
        part = sums.setdefault(direction, {}).setdefault(key, {"launches": 0, "ms": 0.0, "plain_ms": 0.0,
                                                               "library_ms": 0.0, "bound_ms": 0.0})
        part["launches"] += n
        for name in ("ms", "plain_ms", "library_ms", "bound_ms"):
            part[name] += n * (row[name] or 0.0)
        lib = "none" if row["library_ms"] is None else f"{row['library_ms'] * 1e3:.2f} us"
        say(f"{label} ({key}, x{n} a step): max |err| {err:.3e}; kernel {row['ms'] * 1e3:.2f} us, plain "
            f"{row['plain_ms'] * 1e3:.2f} us, library {lib}, bound {row['bound_ms'] * 1e3:.2f} us "
            f"({row['share_of_bound'] * 100:.1f}% of it)")
        del got, want
    check(all(r["library_ms"] is not None for r in rows), "SG2: a step FIR without a library call")
    del capture
    torch.cuda.empty_cache()
    for direction, parts in sums.items():
        say(f"SG2 step FIRs, {direction}, per step by TPU kernel: " + "; ".join(
            f"{key} {p_['launches']} launches, kernel {p_['ms'] * 1e3:.2f} us, plain {p_['plain_ms'] * 1e3:.2f} "
            f"us, library {p_['library_ms'] * 1e3:.2f} us, bound {p_['bound_ms'] * 1e3:.2f} us"
            for key, p_ in sorted(parts.items())))
    return rows, sums, max_err


def replay_sg2_case2_on_cpu(torch, dev, e_align):
    """One StyleGAN2 case-2 step at SG2_REPLAY_SIZE (E_Blur at
    SG2_REPLAY_START_FEATURES) held to float64 (:func:`replay_case2_on_float64`),
    the card's FIRs on B1 and B2."""
    from tpugan_torch.ops import upfirdn

    def card_launches(launches):
        layouts = dict(upfirdn.layout_launches)
        check(layouts["B1"] > 0 and layouts["B2"] > 0, f"the replay's FIR launches {layouts} miss B1 or B2")
        return layouts

    return replay_case2_on_float64(
        torch, dev, e_align, "an SG2", ["--mtype", "2", "--img_size", str(SG2_REPLAY_SIZE), "--start_features",
                                     str(SG2_REPLAY_START_FEATURES)],
        f"StyleGAN2-{SG2_REPLAY_SIZE} config F, E_Blur at start_features {SG2_REPLAY_START_FEATURES}", card_launches)


def replay_case2_on_float64(torch, dev, e_align, name, flags, what, card_launches, card_forms=(("cuda", None),)):
    """One case-2 step of ``e_align`` at ``flags`` (a reduced configuration,
    ``what``) on the card, on the CPU and on the CPU in float64, from the
    same explicit inputs (drawn on the CPU): loss_tsa and both gradients of
    the step, held to the float64 run within CPU_GPU_ATOL x max(1, max |g|)
    or twice the CPU fp32 run's own distance from it.
    ``card_launches(cuda.launches)`` checks the card's launches and returns
    what the record keeps. ``card_forms``: (label, context) of each card
    run, the context (None: none) entered around its step; the first form
    is held to the rule, the others are measured and printed beside it."""
    from tpugan_torch.cli import infer_e
    from tpugan_torch.losses.lpips import make_lpips_fn, random_params
    from tpugan_torch.ops import cuda, upfirdn
    from tpugan_torch.train.e_align import info_scalars

    argv = list(flags) + ["--random_init", "--case", "2", "--iterations", "1", "--batch_size", str(BATCH),
                          "--seed", str(SEED)]
    parser = e_align.make_parser()
    probe = e_align.build_trainer(parser.parse_args(argv + ["--device", "cpu"]))
    request = infer_e.draw_request(probe.bundle, BATCH, 0)
    del probe
    runs = {}
    cpu = torch.device("cpu")
    forms = [(label, CARD, dev, torch.float32, ctx) for label, ctx in card_forms] + [
        ("cpu fp32", "cpu", cpu, torch.float32, None), ("cpu float64", "cpu", cpu, torch.float64, None)]
    for label, device, place, dtype, ctx in forms:
        lpips = make_lpips_fn(random_params(torch.Generator().manual_seed(7)).to(place, dtype))
        req = request.to(place)
        req = req._replace(z=req.z.to(dtype), noise_e=[tuple(n.to(dtype) for n in b) for b in req.noise_e])
        trainer = e_align.build_trainer(parser.parse_args(argv + ["--device", device]), lpips,
                                        draw=lambda it, r=req: r)
        for module in (trainer.bundle.generator, trainer.bundle.encoder):
            module.to(dtype)
        names = [n for n, _ in trainer.state.encoder.named_parameters()]
        grads = []
        opt_step = trainer.state.optimizer.step
        trainer.state.optimizer.step = lambda g=None: (grads.append(g), opt_step(g))
        cuda.reset_launches()
        upfirdn.reset_layout_launches()
        t0 = time.perf_counter()
        with contextlib.nullcontext() if ctx is None else ctx(torch):
            _, info = trainer.step(trainer.state, 0)
            if device == CARD:
                torch.cuda.synchronize()
        if device == CARD:
            layouts = card_launches(dict(cuda.launches))
        else:
            check(not any(cuda.launches.values()), "the CPU replay launched a kernel")
        seconds = time.perf_counter() - t0
        check(len(grads) == 2, f"a case-2 step took {len(grads)} updates")
        runs[label] = (info_scalars(info)["loss_tsa"], [[g_.detach().double().cpu() for g_ in g] for g in grads],
                       seconds)
        del trainer
    held = card_forms[0][0]
    loss_r, grads_r, sec_r = runs.pop("cpu float64")
    say(f"replay of {name} case-2 step: {what}, batch {BATCH}, random LPIPS; launches on the card "
        f"{layouts}; " + ", ".join(f"{label} {sec:.2f} s" for label, (_, _, sec) in runs.items())
        + f", cpu float64 {sec_r:.2f} s (the card's runs are first calls)")
    scale = max(r.abs().max().item() for g in grads_r for r in g)
    errs = {}
    for label, (loss, grads, _) in runs.items():
        worst = max((((a - r).abs().max().item()), f"gradient {k} of {names[i]}")
                    for k, (ga, gr) in enumerate(zip(grads, grads_r))
                    for i, (a, r) in enumerate(zip(ga, gr)))
        errs[label] = (abs(loss - loss_r) / abs(loss_r), worst[0])
        say(f"  {label} vs cpu float64: loss_tsa {loss:.6f} against {loss_r:.6f} (rel err "
            f"{errs[label][0]:.3e}, limit {REPLAY_LOSS_RTOL:g}); gradients max |err| {worst[0]:.3e} (at "
            f"{worst[1]}) against max |g| {scale:.3e}" + ("" if label in (held, "cpu fp32") else
                                                         " (measured beside the held run, not held)"))
    limit = max(CPU_GPU_ATOL * max(1.0, scale), 2 * errs["cpu fp32"][1])
    check(math.isfinite(loss_r) and errs[held][0] <= REPLAY_LOSS_RTOL, f"the replayed {name} loss_tsa disagrees")
    check(scale > 0 and errs[held][1] <= limit,
          f"the card's {name} step gradients ({held}) are {errs[held][1]:.3e} from float64, over {limit:.3e}")
    say(f"  the card's gradients ({held}) within {limit:.3e} of float64 (CPU_GPU_ATOL {CPU_GPU_ATOL:g} x max(1, "
        "max |g|), or twice the CPU fp32 run's own error)")
    out = {"loss_rel_err": errs[held][0], "grad_max_abs_err": errs[held][1], "limit": limit,
           "cpu_fp32_grad_max_abs_err": errs["cpu fp32"][1], "grad_scale": scale, "launches": layouts}
    others = {label: {"loss_rel_err": e[0], "grad_max_abs_err": e[1]} for label, e in errs.items()
              if label not in (held, "cpu fp32")}
    if others:
        out["not_held"] = others
    return out


def sg2_training_path(torch, dev, smi, bandwidth, fp32_peak):
    """Phase 9: ``e_align --mtype 2 --img_size 1024 --start_features 16``'s
    train step at full width, batch 2, random weights from the seed: case 1
    and its lean step, case 2 (E_Blur) and ablation 8 (the plain E), with
    their FIR launches per step, forward and adjoint, by TPU kernel, against
    the counts derived from the modules; every FIR of a case-2 step on its
    own inputs against the plain version, timed; a case-2 step replayed on
    the CPU; step times, device time by kernel and peak memory. Returns the
    FIR launches of the counted steps, the rows and the replay."""
    from tpugan_torch.cli import e_align
    from tpugan_torch.losses.lpips import random_lpips_fn
    from tpugan_torch.ops import cuda, upfirdn
    from tpugan_torch.train.e_align import info_scalars

    parser = e_align.make_parser()
    argv = ["--mtype", "2", "--img_size", str(SG2_SIZE), "--start_features", str(SG2_START_FEATURES),
            "--random_init", "--iterations", "1000", "--batch_size", str(BATCH), "--seed", str(SEED),
            "--device", CARD]
    lpips = random_lpips_fn(dev)
    launches, per_step, times, firs = 0, {}, {}, None
    trainer = None
    for label, flags in SG2_TRAIN_FORMS:
        lean = label == "case 1 lean"  # case 1's trainer's off-tick step
        args = parser.parse_args(argv + list(flags))
        if not lean:
            del trainer
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            trainer = e_align.build_trainer(args, lpips)
            torch.cuda.synchronize()
            enc = trainer.state.encoder
            say(f"trainer: mtype 2, {label} ({' '.join(flags)}), StyleGAN2-{SG2_SIZE} config F frozen + "
                f"{'E_Blur' if enc.block_0.use_blur else 'E'} (startf {SG2_START_FEATURES}, layer_count "
                f"{enc.layer_count}) training, built in {time.perf_counter() - t0:.2f} s")
        step = trainer.lean if lean else trainer.step
        check(step is not None, f"SG2 {label}: no step")
        state = trainer.state
        frozen = list(trainer.bundle.generator.parameters())
        frozen0 = [p.detach().clone() for p in frozen]
        params0 = {n: p.detach().clone() for n, p in state.encoder.named_parameters()}
        fwd_want, adj_want = sg2_step_firs(trainer, step_image_gradients(e_align, args), not lean)

        # the main path: launches counted from 0
        torch.cuda.reset_peak_memory_stats()
        cuda.reset_launches()
        upfirdn.reset_layout_launches()
        with AdjointCount() as adjoint:
            for it in range(TRAIN_STEPS):
                _, info = step(state, it)
                scalars = info_scalars(info)
                check(all(math.isfinite(x) for x in scalars.values()), f"SG2 {label} step {it}: a loss is not finite")
            torch.cuda.synchronize()
        counted = dict(cuda.launches)
        total = dict(upfirdn.layout_launches)
        adj = dict(adjoint.counts)
        fwd = {key: total[key] - adj[key] for key in total}
        n_firs = sum(fwd_want.values()) + sum(adj_want.values())
        check(counted == expected_launches(upfirdn2d=n_firs * TRAIN_STEPS),
              f"SG2 {label}: launches {counted}, expected {n_firs * TRAIN_STEPS} upfirdn2d and no attention")
        want_fwd = {key: n * TRAIN_STEPS for key, n in fwd_want.items()}
        want_adj = {key: n * TRAIN_STEPS for key, n in adj_want.items()}
        check(fwd == want_fwd and adj == want_adj, f"SG2 {label}: FIR launches forward {fwd}, adjoint {adj}; "
              f"derived from the modules: forward {want_fwd}, adjoint {want_adj}")
        launches += counted["upfirdn2d"]
        per_step[label] = {"forward": fwd_want, "adjoint": adj_want}
        moved = sum(not torch.equal(p, params0[n]) for n, p in state.encoder.named_parameters())
        check(moved > 0 and all(bool(torch.isfinite(p).all()) for p in state.encoder.parameters()),
              f"SG2 {label}: the encoder did not train, or is not finite")
        check(all(torch.equal(a, b) and a.grad is None for a, b in zip(frozen, frozen0)),
              f"SG2 {label}: the frozen generator moved")
        say(f"SG2 {label} path: {TRAIN_STEPS} steps, launches {counted}; per step FIR forward {fwd_want}, "
            f"adjoint {adj_want}, as derived from the modules; loss_tsa {scalars['loss_tsa']:.4f}, loss_mtv "
            f"{scalars['loss_mtv']:.4f}; {moved} of {len(params0)} encoder parameters moved, the generator "
            f"did not; peak device memory over the counted steps "
            f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
        if label == "case 2":
            say(f"SG2 case-2 step FIRs below, on the step's own inputs: {smi}; device times from CUDA events "
                "around 20 calls queued behind a device-side sleep")
            firs = sg2_step_fir_times(torch, step, state, 50, bandwidth, fp32_peak)
        if label in SG2_TIMED_FORMS:
            say(f"SG2 training times below: {smi}; step times from the host clock, device times from "
                "torch.profiler")
            median = step_times(torch, step, state, f"SG2 {label}, fp32, TF32 off", 100)
            times[label] = {"median_ms": median, **step_device_time(torch, step, state, median, 200,
                                                                    symbols=("upfirdn2d_kernel",))}
    del trainer
    torch.cuda.empty_cache()
    check(firs is not None, "no SG2 case-2 step was timed")
    rows, sums, max_err = firs
    with cudnn_deterministic(torch):  # the comment at CPU_GPU_ATOL
        replay = replay_sg2_case2_on_cpu(torch, dev, e_align)
    return {"launches": launches, "per_step": per_step, "times": times, "fir_rows": rows, "fir_sums": sums,
            "max_abs_err": max_err, "replay": replay}


# phase 10, bf16 (e_align --bf16, tpugan/precision.py): the forms driven
# (label, mtype, e_align flags); SG2-1024 as phase 9, SGv1 Cat256 as phase 8
BF16_TRAIN_FORMS = (
    ("SG2 case 2", "2", ("--case", "2")),
    ("SG2 case 1", "2", ("--case", "1")),
    ("SG2 case 1 lean", "2", ("--case", "1")),
    ("SG2 ablation 8", "2", ("--ablation", "8")),
    ("SGv1 case 2", "1", ("--case", "2")),
    ("SGv1 ablation 8", "1", ("--ablation", "8")),
)
# bf16's checks beside its kernel's. The step is held as the other paths
# are, to a replay on the CPU, where the plain versions run: at tpugan's
# gate configuration (tests/test_bf16.py's _sg2_setup: StyleGAN2 at 64 px,
# fmaps_base 1024, fmaps_max 64; E_Blur startf 16, maxf 64, 5 blocks;
# random weights from the seed; the iterations' draws made on the CPU; no
# LPIPS) ten case-2 steps in fp32 and bf16 on the card and on the CPU: the
# card's fp32 loss_tsa within REPLAY_LOSS_RTOL of the CPU's at the first
# step, and the card's bf16 trajectory no farther from the CPU's fp32 one,
# at its farthest step, than twice the CPU's bf16 trajectory is (the rule
# of tests/test_torch_bf16.py against tpugan). A request's imgs1 at full
# width (SG2-1024 and SGv1 Cat256, drawn on the CPU) likewise: the card's
# fp32 within CPU_GPU_ATOL x max(1, max |ref|) of the CPU's, the card's
# bf16 within twice the CPU's bf16 distance from the CPU's fp32. tpugan's
# gate at full width (the CLI's trainers from one seed, the same draws):
# the first case-2 step's loss_tsa within 3% of fp32
# (test_bf16_case2_train_step_close). tpugan's other gates are printed,
# held or not: its trajectory gate (test_bf16_training_trajectory_close:
# ten steps within 5%, the first within 3%) at both sizes, beside a second
# fp32 run, a TF32 one and each bf16 step taken from the fp32 run's
# parameters, and its image gates (imgs1 within 0.05 of the fp32 images'
# max |value| for SG2, test_bf16_sg2_image_close, and 0.08 for SGv1,
# test_bf16_sg1_pipeline_runs). Written as checks, they failed: the
# trajectory at full width (6.6% at step 3; 5.1% at step 2 from the same
# parameters) and at the gate configuration with draws made on the card
# (3.5% at the first step), SGv1 Cat256's imgs1 (0.099); the same inputs in
# bf16 leave fp32 alike on the card and on the CPU, and tpugan's own bf16
# leaves fp32 by 11.6% (ten steps) and 0.088 (SGv1 images) at its tests'
# sizes with the constant leaves drawn (PERF.md;
# tests/test_torch_bf16.py).
BF16_GATE_STEPS = 10
BF16_LOSS_RTOL = 0.05
BF16_STEP_LOSS_RTOL = 0.03
BF16_GATE_SG2 = dict(resolution=64, fmaps_base=1024, fmaps_max=64)
BF16_GATE_ENCODER = dict(startf=16, maxf=64, layer_count=5, latent_size=512, use_blur=True)
BF16_TIMED_STEPS = 6  # host-clock steps of each bf16 form, after 2 warm-up steps
BF16_PROFILED_STEPS = 1  # steps of each bf16 form in its device-time trace
BF16_IMAGE_TOL = {"2": 0.05, "1": 0.08}  # tpugan's image gates, by mtype (printed)


def bf16_ulp(torch, g, w):
    """One bf16 ulp of the larger of |g| and |w|, elementwise."""
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.finfo(torch.bfloat16).eps * torch.exp2(torch.floor(torch.log2(mag)))


def bf16_ulps(torch, got, want):
    """max |got - want| over one bf16 ulp of the larger magnitude (at least
    KERNEL_TOL, for sums that cancel to near zero), and max |got - want|:
    the bf16 kernel and its plain version sum the same fp32 products in
    another order and round once, so they agree exactly or one ulp apart,
    where the two sums fall on either side of a rounding boundary."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    return (err / bf16_ulp(torch, g, w).clamp_min(KERNEL_TOL)).max().item(), err.max().item()


def check_bf16_fir(torch, label, got, want, f32):
    """The bf16 kernel's output ``got`` within one bf16 ulp of the plain
    version's ``want``, and bitwise ``f32``, the fp32 kernel's on the same
    values rounded to bf16 (the same sums in the same order). Returns max
    |got - want|."""
    check(got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape == f32.shape,
          f"{label}: dtypes {got.dtype}, {want.dtype} and shapes {tuple(got.shape)}, {tuple(want.shape)}")
    ulps, err = bf16_ulps(torch, got, want)
    check(ulps <= 1.0, f"{label}: the bf16 kernel is {ulps:.2f} bf16 ulps from the plain version "
          f"(max |err| {err:.3e})")
    check(torch.equal(got, f32), f"{label}: the bf16 kernel differs from the fp32 kernel rounded to bf16 "
          f"by {(got.float() - f32.float()).abs().max().item():.3e}")
    return err


def fir_bf16_parity(torch, dev, gen):
    """The kernel's bf16 form (``tpugan_upfirdn2d_bf16``) at the contract
    and tile-edge cases of phase 2 (``contract_cases``) and the FIR
    adjoint's cases, forward and adjoint, on bf16 inputs: within one bf16
    ulp of the plain version, and bitwise the fp32 kernel's output on the
    same values rounded to bf16; a half-precision call, and plans made for
    the other element size, refused. Returns the max |err|."""
    import numpy as np

    from tpugan_torch.ops import cuda, upfirdn
    from tpugan_torch.ops.upfirdn import setup_fir_kernel, upfirdn2d, upfirdn2d_cuda, upfirdn2d_plain

    cases = contract_cases()
    max_err = 0.0
    cuda.reset_launches()
    for label, up, down, taps, pad, (n, h, w, c), gain in cases:
        x = torch.randn(n, c, h, w, device=dev, generator=gen).bfloat16()
        k = setup_fir_kernel(taps)
        got = upfirdn2d_cuda(x, k, up, down, pad, gain)
        f32 = upfirdn2d_cuda(x.float(), k, up, down, pad, gain).bfloat16()
        want = upfirdn2d_plain(x, k, up, down, pad, gain)
        torch.cuda.synchronize()
        max_err = max(max_err, check_bf16_fir(torch, f"bf16 {label}", got, want, f32))
        del x, got, want, f32
    check(cuda.launches == expected_launches(upfirdn2d=len(cases), upfirdn2d_bf16=len(cases)),
          f"bf16 parity launches {cuda.launches}")
    say(f"bf16 parity: {len(cases)} cases (phase 2's) within one bf16 ulp of the plain version and "
        f"bitwise the fp32 kernel rounded to bf16 (max |err| {max_err:.3e})")

    adjoint_cases = [(f"blur {c}x{r}x{r}", 1, 1, (1, 2, 1), (1, 1), (BATCH, c, r, r), 1.0)
                     for c, r in PATH_BLURS]
    adjoint_cases += list(SLICE3_FIRS) + list(ADJOINT_CASES)
    for label, up, down, taps, pad, shape, gain in adjoint_cases:
        k = np.asarray(taps, np.float32)
        k = setup_fir_kernel(taps) if k.ndim == 1 else k / k.sum()
        x = torch.randn(shape, device=dev, generator=gen).bfloat16().requires_grad_()
        cuda.reset_launches()
        y = upfirdn2d(x, k, up, down, pad, gain)
        g = torch.randn(y.shape, device=dev, generator=gen).bfloat16()
        (got,) = torch.autograd.grad(y, x, g)
        torch.cuda.synchronize()
        check(cuda.launches == expected_launches(upfirdn2d_bf16=2), f"bf16 adjoint {label}: {cuda.launches}")
        x32 = x.detach().float().requires_grad_()
        (f32,) = torch.autograd.grad(upfirdn2d(x32, k, up, down, pad, gain), x32, g.float())
        xr = x.detach().requires_grad_()
        (want,) = torch.autograd.grad(upfirdn2d_plain(xr, k, up, down, pad, gain), xr, g)
        max_err = max(max_err, check_bf16_fir(torch, f"bf16 adjoint {label}", got, want, f32.bfloat16()))
        del x, y, g, got, want, f32, x32, xr
    say(f"bf16 adjoint parity: {len(adjoint_cases)} cases (phase 2's) within one bf16 ulp of autograd of "
        f"the plain version, bitwise the fp32 kernel's adjoint rounded to bf16 (max |err| {max_err:.3e})")

    blur = setup_fir_kernel((1, 2, 1))
    x = torch.randn(1, 8, 8, 8, device=dev, generator=gen)
    try:
        upfirdn2d_cuda(x.half(), blur, pad=(1, 1))
        raise RuntimeError("chip_smoke: a half-precision FIR was not refused")
    except TypeError:
        pass
    taps = upfirdn._taps(blur, 1.0)
    cuda.reset_launches()
    for xin, elem in ((x.bfloat16(), 4), (x, 2)):
        y = torch.full_like(xin, 7.0)
        plan = upfirdn.fir_plan(8, 8, 8, 1, 1, 1, 3, 3, 8, 8, min_blocks=upfirdn.min_blocks(dev),
                                elem_bytes=elem).as_array()
        rc = launch_plan(torch, xin, y, taps, 1, 1, 1, plan)
        torch.cuda.synchronize()
        check(rc == 1 and bool((y == 7.0).all()), f"the {xin.dtype} entry point took a plan for {elem}-byte "
              f"elements (rc {rc})")
    check(not any(cuda.launches.values()), "a refused bf16 call launched")
    say("bf16: a half-precision call and plans made for the other element size refused")
    torch.cuda.empty_cache()
    return max_err


def fir_library(torch, x, taps, up, down, pads):
    """One PyTorch call for the FIR, in x's dtype, or None: a depthwise
    ``F.conv2d`` (stride down) for up 1 with equal pads, a depthwise
    ``F.conv_transpose2d`` with the flipped taps for up 2, down 1, where
    its padding and output padding can express the pads."""
    import torch.nn.functional as F

    c = x.shape[1]
    py0, py1, px0, px1 = pads
    kh, kw = taps.shape
    weight = torch.from_numpy(taps).to(x.device, x.dtype)
    if up == 1 and len({py0, py1, px0, px1}) == 1:
        w = weight.expand(c, 1, kh, kw).contiguous()
        return lambda: F.conv2d(x, w, stride=down, padding=py0, groups=c)
    p, op = kh - 1 - py0, py1 - py0 + 1
    if (up, down) == (2, 1) and kh == kw and (py0, py1) == (px0, px1) and p >= 0 and op in (0, 1):
        w = weight.flip(0, 1).expand(c, 1, kh, kw).contiguous()
        return lambda: F.conv_transpose2d(x, w, stride=2, padding=p, output_padding=op, groups=c)
    return None


def bf16_step_fir_rows(torch, step, state, first, bandwidth, fp32_peak, path):
    """Every FIR of one bf16 step, forward and adjoint, on the step's own
    bf16 inputs (:class:`FirCapture`): the bf16 kernel within one bf16 ulp
    of the plain version and bitwise the fp32 kernel's output rounded to
    bf16; timed (``queued_ms``) beside the fp32 kernel on the same values,
    the plain version, one library call in bf16 (``fir_library``) and the
    bound at 2 bytes an element (each input read once, each output written
    once, at the card's memory rate; or the taps on real samples at its
    fp32 rate, the kernel's arithmetic). Returns the rows, the sums per
    step by direction and TPU kernel, and the max |err|."""
    from tpugan_torch.ops import upfirdn

    with FirCapture() as capture:
        step(state, first)
        torch.cuda.synchronize()
    rows, sums, max_err = [], {}, 0.0
    for (direction, shape, _, up, down, pads), (x, taps, n) in capture.firs.items():
        check(x.dtype == torch.bfloat16, f"{path}: a {x.dtype} FIR in a bf16 step")
        py0, py1, px0, px1 = pads
        kh, kw = taps.shape
        key = upfirdn.tpu_layout(shape[1], up, down, kh, kw, (py0, py1)) if (py0, py1) == (px0, px1) else "XLA"
        x32 = x.float()
        library = fir_library(torch, x, taps, up, down, pads)
        calls = {"ms": lambda: upfirdn._fir_cuda(x, taps, up, down, pads),
                 "fp32_ms": lambda: upfirdn._fir_cuda(x32, taps, up, down, pads),
                 "plain_ms": lambda: upfirdn._fir_plain(x, taps, up, down, pads)}
        if library is not None:
            calls["library_ms"] = library
        got, f32, want = (calls[k]() for k in ("ms", "fp32_ms", "plain_ms"))
        torch.cuda.synchronize()
        label = f"{path} bf16 step FIR {direction} {list(shape)} -> {list(got.shape)} up{up} down{down} pads {list(pads)}"
        err = check_bf16_fir(torch, label, got, want, f32.bfloat16())
        max_err = max(max_err, err)
        nbytes = 2 * (x.numel() + got.numel())
        flops = 2 * got.numel() * taps.size // (up * up)
        row = {"direction": direction, "shape": list(shape), "out": list(got.shape), "up": up, "down": down,
               "pads": list(pads), "kernel": key, "per_step": n}
        row.update({name: queued_ms(torch, fn) for name, fn in calls.items()})
        row.setdefault("library_ms", None)
        row["bound_ms"] = max(nbytes / bandwidth, flops / fp32_peak) * 1e3
        row["bound_by"] = "bytes" if nbytes / bandwidth >= flops / fp32_peak else "operations"
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        rows.append(row)
        part = sums.setdefault(direction, {}).setdefault(key, {"launches": 0, "ms": 0.0, "fp32_ms": 0.0,
                                                               "plain_ms": 0.0, "library_ms": 0.0,
                                                               "bound_ms": 0.0})
        part["launches"] += n
        for name in ("ms", "fp32_ms", "plain_ms", "library_ms", "bound_ms"):
            part[name] += n * (row[name] or 0.0)
        lib = "none" if row["library_ms"] is None else f"{row['library_ms'] * 1e3:.2f} us"
        say(f"{label} ({key}, x{n} a step): max |err| {err:.3e}; bf16 kernel {row['ms'] * 1e3:.2f} us, fp32 "
            f"kernel {row['fp32_ms'] * 1e3:.2f} us, plain {row['plain_ms'] * 1e3:.2f} us, library {lib}, "
            f"bound {row['bound_ms'] * 1e3:.2f} us ({row['share_of_bound'] * 100:.1f}% of it)")
        del got, want, f32, x32
    check(all(r["library_ms"] is not None for r in rows), f"{path}: a step FIR without a library call")
    del capture
    torch.cuda.empty_cache()
    for direction, parts in sums.items():
        say(f"{path} bf16 step FIRs, {direction}, per step by TPU kernel: " + "; ".join(
            f"{key} {p_['launches']} launches, bf16 kernel {p_['ms'] * 1e3:.2f} us, fp32 kernel "
            f"{p_['fp32_ms'] * 1e3:.2f} us, plain {p_['plain_ms'] * 1e3:.2f} us, library "
            f"{p_['library_ms'] * 1e3:.2f} us, bound {p_['bound_ms'] * 1e3:.2f} us"
            for key, p_ in sorted(parts.items())))
    return rows, sums, max_err


def conv_split(kernels):
    """A step's device time (ms) in convolution and GEMM kernels (cuDNN's,
    cuBLAS's, CUTLASS's; not the FIR), split into those whose names say
    bf16 (the tensor cores' bf16 forms) and the rest, with the bf16 ones
    by name."""
    words = ("xmma", "cutlass", "cudnn", "implicit_gemm", "dgrad", "wgrad", "fprop", "gemm", "fft",
             "conv2d", "depthwise")
    convs = {k: ms for k, (ms, _) in kernels.items()
             if any(w_ in k.lower() for w_ in words)
             and not any(w_ in k for w_ in ("upfirdn2d", "elementwise", "reduce_kernel"))}
    bf16 = {k: ms for k, ms in convs.items() if "bf16" in k.lower()}
    return sum(bf16.values()), sum(convs.values()) - sum(bf16.values()), bf16


def gate_config_losses(torch, dev, bf16):
    """BF16_GATE_STEPS case-2 steps at tpugan's gate configuration
    (``BF16_GATE_SG2``, ``BF16_GATE_ENCODER``; random weights from SEED, as
    ``--random_init`` makes them; the iterations' seeded draws, made on the
    CPU; no LPIPS), in bf16 or fp32 on ``dev``: loss_tsa of each step."""
    from tpugan_torch.models import Encoder, StyleGAN2Generator
    from tpugan_torch.optim import lreq_adam
    from tpugan_torch.precision import bf16_encode, bf16_frozen, bf16_pipeline
    from tpugan_torch.train.e_align import (Request, build_stylegan2_pipeline, draw_noise, info_scalars,
                                            init_train_state, make_encode_fn, make_train_step)
    from tpugan_torch.utils import iteration_generator

    g = torch.Generator().manual_seed(SEED)
    gen = StyleGAN2Generator(**BF16_GATE_SG2, generator=g).to(dev).requires_grad_(False)
    enc = Encoder(**BF16_GATE_ENCODER, generator=g).to(dev)
    synth, resynth = build_stylegan2_pipeline(bf16_frozen(gen) if bf16 else gen, train=True)
    encode = make_encode_fn(enc, train=True)
    if bf16:
        synth, resynth = bf16_pipeline(synth, resynth)
        encode = bf16_encode(encode, enc)
    size = BF16_GATE_SG2["resolution"]

    def draw(it):  # on the CPU, so that a CPU run of this configuration sees the same inputs
        gi = iteration_generator(it, "cpu")
        z = torch.randn(BATCH, 512, generator=gi)
        return Request(z, None, draw_noise(enc.noise_shapes(BATCH, size), gi), None).to(dev)

    step = make_train_step(encode, lambda r: synth(r.z), resynth, draw, case=2)
    state, out = init_train_state(enc, lreq_adam(enc, 0.0015)), []
    for it in range(BF16_GATE_STEPS):
        state, info = step(state, it)
        out.append(info_scalars(info)["loss_tsa"])
    return out


def bf16_gates(torch, dev, e_align):
    """bf16's checks of the step and the images (the comment above
    ``BF16_GATE_STEPS``): the gate configuration on the card against its
    CPU replay; at full width the first case-2 step, then, printed, the
    ten-step trajectory of bf16, of a second fp32 run and of a TF32 one
    against the first fp32 run's, and bf16's step from each of the fp32
    run's parameters; the first request of REQUEST_SEEDS on SG2-1024 and
    SGv1 Cat256 (the CLI's bf16 generator) on the card against its CPU
    replay, tpugan's image gate and imgs2 through ``bf16_encode`` printed.
    Returns the losses and distances."""
    from tpugan_torch.cli import common, infer_e
    from tpugan_torch.precision import bf16_encode, bf16_frozen, bf16_pipeline
    from tpugan_torch.runtime import parity_mode
    from tpugan_torch.train.e_align import (build_stylegan1_pipeline, build_stylegan2_pipeline,
                                            info_scalars)

    def rel(a, b):
        return [abs(y - x) / abs(x) for x, y in zip(a, b)]

    cpu = torch.device("cpu")
    with cudnn_deterministic(torch):  # the comment at CPU_GPU_ATOL
        small = {f"{where} {kind}": gate_config_losses(torch, place, kind == "bf16")
                 for where, place in (("card", dev), ("cpu", cpu)) for kind in ("fp32", "bf16")}
    small_rel = {name: rel(small["cpu fp32"], v) for name, v in small.items() if name != "cpu fp32"}
    say(f"bf16 at tpugan's gate configuration (StyleGAN2 {BF16_GATE_SG2}, E_Blur {BF16_GATE_ENCODER}), "
        f"{BF16_GATE_STEPS} case-2 steps on the card and on the CPU: loss_tsa on the CPU in fp32 "
        f"{[round(v, 4) for v in small['cpu fp32']]}; relative to it, per step:")
    for name, r in small_rel.items():
        say(f"  {name}: max {max(r):.3e}, {[f'{x:.2e}' for x in r]}")
    mine, theirs = max(small_rel["card bf16"]), max(small_rel["cpu bf16"])
    check(small_rel["card fp32"][0] <= REPLAY_LOSS_RTOL and all(math.isfinite(v) for v in small["card bf16"])
          and mine <= 2 * theirs, f"the card's bf16 steps are {mine:.3e} from the CPU's fp32 ones, the CPU's "
          f"bf16 steps {theirs:.3e}; the card's fp32 first step {small_rel['card fp32'][0]:.3e}")
    small_held = max(small_rel["card bf16"]) <= BF16_LOSS_RTOL and small_rel["card bf16"][0] <= BF16_STEP_LOSS_RTOL
    say(f"  the card's fp32 first step within {REPLAY_LOSS_RTOL:g} of the CPU's, its bf16 trajectory within twice "
        f"the CPU's bf16 distance from fp32 ({mine:.3e} against {theirs:.3e}): held; tpugan's trajectory gate "
        f"({BF16_LOSS_RTOL:g} at every step, {BF16_STEP_LOSS_RTOL:g} at the first) on the card: "
        f"{'held' if small_held else 'not held'} (printed, not a check of this script)")

    parser = e_align.make_parser()
    argv = ["--mtype", "2", "--img_size", str(SG2_SIZE), "--start_features", str(SG2_START_FEATURES),
            "--random_init", "--iterations", "1000", "--batch_size", str(BATCH), "--seed", str(SEED),
            "--device", CARD, "--case", "2"]

    def make(*extra):
        return e_align.build_trainer(parser.parse_args(argv + list(extra)))

    def trajectory(tr):
        state, out = tr.state, []
        for it in range(BF16_GATE_STEPS):
            state, info = tr.step(state, it)
            out.append(info_scalars(info)["loss_tsa"])
        return out

    fp32, bf16 = make(), make("--bf16")
    losses = {"fp32": [], "bf16 from fp32's parameters": []}
    for it in range(BF16_GATE_STEPS):
        with torch.no_grad():
            for p16, p32 in zip(bf16.state.encoder.parameters(), fp32.state.encoder.parameters()):
                p16.copy_(p32)
        _, info16 = bf16.step(bf16.state, it)
        _, info32 = fp32.step(fp32.state, it)
        losses["bf16 from fp32's parameters"].append(info_scalars(info16)["loss_tsa"])
        losses["fp32"].append(info_scalars(info32)["loss_tsa"])
    del fp32, bf16
    losses["bf16"] = trajectory(make("--bf16"))
    losses["fp32 again"] = trajectory(make())
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    losses["fp32 with TF32"] = trajectory(make())
    parity_mode()
    torch.cuda.empty_cache()
    rels = {name: rel(losses["fp32"], v) for name, v in losses.items() if name != "fp32"}
    say(f"bf16 at full width, {BF16_GATE_STEPS} SG2-{SG2_SIZE} case-2 steps from one init and the same draws: "
        f"loss_tsa fp32 {[round(v, 4) for v in losses['fp32']]}; relative to it, per step:")
    for name, r in rels.items():
        say(f"  {name}: max {max(r):.3e}, {[f'{x:.2e}' for x in r]}")
    check(all(math.isfinite(v) for v in losses["bf16"]) and rels["bf16"][0] <= BF16_STEP_LOSS_RTOL,
          f"the first bf16 step's loss_tsa is {rels['bf16'][0]:.3e} from fp32's")
    held = max(rels["bf16"]) <= BF16_LOSS_RTOL and max(rels["bf16 from fp32's parameters"]) <= BF16_STEP_LOSS_RTOL
    say(f"  the first step within {BF16_STEP_LOSS_RTOL:g} (held); tpugan's trajectory gate at full width, bf16 "
        f"within {BF16_LOSS_RTOL:g} at every step and within {BF16_STEP_LOSS_RTOL:g} from fp32's parameters: "
        f"{'held' if held else 'not held'} (printed, not a check of this script)")

    images = {}
    for mtype, size, startf in (("2", SG2_SIZE, SG2_START_FEATURES), ("1", IMG_SIZE, 64)):
        argv = ["--mtype", mtype, "--img_size", str(size), "--start_features", str(startf), "--random_init",
                "--iterations", "1", "--batch_size", str(BATCH), "--seed", str(SEED)]
        trainer = e_align.build_trainer(parser.parse_args(argv + ["--device", CARD, "--bf16"]))
        bundle = common.build_bundle(parser.parse_args(argv + ["--device", CARD]))  # fp32, the same seed
        cpu_bundle = common.build_bundle(parser.parse_args(argv + ["--device", "cpu"]))
        request = infer_e.draw_request(cpu_bundle, BATCH, REQUEST_SEEDS[0])  # drawn on the CPU, for the replay
        runs = (("card", bundle, request.to(dev), trainer.bundle.generator, trainer.bundle.mapping),
                ("cpu", cpu_bundle, request, bf16_frozen(cpu_bundle.generator),
                 None if cpu_bundle.mapping is None else bf16_frozen(cpu_bundle.mapping)))
        out = {}
        for where, b, req, gen16, gm16 in runs:
            if mtype == "2":
                synth, resynth = build_stylegan2_pipeline(gen16)
            else:
                synth, resynth = build_stylegan1_pipeline(gen16, gm16, b.layer_count - 1)
            synth, resynth = bf16_pipeline(synth, resynth)
            with torch.no_grad():
                if where == "card":
                    imgs1, imgs2 = infer_e.serve(b, req)
                else:  # imgs1 alone
                    imgs1 = b.synth(req.z, req.noise_g).imgs1
                batch = synth(req.z, req.noise_g)
                out[f"{where} fp32"], out[f"{where} bf16"] = imgs1.cpu(), batch.imgs1.cpu()
                check(batch.imgs1.dtype == torch.float32, f"{where}: bf16 imgs1 of dtype {batch.imgs1.dtype}")
                if where == "card":
                    _, w2 = bf16_encode(b.encode, b.encoder)(batch, req.noise_e)
                    imgs2_16 = resynth(w2, batch, req.noise_g2)
                    d2 = (imgs2_16 - imgs2).abs().max().item() / imgs2.abs().max().item()
            torch.cuda.synchronize()
        ref = out["cpu fp32"]
        scale = ref.abs().max().item()
        dist = {k: (v - ref).abs().max().item() / scale for k, v in out.items() if k != "cpu fp32"}
        gate = (out["card bf16"] - out["card fp32"]).abs().max().item() / out["card fp32"].abs().max().item()
        name = f"SG2-{size}" if mtype == "2" else f"SGv1 Cat{size}"
        images[name] = {"imgs1_from_fp32": gate, "imgs2_from_fp32": d2, "limit": BF16_IMAGE_TOL[mtype],
                        "replay": dist}
        say(f"bf16, {name} request of seed {REQUEST_SEEDS[0]} (drawn on the CPU): imgs1 against the CPU's fp32 "
            f"images (max |value| {scale:.3f}), over that max: card fp32 {dist['card fp32']:.3e}, card bf16 "
            f"{dist['card bf16']:.3e}, CPU bf16 {dist['cpu bf16']:.3e}")
        check(dist["card fp32"] <= CPU_GPU_ATOL * max(1.0, scale) / scale and dist["card bf16"] <= 2 * dist["cpu bf16"],
              f"{name}: the card's bf16 imgs1 are {dist['card bf16']:.3e} from the CPU's fp32 ones, the CPU's bf16 "
              f"{dist['cpu bf16']:.3e}; the card's fp32 {dist['card fp32']:.3e}")
        say(f"  the card's fp32 imgs1 within CPU_GPU_ATOL x max(1, max |ref|) of the CPU's, its bf16 within twice "
            f"the CPU's bf16 distance: held; tpugan's image gate on the card, bf16 imgs1 within "
            f"{BF16_IMAGE_TOL[mtype]:g} of fp32's max |value|: {gate:.3e}, "
            f"{'held' if gate <= BF16_IMAGE_TOL[mtype] else 'not held'} (printed, not a check of this script); "
            f"imgs2 through the bf16 encoder {d2:.3e} from fp32's")
        del trainer, bundle, cpu_bundle, out, ref
        torch.cuda.empty_cache()
    return {"gate_configuration": {"loss_tsa": small, "loss_rel": small_rel,
                                   "trajectory_gate_held": small_held},
            "full_width": {"loss_tsa": losses, "loss_rel": rels, "trajectory_gate_held": held},
            "images": images}


def bf16_form_times(torch, step, state, label, symbols, kernels, fp32, fp32_from):
    """One bf16 form's host-clock step time and, from torch.profiler, its
    device time, the device time of ``symbols`` (named ``kernels`` in the
    print), peak memory and the convolutions' and GEMMs' split between bf16
    kernels and others; beside ``fp32``, the fp32 form's row of this run
    (from ``fp32_from``), where its device time was measured. Returns the
    row."""
    median = step_times(torch, step, state, f"{label}, bf16", 100, steps=BF16_TIMED_STEPS)
    row = {"median_ms": median}
    dev_time = step_device_time(torch, step, state, median, 200, symbols=symbols,
                                keep_kernels=True, iters=BF16_PROFILED_STEPS)
    if "kernels" not in dev_time:  # no trace saw device time
        row.update(dev_time)
        return row
    bf16_ms, other_ms, by_name = conv_split(dev_time.pop("kernels"))
    row.update(dev_time, bf16_conv_ms=bf16_ms, other_conv_ms=other_ms)
    say(f"  convolutions and GEMMs: bf16 kernels {bf16_ms:.3f} ms ({bf16_ms / dev_time['device_ms'] * 100:.1f}% "
        f"of device time), others {other_ms:.3f} ms; the bf16 ones by name:")
    for kname, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        say(f"    {ms:8.3f} ms  {kname[:100]}")
    if fp32 and "device_ms" in fp32:
        say(f"  {label} beside fp32 in this run ({fp32_from}): step {median:.3f} ms against "
            f"{fp32['median_ms']:.3f}, device time {dev_time['device_ms']:.3f} ms against "
            f"{fp32['device_ms']:.3f}, peak memory {dev_time['peak_mib']:.1f} MiB against "
            f"{fp32['peak_mib']:.1f}, {kernels} {sum(dev_time['kernel_ms'].values()):.3f} ms against "
            f"{sum(fp32['kernel_ms'].values()):.3f}")
    return row


def bf16_training_path(torch, dev, smi, bandwidth, fp32_peak, fp32_times):
    """Phase 10: ``e_align --bf16`` at full width, batch 2, random weights
    from the seed (tpugan's bf16 scheme): StyleGAN2-1024 case 2, case 1,
    lean and ablation 8, SGv1 Cat256 case 2 and ablation 8, with their FIR
    launches per step, forward and adjoint, by TPU kernel, against the
    counts derived from the modules, all through the kernel's bf16 form;
    the encoder moving on fp32 master parameters, the generator frozen;
    every FIR of each path's case-2 step on its own inputs against the
    plain version and the fp32 kernel, timed; step times, device time by
    kernel (bf16 tensor-core convolutions, the FIR), peak memory, beside
    the fp32 steps of phases 8 and 9 (``fp32_times``); tpugan's gates.
    Returns the FIR launches of the counted steps and the rows."""
    from tpugan_torch.cli import e_align
    from tpugan_torch.losses.lpips import random_lpips_fn
    from tpugan_torch.ops import cuda, upfirdn
    from tpugan_torch.train.e_align import info_scalars

    parser = e_align.make_parser()
    sizes = {"2": (SG2_SIZE, SG2_START_FEATURES), "1": (IMG_SIZE, 64)}
    lpips = random_lpips_fn(dev, dtype=torch.bfloat16)  # bench.py's bf16 LPIPS
    launches, per_step, times, firs = 0, {}, {}, {}
    trainer = None
    for label, mtype, flags in BF16_TRAIN_FORMS:
        t_form = time.perf_counter()
        lean = label.endswith("lean")  # case 1's trainer's off-tick step
        size, startf = sizes[mtype]
        args = parser.parse_args(["--mtype", mtype, "--img_size", str(size), "--start_features", str(startf),
                                  "--random_init", "--iterations", "1000", "--batch_size", str(BATCH),
                                  "--seed", str(SEED), "--device", CARD, "--bf16", *flags])
        if not lean:
            del trainer
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            trainer = e_align.build_trainer(args, lpips)
            torch.cuda.synchronize()
            enc = trainer.state.encoder
            say(f"trainer: mtype {mtype} --bf16, {label} ({' '.join(flags)}), {size} px, "
                f"{'E_Blur' if enc.block_0.use_blur else 'E'} (startf {startf}) training, built in "
                f"{time.perf_counter() - t0:.2f} s")
        step = trainer.lean if lean else trainer.step
        check(step is not None, f"bf16 {label}: no step")
        state = trainer.state
        gen = trainer.bundle.generator
        frozen = [*gen.parameters(), *gen.buffers()]
        if mtype == "1":
            frozen += [*trainer.bundle.mapping.parameters()]
        check(all(t.dtype == torch.bfloat16 for t in frozen), f"bf16 {label}: the generator is not bf16")
        frozen0 = [t.detach().clone() for t in frozen]
        params0 = {n: p.detach().clone() for n, p in state.encoder.named_parameters()}
        derive = sg2_step_firs if mtype == "2" else sgv1_step_firs
        fwd_want, adj_want = derive(trainer, step_image_gradients(e_align, args), not lean)

        # the main path: launches counted from 0
        torch.cuda.reset_peak_memory_stats()
        cuda.reset_launches()
        upfirdn.reset_layout_launches()
        with AdjointCount() as adjoint:
            for it in range(TRAIN_STEPS):
                _, info = step(state, it)
                scalars = info_scalars(info)
                check(all(math.isfinite(x) for x in scalars.values()), f"bf16 {label} step {it}: a loss is not finite")
            torch.cuda.synchronize()
        counted = dict(cuda.launches)
        total = dict(upfirdn.layout_launches)
        adj = dict(adjoint.counts)
        fwd = {key: total[key] - adj[key] for key in total}
        n_firs = sum(fwd_want.values()) + sum(adj_want.values())
        check(counted == expected_launches(upfirdn2d_bf16=n_firs * TRAIN_STEPS),
              f"bf16 {label}: launches {counted}, expected {n_firs * TRAIN_STEPS} upfirdn2d_bf16 and no other")
        want_fwd = {key: n * TRAIN_STEPS for key, n in fwd_want.items()}
        want_adj = {key: n * TRAIN_STEPS for key, n in adj_want.items()}
        check(fwd == want_fwd and adj == want_adj, f"bf16 {label}: FIR launches forward {fwd}, adjoint {adj}; "
              f"derived from the modules: forward {want_fwd}, adjoint {want_adj}")
        launches += counted["upfirdn2d_bf16"]
        per_step[label] = {"forward": fwd_want, "adjoint": adj_want}
        moved = sum(not torch.equal(p, params0[n]) for n, p in state.encoder.named_parameters())
        check(moved > 0 and all(p.dtype == torch.float32 and bool(torch.isfinite(p).all())
                                for p in state.encoder.parameters()),
              f"bf16 {label}: the encoder did not train, is not fp32 or is not finite")
        check(all(v.dtype == torch.float32 for st in state.optimizer.state.values() for v in st.values()
                  if torch.is_tensor(v) and v.is_floating_point()), f"bf16 {label}: optimizer state not fp32")
        check(all(torch.equal(a, b) and a.grad is None for a, b in zip(frozen, frozen0)),
              f"bf16 {label}: the frozen generator moved")
        say(f"bf16 {label} path: {TRAIN_STEPS} steps, launches {counted}; per step FIR forward {fwd_want}, "
            f"adjoint {adj_want}, as derived from the modules; loss_tsa {scalars['loss_tsa']:.4f}, loss_mtv "
            f"{scalars['loss_mtv']:.4f}; {moved} of {len(params0)} encoder parameters moved (fp32), the bf16 "
            f"generator did not; peak device memory over the counted steps "
            f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
        if label.endswith("case 2"):
            path = label.split()[0]
            say(f"{path} bf16 case-2 step FIRs below, on the step's own inputs: {smi}; device times from CUDA "
                "events around 20 calls queued behind a device-side sleep")
            firs[path] = bf16_step_fir_rows(torch, step, state, 50, bandwidth, fp32_peak, path)
        say(f"bf16 training times below: {smi}; step times from the host clock, device times from "
            "torch.profiler")
        times[label] = bf16_form_times(torch, step, state, label, ("upfirdn2d_kernel",), "upfirdn2d",
                                       fp32_times.get(label), "phases 8 and 9")
        say(f"bf16 {label} took {time.perf_counter() - t_form:.1f} s")
    del trainer
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gates = bf16_gates(torch, dev, e_align)
    say(f"bf16 gates took {time.perf_counter() - t0:.1f} s")
    check(set(firs) == {"SG2", "SGv1"}, "a bf16 case-2 step's FIRs were not timed")
    return {"launches": launches, "per_step": per_step, "times": times, "firs": firs,
            "max_abs_err": max(f[2] for f in firs.values()), "gates": gates}


# ---- phase 11: bf16 on the BigGAN-deep-256 path (e_align --mtype 4 --bf16) ----

# B3's bf16 form at widths that take each of its staging copies, beside
# ATTENTION_CASES: rows of a multiple of 8 elements (16-byte cp.async, the
# path's widths), even widths (4-byte cp.async), odd ones (one 2-byte load
# a thread), and views whose base lies 2 bytes (2-byte loads) and 8 bytes
# (4-byte copies) past a 16-byte boundary: (label, q, k, v shapes, offset of
# the base in elements)
ATTENTION_BF16_WIDTH_CASES = (
    ("16-byte rows", (1, 100, 64), (1, 80, 64), (1, 80, 128), 0),
    ("4-byte rows", (1, 100, 18), (1, 80, 18), (1, 80, 10), 0),
    ("2-byte rows", (1, 100, 13), (1, 80, 13), (1, 80, 7), 0),
    ("base 2 bytes off", (1, 100, 64), (1, 80, 64), (1, 80, 64), 1),
    ("base 8 bytes off", (1, 100, 64), (1, 80, 64), (1, 80, 64), 4),
)
# B3 and B4 bf16 at the path's shape: the replay's and the counted steps'
# forms, and the steps timed (host clock after 2 warm-ups; profiled)
BIGGAN_BF16_FORMS = ("case 2", "case 1", "case 1 lean")


def bf16_randn(torch, dev, gen, shape, scale=1.0, offset=0):
    """randn values rounded to bf16, as a view ``offset`` elements into a
    fresh buffer (0: its own, 16-byte aligned, allocation)."""
    flat = (torch.randn(math.prod(shape) + offset, device=dev, generator=gen) * scale).bfloat16()
    return flat[offset:].view(shape)


def bf16_tol_ratio(torch, got, want, rtol, atol):
    """max over the elements of |got - want| over one bf16 ulp of the larger
    magnitude plus the fp32 contract (atol + rtol |want|), and max |got -
    want|: a bf16 result of fp32 sums rounds once, so it lies within one
    ulp of the fp32 result, which meets the fp32 contract."""
    g, w = got.double(), want.double()
    err = (g - w).abs()
    return (err / (bf16_ulp(torch, g, w) + atol + rtol * w.abs())).max().item(), err.max().item()


def check_bf16_attention(torch, label, q, k, v, rtol, atol, instances=None):
    """B3's bf16 form on bf16 q, k, v: bitwise the fp32 kernel on the
    widened values, rounded to bf16 (its lse bitwise the fp32 kernel's);
    two runs bitwise equal; within one bf16 ulp plus (rtol, atol) of the
    plain version run in float64 on the same values (its lse within
    LSE_TOL). Adds the launched instance to ``instances``. Returns the max
    |err| against float64."""
    from tpugan_torch.ops.attention import sagan_attention_cuda

    got, lse = sagan_attention_cuda(q, k, v, return_lse=True)
    again = sagan_attention_cuda(q, k, v)
    if instances is not None:
        instances.add(launched_instance())
    f32, lse32 = sagan_attention_cuda(q.float(), k.float(), v.float(), return_lse=True)
    s64 = torch.bmm(q.double(), k.double().transpose(1, 2))
    want = torch.bmm(torch.softmax(s64, dim=-1), v.double())
    want_lse = torch.logsumexp(s64, dim=-1, keepdim=True)
    torch.cuda.synchronize()
    check(got.dtype == again.dtype == torch.bfloat16 and lse.dtype == torch.float32,
          f"{label}: dtypes {got.dtype}, {lse.dtype}")
    check(torch.equal(got, f32.bfloat16()) and torch.equal(lse, lse32),
          f"{label}: the bf16 kernel differs from the fp32 kernel on the widened inputs, rounded, by "
          f"{(got.float() - f32).abs().max().item():.3e} (lse {(lse - lse32).abs().max().item():.3e})")
    check(torch.equal(got, again), f"{label}: two runs of the bf16 kernel differ")
    ratio, err = bf16_tol_ratio(torch, got, want, rtol, atol)
    lse_err = (lse.double() - want_lse).abs().max().item()
    check(ratio <= 1.0 and torch.allclose(lse.double(), want_lse, rtol=LSE_TOL, atol=LSE_TOL),
          f"{label}: the bf16 kernel is {ratio:.2f} of one bf16 ulp plus (rtol {rtol:g}, atol {atol:g}) from "
          f"the plain version in float64 (max |err| {err:.3e}), lse {lse_err:.3e}")
    say(f"bf16 parity {label}: bitwise the fp32 kernel rounded (lse bitwise), two runs bitwise equal; "
        f"against float64 max |err| {err:.3e}, {ratio:.3f} of one ulp plus (rtol {rtol:g}, atol {atol:g}); "
        f"lse {lse_err:.3e}")
    return err


def check_bf16_attention_bwd(torch, label, q, k, v, o, lse, do):
    """B4's bf16 form on bf16 q, k, v, o, do (fp32 lse): dq, dk, dv bitwise
    the fp32 kernels' on the widened values, rounded; two runs bitwise
    equal; within one bf16 ulp plus BWD_TOL of the plain version run in
    float64 on the same values. Returns the max |err| against float64."""
    from tpugan_torch.ops.attention import sagan_attention_bwd_cuda, sagan_attention_bwd_plain

    got = sagan_attention_bwd_cuda(q, k, v, o, lse, do)
    again = sagan_attention_bwd_cuda(q, k, v, o, lse, do)
    f32 = sagan_attention_bwd_cuda(*(x.float() for x in (q, k, v, o, lse, do)))
    want = sagan_attention_bwd_plain(*(x.double() for x in (q, k, v, o, lse, do)))
    torch.cuda.synchronize()
    errs, parts = [], []
    for name, g, a, f, w in zip(("dq", "dk", "dv"), got, again, f32, want):
        check(g.dtype == torch.bfloat16 and g.shape == w.shape, f"{label}: {name} {g.dtype} {tuple(g.shape)}")
        check(torch.equal(g, f.bfloat16()), f"{label}: bf16 {name} differs from the fp32 kernel's on the "
              f"widened inputs, rounded, by {(g.float() - f).abs().max().item():.3e}")
        check(torch.equal(g, a), f"{label}: two runs of the bf16 backward differ in {name}")
        ratio, err = bf16_tol_ratio(torch, g, w, BWD_TOL, BWD_TOL)
        check(ratio <= 1.0, f"{label}: bf16 {name} is {ratio:.2f} of one bf16 ulp plus BWD_TOL from the plain "
              f"version in float64 (max |err| {err:.3e}, max |value| {w.abs().max().item():.3e})")
        errs.append(err)
        parts.append(f"{name} {err:.3e} ({ratio:.3f}; max |value| {w.abs().max().item():.3e})")
    say(f"bf16 parity {label}: dq, dk, dv bitwise the fp32 kernels' rounded, two runs bitwise equal; against "
        "float64 max |err| (share of one ulp plus BWD_TOL; max |value|) " + ", ".join(parts))
    return max(errs)


def attention_bf16_parity(torch, dev, gen):
    """Phase 11's kernel checks: B3's bf16 form at ATTENTION_CASES (every
    instance) and ATTENTION_BF16_WIDTH_CASES, B4's at ATTENTION_BWD_CASES
    and a view 2 bytes off, each held by check_bf16_attention(_bwd); mixed
    dtypes refused. Returns the max |err| against float64."""
    from tpugan_torch.ops import cuda
    from tpugan_torch.ops.attention import sagan_attention_bwd_cuda, sagan_attention_cuda

    cuda.reset_launches()
    cases = [(f"attention q{q_} k{k_} v{v_} x{scale:g}", q_, k_, v_, scale, rtol, atol, 0)
             for q_, k_, v_, scale, rtol, atol, _ in ATTENTION_CASES]
    cases += [(f"attention, {label}, q{q_} k{k_} v{v_}", q_, k_, v_, 1.0, 2e-5, 2e-5, offset)
              for label, q_, k_, v_, offset in ATTENTION_BF16_WIDTH_CASES]
    max_err, instances = 0.0, set()
    for label, q_shape, k_shape, v_shape, scale, rtol, atol, offset in cases:
        q = bf16_randn(torch, dev, gen, q_shape, scale, offset)
        k = bf16_randn(torch, dev, gen, k_shape, scale, offset)
        v = bf16_randn(torch, dev, gen, v_shape, 1.0, offset)
        max_err = max(max_err, check_bf16_attention(torch, label, q, k, v, rtol, atol, instances))
    cks, cvs = attention_tiers()
    check({(ck, cv) for ck, cv, _ in instances} == {(ck, cv) for ck in cks for cv in cvs}
          and {st for *_, st in instances} == {1, 2},
          f"the bf16 attention cases ran the instances {sorted(instances)}, not every one")
    n = len(cases)
    check(cuda.launches == expected_launches(sagan_attention_bf16=2 * n, sagan_attention=n),
          f"bf16 attention parity launches {cuda.launches}")

    cuda.reset_launches()
    bwd_cases = [(f"attention backward q{q_} k{k_} v{v_} x{scale:g}", q_, k_, v_, scale, 0)
                 for q_, k_, v_, scale in ATTENTION_BWD_CASES]
    bwd_cases.append(("attention backward, base 2 bytes off", (1, 100, 64), (1, 80, 64), (1, 80, 256), 1.0, 1))
    for label, q_shape, k_shape, v_shape, scale, offset in bwd_cases:
        q = bf16_randn(torch, dev, gen, q_shape, scale, offset)
        k = bf16_randn(torch, dev, gen, k_shape, scale, offset)
        v = bf16_randn(torch, dev, gen, v_shape, 1.0, offset)
        do = bf16_randn(torch, dev, gen, (q_shape[0], q_shape[1], v_shape[2]), 1.0, offset)
        o, lse = sagan_attention_cuda(q, k, v, return_lse=True)
        max_err = max(max_err, check_bf16_attention_bwd(torch, label, q, k, v, o, lse, do))
    n = len(bwd_cases)
    check(cuda.launches == expected_launches(
        sagan_attention_bf16=n, **{name: n for name in B4_KERNELS},
        **{f"{name}_bf16": 2 * n for name in B4_KERNELS}), f"bf16 backward parity launches {cuda.launches}")

    cuda.reset_launches()
    x = bf16_randn(torch, dev, gen, (2, 8, 16))
    o, lse = sagan_attention_cuda(x, x, x, return_lse=True)
    cuda.reset_launches()
    refused = {
        "q bf16, k and v fp32": lambda: sagan_attention_cuda(x, x.float(), x.float()),
        "v fp32": lambda: sagan_attention_cuda(x, x, x.float()),
        "fp16": lambda: sagan_attention_cuda(x.half(), x.half(), x.half()),
        "backward, do fp32": lambda: sagan_attention_bwd_cuda(x, x, x, o, lse, o.float()),
        "backward, o fp32": lambda: sagan_attention_bwd_cuda(x, x, x, o.float(), lse, o),
        "backward, lse bf16": lambda: sagan_attention_bwd_cuda(x, x, x, o, lse.bfloat16(), o),
        "backward, q fp32": lambda: sagan_attention_bwd_cuda(x.float(), x, x, o, lse, o),
    }
    for name, call in refused.items():
        try:
            call()
        except TypeError:
            continue
        raise RuntimeError(f"chip_smoke: a mixed-dtype attention call ({name}) was not refused")
    check(not any(cuda.launches.values()), "a refused mixed-dtype call launched")
    say(f"bf16 attention parity: {len(cases)} forward cases over the instances {sorted(instances)}, "
        f"{len(bwd_cases)} backward cases, all bitwise the fp32 kernels on the widened inputs rounded to "
        f"bf16 (max |err| against float64 {max_err:.3e}); {len(refused)} mixed-dtype calls refused: "
        + ", ".join(refused))
    torch.cuda.empty_cache()
    return max_err


def attention_bf16_times(torch, dev, gen, bandwidth, tf32_peak, bf16_peak):
    """B3's and B4's bf16 forms at the path's shape (ATTN_PATH_SHAPE, randn
    values rounded to bf16), warm, beside the fp32 kernel on the same
    values, the plain version, scaled_dot_product_attention (and its
    backward) on the widened fp32 inputs and on the bf16 ones (in whatever
    arithmetic it picks for bf16; the kernels it ran are printed), and the
    bound: the function's products on the tensor cores, each at the least
    time that gives it exactly (one dense bf16 pass where both operands are
    bf16; where one is fp32, p or ds, the fewer of two dense TF32 passes
    and three bf16 ones, the fp32 operand split into two TF32 or three
    bf16 pieces), or its bytes at the memory rate. Timed with phase
    2's, before any path is profiled: traced after the paths, the profiler
    has read the fp32 B3 at 48.17 us against 98.76 us from CUDA events (an
    H100 80GB HBM3 at 700 W). Returns the two kernel table rows' timing
    keys."""
    import torch.nn.functional as F

    from tpugan_torch.ops.attention import (
        sagan_attention_bwd_cuda,
        sagan_attention_bwd_plain,
        sagan_attention_cuda,
        sagan_attention_plain,
    )

    (n, lq, dk), (_, lk, _), (_, _, dv) = ATTN_PATH_SHAPE
    q, k, v = (bf16_randn(torch, dev, gen, shape) for shape in ATTN_PATH_SHAPE)
    do = bf16_randn(torch, dev, gen, (n, lq, dv))
    o, lse = sagan_attention_cuda(q, k, v, return_lse=True)
    q32, k32, v32, o32, do32 = (x.float() for x in (q, k, v, o, do))
    shape = f"q [{n}, {lq}, {dk}], k [{n}, {lk}, {dk}], v [{n}, {lk}, {dv}], bf16"
    pairs = 2 * n * lq * lk  # 2 x the score matrix's entries: a product's FLOPs per unit of width

    # seconds per FLOP of a product with one fp32 operand, and its name
    mixed_s, mixed_as = min((2 / tf32_peak, f"two TF32 passes at {tf32_peak / 1e12:g} TFLOP/s"),
                            (3 / bf16_peak, f"three bf16 passes at {bf16_peak / 1e12:g} TFLOP/s"))

    def report(name, row, names, issue, bf16_flops, mixed_flops, nbytes, lib_err, lib16_err):
        ops_s = bf16_flops / bf16_peak + mixed_flops * mixed_s
        row["bound_ms"] = max(nbytes / bandwidth, ops_s) * 1e3
        row["bound_by"] = "bytes" if nbytes / bandwidth >= ops_s else "operations"
        say(f"{name} bf16 at the path's shape ({shape}): device time bf16 kernel {row['ms'] * 1e3:.2f} us "
            f"({row['ms_from']}), fp32 kernel on the same values {row['fp32_ms'] * 1e3:.2f} us "
            f"({row['fp32_ms_from']}), plain {row['plain_ms'] * 1e3:.2f} us, library on the widened fp32 inputs "
            f"{row['library_ms'] * 1e3:.2f} us, library on the bf16 inputs {row['library_bf16_ms'] * 1e3:.2f} us "
            "(torch.profiler); back to back per call: "
            + ", ".join(f"{k_} {v_ * 1e3:.2f} us" for k_, v_ in issue.items()))
        say(f"  bound {row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}: {bf16_flops / 1e9:.3f} GFLOP of bf16 by "
            f"bf16 products at {bf16_peak / 1e12:g} TFLOP/s dense bf16 and {mixed_flops / 1e9:.3f} GFLOP with an "
            f"fp32 operand, each in {mixed_as}; {nbytes / 1e6:.3f} MB at {bandwidth / 1e12:.2f} TB/s), "
            f"{row['bound_ms'] / row['ms'] * 100:.1f}% of it")
        say(f"  library on fp32 ran {', '.join(x[:70] for x in names['library_ms'][:5])} (max |err| "
            f"{lib_err:.3e} against the plain version); on bf16 {', '.join(x[:70] for x in names['library_bf16_ms'][:5])} "
            f"(max |err| {lib16_err:.3e})")
        row["library_kernels"] = [x[:100] for x in names["library_ms"]]
        row["library_bf16_kernels"] = [x[:100] for x in names["library_bf16_ms"]]

    # B3
    plain = sagan_attention_plain(q, k, v)
    lib = lambda: F.scaled_dot_product_attention(q32, k32, v32, scale=1.0)  # noqa: E731
    lib16 = lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0)  # noqa: E731
    lib_err = (lib() - plain.float()).abs().max().item()
    lib16_err = (lib16().float() - plain.float()).abs().max().item()
    check(lib_err < 2e-2, f"scaled_dot_product_attention differs by {lib_err:.3e}")
    b3, names, _, issue = time_calls(torch, {
        "ms": lambda: sagan_attention_cuda(q, k, v),
        "fp32_ms": lambda: sagan_attention_cuda(q32, k32, v32),
        "plain_ms": lambda: sagan_attention_plain(q, k, v),
        "library_ms": lib,
        "library_bf16_ms": lib16,
    }, ("sagan_attention_kernel",))
    report("attention", b3, names, issue, pairs * dk, pairs * dv,  # s; p v
           2 * (q.numel() + k.numel() + v.numel() + o.numel()), lib_err, lib16_err)
    b3["times_are"] = (f"one call at the BigGAN-{BIGGAN_SIZE} paths' shape ({shape}), randn values rounded to "
                       f"bf16, before any path is profiled; bound_ms: s in one pass at the dense bf16 rate, p v "
                       f"(p fp32) in {mixed_as}; library_ms: scaled_dot_product_attention on the widened fp32 inputs, "
                       "library_bf16_ms on the bf16 inputs (library_bf16_kernels: what it ran)")

    # B4
    want = sagan_attention_bwd_plain(q, k, v, o, lse, do)
    grads = {}
    for key, args in (("library_ms", (q32, k32, v32)), ("library_bf16_ms", (q, k, v))):
        leaves = [x.clone().requires_grad_() for x in args]
        out = F.scaled_dot_product_attention(*leaves, scale=1.0)
        grads[key] = (lambda out=out, leaves=leaves, g=do32 if key == "library_ms" else do:
                      torch.autograd.grad(out, leaves, g, retain_graph=True))
    lib_err, lib16_err = (max((a.float() - b.float()).abs().max().item() / b.float().abs().max().item()
                              for a, b in zip(grads[key](), want)) for key in ("library_ms", "library_bf16_ms"))
    check(lib_err < 2e-2, f"scaled_dot_product_attention's backward differs by {lib_err:.3e} (rel)")
    b4, names, _, issue = time_calls(torch, {
        "ms": lambda: sagan_attention_bwd_cuda(q, k, v, o, lse, do),
        "fp32_ms": lambda: sagan_attention_bwd_cuda(q32, k32, v32, o32, lse, do32),
        "plain_ms": lambda: sagan_attention_bwd_plain(q, k, v, o, lse, do),
        **grads,
    }, B4_SYMBOLS)
    report("attention backward", b4, names, issue, pairs * dk + pairs * dv,  # s, dp
           pairs * dv + 2 * pairs * dk,  # dv; dq, dk
           2 * (2 * q.numel() + 2 * k.numel() + 2 * v.numel() + o.numel() + do.numel()) + 4 * lse.numel(),
           lib_err, lib16_err)
    b4["times_are"] = (f"one call (delta in fp32, pack, dq and dkv) at the BigGAN-{BIGGAN_SIZE} case-2 step's "
                       f"shape ({shape}), randn values rounded to bf16, before any path is profiled; bound_ms: s "
                       f"and dp in one pass at the dense bf16 rate, dv, dq and dk (p or ds fp32) in {mixed_as}; "
                       "library_ms: the backward of scaled_dot_product_attention on the widened fp32 inputs, "
                       "library_bf16_ms on the bf16 inputs (library_bf16_kernels: what it ran)")
    del grads
    torch.cuda.empty_cache()
    return b3, b4


def replay_bf16_case2_on_cpu(torch, dev, e_align):
    """replay_steps in bf16 on the card and on the CPU, and in fp32 on the
    CPU: the card's bf16 loss_tsa and first gradients no farther from the
    CPU's fp32 ones than twice the CPU's bf16 ones are (the rule of
    tests/test_torch_bf16.py against tpugan). Returns the distances."""
    factor, runs = replay_steps(torch, dev, e_align, (("card bf16", CARD, True), ("cpu fp32", "cpu", False),
                                                      ("cpu bf16", "cpu", True)))
    (loss_g, grads_g, sec_g), (loss_r, grads_r, sec_r), (loss_c, grads_c, sec_c) = (
        runs["card bf16"], runs["cpu fp32"], runs["cpu bf16"])
    say(f"bf16 replay of a case-2 step: BigGAN-deep-{BIGGAN_SIZE}'s layout at channel width "
        f"{REPLAY_CHANNEL_WIDTH}, E_BIG at start_features {REPLAY_START_FEATURES}, batch {BATCH}, random bf16 "
        f"LPIPS, gamma {ATTN_GAMMA:g}, z head scaled by {factor:.4e}; the step took {sec_g:.2f} s on the card "
        f"(first call), {sec_r:.2f} s on the CPU in fp32 and {sec_c:.2f} s in bf16")
    out = {}
    mine, theirs = abs(loss_g - loss_r) / abs(loss_r), abs(loss_c - loss_r) / abs(loss_r)
    out["loss_tsa"] = {"card_bf16": loss_g, "cpu_fp32": loss_r, "cpu_bf16": loss_c, "card_rel": mine,
                       "cpu_rel": theirs}
    say(f"  loss_tsa: CPU fp32 {loss_r:.6f}; card bf16 {loss_g:.6f} ({mine:.3e} from it), CPU bf16 {loss_c:.6f} "
        f"({theirs:.3e})")
    check(all(math.isfinite(x) for x in (loss_g, loss_r, loss_c)) and mine <= 2 * theirs,
          f"the card's bf16 loss_tsa is {mine:.3e} from the CPU's fp32, the CPU's bf16 {theirs:.3e}")
    for name in REPLAY_LEAVES:
        ref = grads_r[name]
        scale = ref.abs().max().item()
        mine = (grads_g[name] - ref).abs().max().item()
        theirs = (grads_c[name] - ref).abs().max().item()
        out[name] = {"card": mine, "cpu": theirs, "max_abs": scale}
        say(f"  first gradient of {name}: card bf16 {mine:.3e} from the CPU's fp32 (max |g| {scale:.3e}), "
            f"CPU bf16 {theirs:.3e}: {mine / theirs:.3f} of it")
        check(scale > 0 and theirs > 0 and mine <= 2 * theirs,
              f"the card's bf16 gradient of {name} is {mine:.3e} from fp32's, the CPU's bf16 {theirs:.3e}")
    return out


def biggan_bf16_training_path(torch, dev, smi, fp32_times):
    """Phase 11: ``e_align --mtype 4 --bf16`` at full width (BigGAN-deep-256,
    E_BIG startf 64, batch 2, random weights from the seed): case 2 on the
    CLI's weights, then with every SelfAttn gamma of the bf16 generator the
    step runs at ATTN_GAMMA and E_BIG's z head scaled; B3 and B4 bf16 on a
    step's own inputs; counted case-2, case-1 and lean steps against the
    launches derived from the modules (2 forward a case-2 or case-1 step, 1
    a lean one, pack, dq and dkv once a case-2 step; no fp32 attention, no
    plain version on a CUDA tensor); the encoder moving on fp32 masters,
    the bf16 generator frozen; step times, device time by kernel and peak
    memory beside phase 6's fp32 steps (``fp32_times``); the bf16 replay.
    Returns the launches by kernel, the max |err| and the times."""
    from tpugan_torch.cli import e_align, infer_e
    from tpugan_torch.losses.lpips import random_lpips_fn
    from tpugan_torch.ops import attention, cuda
    from tpugan_torch.train.e_align import info_scalars

    parser = e_align.make_parser()
    argv = ["--mtype", "4", "--img_size", str(BIGGAN_SIZE), "--start_features", "64",
            "--z_dim", str(BIGGAN_Z_DIM), "--random_init", "--iterations", "1000",
            "--batch_size", str(BATCH), "--seed", str(SEED), "--device", CARD, "--bf16"]
    lpips = random_lpips_fn(dev, dtype=torch.bfloat16)  # bench.py's bf16 LPIPS

    # the CLI's own weights: one case-2 step
    trainer = e_align.build_trainer(parser.parse_args(argv + ["--case", "2"]), lpips)
    zt_std, z2_std = latent_stds(torch, infer_e, trainer.bundle, REQUEST_SEEDS[0])
    factor = zt_std / z2_std
    _, info = trainer.step(trainer.state, 0)
    scalars = info_scalars(info)
    say(f"bf16 case 2 on the CLI's weights (every gamma 0, z2 std {z2_std:.4f}): loss_tsa {scalars['loss_tsa']}, "
        f"loss_mtv {scalars['loss_mtv']}")
    del trainer, info

    trainer = e_align.build_trainer(parser.parse_args(argv + ["--case", "2"]), lpips)
    state, gen = trainer.state, trainer.bundle.generator
    check(all(t.dtype == torch.bfloat16 for t in [*gen.parameters(), *gen.buffers()]),
          "the trainer's generator is not the bf16 copy")
    scale_z_head(torch, state.encoder, factor)
    before = trainer.visuals(state, 1)
    check(set_attention_gamma(torch, gen, ATTN_GAMMA) == 1, "expected one SelfAttn")
    after = trainer.visuals(state, 1)
    moved = max((after[key] - before[key]).abs().max().item() for key in ("imgs1", "imgs2"))
    check(moved > 1e-2, f"gamma {ATTN_GAMMA:g} on the bf16 generator moved the images by {moved:.3e}")
    say(f"bf16 case 2 from here on: every SelfAttn gamma of the bf16 generator the step runs {ATTN_GAMMA:g} "
        f"(moved the step's images by up to {moved:.3f}), E_BIG's z head scaled by {factor:.4e}")

    captured = {"fwd": [], "bwd": []}
    real_fwd, real_bwd = attention.sagan_attention_cuda, attention.sagan_attention_bwd_cuda

    def capture_fwd(q_, k_, v_, return_lse=False):
        captured["fwd"].append((q_.detach().clone(), k_.detach().clone(), v_.detach().clone(), return_lse))
        return real_fwd(q_, k_, v_, return_lse)

    def capture_bwd(*args):
        captured["bwd"].append(tuple(x.detach().clone() for x in args))
        return real_bwd(*args)

    attention.sagan_attention_cuda, attention.sagan_attention_bwd_cuda = capture_fwd, capture_bwd
    try:
        trainer.step(state, 1)
    finally:
        attention.sagan_attention_cuda, attention.sagan_attention_bwd_cuda = real_fwd, real_bwd
    check([flag for *_, flag in captured["fwd"]] == [False, True] and len(captured["bwd"]) == 1,
          f"a bf16 case-2 step ran the forward {len(captured['fwd'])} times, the backward {len(captured['bwd'])}")
    max_err = 0.0
    for i, (q, k, v, _) in enumerate(captured["fwd"]):
        check(q.dtype == k.dtype == v.dtype == torch.bfloat16, f"the step's attention {i} is {q.dtype}")
        max_err = max(max_err, check_bf16_attention(
            torch, f"attention, the bf16 case-2 step's own inputs ({'resynthesis' if i else 'synthesis'})",
            q, k, v, 2e-5, 2e-5))
    q, k, v, o, lse, do = captured["bwd"][0]
    check(do.dtype == torch.bfloat16 and lse.dtype == torch.float32 and do.abs().max().item() > 0,
          f"the step's attention backward: do {do.dtype}, max |do| {do.abs().max().item():.3e}, lse {lse.dtype}")
    say(f"the bf16 step's own backward inputs: q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}, max |q k^T| "
        f"{torch.bmm(q.float(), k.float().transpose(1, 2)).abs().max().item():.2f}, max |do| "
        f"{do.abs().max().item():.3e}")
    max_err = max(max_err, check_bf16_attention_bwd(torch, "attention backward, the bf16 case-2 step's own inputs",
                                                    q, k, v, o, lse, do))
    del captured, q, k, v, o, lse, do

    # the main path: counted steps, the plain versions watched for CUDA tensors
    plain_on_card = []
    real_plain, real_plain_bwd = attention.sagan_attention_plain, attention.sagan_attention_bwd_plain

    def watch(fn):
        def watched(*args, **kwargs):
            if args[0].is_cuda:
                plain_on_card.append(fn.__name__)
            return fn(*args, **kwargs)
        return watched

    launches = {name: 0 for name in cuda.KERNELS}
    times = {}
    for label in BIGGAN_BF16_FORMS:
        if label == "case 1":
            del trainer, state
            torch.cuda.empty_cache()
            trainer = e_align.build_trainer(parser.parse_args(argv + ["--case", "1"]), lpips)
            state, gen = trainer.state, trainer.bundle.generator
        step = trainer.lean if label.endswith("lean") else trainer.step
        params0, uv0 = encoder_snapshot(state.encoder)
        gen0 = [t.detach().clone() for t in [*gen.parameters(), *gen.buffers()]]
        attention.sagan_attention_plain = watch(real_plain)
        attention.sagan_attention_bwd_plain = watch(real_plain_bwd)
        cuda.reset_launches()
        try:
            for it in range(2, 2 + TRAIN_STEPS):
                _, info = step(state, it)
                scalars = info_scalars(info)
                check(math.isfinite(scalars["loss_mtv"]) and (label != "case 2" or math.isfinite(scalars["loss_tsa"])),
                      f"bf16 {label} step {it}: a loss is not finite")
            torch.cuda.synchronize()
        finally:
            attention.sagan_attention_plain, attention.sagan_attention_bwd_plain = real_plain, real_plain_bwd
        counted = dict(cuda.launches)
        per_step = {"sagan_attention_bf16": 1 if label.endswith("lean") else 2}
        if label == "case 2":
            per_step.update({f"{name}_bf16": 1 for name in B4_KERNELS})
        want = expected_launches(**{name: n * TRAIN_STEPS for name, n in per_step.items()})
        check(counted == want, f"bf16 {label} launches {counted}, expected {want}")
        check(not plain_on_card, f"bf16 {label}: the plain version ran on CUDA tensors: {plain_on_card}")
        for name, n in counted.items():
            launches[name] += n
        moved = sum(not torch.equal(p, params0[n]) for n, p in state.encoder.named_parameters())
        uv_moved = sum(not torch.equal(b, uv0[n]) for n, b in state.encoder.named_buffers() if n in uv0)
        # case 2 trains every parameter; case 1 those its latent losses reach, as phase 6 holds them
        check((moved == len(params0) if label == "case 2" else moved > 0) and uv_moved == len(uv0)
              and all(p.dtype == torch.float32 for p in state.encoder.parameters())
              and all(state.encoder.get_buffer(n).dtype == torch.float32 for n in uv0),
              f"bf16 {label}: E_BIG moved {moved}/{len(params0)} parameters, {uv_moved}/{len(uv0)} u/v buffers, "
              "or they are not fp32")
        check(all(torch.equal(a, b) and a.grad is None for a, b in zip([*gen.parameters(), *gen.buffers()], gen0)),
              f"bf16 {label}: the bf16 BigGAN moved")
        say(f"bf16 {label} path: {TRAIN_STEPS} steps, launches {counted}; loss_mtv {scalars['loss_mtv']:.4f}, "
            f"loss_tsa {scalars['loss_tsa']:.4f}; {moved} of {len(params0)} E_BIG parameters and {uv_moved} u/v buffers "
            "moved (fp32), "
            f"the bf16 BigGAN's {len(gen0)} tensors did not; no plain version on a CUDA tensor")
        del gen0

        say(f"bf16 training times below: {smi}; step times from the host clock, device times from torch.profiler")
        times[label] = bf16_form_times(torch, step, state, f"mtype 4 {label}",
                                       ("sagan_attention_kernel",) + B4_SYMBOLS, "B3 and B4",
                                       fp32_times.get(label), "phase 6")
    del trainer, state
    torch.cuda.empty_cache()
    with cudnn_deterministic(torch):  # the comment at CPU_GPU_ATOL
        replay = replay_bf16_case2_on_cpu(torch, dev, e_align)
    return {"launches": launches, "max_abs_err": max_err, "times": times, "replay": replay}



# phase 12, real-image inversion (tpugan/cli/embedding.py's defaults: batch
# 1, lr 0.01, fine-tuning E). Each form runs the embedding CLI's own loop
# (cli/embedding.py: build_inverter, then run) on one target PNG that the
# script writes (the bundle's own imgs1 at INV_TARGET_SEED) and run reads
# back through io/image.load_image_dir: INV_ITERATIONS iterations in chunks
# of INV_CHUNK, random LPIPS injected (a bf16 LPIPS with --bf16, as tpugan
# builds it without --fp32_lpips). (label, embedding flags)
INV_SG2 = ("--mtype", "2", "--img_size", str(SG2_SIZE), "--start_features", str(SG2_START_FEATURES))
INV_BIGGAN = ("--mtype", "4", "--img_size", str(BIGGAN_SIZE), "--start_features", "64", "--z_dim",
              str(BIGGAN_Z_DIM), "--class_id", "30")
INV_SGV1 = ("--mtype", "1", "--img_size", str(IMG_SIZE), "--start_features", "64")
# E_BIG's own training lr (e_align's default): at the CLI's 0.01 a random
# E_BIG's first LREQAdam update (each weight moved by about lr; its z head
# is a plain linear of fan-in 8192, coefficient 1) sends z and BigGAN's
# resynthesis to NaN at the next iteration. The port's plain path does the
# same on the CPU in float64, with the attention's backward by autograd and
# with E_BIG's u/v converged (tpugan_torch/tools/inversion_lr.py)
INV_BIGGAN_LR = 0.0015
INV_FORMS = (
    ("SG2 fine-tune E", INV_SG2 + ("--optimizeE", "true")),
    ("SG2 optimise w", INV_SG2 + ("--optimizeE", "false")),
    ("SG2 fine-tune E bf16", INV_SG2 + ("--optimizeE", "true", "--bf16")),
    ("BigGAN fine-tune E", INV_BIGGAN + ("--optimizeE", "true", "--lr", str(INV_BIGGAN_LR))),
    ("SGv1 fine-tune E", INV_SGV1 + ("--optimizeE", "true")),
)
INV_ITERATIONS = 4
INV_CHUNK = 2
INV_TARGET_SEED = 30003  # held out: past infer_e's three request seeds
INV_TIMED = 6  # host-clock iterations of each form, after 2 warm-up ones
INV_PROFILED = (1, 2)  # iterations of two profiled inversions (warm); their difference is one iteration
# The replay: tpugan's bf16 gate configuration (StyleGAN2 at 64 px,
# BF16_GATE_SG2, with E: BF16_GATE_ENCODER without its blur, as the
# embedding CLI builds E), random weights from SEED, its target and draws
# made on the CPU; INV_REPLAY_ITERATIONS iterations in each mode on the
# card, on the CPU and on the CPU in float64. loss_msiv and loss_mslv of
# each iteration within REPLAY_LOSS_RTOL of float64, the arm and the
# improvements equal; w, the snapshot's w and the images no farther from
# float64 than twice the CPU fp32 run is (PR 12's rule; LREQAdam's first
# update is about lr * c * sign(g), so an element whose gradient is near
# zero moves with fp32's rounding), or REPLAY_FLOOR x max |ref| where the
# CPU's distance rounds to less. The card in TF32 is the control that must
# exceed that limit. bf16, fine-tuning E: the card's bf16 no farther from
# the CPU's fp32 than twice the CPU's bf16 is, on w, loss_msiv and the
# images. baseline_i2s's Adam: INV_REPLAY_STEPS steps from w = 0 at the same
# configuration, held as the fp32 inversion. rec_real_img and edit: the
# CLIs at INV_REPLAY_CLI (StyleGAN2 config F at 32 px) on the card and on
# the CPU, from the same seed and PNG: w within CPU_GPU_ATOL x max(1, max
# |ref|), the PNGs within one level of 255. The card's runs of the inversion
# and of baseline_i2s use cuDNN's deterministic algorithms (the comment at
# CPU_GPU_ATOL), and two card runs of baseline_i2s must be bitwise equal.
# REPLAY_FLOOR, of max |ref|, is about 17 fp32 epsilons: where the CPU's own
# distance is a few ulps (optimising w, 1.3e-6 of values about 3.2), twice it
# is rounding noise, which the card's reaches (1.78x on an H100)
REPLAY_FLOOR = 2e-6
INV_REPLAY_ENCODER = dict(BF16_GATE_ENCODER, use_blur=False)
INV_REPLAY_ITERATIONS = 2
INV_REPLAY_STEPS = 3
INV_REPLAY_CLI = ("--mtype", "2", "--img_size", "32", "--start_features", "64")
INV_I2S_ITERATIONS = 100  # baseline_i2s at full width: one chunk of 100 iterations (its least)


class IterationClock:
    """At the end of each inversion iteration, which is its second LREQAdam
    update, a synchronize, the host clock and the kernels' launch counts."""

    def __init__(self, torch):
        from tpugan_torch.ops import cuda
        from tpugan_torch.optim.lreq_adam import LREQAdam

        self.torch, self.cuda, self.cls, self.marks = torch, cuda, LREQAdam, []

    def __enter__(self):
        real, marks, torch, cuda, calls = self.cls.step, self.marks, self.torch, self.cuda, [0]
        self.real = real

        def step(opt, grads=None):
            out = real(opt, grads)
            calls[0] += 1
            if calls[0] % 2 == 0:
                torch.cuda.synchronize()
                marks.append((time.perf_counter(), dict(cuda.launches)))
            return out

        self.cls.step = step
        return self

    def __exit__(self, *exc):
        self.cls.step = self.real


def inversion_launches(inverter, iterations, chunk, snapshot):
    """One ``embedding`` run's launches, derived from the modules: each
    iteration decodes once with the graph (the resynthesis of w1) and takes
    two gradients back through that decode (loss_msiv's through the images,
    loss_mslv's through E(imgs2)); the callback at 0 and after each chunk,
    the final reconstruction and the snapshot's grid (``snapshot``) decode
    once each without it. The CLI's E has no blur, so it runs no FIR.
    Returns the FIR launches by TPU kernel, forward and adjoint, of the run
    and of one iteration, and the attention's of the run and of one
    iteration (B3 once a decode; B4's pack, dq and dkv once a gradient)."""
    gen, enc, mtype = inverter.generator, inverter.bundle.encoder, inverter.bundle.mtype
    check(not any(getattr(m, "use_blur", False) for m in enc.modules()), "the inversion's E has a blur")
    decodes = iterations + 2 + math.ceil(iterations / chunk) + snapshot
    empty = {}
    if mtype == 2:
        fwd, adj = sg2_decode_firs(gen), sg2_decode_adjoint_firs(gen)
    elif mtype == 1:
        fwd = adj = sgv1_decode_firs(gen)
    else:
        return empty, empty, empty, {"B3": decodes, "B4": 2 * iterations}, {"B3": 1, "B4": 2}
    run = ({k: n * decodes for k, n in fwd.items()}, {k: n * 2 * iterations for k, n in adj.items()})
    return run[0], run[1], {"forward": fwd, "adjoint": {k: 2 * n for k, n in adj.items()}}, empty, empty


def hold_captured_firs(torch, capture, label, dtype, directions=("forward", "adjoint"), what="iteration"):
    """Every distinct FIR that ``capture`` (:class:`FirCapture`) kept, in
    each of ``directions``, on its own input: fp32 within KERNEL_TOL of the
    plain version, bf16 within one bf16 ulp of it and bitwise the fp32
    kernel rounded (:func:`check_bf16_fir`), as phases 9 and 10 hold a
    step's. Returns the max |err|."""
    from tpugan_torch.ops import upfirdn

    max_err, launches = 0.0, {}
    for (direction, shape, _, up, down, pads), (x, taps, n) in capture.firs.items():
        check(x.dtype == dtype, f"{label}: a {x.dtype} FIR on the {dtype} path")
        name = f"{label} FIR {direction} {list(shape)} up{up} down{down} pads {list(pads)}"
        got, want = upfirdn._fir_cuda(x, taps, up, down, pads), upfirdn._fir_plain(x, taps, up, down, pads)
        if dtype == torch.bfloat16:
            f32 = upfirdn._fir_cuda(x.float(), taps, up, down, pads).bfloat16()
            torch.cuda.synchronize()
            err = check_bf16_fir(torch, name, got, want, f32)
            del f32
        else:
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            check(got.shape == want.shape and torch.allclose(got, want, rtol=KERNEL_TOL, atol=KERNEL_TOL),
                  f"{name}: kernel disagrees with the plain version, max |err| {err:.3e}")
        max_err = max(max_err, err)
        launches[direction] = launches.get(direction, 0) + n
        del got, want
    check(set(launches) == set(directions), f"{label}: FIRs captured {launches}")
    tol = "one bf16 ulp, bitwise the fp32 kernel rounded" if dtype == torch.bfloat16 else f"{KERNEL_TOL:g}"
    say(f"parity {label}: every FIR of one {what} on its own inputs, {len(capture.firs)} distinct calls ("
        + ", ".join(f"{launches[d]} {d}" for d in directions) + f" launches), within {tol} of the plain "
        f"version (max |err| {max_err:.3e})")
    return max_err


def rechunked(inverter, args, chunk, lpips_fn=None):
    """``inverter`` with its embedder rebuilt through ``make_embedder`` as
    ``build_inverter`` builds it, with a callback every ``chunk`` iterations
    (the CLI's is tpugan's 100)."""
    from tpugan_torch.cli import embedding
    from tpugan_torch.invert import make_embedder

    return inverter._replace(invert=make_embedder(inverter.encode, inverter.resynth, inverter.bundle.encoder,
                                                  embedding.embedding_config(args, chunk=chunk),
                                                  lpips_fn=lpips_fn, vgg=inverter.vgg))


def write_target(torch, bundle, directory):
    """The bundle's own imgs1 at INV_TARGET_SEED, as a PNG in ``directory``."""
    import os

    import numpy as np

    from tpugan_torch.cli import infer_e
    from tpugan_torch.io.image import save_image, to_unit

    request = infer_e.draw_request(bundle, 1, INV_TARGET_SEED)
    imgs1 = bundle.synth(request.z, request.label if bundle.mtype == 4 else request.noise_g).imgs1
    check(bool(torch.isfinite(imgs1).all()), "the target image is not finite")
    os.makedirs(directory, exist_ok=True)
    save_image(os.path.join(directory, "00000.png"), np.clip(to_unit(imgs1[0]), 0, 1))


def inversion_form(torch, dev, smi, label, flags, workdir):
    """One form of phase 12 (:data:`INV_FORMS`): the CLI's run with its
    launches counted against :func:`inversion_launches`, its files, the
    encoder moving and restored, the generator frozen; then the iteration's
    host-clock time (median), device time by kernel and the run's peak
    memory. Returns its launches and times."""
    import os

    import numpy as np

    from tpugan_torch.cli import embedding, infer_e
    from tpugan_torch.invert import make_embedder
    from tpugan_torch.io.image import from_unit, load_image_dir
    from tpugan_torch.losses.lpips import random_lpips_fn
    from tpugan_torch.ops import attention, cuda, upfirdn

    bf16 = "--bf16" in flags
    root = os.path.join(workdir, label.replace(" ", "_"))
    img_dir, out = os.path.join(root, "img"), os.path.join(root, "out")
    args = embedding.make_parser().parse_args(list(flags) + [
        "--random_init", "--iterations", str(INV_ITERATIONS), "--seed", str(SEED), "--device", CARD,
        "--img_dir", img_dir, "--experiment_dir", out])
    lpips = random_lpips_fn(dev, dtype=torch.bfloat16 if bf16 else None)
    t0 = time.perf_counter()
    inverter = rechunked(embedding.build_inverter(args, lpips), args, INV_CHUNK, lpips)
    bundle, enc, mtype = inverter.bundle, inverter.bundle.encoder, inverter.bundle.mtype
    write_target(torch, bundle, img_dir)
    extra = ""
    if mtype == 4:  # as phase 6: the attention in the images, a z2 of zt's spread
        zt_std, z2_std = latent_stds(torch, infer_e, bundle, INV_TARGET_SEED)
        scale_z_head(torch, enc, zt_std / z2_std)
        check(set_attention_gamma(torch, inverter.generator, ATTN_GAMMA) == 1, "expected one SelfAttn")
        extra = f"; every SelfAttn gamma {ATTN_GAMMA:g}, E_BIG's z head scaled by {zt_std / z2_std:.4e}"
    torch.cuda.synchronize()
    say(f"inversion {label}: {' '.join(flags)}, batch 1, {INV_ITERATIONS} iterations in chunks of "
        f"{INV_CHUNK}, lr {args.lr:g}, built with its target in {time.perf_counter() - t0:.2f} s{extra}")

    base = {k: t.clone() for k, t in enc.state_dict().items()}
    frozen = list(inverter.generator.parameters())
    frozen0 = [p.detach().clone() for p in frozen]
    # the first attention forward and backward of the run, their inputs kept
    captured = {"B3": [], "B4": []}
    real_fwd, real_bwd = attention.sagan_attention_cuda, attention.sagan_attention_bwd_cuda

    def capture_fwd(q, k, v, return_lse=False):
        if not captured["B3"]:
            captured["B3"].append(tuple(x.detach().clone() for x in (q, k, v)))
        return real_fwd(q, k, v, return_lse)

    def capture_bwd(*tensors):
        if not captured["B4"]:
            captured["B4"].append(tuple(x.detach().clone() for x in tensors))
        return real_bwd(*tensors)

    attention.sagan_attention_cuda, attention.sagan_attention_bwd_cuda = capture_fwd, capture_bwd
    # the main path: launches counted from 0
    torch.cuda.reset_peak_memory_stats()
    cuda.reset_launches()
    upfirdn.reset_layout_launches()
    t0 = time.perf_counter()
    try:
        with AdjointCount() as adjoint:
            result = embedding.run(inverter, args)[0]
            torch.cuda.synchronize()
    finally:
        attention.sagan_attention_cuda, attention.sagan_attention_bwd_cuda = real_fwd, real_bwd
    seconds = time.perf_counter() - t0
    counted, total, adj = dict(cuda.launches), dict(upfirdn.layout_launches), dict(adjoint.counts)
    peak = torch.cuda.max_memory_allocated() / 2**20

    snapshot = int(int(result.iter_best) >= 0 and math.isfinite(float(result.loss_best)))
    fwd_want, adj_want, per_iteration, attn_want, attn_per_iteration = inversion_launches(
        inverter, INV_ITERATIONS, INV_CHUNK, snapshot)
    fir = "upfirdn2d_bf16" if bf16 else "upfirdn2d"
    if mtype == 4:
        want = expected_launches(sagan_attention=attn_want["B3"], **{k: attn_want["B4"] for k in B4_KERNELS})
    else:
        want = expected_launches(**{fir: sum(fwd_want.values()) + sum(adj_want.values())})
        fwd = {key: total[key] - adj[key] for key in total}
        check(fwd == fwd_want and adj == adj_want, f"inversion {label}: FIR launches forward {fwd}, adjoint "
              f"{adj}; derived from the modules: forward {fwd_want}, adjoint {adj_want}")
    check(counted == want, f"inversion {label}: launches {counted}, expected {want}")

    # what the run wrote, and what it left as it was
    models = os.path.join(out, "models")
    names = [f"id0-i0-w{it}.npy" for it in range(0, INV_ITERATIONS + 1, INV_CHUNK)] + [
        "id0-i0-w.npy", "w_all.npy", "img_all.npy", "id0-i0-img0.npy"]
    check(all(os.path.exists(os.path.join(models, n)) for n in names)
          and os.path.exists(os.path.join(out, "imgs", "00000_rec.png")), f"inversion {label}: files missing")
    w0, w_end = (np.load(os.path.join(models, f"id0-i0-w{it}.npy")) for it in (0, INV_ITERATIONS))
    history = [round(float(x), 5) for x in result.msiv_history.tolist()]
    check(np.isfinite(w_end).all() and not np.array_equal(w0, w_end), f"inversion {label}: w did not move "
          f"(or is not finite); loss_msiv by iteration {history}")
    check(all(math.isfinite(x) for x in result.msiv_history.tolist()),
          f"inversion {label}: a loss is not finite")
    check(all(torch.equal(t, base[k]) for k, t in enc.state_dict().items()),
          f"inversion {label}: the encoder is not back at its base weights")
    check(all(torch.equal(a, b) and a.grad is None and not a.requires_grad for a, b in zip(frozen, frozen0)),
          f"inversion {label}: the frozen generator moved")
    if bf16:
        check(all(p.dtype == torch.bfloat16 for p in frozen)
              and all(p.dtype == torch.float32 for p in enc.parameters()),
              f"inversion {label}: not a bf16 generator over fp32 encoder masters")
    say(f"inversion {label} path: launches {counted} in {seconds:.2f} s (iteration {INV_ITERATIONS}'s losses "
        f"{[round(float(x), 5) for x in result.losses[-1]]}, snapshot at {int(result.iter_best)}); "
        + (f"per iteration B3 {attn_per_iteration['B3']}, B4 pack, dq and dkv {attn_per_iteration['B4']} each"
           if mtype == 4 else f"per iteration FIR forward {per_iteration['forward']}, adjoint "
           f"{per_iteration['adjoint']}; the run's by TPU kernel forward {fwd_want}, adjoint {adj_want}")
        + f", as derived from the modules; w moved, the encoder restored, the generator frozen; peak device "
        f"memory {peak:.1f} MiB")
    batch = torch.from_numpy(np.ascontiguousarray(from_unit(load_image_dir(img_dir, args.img_size)))).to(dev)

    def embedder(iterations):
        cfg = embedding.embedding_config(args, iterations=iterations)
        return make_embedder(inverter.encode, inverter.resynth, enc, cfg, lpips_fn=lpips, vgg=inverter.vgg)

    # each kernel against its plain version on the path's own inputs at batch 1
    errs = {}
    if mtype == 4:
        check(len(captured["B3"]) == 1 and len(captured["B4"]) == 1, "no attention in the inversion")
        q, k, v, o, lse, do = captured["B4"][0]
        check(do.abs().max().item() > 0, "the attention's upstream gradient is zero")
        errs["sagan_attention"] = compare_attention(torch, "attention, an inversion iteration's own inputs",
                                                    *captured["B3"][0], 2e-5, 2e-5, True)
        errs["sagan_attention_bwd"] = compare_attention_bwd(
            torch, "attention backward, an inversion iteration's own inputs", q, k, v, o, lse, do)
    else:
        with FirCapture() as firs:
            embedder(1)(batch)
            torch.cuda.synchronize()
        errs[fir] = hold_captured_firs(torch, firs, f"inversion {label}", torch.bfloat16 if bf16 else torch.float32)
        del firs
    del captured
    torch.cuda.empty_cache()

    # times: the host clock at each iteration's end, and two profiled runs
    say(f"inversion {label} times below: {smi}; iteration times from the host clock, device times from "
        f"torch.profiler (the difference of runs of {INV_PROFILED[1]} and {INV_PROFILED[0]} iterations)")

    with IterationClock(torch) as clock:
        embedder(2 + INV_TIMED)(batch)
    laps = [((b - a) * 1e3, {k: n_b[k] - n_a[k] for k in n_b}) for (a, n_a), (b, n_b) in
            zip(clock.marks[1:], clock.marks[2:])]
    per_lap = (expected_launches(sagan_attention=1, **{k: 2 for k in B4_KERNELS}) if mtype == 4 else
               expected_launches(**{fir: sum(per_iteration["forward"].values())
                                    + sum(per_iteration["adjoint"].values())}))
    check(all(n == per_lap for _, n in laps), f"inversion {label}: an iteration's launches "
          f"{[n for _, n in laps]}, expected {per_lap}")
    lap_ms = sorted(ms for ms, _ in laps)
    median = statistics.median(lap_ms)
    say(f"iteration time, {label} ({len(lap_ms)} iterations, each ending in a synchronize): median "
        f"{median:.3f} ms, min {lap_ms[0]:.3f}, max {lap_ms[-1]:.3f}; each launched {per_lap}")
    times = {"median_ms": median, "min_ms": lap_ms[0], "max_ms": lap_ms[-1], "peak_mib": peak}
    t0 = time.perf_counter()
    try:
        runs = {n: embedder(n) for n in INV_PROFILED}
        found = {n: device_kernels(torch, lambda n=n: runs[n](batch), iters=1, warmup=False, host=False)
                 for n in INV_PROFILED}
    except MissedLaunches as missed:
        say(f"device time per {label} iteration: not measured ({missed})")
        found = None
    if found is not None:
        lo, hi = INV_PROFILED
        kernels = {name: (found[hi].get(name, (0.0, 0.0))[0] - found[lo].get(name, (0.0, 0.0))[0]) / (hi - lo)
                   for name in set(found[hi]) | set(found[lo])}
        busy = sum(kernels.values())
        say(f"device time per {label} iteration {busy:.3f} ms = {busy / median * 100:.1f}% of the median "
            f"iteration time (profiled in {time.perf_counter() - t0:.1f} s); by name:")
        for kname, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:10]:
            say(f"  {ms:8.3f} ms  {kname[:100]}")
        shares = {}
        for name, symbols in (("FIR", ("upfirdn2d_kernel",)),
                              ("attention", ("sagan_attention_kernel",) + B4_SYMBOLS)):
            own = sum(ms for kname, ms in kernels.items() if any(s in kname for s in symbols))
            shares[name] = own
            say(f"  {name} kernels: {own:.3f} ms per iteration, {own / busy * 100:.2f}% of device time")
        times.update({"device_ms": busy, "kernel_ms": shares, "busy_share": busy / median})
    return {"launches": counted, "per_iteration": per_iteration or attn_per_iteration, "times": times,
            "max_abs_err": errs, "img_dir": img_dir}


def gate_inverter(torch, place, dtype, optimize_e, bf16=False):
    """The embedding CLI's inverter over the replay's models (tpugan's bf16
    gate configuration, :data:`INV_REPLAY_ENCODER`), built on the CPU from
    SEED and moved to ``place`` in ``dtype``."""
    from tpugan_torch.cli import embedding
    from tpugan_torch.cli.common import GanBundle
    from tpugan_torch.models import Encoder, StyleGAN2Generator

    g = torch.Generator().manual_seed(SEED)
    gen = StyleGAN2Generator(**BF16_GATE_SG2, generator=g).to(place, dtype)
    enc = Encoder(**INV_REPLAY_ENCODER, generator=g).to(place, dtype)
    size = BF16_GATE_SG2["resolution"]
    bundle = GanBundle(None, None, None, enc, 512, enc.layer_count, gen.num_layers, gen, torch.device(place),
                       size, mtype=2)
    args = embedding.make_parser().parse_args(
        ["--mtype", "2", "--img_size", str(size), "--random_init", "--iterations", str(INV_REPLAY_ITERATIONS),
         "--optimizeE", str(optimize_e).lower()] + (["--bf16"] if bf16 else []))
    return rechunked(embedding.build_inverter(args, bundle=bundle), args, 1)  # the losses of every iteration


def gate_target(torch):
    """The replay's target: its generator's image of a seeded z, on the CPU."""
    from tpugan_torch.models import StyleGAN2Generator

    gen = StyleGAN2Generator(**BF16_GATE_SG2, generator=torch.Generator().manual_seed(SEED))
    z = torch.randn(1, 512, generator=torch.Generator().manual_seed(INV_TARGET_SEED))
    with torch.no_grad():
        return gen(z, trunc_psi=0.7, trunc_layers=8)["image"].permute(0, 2, 3, 1).contiguous()


def replay_distance(torch, label, runs, keys, loss_keys):
    """Each run's distance from the float64 run (``runs["f64"]``), printed;
    the card's held to twice the CPU fp32 run's (PR 12's rule), or
    REPLAY_FLOOR x max |ref| where that is larger; its losses within
    REPLAY_LOSS_RTOL. ``runs["card tf32"]``, where there is one, is the
    control: the card in TF32 must exceed that limit, or the rule could not
    tell TF32 from fp32."""
    ref = runs["f64"]
    out, control = {}, {}
    for key in keys:
        scale = float(ref[key].abs().max())
        dist = {name: float((runs[name][key] - ref[key]).abs().max()) for name in runs if name in
                ("card", "cpu", "card tf32")}
        limit = max(2 * dist["cpu"], REPLAY_FLOOR * scale)
        tf32 = f", the card in TF32 {dist['card tf32']:.3e}" if "card tf32" in dist else ""
        by = "2x the CPU" if limit > REPLAY_FLOOR * scale else "the floor"
        say(f"  {label} {key}: the card {dist['card']:.3e} from float64, the CPU fp32 {dist['cpu']:.3e}{tf32} "
            f"(max |ref| {scale:.3e}; limit {limit:.3e}, {by})")
        check(dist["card"] <= limit, f"{label}: the card's {key} is {dist['card']:.3e} from float64, over {limit:.3e}")
        out[key] = dist["card"]
        if tf32:
            control[key] = dist["card tf32"] / limit
    if control:
        say(f"  {label} control: the card in TF32 at {', '.join(f'{k} {r:.1f}x' for k, r in control.items())} "
            "the limit")
        check(max(control.values()) > 1, f"{label}: the card in TF32 passes the replay's limits {control}")
        out["tf32_over_limit"] = control
    for key in loss_keys:
        rel = float(((runs["card"][key] - ref[key]).abs() / ref[key].abs()).max())
        say(f"  {label} {key}: the card's rel err {rel:.3e} against float64 (limit {REPLAY_LOSS_RTOL:g})")
        check(rel <= REPLAY_LOSS_RTOL, f"{label}: the card's {key} is {rel:.3e} from float64")
        out[key] = rel
    return out


def replay_inversion_on_cpu(torch, dev):
    """The replay of phase 12 (the comment at INV_REPLAY_ENCODER): the
    inversion in each mode, bf16 fine-tuning E, and baseline_i2s's Adam, on
    the card and on the CPU, held to float64 and by the 2x rule. Run it
    under :func:`cudnn_deterministic`."""
    from tpugan_torch.cli import baseline_i2s
    from tpugan_torch.ops import cuda
    from tpugan_torch.runtime import parity_mode

    target = gate_target(torch)
    f32, f64 = torch.float32, torch.float64
    summary = {}
    for optimize_e in (True, False):
        mode = "fine-tune E" if optimize_e else "optimise w"
        forms = [("card", dev, f32, False), ("card tf32", dev, f32, False), ("cpu", "cpu", f32, False),
                 ("f64", "cpu", f64, False)]
        if optimize_e:
            forms += [("card bf16", dev, f32, True), ("cpu bf16", "cpu", f32, True)]
        runs = {}
        for name, place, dtype, bf16 in forms:
            inverter = gate_inverter(torch, place, dtype, optimize_e, bf16)
            cuda.reset_launches()
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = name == "card tf32"
            try:
                r = inverter.invert(target.to(place, dtype))
            finally:
                parity_mode()
            on_card = name.startswith("card")
            if on_card:
                torch.cuda.synchronize()
            launched = cuda.launches["upfirdn2d_bf16" if bf16 else "upfirdn2d"]
            check((launched > 0) == on_card and sum(cuda.launches.values()) == launched,
                  f"replay {mode} {name}: launches {dict(cuda.launches)}")
            runs[name] = {"w": r.w, "w_best": r.w_best, "images": r.images, "msiv": r.msiv_history,
                          "losses": torch.stack([torch.stack(x) for x in r.losses]), "iter_best": int(r.iter_best),
                          "improved": r.improved_history.tolist()}
            runs[name] = {k: v.detach().double().cpu() if isinstance(v, torch.Tensor) else v
                          for k, v in runs[name].items()}
        check(all(runs[n]["iter_best"] == runs["f64"]["iter_best"] and runs[n]["improved"] == runs["f64"]["improved"]
                  for n in ("card", "cpu")), f"replay {mode}: the snapshot's arm or improvements differ")
        say(f"replay of the inversion, {mode}: StyleGAN2-{BF16_GATE_SG2['resolution']} (fmaps_base "
            f"{BF16_GATE_SG2['fmaps_base']}, fmaps_max {BF16_GATE_SG2['fmaps_max']}) with E (startf "
            f"{INV_REPLAY_ENCODER['startf']}), {INV_REPLAY_ITERATIONS} iterations; snapshot at "
            f"{runs['f64']['iter_best']} on every side")
        summary[mode] = replay_distance(torch, f"replay {mode}", runs, ("w", "w_best", "images"), ("losses",))
        if optimize_e:
            ratios = {}
            for key in ("w", "msiv", "images"):
                mine = float((runs["card bf16"][key] - runs["cpu"][key]).abs().max())
                theirs = float((runs["cpu bf16"][key] - runs["cpu"][key]).abs().max())
                say(f"  replay bf16 {key}: the card's bf16 {mine:.3e} from the CPU's fp32, the CPU's bf16 "
                    f"{theirs:.3e} (ratio {mine / theirs:.3f}, limit 2)")
                check(theirs > 0 and mine <= 2 * theirs, f"replay bf16 {key}: {mine:.3e} > 2 x {theirs:.3e}")
                ratios[key] = mine / theirs
            summary["bf16 ratio"] = ratios
    runs = {}
    for name, place, dtype in (("card", dev, f32), ("card again", dev, f32), ("cpu", "cpu", f32),
                               ("f64", "cpu", f64)):
        bundle = gate_inverter(torch, place, dtype, False).bundle
        resynth = baseline_i2s.train_resynth(bundle)
        w = torch.zeros((1, bundle.num_style_layers, 512), device=place, dtype=dtype, requires_grad=True)
        losses = baseline_i2s.optimise(resynth, target.to(place, dtype), w, baseline_i2s.adam(w, 0.01),
                                       INV_REPLAY_STEPS)
        runs[name] = {"w": w.detach().double().cpu(), "losses": losses.double().cpu()}
    check(torch.equal(runs["card"]["w"], runs["card again"]["w"]), "replay baseline_i2s: two card runs differ")
    say(f"replay of baseline_i2s's Adam: {INV_REPLAY_STEPS} steps from w = 0 at the same configuration; two card "
        "runs bitwise equal")
    summary["baseline_i2s"] = replay_distance(torch, "replay baseline_i2s", runs, ("w",), ("losses",))
    return summary


def inversion_clis(torch, dev, workdir, img_dir, decode_firs):
    """rec_real_img, edit and baseline_i2s at StyleGAN2-1024 on the card,
    one call each, with their files and launches (a decode's FIRs each, and
    two gradients' worth for each of baseline_i2s's iterations); then
    rec_real_img and edit at INV_REPLAY_CLI on the card and on the CPU."""
    import os

    import numpy as np
    from PIL import Image

    from tpugan_torch.cli import baseline_i2s, edit, rec_real_img
    from tpugan_torch.ops import cuda

    common = ["--random_init", "--seed", str(SEED)]
    direction = os.path.join(workdir, "direction.npy")
    np.save(direction, np.random.RandomState(SEED).randn(1, 512).astype(np.float32))
    launches = {}

    def call(name, main, argv, want):
        cuda.reset_launches()
        t0 = time.perf_counter()
        main(argv)
        torch.cuda.synchronize()
        counted = dict(cuda.launches)
        check(counted == expected_launches(upfirdn2d=want), f"{name}: launches {counted}, expected {want} upfirdn2d")
        say(f"{name} at StyleGAN2-{SG2_SIZE}: {time.perf_counter() - t0:.2f} s, launches {counted}")
        launches[name] = want

    rec_dir, i2s_dir = os.path.join(workdir, "rec"), os.path.join(workdir, "i2s")
    card = list(INV_SG2) + common + ["--device", CARD]
    call("rec_real_img", rec_real_img.main, card + ["--img_dir", img_dir, "--experiment_dir", rec_dir], decode_firs)
    w = np.load(os.path.join(rec_dir, "models", "00000_w.npy"))
    check(w.shape == (2 * (int(math.log2(SG2_SIZE)) - 1), 512) and np.isfinite(w).all()
          and all(os.path.exists(os.path.join(rec_dir, "imgs", f"00000_{k}.png")) for k in ("real", "rec")),
          "rec_real_img: its files are missing, or w is not finite")
    edited = os.path.join(workdir, "edited.png")
    call("edit", edit.main, card + ["--w_path", os.path.join(rec_dir, "models", "00000_w.npy"), "--direction",
                                    direction, "--out", edited], decode_firs)
    check(os.path.exists(edited), "edit wrote no image")
    call("baseline_i2s", baseline_i2s.main, card + ["--img_dir", img_dir, "--iterations", str(INV_I2S_ITERATIONS),
                                                     "--experiment_dir", i2s_dir],
         decode_firs * (2 * INV_I2S_ITERATIONS + 1))
    w_i2s = np.load(os.path.join(i2s_dir, "models", "00000_w.npy"))
    check(os.path.exists(os.path.join(i2s_dir, "imgs", "00000_rec.png")), "baseline_i2s wrote no image")
    say(f"the CLIs' files written; baseline_i2s's w finite: {bool(np.isfinite(w_i2s).all())}")

    # the replay at a reduced width: the same seed and PNG on the CPU, then on
    # the card; edit regenerates the CPU's w on both
    dirs = {device: os.path.join(workdir, f"replay_{device}") for device in ("cpu", CARD)}
    w_cpu = os.path.join(dirs["cpu"], "models", "00000_w.npy")
    for device, d in dirs.items():
        small = list(INV_REPLAY_CLI) + common + ["--device", device]
        rec_real_img.main(small + ["--img_dir", img_dir, "--experiment_dir", d])
        edit.main(small + ["--w_path", w_cpu, "--direction", direction, "--out", os.path.join(d, "edited.png")])

    def png(d, name):
        return np.asarray(Image.open(os.path.join(d, name)), dtype=np.int32)

    w_ref, w_card = np.load(w_cpu), np.load(os.path.join(dirs[CARD], "models", "00000_w.npy"))
    w_err, w_limit = float(np.abs(w_card - w_ref).max()), CPU_GPU_ATOL * max(1.0, float(np.abs(w_ref).max()))
    levels = {name: int(np.abs(png(dirs[CARD], name) - png(dirs["cpu"], name)).max())
              for name in ("imgs/00000_rec.png", "edited.png")}
    say(f"replay of rec_real_img and edit ({' '.join(INV_REPLAY_CLI)}): w {w_err:.3e} from the CPU's (limit "
        f"{w_limit:.3e}); the PNGs' largest difference in levels of 255 {levels} (limit 1)")
    check(w_err <= w_limit and max(levels.values()) <= 1, "rec_real_img or edit: the card and the CPU disagree")
    return {"launches": launches, "replay": {"w_max_abs_err": w_err, "w_limit": w_limit, "png_levels": levels}}


def inversion_path(torch, dev, smi):
    """Phase 12: real-image inversion (the docstring's item 12). Returns each
    form's launches and times, the CLIs' launches and the replays."""
    import shutil
    import tempfile

    workdir = tempfile.mkdtemp(prefix="chip_smoke_inversion_")
    try:
        forms = {}
        for label, flags in INV_FORMS:
            t0 = time.perf_counter()
            forms[label] = inversion_form(torch, dev, smi, label, flags, workdir)
            torch.cuda.empty_cache()
            say(f"inversion {label} took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        with cudnn_deterministic(torch):  # the comment at CPU_GPU_ATOL
            replay = replay_inversion_on_cpu(torch, dev)
        say(f"the inversion replays took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        decode = forms["SG2 fine-tune E"]["per_iteration"]["forward"]
        clis = inversion_clis(torch, dev, workdir, forms["SG2 fine-tune E"]["img_dir"], sum(decode.values()))
        say(f"the inversion CLIs took {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return {"forms": forms, "replay": replay, "clis": clis}


# ---------------------------------------------------------------------------
# phase 13: Grad-CAM mis-aligned training (e_mis_align at tpugan's
# scripts/bench_mis_align.py:14-15 configuration: SGv1 Cat256, the plain E,
# batch 5, the CLI's default; random weights and a random 1000-class VGG16,
# as the CLI runs without --vgg_weights), infer_e --gradcam and embedding
# --gradcam on BigGAN-deep-256. No new kernel: the path's FIRs at batch 5
# and the attention kernels' backward in the Grad-CAM inversion.
MIS_BATCH = 5
MIS_ARGV = ("--mtype", "1", "--img_size", str(IMG_SIZE), "--start_features", "64", "--random_init")
MIS_STEPS = 3  # steps of each counted trajectory
MIS_TIMED = 6  # host-clock steps of each form, after two warm-up steps
# The replay: a full step of Cat256 at MIS_REPLAY_START_FEATURES with the
# full-width VGG16, at MIS_REPLAY_BATCH (the CPU runs VGG16 at 256 px in
# float64), on the card, on the CPU and on the CPU in float64, from the same
# inputs drawn on the CPU. Held to float64 by phase 8's rule (twice the CPU
# fp32 run's distance, or CPU_GPU_ATOL x max |ref|, whichever is larger;
# phase 8 floors at CPU_GPU_ATOL x max(1, max |ref|), which for a gradient of
# max 1e-2 allows a tenth of it): the step's gradient (of 0.01 loss_w, through E), its images, and
# the CAM++ masks of its imgs1 and imgs2 at the float64 run's majority class
# (a random VGG16's logits can nearly tie, and another class gives another
# mask, not an error: the card's own pick and the top-2 margins are
# printed); loss_mtv and loss_imgs_mse within REPLAY_LOSS_RTOL; the masks'
# colormap indices at most one step apart at HEATMAP_SHARE of the pixels.
MIS_REPLAY_START_FEATURES = 16
MIS_REPLAY_BATCH = 2
HEATMAP_SHARE = 0.01
# embedding --gradcam: phase 12's BigGAN form (E_BIG's lr, every gamma 1,
# the z head scaled) with Grad-CAM attention in place of the crops
GRADCAM_INVERSION = ("BigGAN fine-tune E Grad-CAM",
                     INV_BIGGAN + ("--optimizeE", "true", "--lr", str(INV_BIGGAN_LR), "--gradcam"))


def mis_align_args(*flags, device=None):
    """e_mis_align's arguments at MIS_ARGV, on ``device`` (CARD unless given)."""
    from tpugan_torch.cli import e_mis_align

    return e_mis_align.parse_args(list(MIS_ARGV) + ["--seed", str(SEED), "--device", device or CARD, *flags])


def counted_step(torch, step, state, iteration):
    """One train step with every count set to 0 just before it: the kernels'
    launches, the FIR launches by TPU kernel forward and adjoint, and the
    step's scalars."""
    from tpugan_torch.ops import cuda, upfirdn
    from tpugan_torch.train.e_align import info_scalars

    cuda.reset_launches()
    upfirdn.reset_layout_launches()
    with AdjointCount() as adjoint:
        _, info = step(state, iteration)
        torch.cuda.synchronize()
    total, adj = dict(upfirdn.layout_launches), dict(adjoint.counts)
    return dict(cuda.launches), {k: total[k] - adj[k] for k in total}, adj, info_scalars(info)


def hold_step_launches(label, counted, fwd_want, kernel):
    """A counted step's launches against the FIR counts derived from the
    modules (no adjoint: the images are detached and E has no blur)."""
    launches, fwd, adj, scalars = counted
    zero = {k: 0 for k in fwd_want}
    check(launches == expected_launches(**{kernel: sum(fwd_want.values())}),
          f"{label}: launches {launches}, expected {sum(fwd_want.values())} {kernel} and nothing else")
    check(fwd == fwd_want and adj == zero, f"{label}: FIR launches forward {fwd}, adjoint {adj}; derived from "
          f"the modules: forward {fwd_want}, no adjoint")
    check(all(math.isfinite(x) for x in scalars.values()), f"{label}: a logged scalar is not finite")
    return scalars


def fresh_state(trainer, base, lr):
    """The trainer's encoder back at ``base`` and a new optimizer: a
    trajectory from the same start."""
    from tpugan_torch.optim import lreq_adam
    from tpugan_torch.train.e_align import init_train_state

    enc = trainer.state.encoder
    enc.load_state_dict(base)
    return init_train_state(enc, lreq_adam(enc, lr))


def mis_align_times(torch, trainer, label, vgg_passes=None):
    """Host-clock step times of the full and the lean step, each with its
    device time by kernel, busy share and peak memory; with ``vgg_passes``
    (a call of the four VGG16 passes of a full step) their device time and
    share of the full step's."""
    times = {}
    for kind, step in (("full", trainer.step), ("lean", trainer.lean)):
        median = step_times(torch, step, trainer.state, f"e_mis_align {label} {kind}", 100, steps=MIS_TIMED)
        dev_time = step_device_time(torch, step, trainer.state, median, 200, symbols=("upfirdn2d_kernel",))
        if "device_ms" in dev_time:
            dev_time["busy_share"] = dev_time["device_ms"] / median
        times[kind] = {"median_ms": median, **dev_time}
    if vgg_passes is not None and "device_ms" in times["full"]:
        try:
            kernels = device_kernels(torch, vgg_passes, iters=3)
        except MissedLaunches as missed:
            say(f"e_mis_align {label}: the VGG16 passes' device time not measured ({missed})")
            return times
        vgg_ms = sum(ms for ms, _ in kernels.values())
        share = vgg_ms / times["full"]["device_ms"]
        times["full"].update(vgg16_ms=vgg_ms, vgg16_share=share)
        say(f"e_mis_align {label}: the four VGG16 passes (CAM++ and guided backpropagation of imgs1 and imgs2) "
            f"take {vgg_ms:.3f} ms of device time, {share * 100:.1f}% of the full step's")
    return times


def mis_align_training(torch, dev, smi, workdir):
    """Phase 13's training part: the CLI's loop (a full step on the log tick
    with its dumps, then a lean step), three full steps against full, lean,
    lean (bitwise), a cam_bf16-only step against fp32 (bitwise), the --bf16
    trainer's full and lean steps, each step's launches against the counts
    derived from the modules; every FIR of a full step on its own inputs;
    times; the CPU replay."""
    import copy
    import json
    import os

    from tpugan_torch.cli import e_mis_align
    from tpugan_torch.cli.common import build_vgg16
    from tpugan_torch.losses.gradcam import grad_cam, guided_backprop
    from tpugan_torch.ops import cuda, upfirdn
    from tpugan_torch.train import MisAlignInfo, make_mis_align_step

    out = os.path.join(workdir, "e_mis_align")
    args = mis_align_args("--iterations", "2", "--log_every", "2", "--experiment_dir", out)
    check(args.batch_size == MIS_BATCH, f"e_mis_align's default batch is {args.batch_size}")
    t0 = time.perf_counter()
    vgg = build_vgg16(args)
    trainer = e_mis_align.build_trainer(args, vgg=vgg)
    torch.cuda.synchronize()
    enc, gen = trainer.state.encoder, trainer.bundle.generator
    check(not any(getattr(m, "use_blur", False) for m in enc.modules()), "e_mis_align's E has a blur")
    say(f"trainer: e_mis_align {' '.join(MIS_ARGV)}, batch {args.batch_size}, lr {args.lr:g}: SGv1 Cat256 "
        f"frozen + E training, random VGG16 (1000 classes), built in {time.perf_counter() - t0:.2f} s")
    decode = sgv1_decode_firs(gen)
    fwd_full, adj_full = sgv1_step_firs(trainer, 0, True)
    fwd_lean, adj_lean = sgv1_step_firs(trainer, 0, False)
    check(not any(adj_full.values()) and not any(adj_lean.values()), "a mis-align step runs an adjoint")
    base = {k: t.clone() for k, t in enc.state_dict().items()}
    frozen = [*gen.parameters(), *trainer.bundle.mapping.parameters(), *vgg.parameters()]
    frozen0 = [p.detach().clone() for p in frozen]

    # the main path: the CLI's loop, counts from 0
    cuda.reset_launches()
    upfirdn.reset_layout_launches()
    t0 = time.perf_counter()
    with AdjointCount() as adjoint:
        e_mis_align.run(trainer, args)
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counted, total, adj = dict(cuda.launches), dict(upfirdn.layout_launches), dict(adjoint.counts)
    fwd = {k: total[k] - adj[k] for k in total}
    # the tick's dumps decode twice (imgs1, imgs2 at the initial parameters)
    want = {k: 2 * decode[k] + fwd_full[k] + fwd_lean[k] for k in decode}
    check(counted == expected_launches(upfirdn2d=sum(want.values())) and fwd == want and not any(adj.values()),
          f"e_mis_align's loop: launches {counted}, FIRs forward {fwd}, adjoint {adj}; expected forward {want}")
    with open(os.path.join(out, "Loss.txt")) as f:
        records = [json.loads(line) for line in f]
    fields = {f"{g}_{k}" for g in MisAlignInfo._fields[:6]
              for k in ("mse", "mse_mean", "mse_std", "kl", "cosine", "ssim", "lpips")} | {"loss_tsa", "loss_mtv"}
    check(len(records) == 1 and set(records[0]) == {"iteration", "epoch"} | fields
          and all(math.isfinite(v) for v in records[0].values()), f"e_mis_align's Loss.txt: {records}")
    files = [os.path.join(out, "imgs", "ep0_iter0.png")] + [
        os.path.join(out, "grad_cam", f"{kind}_0.png") for kind in ("heatmap", "cam", "gb")]
    check(all(os.path.exists(f) for f in files), "e_mis_align's dumps are missing")
    say(f"e_mis_align path (the CLI's loop: a full step on the log tick with its dumps, then a lean step) in "
        f"{seconds:.2f} s: launches {counted}; FIR per decode {decode}, a full step {fwd_full}, a lean step "
        f"{fwd_lean}, as derived from the modules; Loss.txt with {len(fields)} scalars (loss_tsa "
        f"{records[0]['loss_tsa']:.4f}, loss_mask_mse {records[0]['loss_mask_mse']:.4e}, loss_mtv "
        f"{records[0]['loss_mtv']:.4f}), the grid, heatmap, cam and gb dumps")

    # three full steps against full, lean, lean; a cam_bf16-only step; with
    # cuDNN's deterministic algorithms (its default weight-gradient ones may
    # sum in another order from run to run)
    torch.backends.cudnn.deterministic = True
    finals, per_step, launches = {}, {}, counted["upfirdn2d"]
    lean_kinds = ("full",) + ("lean",) * (MIS_STEPS - 1)
    for label, kinds in (("full x3", ("full",) * MIS_STEPS), ("full, lean, lean", lean_kinds)):
        state = fresh_state(trainer, base, args.lr)
        for it, kind in enumerate(kinds):
            step = trainer.step if kind == "full" else trainer.lean
            c = counted_step(torch, step, state, it)
            hold_step_launches(f"e_mis_align {label} step {it}", c, fwd_full if kind == "full" else fwd_lean,
                               "upfirdn2d")
            launches += c[0]["upfirdn2d"]
        finals[label] = {n: p.detach().clone() for n, p in enc.named_parameters()}
    moved = sum(not torch.equal(p, base[n]) for n, p in finals["full x3"].items())
    check(moved > 0, "the encoder did not train")
    check(all(torch.equal(finals["full x3"][n], p) for n, p in finals["full, lean, lean"].items()),
          "full, lean, lean steps part from three full steps")
    p = trainer.pipeline
    vgg16 = copy.deepcopy(vgg).to(torch.bfloat16)
    cam16 = make_mis_align_step(p.encode, p.synth, p.resynth, p.draw, vgg16, cam_bf16=True)
    one = {}
    for label, step in (("fp32", trainer.step), ("cam_bf16", cam16)):
        state = fresh_state(trainer, base, args.lr)
        c = counted_step(torch, step, state, 0)
        one[label] = (hold_step_launches(f"e_mis_align {label} step", c, fwd_full, "upfirdn2d"),
                      {n: q.detach().clone() for n, q in enc.named_parameters()})
        launches += c[0]["upfirdn2d"]
    torch.backends.cudnn.deterministic = False
    check(all(torch.equal(one["fp32"][1][n], q) for n, q in one["cam_bf16"][1].items()),
          "the cam_bf16 step's parameters are not the fp32 step's")
    check(all(torch.equal(a, b) and a.grad is None for a, b in zip(frozen, frozen0)),
          "the generator, mapping or VGG16 moved")
    say(f"e_mis_align trajectories: {MIS_STEPS} full steps and full, lean, lean bitwise equal ({moved} of "
        f"{len(base)} encoder tensors moved); a cam_bf16 step bitwise the fp32 step (loss_mask_mse "
        f"{one['cam_bf16'][0]['loss_mask_mse']:.4e} against {one['fp32'][0]['loss_mask_mse']:.4e}); each step "
        f"launched {sum(fwd_full.values())} (full) or {sum(fwd_lean.values())} (lean) upfirdn2d, no adjoint; "
        "the generator, mapping and VGG16 did not move")
    per_step["fp32"] = {"full": fwd_full, "lean": fwd_lean}

    # every FIR of a full step on its own batch-5 inputs
    with FirCapture() as firs:
        trainer.step(fresh_state(trainer, base, args.lr), 0)
        torch.cuda.synchronize()
    err32 = hold_captured_firs(torch, firs, "e_mis_align full step", torch.float32, ("forward",), "step")
    del firs
    batch = p.synth(p.draw(0))
    imgs = batch.imgs1.detach()
    say(f"e_mis_align times below: {smi}; step times from the host clock, device times from torch.profiler")

    def vgg_passes():
        for x in (imgs, imgs):  # the step's imgs1 and imgs2 have imgs1's shape
            grad_cam(vgg, x, plus_plus=True)
            guided_backprop(vgg, x)

    state = fresh_state(trainer, base, args.lr)
    trainer = trainer._replace(state=state)
    times = {"fp32": mis_align_times(torch, trainer, "fp32, TF32 off", vgg_passes)}
    del trainer, vgg16, cam16, batch, imgs, state
    torch.cuda.empty_cache()

    # --bf16: the FIRs on the kernel's bf16 form, none on the fp32 one
    args16 = mis_align_args("--bf16", "--iterations", "1000")
    t0 = time.perf_counter()
    trainer = e_mis_align.build_trainer(args16, vgg=copy.deepcopy(vgg))
    torch.cuda.synchronize()
    enc = trainer.state.encoder
    say(f"trainer: e_mis_align --bf16, built in {time.perf_counter() - t0:.2f} s")
    gen16, vgg16 = trainer.bundle.generator, trainer.vgg
    check(all(q.dtype == torch.bfloat16 for q in (*gen16.parameters(), *vgg16.parameters()))
          and all(q.dtype == torch.float32 for q in enc.parameters()),
          "--bf16: not a bf16 generator and VGG16 over fp32 encoder masters")
    frozen = [*gen16.parameters(), *vgg16.parameters()]
    frozen0 = [q.detach().clone() for q in frozen]
    params0 = {n: q.detach().clone() for n, q in enc.named_parameters()}
    for it, kind in enumerate(("full", "lean")):
        step = trainer.step if kind == "full" else trainer.lean
        c = counted_step(torch, step, trainer.state, it)
        scalars = hold_step_launches(f"e_mis_align --bf16 {kind} step", c, fwd_full if kind == "full" else fwd_lean,
                                     "upfirdn2d_bf16")
        say(f"e_mis_align --bf16 {kind} step: launches {c[0]}; loss_mtv {scalars['loss_mtv']:.4f}, loss_tsa "
            f"{scalars['loss_tsa']:.4f}")
        per_step.setdefault("bf16", {})[kind] = c[1]
    launches16 = sum(sum(v.values()) for v in per_step["bf16"].values())
    check(any(not torch.equal(q, params0[n]) for n, q in enc.named_parameters())
          and all(torch.equal(a, b) and a.grad is None for a, b in zip(frozen, frozen0)),
          "--bf16: the encoder did not train, or the generator or VGG16 moved")
    with FirCapture() as firs:
        trainer.step(trainer.state, 2)
        torch.cuda.synchronize()
    err16 = hold_captured_firs(torch, firs, "e_mis_align --bf16 full step", torch.bfloat16, ("forward",), "step")
    del firs
    say(f"e_mis_align --bf16 times below: {smi}")
    times["bf16"] = mis_align_times(torch, trainer, "--bf16")
    del trainer, gen16, vgg16, frozen, frozen0
    torch.cuda.empty_cache()
    with cudnn_deterministic(torch):  # the comment at CPU_GPU_ATOL
        replay = replay_mis_align_on_cpu(torch, dev, vgg)
    return {"launches": launches, "launches_bf16": launches16, "per_step": per_step, "times": times,
            "max_abs_err": err32, "max_abs_err_bf16": err16, "replay": replay, "vgg": vgg}


def top2_margins(logits):
    top = logits.topk(2, dim=-1).values
    return [round(float(x), 6) for x in (top[:, 0] - top[:, 1])]


def replay_distance_rule(torch, label, got, cpu32, ref):
    """``got`` (the card's) within twice the CPU fp32 run's distance from
    float64 (``ref``), or CPU_GPU_ATOL x max |ref|, whichever is larger;
    returns the card's error and the limit. Tensors or lists of them (a
    gradient's leaves)."""
    got, cpu32, ref = ([x] if torch.is_tensor(x) else x for x in (got, cpu32, ref))
    ref = [r.double().cpu() for r in ref]
    scale = max(float(r.abs().max()) for r in ref)
    err = max(float((g.double().cpu() - r).abs().max()) for g, r in zip(got, ref))
    own = max(float((c.double() - r).abs().max()) for c, r in zip(cpu32, ref))
    limit = max(CPU_GPU_ATOL * scale, 2 * own)
    say(f"  {label}: the card {err:.3e} from float64, the CPU fp32 {own:.3e} (max |ref| {scale:.3e}, limit "
        f"{limit:.3e})")
    check(err <= limit, f"{label}: the card is {err:.3e} from float64, over {limit:.3e}")
    return err, limit


def heatmap_steps(torch, got, want):
    """The share of pixels whose colormap index differs between two masks,
    and the largest difference in steps."""
    a = (255.0 * got.float().cpu()).to(torch.uint8).int()
    b = (255.0 * want.float().cpu()).to(torch.uint8).int()
    return float((a != b).float().mean()), int((a - b).abs().max())


def replay_mis_align_on_cpu(torch, dev, vgg):
    """A full e_mis_align step at MIS_REPLAY_START_FEATURES, batch
    MIS_REPLAY_BATCH, on the card, on the CPU and on the CPU in float64 (the
    rule at MIS_REPLAY_START_FEATURES' definition)."""
    import copy

    from tpugan_torch.cli import e_mis_align, infer_e
    from tpugan_torch.losses.gradcam import grad_cam, majority_class
    from tpugan_torch.train.e_align import info_scalars

    argv = ("--start_features", str(MIS_REPLAY_START_FEATURES), "--batch_size", str(MIS_REPLAY_BATCH),
            "--iterations", "1")
    vgg_cpu = copy.deepcopy(vgg).cpu()
    probe = e_mis_align.build_trainer(mis_align_args(*argv, device="cpu"), vgg=vgg_cpu)
    request = infer_e.draw_request(probe.bundle, MIS_REPLAY_BATCH, 0)
    del probe
    runs = {}
    cpu = torch.device("cpu")
    for label, device, place, dtype in (("card", CARD, dev, torch.float32), ("cpu fp32", "cpu", cpu, torch.float32),
                                        ("f64", "cpu", cpu, torch.float64)):
        cast = lambda blocks: [tuple(n.to(place, dtype) for n in b) for b in blocks]  # noqa: E731
        req = request._replace(z=request.z.to(place, dtype), noise_g=cast(request.noise_g),
                               noise_e=cast(request.noise_e), noise_g2=cast(request.noise_g2))
        net = vgg if label == "card" else vgg_cpu if dtype == torch.float32 else copy.deepcopy(vgg_cpu).double()
        trainer = e_mis_align.build_trainer(mis_align_args(*argv, device=device), draw=lambda it, r=req: r, vgg=net)
        for module in (trainer.bundle.generator, trainer.bundle.mapping, trainer.bundle.encoder):
            module.to(dtype)
        p = trainer.pipeline
        t0 = time.perf_counter()
        with torch.no_grad():
            batch = p.synth(req)
            imgs2 = p.resynth(p.encode(batch, req.noise_e)[1], batch, req.noise_g2)
            logits = net(batch.imgs1.permute(0, 3, 1, 2))[0]
        grads = []
        opt_step = trainer.state.optimizer.step
        trainer.state.optimizer.step = lambda g=None: (grads.append([x.detach().clone() for x in g]), opt_step(g))
        _, info = trainer.step(trainer.state, 0)
        runs[label] = dict(imgs1=batch.imgs1, imgs2=imgs2, logits=logits, grads=grads[0],
                           scalars=info_scalars(info), net=net)
        if device == CARD:
            torch.cuda.synchronize()
        runs[label]["seconds"] = time.perf_counter() - t0
        del trainer
    say(f"replay of an e_mis_align full step: Cat256 at start_features {MIS_REPLAY_START_FEATURES}, batch "
        f"{MIS_REPLAY_BATCH}, the full-width VGG16; " + ", ".join(f"{k} {r['seconds']:.2f} s" for k, r in runs.items()))
    cls = int(majority_class(runs["f64"]["logits"]))
    picks = {k: int(majority_class(r["logits"])) for k, r in runs.items()}
    say(f"  majority class of imgs1: {picks} (the card's own pick {'agrees' if picks['card'] == cls else 'differs'}); "
        f"top-2 logit margins of the float64 run {top2_margins(runs['f64']['logits'])}, largest |logit| "
        f"{float(runs['f64']['logits'].abs().max()):.4e}")
    for label, r in runs.items():  # the masks at the float64 run's class, on each run's own images
        for side in ("imgs1", "imgs2"):
            r[f"mask_{side}"] = grad_cam(r["net"], r[side], index=cls, plus_plus=True)
    out = {"majority_class": picks, "f64_class": cls}
    for key in ("imgs1", "imgs2", "mask_imgs1", "mask_imgs2"):
        out[key] = replay_distance_rule(torch, key, runs["card"][key], runs["cpu fp32"][key], runs["f64"][key])
    for side in ("imgs1", "imgs2"):
        share, steps = heatmap_steps(torch, runs["card"][f"mask_{side}"], runs["f64"][f"mask_{side}"])
        say(f"  heatmap of {side}: {share:.3%} of the pixels one step apart at most ({steps})")
        check(share <= HEATMAP_SHARE and steps <= 1, f"the {side} heatmap: {share:.3%} differ by up to {steps}")
    out["gradient"] = replay_distance_rule(torch, "the step's gradient", runs["card"]["grads"],
                                           runs["cpu fp32"]["grads"], runs["f64"]["grads"])
    for key in ("loss_mtv", "loss_imgs_mse"):
        ref, got = runs["f64"]["scalars"][key], runs["card"]["scalars"][key]
        rel = abs(got - ref) / abs(ref)
        say(f"  {key}: the card {got:.6f} against {ref:.6f} (rel err {rel:.3e}, limit {REPLAY_LOSS_RTOL:g})")
        check(rel <= REPLAY_LOSS_RTOL, f"the replayed {key} disagrees")
        out[key] = rel
    say("  logged attention scalars (each run at its own majority class): " + ", ".join(
        f"{k} loss_mask_mse {r['scalars']['loss_mask_mse']:.4e} loss_gcam_mse {r['scalars']['loss_gcam_mse']:.4e}"
        for k, r in runs.items()))
    return out


def gradcam_request(torch, dev, vgg, workdir):
    """``infer_e --gradcam``: one request of the phase-3 bundle (batch 2)
    with its cam_seed file, its launches counted; its CAM++ mask of imgs1
    replayed on the CPU on the card's imgs1, in fp32 and float64, at the
    float64 run's class, held by phase 8's rule."""
    import copy
    import os

    from tpugan_torch.cli import common, infer_e
    from tpugan_torch.losses.gradcam import grad_cam, majority_class
    from tpugan_torch.ops import cuda, upfirdn

    parser = argparse.ArgumentParser()
    common.add_common_args(parser, training=True)
    bundle = common.build_bundle(parser.parse_args(list(MIS_ARGV) + ["--batch_size", str(BATCH), "--seed",
                                                                     str(SEED), "--device", CARD]))
    imgs_dir = os.path.join(workdir, "infer_e")
    os.makedirs(imgs_dir, exist_ok=True)
    seed = REQUEST_SEEDS[0]
    decode = sgv1_decode_firs(bundle.generator)
    cuda.reset_launches()
    upfirdn.reset_layout_launches()
    imgs1, _ = infer_e.write_request(bundle, BATCH, seed, imgs_dir, vgg)
    torch.cuda.synchronize()
    counted, layouts = dict(cuda.launches), dict(upfirdn.layout_launches)
    want = {k: 2 * n for k, n in decode.items()}
    check(counted == expected_launches(upfirdn2d=sum(want.values())) and layouts == want,
          f"infer_e --gradcam: launches {counted}, by TPU kernel {layouts}; expected {want}")
    check(os.path.exists(os.path.join(imgs_dir, f"cam_seed{seed}.png")), "infer_e --gradcam: no cam_seed file")
    say(f"infer_e --gradcam: a request at batch {BATCH}, launches {counted} (by TPU kernel {layouts}; the CAM "
        f"adds none), cam_seed{seed}.png written")
    nets = {"card": vgg, "cpu fp32": copy.deepcopy(vgg).cpu()}
    nets["f64"] = copy.deepcopy(nets["cpu fp32"]).double()
    inputs = {"card": imgs1, "cpu fp32": imgs1.cpu(), "f64": imgs1.cpu().double()}
    with torch.no_grad():
        logits = {k: nets[k](inputs[k].permute(0, 3, 1, 2))[0] for k in nets}
    cls = int(majority_class(logits["f64"]))
    say(f"  majority class of the request's imgs1: card {int(majority_class(logits['card']))}, float64 {cls}; "
        f"top-2 logit margins {top2_margins(logits['f64'])}")
    masks = {k: grad_cam(nets[k], inputs[k], index=cls, plus_plus=True) for k in nets}
    err = replay_distance_rule(torch, "infer_e --gradcam mask", masks["card"], masks["cpu fp32"], masks["f64"])
    share, steps = heatmap_steps(torch, masks["card"], masks["f64"])
    say(f"  heatmap: {share:.3%} of the pixels one step apart at most ({steps})")
    check(share <= HEATMAP_SHARE and steps <= 1, f"infer_e --gradcam heatmap: {share:.3%} differ by up to {steps}")
    return {"launches": counted["upfirdn2d"], "per_request": want, "mask": err}


def gradcam_path(torch, dev, smi):
    """Phase 13 (the docstring's item 13). Returns the training part's
    launches, times and replay, the request's and the inversion's."""
    import shutil
    import tempfile

    workdir = tempfile.mkdtemp(prefix="chip_smoke_gradcam_")
    try:
        t0 = time.perf_counter()
        train = mis_align_training(torch, dev, smi, workdir)
        say(f"e_mis_align took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        request = gradcam_request(torch, dev, train.pop("vgg"), workdir)
        torch.cuda.empty_cache()
        say(f"infer_e --gradcam took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        label, flags = GRADCAM_INVERSION
        inversion = inversion_form(torch, dev, smi, label, flags, workdir)
        torch.cuda.empty_cache()
        say(f"inversion {label} took {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return {"training": train, "request": request, "inversion": inversion}


# ---------------------------------------------------------------------------
# Phase 14: slice 7a, tpugan's commands at their defaults: --resume, remat
# (A3) and converted weights

RESUME_EVERY = 2  # --checkpoint_every and --log_every: 4 unbroken iterations against 3 and a resume
RESUME_SG2 = ("--mtype", "2", "--img_size", str(SG2_SIZE), "--start_features", str(SG2_START_FEATURES),
              "--case", "2")
RESUME_BIGGAN = ("--mtype", "4", "--img_size", str(BIGGAN_SIZE), "--start_features", "64", "--z_dim",
                 str(BIGGAN_Z_DIM), "--case", "2")
REMAT_FORMS = (("plain", ()), ("--remat", ("--remat",)), ("--remat_policy conv_outs", ("--remat_policy", "conv_outs")))
REMAT_TIMED = 2  # host-clock steps of each remat form, after two warm-up steps


def train_state_distance(torch, a, b):
    """Whether two train states are bitwise equal (the encoder's parameters
    and buffers, the spectral norms' u/v among them, the optimizer's second
    moments and step counts, the step), and the largest |difference|."""
    pairs = list(zip(a.encoder.state_dict().values(), b.encoder.state_dict().values()))
    sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    pairs += [(sa[k]["nu"], sb[k]["nu"]) for k in sa]
    steps = a.step == b.step and all(sa[k]["step"] == sb[k]["step"] for k in sa)
    equal = steps and all(torch.equal(x, y) for x, y in pairs)
    return equal, max((x.float() - y.float()).abs().max().item() for x, y in pairs)


def card_vgg16(torch, dev):
    """A 1000-class VGG16 made on the card (He-normal kernels, zero biases):
    the resume runs need one and hold no VGG16 output to a reference."""
    from tpugan_torch.losses.vgg import VGG16

    with torch.device("meta"):
        vgg = VGG16()
    vgg = vgg.to_empty(device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    with torch.no_grad():
        for name, p in vgg.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            else:
                p.normal_(0.0, math.sqrt(2.0 / p[0].numel()), generator=gen)
    return vgg.requires_grad_(False)


def resume_run(torch, label, cli, argv, workdir, step_want, adjust=None):
    """``cli.main`` for 4 unbroken iterations against 3 (a save at iteration
    2) and a ``--resume`` to 4, at full width, with cuDNN deterministic: the
    final train states, and the Loss.txt records, bitwise equal; else the
    resumed run held by the distance between two unbroken runs, printed.
    The resumed run's launches (one off-tick step, iteration 3) are counted
    from 0 against ``step_want(trainer) -> (launches, FIRs forward,
    adjoint)``. ``adjust(trainer)`` runs on each built trainer, before the
    counts are set to 0. The runs' own records go to a buffer, not the log."""
    import contextlib
    import io
    import os

    from tpugan_torch.io.checkpoint import latest_step
    from tpugan_torch.ops import cuda, upfirdn

    build, built = cli.build_trainer, []

    def building(*args, **kwargs):
        trainer = build(*args, **kwargs)
        if adjust is not None:
            adjust(trainer)
        cuda.reset_launches()
        upfirdn.reset_layout_launches()
        built.append(trainer)
        return trainer

    common = [*argv, "--random_init", "--batch_size", str(BATCH), "--seed", str(SEED), "--device", CARD,
              "--checkpoint_every", str(RESUME_EVERY), "--log_every", str(RESUME_EVERY)]

    printed = io.StringIO()

    def run(name, iterations, *extra):
        with contextlib.redirect_stdout(printed):
            return cli.main(common + ["--iterations", str(iterations), "--experiment_dir",
                                      os.path.join(workdir, name), *extra])

    t0 = time.perf_counter()
    cli.build_trainer = building
    try:
        whole = run("whole", 2 * RESUME_EVERY)
        run("parts", RESUME_EVERY + 1)
        models = os.path.join(workdir, "parts", "models")
        check(latest_step(models) == RESUME_EVERY, f"{label}: the run saved {os.listdir(models)}")
        cuda.reset_launches()
        upfirdn.reset_layout_launches()
        with AdjointCount() as adjoint:
            resumed = run("parts", 2 * RESUME_EVERY, "--resume")
            torch.cuda.synchronize()
        counted, total, adj = dict(cuda.launches), dict(upfirdn.layout_launches), dict(adjoint.counts)
        fwd = {k: total[k] - adj[k] for k in total}
        resumed_from = [line for line in printed.getvalue().splitlines() if line.startswith("resumed from")]
        check(len(resumed_from) == 1, f"{label}: the CLI printed {resumed_from} on --resume")
        say(f"{label}: {resumed_from[0]}")
        launches_want, fwd_want, adj_want = step_want(built[-1])
        check(counted == launches_want and fwd == fwd_want and adj == adj_want,
              f"{label}: the resumed step's launches {counted}, FIRs forward {fwd}, adjoint {adj}; expected "
              f"{launches_want}, forward {fwd_want}, adjoint {adj_want}")
        check(all(bool(torch.isfinite(p).all()) for p in resumed.encoder.parameters()),
              f"{label}: the resumed encoder is not finite")
        equal, dist = train_state_distance(torch, whole, resumed)
        records = [open(os.path.join(workdir, name, "Loss.txt")).read() for name in ("whole", "parts")]
        if equal:
            check(records[0] == records[1], f"{label}: the Loss.txt records differ")
            say(f"{label}: 4 unbroken iterations and 3 + --resume to 4 are bitwise equal (encoder parameters, "
                f"spectral-norm u/v, optimizer state, step {resumed.step}; Loss.txt too); the resumed step's "
                f"launches {counted} as expected")
        else:
            again = run("again", 2 * RESUME_EVERY)
            _, dist0 = train_state_distance(torch, whole, again)
            say(f"{label}: the resumed run is {dist:.3e} from the unbroken one, and two unbroken runs are "
                f"{dist0:.3e} apart (cuDNN)")
            check(dist <= dist0, f"{label}: the resumed run is farther from the unbroken one than two unbroken "
                  "runs are from each other")
    finally:
        cli.build_trainer = build
    seconds = time.perf_counter() - t0
    say(f"{label}: the three runs took {seconds:.1f} s")
    return {"bitwise": equal, "max_abs_diff": dist, "launches": counted, "seconds": seconds}


def resume_path(torch, dev, workdir):
    """``e_align --mtype 2 --case 2`` (StyleGAN2-1024, E_Blur), ``e_align
    --mtype 4 --case 2`` (BigGAN-deep-256 + E_BIG, B3/B4; every gamma 1 and
    the z head scaled, as phase 6) and ``e_mis_align`` (SGv1 Cat256 at batch
    5; iteration 3 is a lean step) saved and resumed through their ``main``."""
    import os

    from tpugan_torch.cli import e_align, e_mis_align, infer_e

    def sg2_want(trainer):
        fwd, adj = sg2_step_firs(trainer, 1, True)
        return expected_launches(upfirdn2d=sum(fwd.values()) + sum(adj.values())), fwd, adj

    def biggan_want(trainer):
        zero = sgv1_step_firs_zero()
        return expected_launches(sagan_attention=2, **{name: 1 for name in B4_KERNELS}), zero, zero

    def biggan_adjust(trainer):
        zt_std, z2_std = latent_stds(torch, infer_e, trainer.bundle, REQUEST_SEEDS[0])
        scale_z_head(torch, trainer.state.encoder, zt_std / z2_std)
        check(set_attention_gamma(torch, trainer.bundle.generator, ATTN_GAMMA) == 1, "expected one SelfAttn")

    def mis_want(trainer):
        fwd, _ = sgv1_step_firs(trainer, 0, False)
        return expected_launches(upfirdn2d=sum(fwd.values())), fwd, sgv1_step_firs_zero()

    build_vgg16 = e_mis_align.build_vgg16
    vgg = card_vgg16(torch, dev)
    e_mis_align.build_vgg16 = lambda args: vgg
    try:
        with cudnn_deterministic(torch):
            out = {
                f"e_align SG2-{SG2_SIZE} case 2": resume_run(
                    torch, f"resume, e_align SG2-{SG2_SIZE} case 2", e_align, RESUME_SG2,
                    os.path.join(workdir, "sg2"), sg2_want),
                f"e_align BigGAN-deep-{BIGGAN_SIZE} case 2": resume_run(
                    torch, f"resume, e_align BigGAN-deep-{BIGGAN_SIZE} + E_BIG case 2", e_align, RESUME_BIGGAN,
                    os.path.join(workdir, "biggan"), biggan_want, biggan_adjust),
                f"e_mis_align (batch {MIS_BATCH})": resume_run(
                    torch, f"resume, e_mis_align batch {MIS_BATCH}", e_mis_align, MIS_ARGV[:6],
                    os.path.join(workdir, "mis"), mis_want),
            }
    finally:
        e_mis_align.build_vgg16 = build_vgg16
    del vgg
    torch.cuda.empty_cache()
    return out


def sgv1_step_firs_zero():
    from tpugan_torch.ops import upfirdn

    return {key: 0 for key in upfirdn.layout_launches}


def remat_path(torch, dev, smi, bf16):
    """The SG2-1024 case-2 step (``e_align --mtype 2 --case 2``, random LPIPS
    as phase 9) plain, with ``--remat`` and with ``--remat_policy
    conv_outs``, each one step from the same state: the FIR launches
    forward and adjoint by TPU kernel against the counts derived from the
    modules (each gradient group runs its own forward and each backward
    through a region recomputes its forward: the synthesis's decode, two
    of encode and resynth for the image group and two of encode for the
    latent one), the update bitwise the plain step's (cuDNN deterministic),
    then the step's host-clock and device time and its peak memory."""
    from tpugan_torch.cli import e_align
    from tpugan_torch.losses.lpips import random_lpips_fn
    from tpugan_torch.optim import lreq_adam
    from tpugan_torch.train.e_align import init_train_state, make_train_step

    dtype = "bf16" if bf16 else "fp32"
    kernel = "upfirdn2d_bf16" if bf16 else "upfirdn2d"
    args = e_align.make_parser().parse_args(
        [*RESUME_SG2, "--random_init", "--batch_size", str(BATCH), "--seed", str(SEED), "--device", CARD,
         "--iterations", "1000"] + (["--bf16"] if bf16 else []))
    lpips = random_lpips_fn(dev, dtype=torch.bfloat16 if bf16 else None)
    pipeline = e_align.build_pipeline(args)
    enc = pipeline.bundle.encoder
    base = {k: t.clone() for k, t in enc.state_dict().items()}
    fwd_plain, adj_plain = sg2_step_firs(pipeline, 1, True)
    decode = sg2_decode_firs(pipeline.bundle.generator)
    blurs = {k: sg2_step_firs(pipeline, 0, False)[0][k] - decode[k] for k in decode}
    fwd_remat = {k: 3 * decode[k] + 4 * blurs[k] for k in decode}
    out, after = {}, {}
    for label, flags in REMAT_FORMS:
        step = make_train_step(pipeline.encode, pipeline.synth, pipeline.resynth, pipeline.draw, case=2,
                               lpips_fn=lpips, remat="--remat" in flags,
                               remat_policy="conv_outs" if "conv_outs" in flags else None)

        def fresh():
            enc.load_state_dict(base)
            return init_train_state(enc, lreq_adam(enc, args.lr))

        state = fresh()
        with cudnn_deterministic(torch):
            launches, fwd, adj, scalars = counted_step(torch, step, state, 0)
            fwd_want = fwd_plain if label == "plain" else fwd_remat
            n = sum(fwd_want.values()) + sum(adj_plain.values())
            check(launches == expected_launches(**{kernel: n}) and fwd == fwd_want and adj == adj_plain,
                  f"SG2 case 2 {label} ({dtype}): launches {launches}, FIRs forward {fwd}, adjoint {adj}; derived "
                  f"from the modules: {n} {kernel}, forward {fwd_want}, adjoint {adj_plain}")
            check(all(math.isfinite(x) for x in scalars.values()), f"SG2 case 2 {label} ({dtype}): a loss is not finite")
            after[label] = {k: t.clone() for k, t in enc.state_dict().items()}
            if label == "plain":
                again = fresh()
                step(again, 0)
                own = max((after[label][k].float() - t.float()).abs().max().item() for k, t in enc.state_dict().items())
                say(f"SG2 case 2 plain ({dtype}): two steps from the same state are {own:.3e} apart")
                state = again
                distance = 0.0
            else:
                distance = max((after[label][k].float() - t.float()).abs().max().item()
                               for k, t in after["plain"].items())
                check(distance <= own, f"SG2 case 2 {label} ({dtype}): the update is {distance:.3e} from the "
                      f"plain step's, whose own run-to-run distance is {own:.3e}")
        same = "bitwise the plain step's" if distance == 0 else f"{distance:.3e} from the plain step's"
        say(f"SG2 case 2 {label} ({dtype}): launches {launches}, FIRs forward {fwd}, adjoint {adj} as derived; "
            f"the update {same}")
        say(f"SG2 case 2 {label} ({dtype}) times below: {smi}")
        median = step_times(torch, step, state, f"SG2 case 2 {label}, {dtype}, TF32 off", 10, steps=REMAT_TIMED)
        dev_time = step_device_time(torch, step, state, median, 100, symbols=("upfirdn2d",))
        out[label] = {"launches": launches[kernel], "forward": fwd, "adjoint": adj, "max_abs_diff_from_plain": distance,
                      "median_ms": median, **dev_time}
        del step, state
        torch.cuda.empty_cache()
    del pipeline, enc, lpips
    torch.cuda.empty_cache()
    return out


def converted_request(torch, dev, parser, label, argv, want, adjust=None):
    """One ``infer_e`` request of REQUEST_SEEDS[0] on the bundle that
    ``argv`` loads (converted files), on the card and on the CPU from the
    same files and draws: the card's launches against ``want(bundle)`` and
    the images held to the CPU's (phase 7's rule). ``adjust(card, cpu)``
    runs on the two bundles first."""
    from tpugan_torch.cli import common, infer_e
    from tpugan_torch.ops import cuda, upfirdn

    card = common.build_bundle(parser.parse_args(argv + ["--device", CARD]))
    cpu = common.build_bundle(parser.parse_args(argv + ["--device", "cpu"]))
    if adjust is not None:
        adjust(card, cpu)
    req = infer_e.draw_request(cpu, BATCH, REQUEST_SEEDS[0])
    cuda.reset_launches()
    upfirdn.reset_layout_launches()
    on_card = infer_e.serve(card, req.to(dev))
    torch.cuda.synchronize()
    launches = dict(cuda.launches)
    check(launches == want(card), f"{label}: launches {launches}, expected {want(card)}")
    on_cpu = infer_e.serve(cpu, req)
    errs = {}
    for name, g, c in zip(("imgs1", "imgs2"), on_card, on_cpu):
        check(bool(torch.isfinite(g).all()), f"{label}: {name} is not finite")
        errs[name] = (g.cpu() - c).abs().max().item()
        limit = CPU_GPU_ATOL * max(1.0, c.abs().max().item())
        say(f"{label}: cuda vs cpu {name}, max |err| {errs[name]:.3e} (limit {limit:.3e}, max |ref| "
            f"{c.abs().max().item():.3f})")
        check(errs[name] <= limit, f"{label}: {name} differs from the CPU's load by {errs[name]:.3e}")
    del card, cpu
    torch.cuda.empty_cache()
    return {"launches": launches, "max_abs_err": errs}


def converted_path(torch, dev, smi, workdir):
    """Converted weights: state dicts with the reference's key names and
    shapes at full width, drawn from the seed (``tpugan_torch/tools/
    reference_state.py``: StyleGAN2-1024 as ``generator_smooth``, its E,
    BigGAN-deep-256 with spectral-norm triplets, one without ``_u`` and one
    without ``_v``, and its config JSON, E_BIG, LPIPS, VGG16 with its
    classifier), written with ``torch.save``. ``infer_e --mtype 2`` and
    ``--mtype 4`` requests on the loaded bundles, held to the CPU bundles
    that load the same files (phase 7's rule); one ``e_align --mtype 2
    --case 2 --lpips_weights`` step and one ``e_mis_align --vgg_weights
    --lpips_weights`` full step with their launches, the converted LPIPS
    and VGG16 held to their CPU loads on the steps' own images."""
    import os

    import numpy as np

    from tpugan_torch.cli import common, e_align, e_mis_align, infer_e
    from tpugan_torch.losses.space_loss import space_loss
    from tpugan_torch.models import BigGANConfig, BigGANEncoder, Encoder, StyleGAN2Generator
    from tpugan_torch.tools import reference_state as ref

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    path = lambda name: os.path.join(workdir, name)  # noqa: E731
    sg2_layers, big_layers = int(math.log2(SG2_SIZE)) - 1, int(math.log2(BIGGAN_SIZE)) - 1
    cfg = BigGANConfig.for_resolution(BIGGAN_SIZE, z_dim=BIGGAN_Z_DIM)
    with open(path("biggan-deep-256.json"), "w") as f:
        f.write(cfg.to_json_string())
    files = {
        "sg2": ref.save(path("stylegan2-1024.pth"), {"generator_smooth": ref.stylegan2(
            rng, lambda: StyleGAN2Generator(resolution=SG2_SIZE))}),
        "sg2_e": ref.save(path("E-1024.pth"), ref.encoder(rng, lambda: Encoder(
            startf=SG2_START_FEATURES, maxf=512, layer_count=sg2_layers, latent_size=512))),
        "biggan": ref.save(path("G-256.pt"), ref.biggan(rng, cfg)),
        "ebig": ref.save(path("E_BIG-256.pth"), ref.biggan_encoder(rng, lambda: BigGANEncoder(
            startf=64, maxf=512, layer_count=big_layers, cond_dim=2 * cfg.z_dim, z_dim=cfg.z_dim,
            img_size=BIGGAN_SIZE))),
        "lpips": ref.save(path("lpips-vgg.pth"), ref.lpips(rng)),
        "vgg": ref.save(path("vgg16.pth"), ref.vgg16(rng)),
    }
    sizes = {k: os.path.getsize(v) / 2**20 for k, v in files.items()}
    say(f"converted weights: reference-named state dicts from seed {SEED} written in "
        f"{time.perf_counter() - t0:.1f} s ({', '.join(f'{k} {v:.1f} MiB' for k, v in sizes.items())})")
    parser = argparse.ArgumentParser()
    common.add_common_args(parser, training=True)
    seed = REQUEST_SEEDS[0]
    out = {}

    def request(label, argv, want, adjust=None):
        out[label] = converted_request(torch, dev, parser, label, argv, want, adjust)

    sg2_argv = ["--mtype", "2", "--img_size", str(SG2_SIZE), "--start_features", str(SG2_START_FEATURES),
                "--batch_size", str(BATCH), "--seed", str(SEED), "--checkpoint_dir_GAN", files["sg2"],
                "--checkpoint_dir_E", files["sg2_e"]]
    request(f"infer_e --mtype 2 (converted StyleGAN2-{SG2_SIZE} and E)", sg2_argv, lambda b: expected_launches(
        upfirdn2d=2 * sum(sg2_decode_firs(b.generator).values())))

    def e_big_scale(card, cpu):
        zt_std, z2_std = latent_stds(torch, infer_e, card, seed)
        check(math.isfinite(z2_std) and z2_std > 0, f"the converted E_BIG's z2 has std {z2_std}")
        for b in (card, cpu):
            scale_z_head(torch, b.encoder, zt_std / z2_std)
        say(f"converted E_BIG: z2 std {z2_std:.4f} against zt's {zt_std:.4f}; the z head scaled on both "
            "bundles, as phase 5")

    big_argv = ["--mtype", "4", "--img_size", str(BIGGAN_SIZE), "--start_features", "64", "--z_dim",
                str(BIGGAN_Z_DIM), "--batch_size", str(BATCH), "--seed", str(SEED), "--config_dir",
                path("biggan-deep-256.json"), "--checkpoint_dir_GAN", files["biggan"], "--checkpoint_dir_E",
                files["ebig"]]
    request(f"infer_e --mtype 4 (converted BigGAN-deep-{BIGGAN_SIZE} and E_BIG)", big_argv,
            lambda b: expected_launches(sagan_attention=2), e_big_scale)

    # e_align --mtype 2 --case 2 with the converted LPIPS: one counted step
    args = e_align.make_parser().parse_args(sg2_argv + ["--case", "2", "--iterations", "1", "--lpips_weights",
                                                        files["lpips"], "--device", CARD])
    trainer = e_align.build_trainer(args, common.build_lpips_fn(args))
    fwd_want, adj_want = sg2_step_firs(trainer, 1, True)
    vis = trainer.visuals(trainer.state, 0)
    launches, fwd, adj, scalars = counted_step(torch, trainer.step, trainer.state, 0)
    n = sum(fwd_want.values()) + sum(adj_want.values())
    check(launches == expected_launches(upfirdn2d=n) and fwd == fwd_want and adj == adj_want,
          f"converted e_align step: launches {launches}, forward {fwd}, adjoint {adj}")
    check(all(math.isfinite(x) for x in scalars.values()) and scalars["loss_imgs_lpips"] > 0,
          f"converted e_align step: scalars {scalars}")
    args.device = "cpu"
    _, cpu_info = space_loss(vis["imgs1"].cpu(), vis["imgs2"].cpu(), lpips_fn=common.build_lpips_fn(args))
    err = abs(scalars["loss_imgs_lpips"] - cpu_info.lpips.item())
    limit = CPU_GPU_ATOL * max(1.0, abs(cpu_info.lpips.item()))
    say(f"converted e_align --mtype 2 --case 2 --lpips_weights step: launches {launches}; loss_imgs_lpips "
        f"{scalars['loss_imgs_lpips']:.6f} against the CPU's LPIPS load on the step's own images "
        f"{cpu_info.lpips.item():.6f}, |err| {err:.3e} (limit {limit:.3e})")
    check(err <= limit, "the converted LPIPS differs from its CPU load")
    out["e_align --lpips_weights"] = {"launches": launches, "lpips_err": err}
    del trainer, vis
    torch.cuda.empty_cache()

    # e_mis_align with the converted VGG16 and LPIPS: one counted full step
    args = mis_align_args("--iterations", "1", "--vgg_weights", files["vgg"], "--lpips_weights", files["lpips"])
    trainer = e_mis_align.build_trainer(args, common.build_lpips_fn(args))
    fwd_full, _ = sgv1_step_firs(trainer, 0, True)
    imgs1 = trainer.pipeline.synth(trainer.pipeline.draw(0)).imgs1
    scalars = hold_step_launches("converted e_mis_align full step", counted_step(
        torch, trainer.step, trainer.state, 0), fwd_full, "upfirdn2d")
    check(scalars["loss_imgs_lpips"] > 0, "the converted LPIPS did not enter the mis-align step")
    args.device = "cpu"
    x = imgs1.permute(0, 3, 1, 2)
    with torch.no_grad():
        logits = trainer.vgg(x)[0]
        ref_logits = common.build_vgg16(args)(x.cpu())[0]
    err = (logits.cpu() - ref_logits).abs().max().item()
    limit = CPU_GPU_ATOL * max(1.0, ref_logits.abs().max().item())
    say(f"converted e_mis_align --vgg_weights --lpips_weights full step (batch {MIS_BATCH}): FIRs {sum(fwd_full.values())}"
        f" as derived; the converted VGG16's logits on the step's imgs1 against its CPU load: max |err| {err:.3e} "
        f"(limit {limit:.3e}, max |ref| {ref_logits.abs().max().item():.3f})")
    check(err <= limit, "the converted VGG16 differs from its CPU load")
    out["e_mis_align --vgg_weights --lpips_weights"] = {"launches": sum(fwd_full.values()), "vgg_logits_err": err}
    del trainer
    torch.cuda.empty_cache()
    return out


def slice7a_path(torch, dev, smi):
    """Phase 14: ``--resume`` bitwise through the training CLIs' ``main``,
    remat on the SG2-1024 case-2 step in fp32 and bf16, and converted
    weights through ``--checkpoint_dir_GAN``/``_E``, ``--config_dir``,
    ``--lpips_weights`` and ``--vgg_weights``."""
    import shutil
    import tempfile

    workdir = tempfile.mkdtemp(prefix="chip_smoke_slice7a_")
    try:
        t0 = time.perf_counter()
        resume = resume_path(torch, dev, workdir)
        say(f"phase 14: resume took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        remat = {"fp32": remat_path(torch, dev, smi, False), "bf16": remat_path(torch, dev, smi, True)}
        say(f"phase 14: remat took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        converted = converted_path(torch, dev, smi, workdir)
        say(f"phase 14: converted weights took {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return {"resume": resume, "remat": remat, "converted": converted}


# phase 15, slice 7b: eval and PGGAN. PGGAN-1024 at tpugan's CLI defaults
# (GenForce's CelebA-HQ 1024 generator, fmaps min(16384 / res, 512); E_PG at
# start_features 16, layer_count 9), batch 2, random weights from SEED.
PG_SIZE = 1024
PG_START_FEATURES = 16
PG_ARGV = ("--mtype", "3", "--img_size", str(PG_SIZE), "--start_features", str(PG_START_FEATURES))
# synthesize's families, one seed (SYN_SEED) each, in the default form (bf16
# generators on the card) and with --fp32: (label, flags). BigGAN's E_BIG z
# head is scaled and its SelfAttn gamma set to ATTN_GAMMA in both packages'
# sense of phase 5 (the CLI's bundle adjusted as it is built), so that the
# images are finite and carry the attention.
SYN_FAMILIES = (
    (f"StyleGAN2-{SG2_SIZE}", ("--mtype", "2", "--img_size", str(SG2_SIZE), "--start_features",
                               str(SG2_START_FEATURES))),
    (f"BigGAN-deep-{BIGGAN_SIZE}", ("--mtype", "4", "--img_size", str(BIGGAN_SIZE), "--start_features", "64",
                                    "--z_dim", str(BIGGAN_Z_DIM))),
    (f"PGGAN-{PG_SIZE}", PG_ARGV),
)
SYN_SEED = REQUEST_SEEDS[0]
SYN_TIMED = 2  # host-clock seeds of each form, after 2 warm-up ones
COMPARE_RTOL = 1e-4  # compare's PSNR, SSIM, MSE and cosine on the card against the CPU's
PG_TRAIN_FORMS = (("case 1", ("--case", "1")), ("case 1 lean", ("--case", "1")), ("case 2", ("--case", "2")))
# PGGAN's times. With TF32 off, as every other phase measures, one
# convolution shape (N 2, 256 -> 128 channels at 128 px: layer10 of
# PGGAN-1024) takes cuDNN's FFT algorithm, 33024 complex GEMMs and about
# 0.35 s, forward and data gradient alike
# (tpugan_torch/tools/pggan_conv_probe.py): a request takes 0.9 s and its
# trace holds 66k kernels. That request is synthesize --fp32's PGGAN seed,
# timed there; PGGAN's infer_e requests and e_align steps are timed with
# PyTorch's defaults (cuDNN's convolutions in TF32), as the CLIs run, and
# every number from them is labelled so. The CPU replays keep TF32 off.
PG_TIMED = (6, 1)  # (host-clock calls, profiled calls) of each PGGAN request and step form
# the replay of a PGGAN case-2 step against float64: PGGAN-256 (its fmaps,
# the FFT shape among them), E_PG at start_features 64. Its fp32 gradient is
# ill-conditioned (every conv block begins with a pixel norm, whose backward
# removes the radial part of the upstream gradient), and cuDNN's fp32
# algorithms (FFT, and E_PG's own) put the card 4.314e-2 from float64
# against the CPU's 8.647e-3; with cuDNN off, PyTorch's own convolutions
# (im2col and cuBLAS) on the card, 1.323e-2
# (tpugan_torch/tools/pggan_conv_probe.py --replay). So the card's run held
# to the rule has cuDNN off, and the cuDNN run is measured beside it and
# printed, not held: ROADMAP C records it as open.
PG_REPLAY_SIZE = 256
PG_REPLAY_START_FEATURES = 64
PG_INV_ITERATIONS = 2


@contextlib.contextmanager
def cudnn_off(torch):
    """cuDNN off inside (PyTorch's own CUDA convolutions), on after."""
    saved = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = saved


@contextlib.contextmanager
def pytorch_defaults(torch):
    """PyTorch's default numerics inside, which the CLIs keep (cuDNN's
    convolutions in TF32); parity mode (TF32 off) restored after."""
    from tpugan_torch.runtime import parity_mode

    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        parity_mode()


def conv_flops(torch, models, run):
    """The multiply-adds of the convolutions and dense layers of ``models``
    (PGGAN's conv blocks, EqConv and EqLinear) in the forward passes of one
    call of ``run``, times 2: FLOPs, counted by forward hooks from the
    outputs (a transposed EqConv from its input)."""
    from tpugan_torch.models import PGConvBlock
    from tpugan_torch.nn.layers import EqConv, EqLinear

    total = [0]

    def hook(module, args, out):
        x = args[0] if getattr(module, "transpose", False) else out
        total[0] += 2 * x.numel() * module.weight[0].numel()

    handles = [m.register_forward_hook(hook) for model in models
               for m in model.modules() if isinstance(m, (PGConvBlock, EqConv, EqLinear))]
    try:
        run()
    finally:
        for h in handles:
            h.remove()
    return total[0]


def synthesize_launches(bundle, bf16):
    """One synthesize seed's kernel launches and FIR launches by TPU kernel,
    derived from the bundle's generator (two decodes): StyleGAN2's FIRs
    (``sg2_decode_firs``), BigGAN's attention (a launch per SelfAttn), none
    for PGGAN; on the bf16 forms in the default run."""
    from tpugan_torch.models import SelfAttn
    from tpugan_torch.ops import upfirdn

    suffix = "_bf16" if bf16 else ""
    layouts = {key: 0 for key in upfirdn.layout_launches}
    if bundle.mtype == 2:
        layouts = {key: 2 * n for key, n in sg2_decode_firs(bundle.generator).items()}
        return expected_launches(**{f"upfirdn2d{suffix}": sum(layouts.values())}), layouts
    if bundle.mtype == 4:
        n = sum(isinstance(m, SelfAttn) for m in bundle.generator.modules())
        return expected_launches(**{f"sagan_attention{suffix}": 2 * n}), layouts
    return expected_launches(), layouts


def synthesize_run(torch, label, flags, workdir, fp32, adjust=None):
    """``synthesize.main`` for SYN_SEED in one form, every count set to 0
    just before: its file, its launches against the counts derived from the
    bundle, and, kept from the run through wrappers of
    ``infer_e.draw_request`` and ``serve``, the request it drew, its images
    and its bundle. ``adjust(bundle)`` runs on the CLI's bundle as it is
    built."""
    import os

    from tpugan_torch.cli import infer_e, synthesize
    from tpugan_torch.io.image import load_image
    from tpugan_torch.ops import cuda, upfirdn

    form = "--fp32" if fp32 else "default"
    out_dir = os.path.join(workdir, f"{label} {form}")
    argv = list(flags) + ["--random_init", "--batch_size", str(BATCH), "--seed", str(SEED), "--device", CARD,
                          "--start_seed", str(SYN_SEED), "--count", "1", "--experiment_dir", out_dir]
    kept = {}
    real = (synthesize.build_bundle, infer_e.draw_request, infer_e.serve)

    def build(args):
        bundle = real[0](args)
        if adjust is not None:
            adjust(bundle)
        return bundle

    def draw(bundle, batch_size, seed):
        kept["request"] = real[1](bundle, batch_size, seed)
        return kept["request"]

    def serve(bundle, request):
        kept["bundle"], kept["images"] = bundle, real[2](bundle, request)
        return kept["images"]

    synthesize.build_bundle, infer_e.draw_request, infer_e.serve = build, draw, serve
    try:
        cuda.reset_launches()
        upfirdn.reset_layout_launches()
        t0 = time.perf_counter()
        paths = synthesize.main(argv + (["--fp32"] if fp32 else []))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches, layouts = dict(cuda.launches), dict(upfirdn.layout_launches)
    finally:
        synthesize.build_bundle, infer_e.draw_request, infer_e.serve = real
    bundle = kept["bundle"]
    want, want_layouts = synthesize_launches(bundle, bf16=not fp32)
    check(launches == want and layouts == want_layouts, f"synthesize {label} {form}: launches {launches}, by TPU "
          f"kernel {layouts}; derived from the modules: {want}, {want_layouts}")
    path = os.path.join(out_dir, "imgs", f"seed{SYN_SEED}.png")
    size = bundle.img_size
    grid = load_image(path)
    check(paths == [path] and grid.shape == (2 * size + 6, BATCH * size + 2 * (BATCH + 1), 3),
          f"synthesize {label} {form}: files {paths}, grid {grid.shape}")
    imgs = kept["images"]
    for name, img in zip(("imgs1", "imgs2"), imgs):
        check(tuple(img.shape) == (BATCH, size, size, 3) and img.dtype == torch.float32
              and bool(torch.isfinite(img).all()), f"synthesize {label} {form}: {name} {tuple(img.shape)}, "
              f"{img.dtype}, not all finite")
    used = {k: n for k, n in launches.items() if n}
    say(f"synthesize {label} {form}: {path} ({grid.shape[1]}x{grid.shape[0]}), launches {used or 'none'}, FIRs by "
        f"TPU kernel {layouts}, as derived from the modules; {seconds:.2f} s with the bundle's build; imgs1 in "
        f"[{imgs[0].min().item():.4f}, {imgs[0].max().item():.4f}], imgs2 in [{imgs[1].min().item():.4f}, "
        f"{imgs[1].max().item():.4f}]")
    return {"bundle": bundle, "request": kept["request"], "images": imgs, "launches": used, "layouts": layouts,
            "path": path}


def seed_times(torch, bundle, label, symbols):
    """Host-clock time of SYN_TIMED seeds of a synthesize bundle (a request
    each, ending in a synchronize) after two warm-up ones, and one seed's
    device time by kernel (torch.profiler, the device alone), with the
    share of the kernels whose symbols contain ``symbols`` (the host-clock
    time alone where no trace saw device time)."""
    from tpugan_torch.cli import infer_e

    lat = []
    for i in range(SYN_TIMED + 2):
        t0 = time.perf_counter()
        infer_e.run(bundle, BATCH, SYN_SEED + i)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    median = statistics.median(lat[2:])
    try:
        kernels = device_kernels(torch, lambda: infer_e.run(bundle, BATCH, SYN_SEED), iters=1, host=False)
    except MissedLaunches as missed:
        say(f"synthesize {label}: a seed {median:.3f} ms on the host clock (median of {SYN_TIMED}); device time "
            f"not measured ({missed})")
        return {"median_ms": median}
    busy = sum(ms for ms, _ in kernels.values())
    own = sum(ms for kname, (ms, _) in kernels.items() if any(s in kname for s in symbols))
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:3]
    say(f"synthesize {label}: a seed {median:.3f} ms on the host clock (median of {SYN_TIMED}), {busy:.3f} ms of "
        f"device time over {sum(n for _, n in kernels.values()):.0f} kernels and copies ({busy / median * 100:.1f}%"
        f" busy); the TPU kernels' counterparts {own:.3f} ms; largest: "
        + "; ".join(f"{ms:.3f} ms x{n:.0f} {k[:60]}" for k, (ms, n) in top))
    return {"median_ms": median, "device_ms": busy, "tpu_kernel_ms": own}


def synthesize_family(torch, dev, label, flags, workdir, adjust=None, cpu_adjust=None):
    """A family's two synthesize runs (the default, bf16 on the card, and
    --fp32) and their holds: the fp32 seed against its CPU replay (the
    request the CLI drew, moved; phase 7's rule), the bf16 seed against the
    card's fp32 one within twice the CPU's bf16 distance from its fp32 (the
    same request through ``synthesize.bf16_bundle`` of the CPU bundle;
    phase 10's rule), each image over its max |value|; and each form's
    times."""
    from tpugan_torch.cli import common, infer_e, synthesize

    runs = {form: synthesize_run(torch, label, flags, workdir, form == "fp32", adjust) for form in ("bf16", "fp32")}
    req = runs["fp32"]["request"]
    check(torch.equal(runs["bf16"]["request"].z, req.z), f"synthesize {label}: the two forms drew other inputs")
    symbols = ("upfirdn2d_kernel", "sagan_attention_kernel")
    times = {form: seed_times(torch, r["bundle"], f"{label} {form}", symbols) for form, r in runs.items()}
    cpu = common.build_bundle(synthesize.make_parser().parse_args(
        list(flags) + ["--random_init", "--batch_size", str(BATCH), "--seed", str(SEED), "--device", "cpu"]))
    if cpu_adjust is not None:
        cpu_adjust(cpu)
    t0 = time.perf_counter()
    cpu32 = infer_e.serve(cpu, req.to("cpu"))
    t1 = time.perf_counter()
    cpu16 = infer_e.serve(synthesize.bf16_bundle(cpu), req.to("cpu"))
    t2 = time.perf_counter()
    say(f"synthesize {label}: the CLI's fp32 request replayed on the CPU in {t1 - t0:.2f} s, in bf16 in "
        f"{t2 - t1:.2f} s")
    held = {}
    for i, name in enumerate(("imgs1", "imgs2")):
        g32, g16 = runs["fp32"]["images"][i].cpu(), runs["bf16"]["images"][i].cpu()
        ref = cpu32[i].abs().max().item()
        err = (g32 - cpu32[i]).abs().max().item()
        limit = CPU_GPU_ATOL * max(1.0, ref)
        card16 = (g16 - g32).abs().max().item() / g32.abs().max().item()
        cpu16_d = (cpu16[i] - cpu32[i]).abs().max().item() / ref
        say(f"  {name}: card fp32 vs CPU max |err| {err:.3e} (limit {limit:.3e}, max |ref| {ref:.3f}); bf16 from "
            f"fp32 over max |value|: card {card16:.3e}, CPU {cpu16_d:.3e} (limit twice the CPU's)")
        check(err <= limit, f"synthesize {label} {name}: the card's fp32 seed is {err:.3e} from the CPU's")
        check(0 < card16 <= 2 * cpu16_d, f"synthesize {label} {name}: the card's bf16 seed is {card16:.3e} from "
              f"its fp32, the CPU's {cpu16_d:.3e}")
        held[name] = {"fp32_err": err, "fp32_limit": limit, "bf16_card": card16, "bf16_cpu": cpu16_d}
    del cpu, cpu32, cpu16
    out = {form: {"launches": r["launches"], "fir_by_tpu_kernel": r["layouts"], **times[form]}
           for form, r in runs.items()}
    return out, held, runs["fp32"]["path"]


def compare_path(torch, workdir, png, size):
    """``compare.main`` over one synthesize grid's imgs1 against its imgs2,
    split into two directories (the tiles of the PNG), on the card and on
    the CPU, without and with ``--lpips_weights`` (a reference-named LPIPS
    state dict from SEED): PSNR, SSIM, MSE and cosine within COMPARE_RTOL of
    the CPU's, LPIPS within phase 14's rule."""
    import contextlib
    import io
    import os

    import numpy as np

    from tpugan_torch.cli import compare
    from tpugan_torch.io.image import load_image, save_image
    from tpugan_torch.tools import reference_state as ref

    grid = load_image(png)
    dirs = [os.path.join(workdir, f"compare{r + 1}") for r in range(2)]
    for r, d in enumerate(dirs):
        for c in range(BATCH):
            y, x = 2 + r * (size + 2), 2 + c * (size + 2)
            save_image(os.path.join(d, f"{c:05d}.png"), grid[y:y + size, x:x + size])
    weights = ref.save(os.path.join(workdir, "lpips-vgg.pth"), ref.lpips(np.random.default_rng(SEED)))
    out = {}
    for form, extra in (("without --lpips_weights", []), ("with --lpips_weights", ["--lpips_weights", weights])):
        argv = ["--dir1", dirs[0], "--dir2", dirs[1], "--img_size", str(size)] + extra
        with contextlib.redirect_stderr(io.StringIO()):  # the LPIPS warning, once a run
            card = compare.main(argv + ["--device", CARD])
            cpu = compare.main(argv + ["--device", "cpu"])
        errs = {}
        for metric, want in cpu.items():
            err = abs(card[metric] - want)
            if metric == "lpips":
                limit = CPU_GPU_ATOL * max(1.0, abs(want))
                check(err <= limit and (want != 0.0) == bool(extra), f"compare {form}: LPIPS {card[metric]} on the "
                      f"card, {want} on the CPU")
            else:
                limit = COMPARE_RTOL * abs(want)
                check(err <= limit, f"compare {form}: {metric} {card[metric]} on the card, {want} on the CPU")
            errs[metric] = err
        say(f"compare {form} ({BATCH} pairs at {size} px): card {json.dumps(card)}; |card - CPU| "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + f" (limits: {COMPARE_RTOL:g} relative, LPIPS "
            f"CPU_GPU_ATOL x max(1, |ref|))")
        out[form] = {"card": card, "cpu": cpu, "abs_err": errs}
    return out


def pggan_serving_path(torch, dev, parser, smi, fp32_peak, tf32_peak):
    """``infer_e --mtype 3`` at PGGAN-1024: REQUEST_SEEDS' requests with
    every count at 0 (no kernel of this repo runs), a request replayed on
    the CPU (phase 7's rule, TF32 off), its convolution FLOPs and their
    time at the card's fp32 and TF32 rates, and its latency, device time
    and peak memory with PyTorch's defaults (PG_TIMED's comment)."""
    from tpugan_torch.cli import common, infer_e
    from tpugan_torch.ops import cuda, upfirdn

    argv = list(PG_ARGV) + ["--random_init", "--batch_size", str(BATCH), "--seed", str(SEED)]
    t0 = time.perf_counter()
    bundle = common.build_bundle(parser.parse_args(argv + ["--device", CARD]))
    torch.cuda.synchronize()
    gen = bundle.generator
    say(f"bundle: mtype 3, PGGAN-{PG_SIZE} (fmaps {[gen.get_nf(2**r) for r in range(2, gen.final_log2 + 1)]} at "
        f"4-{PG_SIZE} px, nearest up-sampling) + E_PG (startf {PG_START_FEATURES}, maxf 512, layer_count "
        f"{bundle.layer_count}) built in {time.perf_counter() - t0:.2f} s")
    with torch.no_grad():
        flops = conv_flops(torch, (bundle.generator, bundle.encoder),
                           lambda: infer_e.run(bundle, BATCH, REQUEST_SEEDS[0]))
    cuda.reset_launches()
    upfirdn.reset_layout_launches()
    with pytorch_defaults(torch):  # PG_TIMED's comment
        for s in REQUEST_SEEDS:
            imgs1, imgs2 = infer_e.run(bundle, BATCH, s)
            torch.cuda.synchronize()
            for label, img in (("imgs1", imgs1), ("imgs2", imgs2)):
                check(tuple(img.shape) == (BATCH, PG_SIZE, PG_SIZE, 3) and bool(torch.isfinite(img).all()),
                      f"PGGAN {label} of seed {s}: shape {tuple(img.shape)}, or not finite")
        say(f"PGGAN request of seed {s}: imgs1 in [{imgs1.min().item():.4f}, {imgs1.max().item():.4f}], "
            f"imgs2 in [{imgs2.min().item():.4f}, {imgs2.max().item():.4f}]")
    launches, layouts = dict(cuda.launches), dict(upfirdn.layout_launches)
    check(launches == expected_launches() and not any(layouts.values()),
          f"PGGAN path launches {launches}, FIRs {layouts}: PGGAN runs no TPU kernel")
    say(f"PGGAN path: {len(REQUEST_SEEDS)} requests, no kernel of this repo launched (PGGAN runs no TPU kernel); "
        f"{flops / 1e12:.4f} TFLOP of convolutions and dense layers a request (G, E_PG, G), at the card's fp32 "
        f"rate {flops / fp32_peak * 1e3:.3f} ms (the bound with TF32 off), at its TF32 rate "
        f"{flops / tf32_peak * 1e3:.3f} ms (the bound with PyTorch's defaults)")
    cpu = common.build_bundle(parser.parse_args(argv + ["--device", "cpu"]))
    request = infer_e.draw_request(cpu, BATCH, REQUEST_SEEDS[0])
    on_gpu = infer_e.serve(bundle, request.to(dev))
    t0 = time.perf_counter()
    on_cpu = infer_e.serve(cpu, request)
    say(f"cuda vs cpu (PGGAN): the request of seed {REQUEST_SEEDS[0]} took {time.perf_counter() - t0:.2f} s on the "
        "CPU")
    errs = {}
    for label, g, c in zip(("imgs1", "imgs2"), on_gpu, on_cpu):
        err, ref = (g.cpu() - c).abs().max().item(), c.abs().max().item()
        limit = CPU_GPU_ATOL * max(1.0, ref)
        say(f"cuda vs cpu (PGGAN) {label}: max |err| {err:.3e}, limit {limit:.3e} (max |ref| {ref:.3f})")
        check(err <= limit, f"PGGAN {label}: cuda and cpu differ by {err:.3e} > {limit:.3e}")
        errs[label] = err
    del cpu, on_gpu, on_cpu
    say(f"PGGAN request times below: {smi}; device times from torch.profiler, request times from the host clock")
    run = lambda s: infer_e.run(bundle, BATCH, s)  # noqa: E731
    calls, profiled = PG_TIMED
    with pytorch_defaults(torch):
        median = request_latency(torch, run, REQUEST_SEEDS[0], f"PGGAN-{PG_SIZE} + E_PG, fp32 with TF32 "
                                 "convolutions (PyTorch defaults)", calls)
        times = {"median_ms": median, **request_device_time(torch, run, REQUEST_SEEDS[0], median, None, None,
                                                            iters=profiled)}
    del bundle
    torch.cuda.empty_cache()
    return {"tflop": flops / 1e12, "bound_ms_fp32": flops / fp32_peak * 1e3, "bound_ms_tf32": flops / tf32_peak * 1e3,
            "times_pytorch_defaults": times, "replay_max_abs_err": errs}


def pggan_training_path(torch, dev, smi):
    """``e_align --mtype 3`` at PGGAN-1024 (E_PG training, batch 2): case 1,
    its lean step and case 2, TRAIN_STEPS counted steps each with no kernel
    of this repo launched, the encoder moving and the generator frozen; step
    times, device time by kernel and peak memory (all with PyTorch's
    defaults: PG_TIMED's comment); a case-2 step at PG_REPLAY_SIZE replayed
    with TF32 off, on the card with cuDNN off held to float64 and beside it
    with cuDNN's deterministic algorithms (PG_REPLAY_SIZE's comment)."""
    from tpugan_torch.cli import e_align
    from tpugan_torch.losses.lpips import random_lpips_fn

    parser = e_align.make_parser()
    argv = list(PG_ARGV) + ["--random_init", "--iterations", "1000", "--batch_size", str(BATCH), "--seed",
                            str(SEED), "--device", CARD]
    lpips = random_lpips_fn(dev)
    times, trainer = {}, None
    zero = {key: 0 for key in AdjointCount().counts}
    for label, flags in PG_TRAIN_FORMS:
        lean = label == "case 1 lean"
        if not lean:
            del trainer
            torch.cuda.empty_cache()
            trainer = e_align.build_trainer(parser.parse_args(argv + list(flags)), lpips)
        step = trainer.lean if lean else trainer.step
        check(step is not None, f"PGGAN {label}: no step")
        state = trainer.state
        frozen = list(trainer.bundle.generator.parameters())
        frozen0 = [p.detach().clone() for p in frozen]
        params0 = {n: p.detach().clone() for n, p in state.encoder.named_parameters()}
        torch.cuda.reset_peak_memory_stats()
        for it in range(TRAIN_STEPS):
            with pytorch_defaults(torch):
                launches, fwd, adj, scalars = counted_step(torch, step, state, it)
            check(launches == expected_launches() and fwd == zero and adj == zero,
                  f"PGGAN {label} step {it}: launches {launches}, FIRs {fwd} + {adj}; PGGAN runs no TPU kernel")
            check(all(math.isfinite(x) for x in scalars.values()), f"PGGAN {label} step {it}: a loss is not finite")
        moved = sum(not torch.equal(p, params0[n]) for n, p in state.encoder.named_parameters())
        check(moved > 0 and all(bool(torch.isfinite(p).all()) for p in state.encoder.parameters()),
              f"PGGAN {label}: the encoder did not train, or is not finite")
        check(all(torch.equal(a, b) and a.grad is None for a, b in zip(frozen, frozen0)),
              f"PGGAN {label}: the frozen generator moved")
        say(f"PGGAN {label} path: {TRAIN_STEPS} steps, no kernel of this repo launched; loss_tsa "
            f"{scalars['loss_tsa']:.4f}, loss_mtv {scalars['loss_mtv']:.4f}, loss_c_mse {scalars['loss_c_mse']:.4f}; "
            f"{moved} of {len(params0)} E_PG parameters moved, the generator did not; peak device memory over the "
            f"counted steps (PyTorch defaults) {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
        say(f"PGGAN training times below: {smi}; step times from the host clock, device times from torch.profiler")
        calls, profiled = PG_TIMED
        with pytorch_defaults(torch):
            median = step_times(torch, step, state, f"PGGAN {label}, fp32 with TF32 convolutions (PyTorch "
                                "defaults)", 100, steps=calls)
            times[label] = {"median_ms": median, **step_device_time(torch, step, state, median, 200, symbols=(),
                                                                    iters=profiled)}
    del trainer
    torch.cuda.empty_cache()

    def card_launches(launches):
        check(launches == expected_launches(), f"the PGGAN replay launched {launches}")
        return launches

    with cudnn_deterministic(torch):  # the comment at CPU_GPU_ATOL
        replay = replay_case2_on_float64(
            torch, dev, e_align, "a PGGAN", ["--mtype", "3", "--img_size", str(PG_REPLAY_SIZE), "--start_features",
                                           str(PG_REPLAY_START_FEATURES)],
            f"PGGAN-{PG_REPLAY_SIZE} (its fmaps), E_PG at start_features {PG_REPLAY_START_FEATURES}", card_launches,
            card_forms=(("cuda, cuDNN off", cudnn_off), ("cuda, cuDNN deterministic", None)))
    return {"times": times, "replay": replay}


def pggan_inversion(torch, dev, workdir):
    """``embedding --mtype 3`` (fine-tuning E_PG, batch 1, lr 0.01, the CLI
    without LPIPS weights) for PG_INV_ITERATIONS iterations on a target PNG
    of the bundle's own (``write_target``), through the CLI's ``run``: its
    files, w moving, the encoder restored, the generator frozen, no kernel
    of this repo launched."""
    import os

    import numpy as np

    from tpugan_torch.cli import embedding
    from tpugan_torch.ops import cuda

    img_dir, out = os.path.join(workdir, "pggan-target"), os.path.join(workdir, "pggan-embedding")
    args = embedding.make_parser().parse_args(list(PG_ARGV) + [
        "--random_init", "--seed", str(SEED), "--device", CARD, "--img_dir", img_dir, "--iterations",
        str(PG_INV_ITERATIONS), "--experiment_dir", out])
    inverter = embedding.build_inverter(args)
    write_target(torch, inverter.bundle, img_dir)
    base = {k: v.clone() for k, v in inverter.bundle.encoder.state_dict().items()}
    frozen = {k: v.clone() for k, v in inverter.bundle.generator.state_dict().items()}
    cuda.reset_launches()
    t0 = time.perf_counter()
    embedding.run(inverter, args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check(cuda.launches == expected_launches(), f"embedding --mtype 3 launched {cuda.launches}")
    models = os.path.join(out, "models")
    w0, w1 = (np.load(os.path.join(models, f"id0-i0-w{i}.npy")) for i in (0, PG_INV_ITERATIONS))
    w, w_all = np.load(os.path.join(models, "id0-i0-w.npy")), np.load(os.path.join(models, "w_all.npy"))
    check(os.path.exists(os.path.join(out, "imgs", "00000_rec.png")) and w.shape == (512,) and w_all.shape == (1, 512)
          and np.isfinite(w).all(), f"embedding --mtype 3: files, w {w.shape}")
    moved = float(np.abs(w1 - w0).max())
    check(moved > 0, "embedding --mtype 3: w did not move")
    check(all(torch.equal(v, base[k]) for k, v in inverter.bundle.encoder.state_dict().items())
          and all(torch.equal(v, frozen[k]) for k, v in inverter.bundle.generator.state_dict().items()),
          "embedding --mtype 3: the encoder was not restored, or the generator moved")
    say(f"embedding --mtype 3 (PGGAN-{PG_SIZE}, E_PG fine-tuned, batch 1): {PG_INV_ITERATIONS} iterations in "
        f"{seconds:.2f} s with the files (first calls); no kernel of this repo launched; z moved by up to {moved:.4e}; "
        "the encoder restored, the generator frozen")
    del inverter
    torch.cuda.empty_cache()
    return {"seconds": seconds, "w_moved": moved}


def slice7b_path(torch, dev, smi, fp32_peak, tf32_peak):
    """Phase 15: synthesize on every family (the default bf16 run and
    --fp32) and compare over its files; PGGAN-1024 with E_PG through
    infer_e, e_align (case 1, lean, case 2), embedding and converted
    weights."""
    import os
    import shutil
    import tempfile

    import numpy as np

    from tpugan_torch.cli import common, infer_e
    from tpugan_torch.models import PGEncoder, PGGANGenerator
    from tpugan_torch.tools import reference_state as ref

    workdir = tempfile.mkdtemp(prefix="chip_smoke_slice7b_")
    parser = common.add_common_args(argparse.ArgumentParser(), training=True)
    try:
        t0 = time.perf_counter()
        syn, held, pngs = {}, {}, {}
        for label, flags in SYN_FAMILIES:
            adjust = cpu_adjust = None
            if flags[1] == "4":
                probe = common.build_bundle(parser.parse_args(list(flags) + [
                    "--random_init", "--batch_size", str(BATCH), "--seed", str(SEED), "--device", CARD]))
                zt_std, z2_std = latent_stds(torch, infer_e, probe, SYN_SEED)
                del probe
                factor = zt_std / z2_std

                def adjust(bundle, factor=factor):
                    scale_z_head(torch, bundle.encoder, factor)
                    check(set_attention_gamma(torch, bundle.generator, ATTN_GAMMA) == 1, "expected one SelfAttn")

                cpu_adjust = adjust
                say(f"synthesize {label}: E_BIG's z head scaled by {factor:.4e} and SelfAttn.gamma set to "
                    f"{ATTN_GAMMA:g} as the CLI builds its bundle (phase 5's adjustments)")
            syn[label], held[label], pngs[label] = synthesize_family(torch, dev, label, flags, workdir, adjust,
                                                                     cpu_adjust)
            torch.cuda.empty_cache()
        say(f"phase 15: synthesize took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        cmp = compare_path(torch, workdir, pngs[f"BigGAN-deep-{BIGGAN_SIZE}"], BIGGAN_SIZE)
        say(f"phase 15: compare took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        serving = pggan_serving_path(torch, dev, parser, smi, fp32_peak, tf32_peak)
        say(f"phase 15: PGGAN serving took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        training = pggan_training_path(torch, dev, smi)
        say(f"phase 15: PGGAN training took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        inversion = pggan_inversion(torch, dev, workdir)
        rng = np.random.default_rng(SEED)
        layers = int(math.log2(PG_SIZE)) - 1
        files = [ref.save(os.path.join(workdir, "pggan-1024.pth"), {f"generator_smooth.{k}": v for k, v in ref.pggan(
                     rng, lambda: PGGANGenerator(resolution=PG_SIZE)).items()}),
                 ref.save(os.path.join(workdir, "E_PG-1024.pth"), ref.encoder(rng, lambda: PGEncoder(
                     startf=PG_START_FEATURES, maxf=512, layer_count=layers, latent_size=512, img_size=PG_SIZE)))]
        argv = list(PG_ARGV) + ["--batch_size", str(BATCH), "--seed", str(SEED), "--checkpoint_dir_GAN", files[0],
                                "--checkpoint_dir_E", files[1]]
        converted = converted_request(torch, dev, parser, f"infer_e --mtype 3 (converted PGGAN-{PG_SIZE} and E_PG)",
                                      argv, lambda b: expected_launches())
        say(f"phase 15: PGGAN embedding and converted weights took {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return {"synthesize": syn, "synthesize_holds": held, "compare": cmp, "pggan_serving": serving,
            "pggan_training": training, "pggan_embedding": inversion, "pggan_converted": converted}


# phase 16, slice 7c: tpugan/train/gan.py at SGv1 Cat256's full width
# (tpugan/cli/common.py:117-120: G startf 64, maxf 512, layer_count 7,
# latent 512; its mapping 14 style layers from 8 mapping layers; D startf
# 64, maxf 512, layer_count 7), none of it cut: lod 6 at LODSchedule(max_lod
# 6)'s batch there (lod_2_batch[5], 16), ALAE's lr 0.0015 and beta2 0.99 in
# LREQAdam for both networks, r1_gamma 10, reals drawn from SEED; fp32, TF32
# off (tpugan's GAN step has no bf16 form). GAN_STEPS counted D + G pairs,
# each followed by ema_params onto a smoothed G, then one pair at the blend
# of GAN_TRANSITION (lod 6's fade-in: decode2).
GAN_MAX_LOD = 6
GAN_EPOCH = 97  # lod 6, past its fade-in (epochs 90-96)
GAN_TRANSITION = (93, 0)  # (epoch, iteration) inside the fade-in
GAN_LR, GAN_BETA2, GAN_R1_GAMMA = 0.0015, 0.99, 10.0
GAN_STEPS = 3
GAN_TIMED = (6, 1)  # (host-clock steps after 2 warm-up ones, profiled steps) of each step kind
# The replay: one D step and one G step, each from the same weights (the
# seed's, at full width), reals and draws (made on the CPU), at batch 4 (one
# minibatch-stddev group) and GAN_REPLAY_SIZE px, on the card (TF32 off), on
# the CPU and on the CPU in float64. Written before its first run: the
# losses within REPLAY_LOSS_RTOL of float64; each step's gradients (all
# leaves together) and the dlatent average after the G step no farther from
# float64 than twice the CPU fp32 run is, or REPLAY_FLOOR x max |ref| where
# that is larger (replay_distance). The R1 gradient is ill-conditioned in
# fp32, and cuDNN's fp32 algorithms (deterministic, default or benchmark)
# put the card's D gradient 2.915e-4 from float64 and its G gradient 26.6,
# against the CPU's 5.089e-5 and 2.51; with cuDNN off (PyTorch's own
# convolutions) 4.862e-5 and 2.52 (tpugan_torch/tools/gan_replay_forms.py,
# 256 px; at 128 px cuDNN off is 2.567e-5 against the CPU's 9.544e-6). So,
# as for PGGAN (PG_REPLAY_SIZE), the held card run has cuDNN off and the run
# with cuDNN's deterministic algorithms is measured beside it and printed;
# ROADMAP C records it as open. The CPU side takes about 65 s at 256 px.
GAN_REPLAY_BATCH = 4
GAN_REPLAY_SIZE = 256


def gan_modules(torch, size):
    """SGv1's G, mapping and D at ``size`` px and full width, random weights
    from SEED, on the CPU."""
    from tpugan_torch.models import StyleGANv1Discriminator, StyleGANv1Generator, StyleGANv1Mapping

    layers = int(math.log2(size)) - 1
    g = torch.Generator().manual_seed(SEED)
    return (StyleGANv1Generator(startf=64, maxf=512, layer_count=layers, latent_size=512, generator=g),
            StyleGANv1Mapping(num_layers=2 * layers, mapping_layers=8, generator=g),
            StyleGANv1Discriminator(startf=64, maxf=512, layer_count=layers, generator=g))


def gan_optimizers(torch, gen, gm, disc):
    """LREQAdam for G (gen and gm together, as tpugan's covers {'gen', 'gm'})
    and for D, at GAN_LR and GAN_BETA2."""
    from torch import nn

    from tpugan_torch.optim.lreq_adam import lreq_adam

    return (lreq_adam(nn.ModuleDict({"gen": gen, "gm": gm}), GAN_LR, GAN_BETA2),
            lreq_adam(disc, GAN_LR, GAN_BETA2))


def gan_step_firs(gen, disc, lod):
    """The FIR launches of a D step and of a G step at ``lod`` by direction
    and TPU kernel, derived from the modules: G's blur after each
    up-sampling conv (blocks 1 to lod, on their outputs; decode2 runs the
    same blocks) and D's blur before each down-sampling conv (every block
    from the lod's first but the last, on its input channels). D step:
    forward G's once (no graph) and D's on the reals and on the fakes;
    adjoint D's on the reals in the R1 gradient (built with a graph), then
    in the loss's backward D's on the reals and on the fakes; second order
    the backward of each R1 adjoint. G step: G's and D's forward and their
    adjoints."""
    from tpugan_torch.ops import upfirdn

    def by_key(channels):
        keys = [upfirdn.tpu_layout(c, 1, 1, 3, 3, (1, 1)) for c in channels]
        return {key: keys.count(key) for key in upfirdn.layout_launches}

    g = by_key(getattr(gen, f"decode_block_{i}").bias_1.shape[0] for i in range(1, lod + 1))
    blocks = [getattr(disc, f"encode_block_{i}") for i in range(disc.layer_count - lod - 1, disc.layer_count)]
    d = by_key(b.bias_1.shape[0] for b in blocks if not b.last)
    add = lambda *parts: {key: sum(p_[key] for p_ in parts) for key in g}  # noqa: E731
    return {"D step": {"forward": add(g, d, d), "adjoint": add(d, d, d), "second order": d},
            "G step": {"forward": add(g, d), "adjoint": add(g, d)}}


def counted_gan_step(torch, label, run, want):
    """One GAN step with every count set to 0 just before it, its FIR
    launches by direction and TPU kernel held to ``want``; returns the
    launches and the loss."""
    from tpugan_torch.ops import cuda, upfirdn

    cuda.reset_launches()
    upfirdn.reset_layout_launches()
    with FirCapture(keep=False) as capture:
        _, loss = run()
        torch.cuda.synchronize()
    launches, counted = dict(cuda.launches), capture.counts()
    total = sum(sum(v.values()) for v in want.values())
    check(launches == expected_launches(upfirdn2d=total) and sum(upfirdn.layout_launches.values()) == total,
          f"{label}: launches {launches}, expected {total} upfirdn2d and nothing else")
    check(counted == want, f"{label}: FIR launches {counted}; derived from the modules {want}")
    check(math.isfinite(loss.item()), f"{label}: the loss is not finite")
    return total, loss.item()


def gan_replay(torch, dev, card_forms=(("cuda, cuDNN off", cudnn_off),
                                      ("cuda, cuDNN deterministic", cudnn_deterministic))):
    """A D step and a G step at GAN_REPLAY_SIZE px, batch GAN_REPLAY_BATCH,
    on the card, on the CPU and on the CPU in float64 (GAN_REPLAY_SIZE's
    comment). ``card_forms``: (label, context) of each card run; the first
    is held, the others are measured and printed beside it."""
    from tpugan_torch.models import StyleGANv1Generator
    from tpugan_torch.ops import cuda
    from tpugan_torch.train import gan

    size, batch = GAN_REPLAY_SIZE, GAN_REPLAY_BATCH
    lod = int(math.log2(size)) - 2
    g = torch.Generator().manual_seed(SEED)
    reals = torch.randn(batch, 3, size, size, generator=g)
    draws = gan.draw(StyleGANv1Generator(1, 1, lod + 1, 1), batch, 512, lod, g)  # its noise_shapes
    cpu = torch.device("cpu")
    runs, seconds, names, launches = {}, {}, {}, {}
    forms = [(label, CARD, dev, torch.float32, ctx) for label, ctx in card_forms] + [
        ("cpu", "cpu", cpu, torch.float32, None), ("f64", "cpu", cpu, torch.float64, None)]
    for label, device, place, dtype, ctx in forms:
        run, t0 = {}, time.perf_counter()
        d = draws._replace(z=draws.z.to(place, dtype), z2=draws.z2.to(place, dtype), cutoff=draws.cutoff.to(place),
                           mix=draws.mix.to(place), noise=[tuple(n.to(place, dtype) for n in p_) for p_ in draws.noise])
        cuda.reset_launches()
        for kind in ("d", "g"):
            gen, gm, disc = (m.to(dtype) for m in gan_modules(torch, size))
            g_opt, d_opt = gan_optimizers(torch, gen, gm, disc)
            owner = disc if kind == "d" else torch.nn.ModuleDict({"gen": gen, "gm": gm})
            opt, grads = (d_opt if kind == "d" else g_opt), {}
            step_with = opt.step
            opt.step = lambda: (grads.update((n, p_.grad.detach().double().cpu()) for n, p_ in owner.named_parameters()
                                             if p_.grad is not None), step_with())
            state = gan.init_gan_state(gen, gm, disc, g_opt, d_opt, device=device, seed=SEED)
            state.dlatent_avg = state.dlatent_avg.to(dtype)
            d_step, g_step = gan.make_gan_steps(lod, 1.0, 512, GAN_R1_GAMMA)
            with contextlib.nullcontext() if ctx is None else ctx(torch):
                _, loss = d_step(state, reals.to(place, dtype), d) if kind == "d" else g_step(state, batch, d)
            run[f"{kind}_loss"] = loss.double().cpu().reshape(1)
            names[kind] = list(grads)
            run[f"{kind}_leaves"] = grads
            run[f"{kind}_grads"] = torch.cat([x.flatten() for x in grads.values()])
            if kind == "g":
                run["avg"] = state.dlatent_avg.double().cpu()
            del state, gen, gm, disc, g_opt, d_opt, opt, owner
        if label not in ("cpu", "f64"):
            torch.cuda.synchronize()
            launches = dict(cuda.launches)
            check(launches["upfirdn2d"] > 0, f"the GAN replay's {label} run launched {launches}")
        else:
            check(not any(cuda.launches.values()), "the GAN replay's CPU run launched a kernel")
        runs[label], seconds[label] = run, time.perf_counter() - t0
    say(f"replay of a GAN D step and G step: SGv1 at {size} px, full width, batch {batch}, lod {lod}; launches on "
        f"the card {launches['upfirdn2d']} upfirdn2d a run; " + ", ".join(f"{k} {v:.2f} s" for k, v in seconds.items())
        + " (the card's first run is a first call)")
    ref = runs["f64"]
    for label in [f[0] for f in card_forms] + ["cpu"]:
        for kind in ("d", "g"):
            worst = sorted(((float((runs[label][f"{kind}_leaves"][n] - r).abs().max()), n)
                            for n, r in ref[f"{kind}_leaves"].items()), reverse=True)[:3]
            say(f"  GAN replay {label} {kind.upper()} gradient, worst leaves against float64: "
                + ", ".join(f"{n} {e:.3e} (max |ref| {ref[f'{kind}_leaves'][n].abs().max().item():.3e})"
                            for e, n in worst))
    others = {}
    for label, _ in card_forms[1:]:
        others[label] = {key: float((runs[label][key] - ref[key]).abs().max()) for key in ("d_grads", "g_grads", "avg")}
        say(f"  GAN replay {label} (measured beside the held run, not held): " + ", ".join(
            f"{key} {v:.3e} from float64" for key, v in others[label].items()))
    held = {"card": runs[card_forms[0][0]], "cpu": runs["cpu"], "f64": ref}
    out = replay_distance(torch, f"GAN replay ({card_forms[0][0]})", held, ("d_grads", "g_grads", "avg"),
                          ("d_loss", "g_loss"))
    torch.cuda.empty_cache()
    return {"size": size, "batch": batch, "seconds": seconds, "held": card_forms[0][0], **out,
            **({"not_held": others} if others else {})}


def gan_module_checks(torch, dev, gen, lod):
    """decode3 (blob removal) at ``lod`` with its FIR launches, and
    Mapping2 (both directions), Mapping3 and Mapping4 at full width (14
    style layers, latent 512) from SEED, each on the card against the CPU
    within CPU_GPU_ATOL x max(1, max |ref|)."""
    import copy

    from tpugan_torch.models import StyleGANv1Mapping2, StyleGANv1Mapping3, StyleGANv1Mapping4
    from tpugan_torch.ops import cuda, upfirdn

    g = torch.Generator().manual_seed(SEED)
    layers = 2 * gen.layer_count
    styles = torch.randn(BATCH, layers, 512, generator=g)
    noise = [tuple(torch.randn(s_, generator=g) for s_ in pair) for pair in gen.noise_shapes(BATCH, lod)]
    z, w = torch.randn(16, 512, generator=g), torch.randn(16, layers, 512, generator=g)
    cases = [("decode3", gen, copy.deepcopy(gen).cpu(), lambda m, place: m.decode3(
        styles.to(place), lod, [tuple(n.to(place) for n in p_) for p_ in noise]))]
    for label, make, x in (("Mapping2", lambda: StyleGANv1Mapping2(layers, 8, 512, generator=g), z),
                           ("Mapping2 inverse", lambda: StyleGANv1Mapping2(layers, 8, 512, inverse=True,
                                                                           generator=g), w),
                           ("Mapping3", lambda: StyleGANv1Mapping3(layers, 512, generator=g), z),
                           ("Mapping4", lambda: StyleGANv1Mapping4(layers, 512, generator=g), w)):
        module = make()
        cases.append((label, copy.deepcopy(module).to(dev), module, lambda m, place, x=x: m(x.to(place))))
    out, decode3_launches = {}, 0
    for label, card_module, cpu_module, call in cases:
        cuda.reset_launches()
        upfirdn.reset_layout_launches()
        with torch.no_grad():
            got = call(card_module, dev)
            torch.cuda.synchronize()
            launches = dict(cuda.launches)
            want = call(cpu_module, torch.device("cpu"))
        if label == "decode3":
            # G's blurs, blocks 1 to lod; from block 4 on, the pair's too
            decode3_launches = sum(1 + (i >= 4) for i in range(1, lod + 1))
            check(launches == expected_launches(upfirdn2d=decode3_launches),
                  f"decode3 launched {launches}, expected {decode3_launches} upfirdn2d")
        else:
            check(launches == expected_launches(), f"{label} launched {launches}")
        err, ref = (got.cpu() - want).abs().max().item(), want.abs().max().item()
        limit = CPU_GPU_ATOL * max(1.0, ref)
        say(f"cuda vs cpu {label}: output {list(got.shape)}, max |err| {err:.3e}, limit {limit:.3e} (max |ref| "
            f"{ref:.3f}); launches {launches['upfirdn2d']} upfirdn2d")
        check(got.shape == want.shape and bool(torch.isfinite(got).all()) and err <= limit,
              f"{label}: the card and the CPU differ by {err:.3e} > {limit:.3e}")
        out[label] = err
        del card_module, cpu_module, got, want
    torch.cuda.empty_cache()
    return out, decode3_launches


def gan_training_path(torch, dev, smi, fp32_peak):
    """Phase 16 (GAN_MAX_LOD's comment): the counted D + G pairs with their
    FIR launches by direction (forward, adjoint, second order) and TPU
    kernel against ``gan_step_firs``, ema_params onto the smoothed G, the
    transition pair; every FIR of a D step and of a G step on its own inputs
    against the plain version; step times, device time by kernel, the FIR's
    share, the convolutions' forward FLOPs and peak memory; decode3 and
    Mapping2/3/4 against the CPU; the float64 replay."""
    import copy

    from tpugan_torch.train import gan

    t0 = time.perf_counter()
    schedule = gan.LODSchedule(max_lod=GAN_MAX_LOD)
    lod, batch, blend = schedule.lod(GAN_EPOCH), schedule.batch_size(GAN_EPOCH), schedule.blend(*GAN_TRANSITION)
    check(schedule.blend(GAN_EPOCH, 0) == 1.0 and schedule.lod(GAN_TRANSITION[0]) == lod and 0 < blend < 1,
          f"LODSchedule: lod {lod}, transition blend {blend}")
    gen, gm, disc = gan_modules(torch, IMG_SIZE)
    check(lod == gen.layer_count - 1, f"lod {lod} is not the top of a {IMG_SIZE} px G")
    smooth = copy.deepcopy(gen).to(dev)
    state = gan.init_gan_state(gen, gm, disc, *gan_optimizers(torch, gen, gm, disc), device=CARD, seed=SEED)
    smooth0 = [p.detach().clone() for p in smooth.parameters()]
    reals = torch.randn(batch, 3, IMG_SIZE, IMG_SIZE, generator=torch.Generator(device=dev).manual_seed(SEED),
                        device=dev)
    want = gan_step_firs(gen, disc, lod)
    d0 = {n: p.detach().clone() for n, p in disc.named_parameters()}
    g0 = {n: p.detach().clone() for n, p in gen.named_parameters()}
    torch.cuda.synchronize()
    say(f"GAN: SGv1 Cat256 G (startf 64, maxf 512, layer_count {gen.layer_count}) + mapping (8 layers) + D (startf "
        f"64, maxf 512) built in {time.perf_counter() - t0:.2f} s; lod {lod}, batch {batch} (LODSchedule(max_lod="
        f"{GAN_MAX_LOD}) at epoch {GAN_EPOCH}), transition blend {blend:.6f} at (epoch, iteration) {GAN_TRANSITION}; "
        f"FIR launches a step derived from the modules: {want}")

    # the main path: GAN_STEPS pairs and a transition pair, counts at 0 before each step
    launches, losses = 0, []
    for form, pairs, b in (("stable", GAN_STEPS, 1.0), ("transition", 1, blend)):
        d_step, g_step = gan.make_gan_steps(lod, b, 512, GAN_R1_GAMMA)
        for it in range(pairs):
            n_d, d_loss = counted_gan_step(torch, f"GAN {form} D step {it}", lambda: d_step(state, reals),
                                           want["D step"])
            n_g, g_loss = counted_gan_step(torch, f"GAN {form} G step {it}", lambda: g_step(state, batch),
                                           want["G step"])
            gan.ema_params(smooth, gen)
            launches += n_d + n_g
            losses.append((form, d_loss, g_loss))
    d_moved = sum(not torch.equal(p, d0[n]) for n, p in disc.named_parameters())
    g_moved = sum(not torch.equal(p, g0[n]) for n, p in gen.named_parameters())
    s_moved = sum(not torch.equal(p, p0) for p, p0 in zip(smooth.parameters(), smooth0))
    finite = all(bool(torch.isfinite(p).all()) for m in (gen, gm, disc, smooth) for p in m.parameters())
    check(state.step == GAN_STEPS + 1 and d_moved and g_moved and s_moved and finite
          and bool(state.dlatent_avg.abs().sum() > 0),
          f"GAN: step {state.step}, D {d_moved}, G {g_moved}, smoothed G {s_moved} parameters moved, finite {finite}")
    say(f"GAN path: {GAN_STEPS} D + G pairs and one at blend {blend:.6f}, each followed by ema_params; "
        f"{launches} upfirdn2d launches, a D step {sum(sum(v.values()) for v in want['D step'].values())} and a G step "
        f"{sum(sum(v.values()) for v in want['G step'].values())} as derived; losses (form, D, G) "
        + "; ".join(f"{f} {d:.4f} {g:.4f}" for f, d, g in losses)
        + f"; parameters moved: D {d_moved}, G {g_moved}, the smoothed G {s_moved}; state.step {state.step}")

    # every FIR of a D step and of a G step on its own inputs
    d_step, g_step = gan.make_gan_steps(lod, 1.0, 512, GAN_R1_GAMMA)
    runs = {"D step": (lambda st, it: d_step(st, reals)), "G step": (lambda st, it: g_step(st, batch))}
    max_err = 0.0
    for kind, run in runs.items():
        with FirCapture() as capture:
            run(state, 0)
            torch.cuda.synchronize()
        max_err = max(max_err, hold_captured_firs(torch, capture, f"SGv1 Cat256 GAN {kind}", torch.float32,
                                                  directions=tuple(want[kind]), what=kind))
        del capture
        torch.cuda.empty_cache()

    say(f"GAN training times below: {smi}; step times from the host clock, device times from torch.profiler")
    times = {}
    for kind, run in runs.items():
        flops = conv_flops(torch, (gen, gm, disc), lambda: run(state, 0))
        median = step_times(torch, run, state, f"SGv1 Cat256 GAN {kind}, lod {lod}, batch {batch}, fp32, TF32 off",
                            0, steps=GAN_TIMED[0])
        t = step_device_time(torch, run, state, median, 0, symbols=("upfirdn2d_kernel",), iters=GAN_TIMED[1])
        t.update(median_ms=median, forward_conv_tflop=flops / 1e12, forward_conv_bound_ms=flops / fp32_peak * 1e3)
        if "device_ms" in t:
            t["fir_share"] = t["kernel_ms"]["upfirdn2d_kernel"] / t["device_ms"]
        say(f"GAN {kind}: the forward passes' convolutions and dense layers {flops / 1e12:.4f} TFLOP, "
            f"{flops / fp32_peak * 1e3:.3f} ms at the card's fp32 rate"
            + (f"; upfirdn2d {t['fir_share'] * 100:.2f}% of the device time" if "fir_share" in t else ""))
        times[kind] = t
    say(f"phase 16: the GAN path took {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    modules, decode3_launches = gan_module_checks(torch, dev, gen, lod)
    del state, gen, gm, disc, smooth
    torch.cuda.empty_cache()
    say(f"phase 16: decode3 and the mappings took {time.perf_counter() - t1:.1f} s")
    replay = gan_replay(torch, dev)
    return {"launches": launches, "decode3_launches": decode3_launches, "max_abs_err": max_err, "lod": lod,
            "batch": batch, "transition_blend": blend, "per_step": want, "times": times, "modules": modules,
            "replay": replay}


# ---- phase 17: slice 7d, export_model through torch.export; profiling; PGGAN's D and pggan_alt ----
EXPORT_SGV1 = ("--mtype", "1", "--img_size", str(IMG_SIZE), "--start_features", "64")
EXPORT_SG2 = ("--mtype", "2", "--img_size", str(SG2_SIZE), "--start_features", str(SG2_START_FEATURES))
EXPORT_BIGGAN = ("--mtype", "4", "--img_size", str(BIGGAN_SIZE), "--start_features", "64", "--z_dim",
                 str(BIGGAN_Z_DIM))
# (label, argv, --what, extra flags) of each artifact export_model's main writes, with --check
EXPORTS = (
    ("SGv1 Cat256 synthesis", EXPORT_SGV1, "synthesis", ()),
    ("SGv1 Cat256 E_Blur encode", EXPORT_SGV1, "encode", ("--ablation", "8")),
    (f"StyleGAN2-{SG2_SIZE} synthesis", EXPORT_SG2, "synthesis", ()),
    (f"StyleGAN2-{SG2_SIZE} synthesis --bf16", EXPORT_SG2, "synthesis", ("--bf16",)),
    (f"BigGAN-deep-{BIGGAN_SIZE} synthesis", EXPORT_BIGGAN, "synthesis", ()),
    (f"BigGAN-deep-{BIGGAN_SIZE} synthesis --bf16", EXPORT_BIGGAN, "synthesis", ("--bf16",)),
    (f"PGGAN-{PG_SIZE} synthesis", PG_ARGV, "synthesis", ()),
    (f"E_BIG-{BIGGAN_SIZE} encode", EXPORT_BIGGAN, "encode", ()),
)
FRESH_PROCESS_ARTIFACT = "SGv1 Cat256 synthesis"  # loaded in a process that imports tpugan_torch.io.export alone
EXPORT_TIMED = (5, 3)  # profiling.timeit_ms: calls a window, windows (best of)
PROGAN_CLASSES = 10  # the conditional Pro-GAN discriminator's classes


def e_blur_firs(encoder):
    """E_Blur's blurs by TPU kernel: the same-size 3x3 blur before each
    block's fused downsampling conv, on the block's input channels."""
    from tpugan_torch.ops import upfirdn

    blocks = [getattr(encoder, f"block_{i}") for i in range(encoder.layer_count)]
    keys = [upfirdn.tpu_layout(b.conv_1.weight.shape[0], 1, 1, 3, 3, (1, 1)) for b in blocks
            if b.use_blur and b.has_last_conv and b.block_version == 2]
    return {key: keys.count(key) for key in upfirdn.layout_launches}


def artifact_calls(module, bf16):
    """The kernel launches of one artifact call (``cuda.launches`` of the
    dtype's form) and its FIRs by TPU kernel, derived from its generator or
    encoder as phases 3, 7 and 15 derive them; an artifact's graph holds one
    operator node per launch."""
    from tpugan_torch.models import Encoder, SelfAttn, StyleGAN2Generator, StyleGANv1Generator

    layouts = {"B1": 0, "B2": 0, "XLA": 0}
    if isinstance(module, Encoder):
        layouts = e_blur_firs(module)
    elif isinstance(module, StyleGANv1Generator):
        layouts = sgv1_decode_firs(module)
    elif isinstance(module, StyleGAN2Generator):
        layouts = sg2_decode_firs(module)
    firs, attn = sum(layouts.values()), sum(isinstance(m, SelfAttn) for m in module.modules())
    suffix = "_bf16" if bf16 else ""
    counts = {name: n for name, n in ((f"upfirdn2d{suffix}", firs), (f"sagan_attention{suffix}", attn)) if n}
    nodes = {name: n for name, n in (("upfirdn2d", firs), ("sagan_attention", attn)) if n}
    return counts, layouts, nodes


class PlainOnCard:
    """Counts, while entered, the calls of the plain FIR and attention
    versions on CUDA tensors (the card's route must never reach them)."""

    def __init__(self):
        from tpugan_torch.ops import attention, upfirdn

        self.targets = [(upfirdn, "_fir_plain"), (attention, "sagan_attention_plain"),
                        (attention, "sagan_attention_bwd_plain")]
        self.calls = 0

    def __enter__(self):
        self.saved = [getattr(mod, name) for mod, name in self.targets]
        for (mod, name), real in zip(self.targets, self.saved):
            def spy(x, *args, _real=real, **kwargs):
                self.calls += x.is_cuda
                return _real(x, *args, **kwargs)

            setattr(mod, name, spy)
        return self

    def __exit__(self, *exc):
        for (mod, name), real in zip(self.targets, self.saved):
            setattr(mod, name, real)


def fresh_process_start(torch, path, example, workdir):
    """Start a new Python process that imports ``tpugan_torch.io.export``
    alone, with the parent's numerics (TF32 off, cuDNN's deterministic
    algorithms), loads the artifact at ``path`` and calls it once; it runs
    beside the parent's next exports (:func:`fresh_process_result`)."""
    inputs, output = f"{workdir}/fresh_inputs.pt", f"{workdir}/fresh_output.pt"
    torch.save(tuple(example), inputs)
    code = (
        "import json, sys, torch\n"
        "torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False  # as the parent\n"
        "torch.backends.cudnn.deterministic = True\n"
        "from tpugan_torch.io.export import load_exported_file\n"
        "from tpugan_torch.ops import cuda\n"
        f"f = load_exported_file({path!r})\n"
        f"out = f(*torch.load({inputs!r}))\n"
        "torch.cuda.synchronize()\n"
        f"torch.save(out, {output!r})\n"
        "print(json.dumps({'launches': {k: v for k, v in cuda.launches.items() if v}, 'modules': sorted("
        "m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'tpugan') or m.startswith(("
        "'tpugan_torch.models', 'tpugan_torch.train', 'tpugan_torch.cli')))}))\n"
    )
    proc = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, output, time.perf_counter()


def fresh_process_result(torch, started):
    """The fresh process's output, its launches and the port's model,
    training and CLI modules (and JAX) it imported, which must be none, and
    its seconds; waits for it (at most 300 s)."""
    proc, output, t0 = started
    try:
        stdout, stderr = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    check(proc.returncode == 0, f"the fresh process failed: {stderr[-2000:]}")
    report = json.loads(stdout.strip().splitlines()[-1])
    return torch.load(output, map_location="cuda"), report, time.perf_counter() - t0


def export_artifacts(torch, dev, smi, workdir):
    """Every artifact of EXPORTS through ``export_model.main`` with
    ``--check`` (bitwise against the live function, both on cuDNN's
    deterministic algorithms: ``check_artifact``'s comment): exporting launches
    nothing; the graph's operator nodes, and one call's launches on the
    form of its dtype with its FIRs by TPU kernel, equal the counts derived
    from the modules; no plain version runs on a CUDA tensor; the artifact
    against the live function per call (``profiling.timeit_ms``). BigGAN's
    SelfAttn gammas are set as phase 5 sets them; PGGAN runs with PyTorch's
    defaults (TF32 convolutions; the FFT trap of TF32 off). One artifact is
    loaded in a fresh process, which runs beside the later exports, and held
    to the CPU run of the same weights."""
    from tpugan_torch import profiling
    from tpugan_torch.cli import common, export_model
    from tpugan_torch.ops import cuda, upfirdn

    real_build, real_export = export_model.build_bundle, export_model.export_program
    exported = []

    def build(args):
        bundle = real_build(args)
        if bundle.mtype == 4:
            set_attention_gamma(torch, bundle.generator, ATTN_GAMMA)
        return bundle

    def export(*args, **kwargs):
        cuda.reset_launches()
        upfirdn.reset_layout_launches()
        program = real_export(*args, **kwargs)
        torch.cuda.synchronize()
        exported.append(sum(cuda.launches.values()) + sum(upfirdn.layout_launches.values()))
        return program

    rows, artifacts, fresh = {}, {}, None
    export_model.build_bundle, export_model.export_program = build, export
    try:
        for label, argv, what, extra in EXPORTS:
            bf16, pg = "--bf16" in extra, argv is PG_ARGV
            path = f"{workdir}/{len(rows)}.pt2"
            flags = [*argv, *extra, "--random_init", "--batch_size", str(BATCH), "--seed", str(SEED),
                     "--what", what, "--out", path, "--check"]
            with (pytorch_defaults(torch) if pg else contextlib.nullcontext()):
                t0 = time.perf_counter()
                out = export_model.main(flags)
                main_s = time.perf_counter() - t0
                check(exported[-1] == 0, f"{label}: exporting launched {exported[-1]} kernels")
                want, layouts_want, nodes_want = artifact_calls(out.modules[0], bf16)
                check(out.nodes == nodes_want, f"{label}: operator nodes {out.nodes}, derived {nodes_want}")
                artifact = out.artifact
                cuda.reset_launches()
                upfirdn.reset_layout_launches()
                with PlainOnCard() as plain, torch.no_grad(), cudnn_deterministic(torch):  # check_artifact's comment
                    got = artifact(*out.example)
                    torch.cuda.synchronize()
                    launches, layouts = dict(cuda.launches), dict(upfirdn.layout_launches)
                    live = out.fn(*out.example)
                check(launches == expected_launches(**want) and layouts == layouts_want,
                      f"{label}: a call launched {launches}, FIRs {layouts}; derived {want}, {layouts_want}")
                check(plain.calls == 0, f"{label}: a plain version ran {plain.calls} times on a CUDA tensor")
                got_t = got if isinstance(got, tuple) else (got,)
                live_t = live if isinstance(live, tuple) else (live,)
                check(all(torch.equal(a, b) for a, b in zip(got_t, live_t))
                      and all(bool(torch.isfinite(a).all()) for a in got_t),
                      f"{label}: the artifact's call is not bitwise the live function's, or not finite")
                with torch.no_grad():  # cuDNN's default algorithms: two live calls
                    first, second = (out.fn(*out.example) for _ in range(2))
                spread = max((a.float() - b.float()).abs().max().item() for a, b in
                             zip(*((x if isinstance(x, tuple) else (x,)) for x in (first, second))))
                del first, second
                t_art = profiling.timeit_ms(artifact, *out.example, iters=EXPORT_TIMED[0], windows=EXPORT_TIMED[1])
                t_live = profiling.timeit_ms(out.fn, *out.example, iters=EXPORT_TIMED[0], windows=EXPORT_TIMED[1])
            rows[label] = {"what": what, "mtype": int(argv[1]), "bf16": bf16, "export_s": out.seconds,
                           "main_s": main_s, "mib": out.size / 2**20, "nodes": out.nodes, "launches": want,
                           "firs_by_tpu_kernel": layouts, "artifact_ms": t_art, "live_ms": t_live,
                           "live_spread_default_cudnn": spread,
                           "graph_calls": sum(n.op == "call_function" for n in artifact.graph.nodes),
                           "outputs": [list(a.shape) for a in got_t]}
            say(f"export {label}: {out.size / 2**20:.1f} MiB in {out.seconds:.2f} s (main with --check "
                f"{main_s:.2f} s, {rows[label]['graph_calls']} calls in the graph), exporting launched nothing; "
                f"operator nodes {out.nodes} as derived; a call "
                f"launched {want} (FIRs by TPU kernel {layouts}), no plain version on the card; bitwise the live "
                f"function under cuDNN's deterministic algorithms (two live calls with its default ones part by "
                f"{spread:.3e}); per call artifact {t_art:.3f} ms, live {t_live:.3f} ms ({t_art / t_live:.3f}x)"
                + (" (PyTorch defaults: TF32 convolutions)" if pg else ""))
            if label == FRESH_PROCESS_ARTIFACT:
                fresh = (label, fresh_process_start(torch, path, out.example, workdir), got.clone(), want)
                cpu = common.build_bundle(export_model.make_parser().parse_args(
                    [*argv, "--random_init", "--batch_size", str(BATCH), "--seed", str(SEED), "--out", path,
                     "--device", "cpu"]))
                fn_cpu, _, example_cpu = export_model.synthesis_program(cpu, BATCH)
                with torch.no_grad():
                    ref = fn_cpu(*example_cpu)
                err, peak = (got.cpu() - ref).abs().max().item(), ref.abs().max().item()
                limit = CPU_GPU_ATOL * max(1.0, peak)
                say(f"export {label}: the artifact on the card against the CPU run of the same weights: max |err| "
                    f"{err:.3e}, limit {limit:.3e} (max |ref| {peak:.3f})")
                check(err <= limit, f"{label}: card and CPU differ by {err:.3e} > {limit:.3e}")
                rows[label]["cpu_max_abs_err"] = err
                del cpu, fn_cpu, ref
            if label.startswith(f"StyleGAN2-{SG2_SIZE} synthesis") and not bf16:
                artifacts["sg2"] = (artifact, out.example)
            if pg:
                with torch.no_grad():
                    artifacts["pggan_images"] = out.fn(*out.example)
            del out, got, live, got_t, live_t
            if label != FRESH_PROCESS_ARTIFACT:
                os.remove(path)
            torch.cuda.empty_cache()
        label, started, parent, want = fresh
        got, report, secs = fresh_process_result(torch, started)
        check(torch.equal(got, parent) and report["launches"] == want and not report["modules"],
              f"fresh process: bitwise {torch.equal(got, parent)}, launches {report['launches']}, "
              f"imported {report['modules']}")
        rows[label]["fresh_process"] = {"seconds": secs, **report}
        say(f"export {label}: loaded in a fresh process that imports tpugan_torch.io.export alone ({secs:.2f} s, "
            f"beside the later exports): launches {report['launches']}, no model, training or CLI module, no JAX; "
            "bitwise the parent's output")
    finally:
        export_model.build_bundle, export_model.export_program = real_build, real_export
        if fresh is not None and fresh[1][0].poll() is None:  # a check failed while it ran
            fresh[1][0].kill()
            fresh[1][0].communicate()
    return rows, artifacts


def roofline_of(torch, label, fn, args, workdir):
    """``profiling.trace_roofline`` and ``op_table`` of one call."""
    from tpugan_torch import profiling

    r = profiling.trace_roofline(fn, args, iters=3, logdir=f"{workdir}/roofline")
    say(f"trace_roofline {label}: {r['seconds_per_call'] * 1e3:.3f} ms of device time a call over "
        f"{r['kernels_per_call']:.0f} kernels; {r['flops_per_call'] / 1e12:.4f} TFLOP counted; measured HBM "
        + ("not measured" if r["hbm_bytes_per_call"] is None else f"{r['hbm_bytes_per_call'] / 1e9:.3f} GB")
        + ", tensor-core use " + ("not measured" if r["tensor_core_use"] is None else f"{r['tensor_core_use']:.3f}")
        + f"; counters: {r['counters'][:400]}")
    table = profiling.op_table(r, top=10)
    for name, category, time_share, byte_share, tc in table:
        say(f"  {time_share * 100:6.2f}%  {category:20s} bytes {'n/a' if byte_share is None else f'{byte_share:.3f}'}"
            f"  tc {'n/a' if tc is None else f'{tc:.3f}'}  {name[:90]}")
    return {k: v for k, v in r.items() if not k.startswith("_") and k != "logdir"} | {
        "op_table": [list(row) for row in table]}


def hold_on_cpu(torch, label, module, args):
    """``module`` (built on the CPU) on the card against itself on the CPU,
    TF32 off, by CPU_GPU_ATOL x max(1, max |ref|); returns the error and
    the card's module."""
    import copy

    with torch.no_grad():
        ref = module(*args)
        card = copy.deepcopy(module).to(CARD)
        got = card(*(a.to(CARD) if isinstance(a, torch.Tensor) else a for a in args))
        torch.cuda.synchronize()
    err, peak = (got.cpu() - ref).abs().max().item(), ref.abs().max().item()
    limit = CPU_GPU_ATOL * max(1.0, peak)
    say(f"cuda vs cpu {label}: output {list(got.shape)}, max |err| {err:.3e}, limit {limit:.3e} (max |ref| "
        f"{peak:.3f})")
    check(got.shape == ref.shape and bool(torch.isfinite(got).all()) and err <= limit,
          f"{label}: cuda and cpu differ by {err:.3e} > {limit:.3e}, or not finite")
    return err, card


def discriminators_on_cpu(torch, dev, pggan_images):
    """PGGANDiscriminator at PGGAN-1024's widths on G's images (the PGGAN
    artifact's live images) at lod 0 and 0.5, and the pggan_alt forms at
    their defaults (depth/height 7, 512 features, 256 px; SmallEncoder at
    its 1024 px) held to the CPU with TF32 off, timed with PyTorch's
    defaults (``profiling.timeit_ms``)."""
    from tpugan_torch import profiling
    from tpugan_torch.models import pggan, pggan_alt

    g = torch.Generator().manual_seed(SEED)
    images = pggan_images.permute(0, 3, 1, 2).contiguous().cpu()
    out, cards = {}, []
    d = pggan.PGGANDiscriminator(resolution=PG_SIZE, generator=g).requires_grad_(False)
    for lod in (0.0, 0.5):
        err, card = hold_on_cpu(torch, f"PGGANDiscriminator-{PG_SIZE} lod {lod}", d, (images, lod))
        out[f"PGGANDiscriminator lod {lod}"] = {"max_abs_err": err}
        cards.append((f"PGGANDiscriminator lod {lod}", card, (images.to(dev), lod)))
    gen = pggan_alt.ProGANGenerator(generator=g).requires_grad_(False)
    z = torch.randn(BATCH, 512, generator=g)
    err, card = hold_on_cpu(torch, "ProGANGenerator (depth 7)", gen, (z,))
    out["ProGANGenerator"] = {"max_abs_err": err}
    cards.append(("ProGANGenerator", card, (z.to(dev),)))
    with torch.no_grad():
        fakes = gen(z)
    labels = torch.arange(BATCH) % PROGAN_CLASSES
    for name, module, args in (
            ("ProGANDiscriminator (height 7)", pggan_alt.ProGANDiscriminator(generator=g), (fakes,)),
            ("ProGANDiscriminator conditional", pggan_alt.ProGANDiscriminator(
                conditional=True, num_classes=PROGAN_CLASSES, generator=g), (fakes, None, 1.0, labels)),
            ("ProGANEncoder (height 7)", pggan_alt.ProGANEncoder(generator=g), (fakes,)),
            (f"SmallEncoder ({PG_SIZE} px)", pggan_alt.SmallEncoder(PG_SIZE, generator=g), (images,))):
        err, card = hold_on_cpu(torch, name, module.requires_grad_(False), args)
        out[name] = {"max_abs_err": err}
        cards.append((name, card, tuple(a.to(dev) if isinstance(a, torch.Tensor) else a for a in args)))
    with pytorch_defaults(torch), torch.no_grad():
        for name, card, args in cards:
            out[name]["ms_pytorch_defaults"] = profiling.timeit_ms(card, *args, iters=EXPORT_TIMED[0],
                                                                   windows=EXPORT_TIMED[1])
    say("discriminators and the Pro-GAN stack per call, PyTorch defaults (TF32 convolutions): "
        + "; ".join(f"{name} {r['ms_pytorch_defaults']:.3f} ms" for name, r in out.items()))
    return out


def slice7d_path(torch, dev, smi):
    """Phase 17 (the module docstring's item 17)."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="tpugan_export_") as workdir:
        say(f"phase 17 times below: {smi}")
        rows, artifacts = export_artifacts(torch, dev, smi, workdir)
        artifact, example = artifacts.pop("sg2")
        roofline = roofline_of(torch, f"StyleGAN2-{SG2_SIZE} synthesis artifact", artifact, example, workdir)
        del artifact, example
        torch.cuda.empty_cache()
    say(f"phase 17: the exports took {time.perf_counter() - t0:.1f} s")
    from tpugan_torch.tools import operator_overhead

    overhead = operator_overhead.measure(dev, say=say)
    t1 = time.perf_counter()
    discriminators = discriminators_on_cpu(torch, dev, artifacts.pop("pggan_images"))
    say(f"phase 17: the discriminators took {time.perf_counter() - t1:.1f} s")
    torch.cuda.empty_cache()
    return {"artifacts": rows, "roofline": roofline, "operator_overhead": overhead,
            "discriminators": discriminators}



def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1

    from tpugan_torch.cli import common, infer_e
    from tpugan_torch.ops import cuda, upfirdn
    from tpugan_torch.runtime import parity_mode

    start = time.perf_counter()
    dev = torch.device(CARD)
    # ---- 1. the card and the build ----------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    bandwidth, fp32_peak, tf32_peak, bf16_peak = card_specs(kind)
    say(f"card: {smi}")
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    t0 = time.perf_counter()
    logs = cuda.build()
    say(f"build: {sorted(cuda.KERNELS)} in {time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if any(word in line for word in ("entry function", "registers", "spill", "rror")):
                say(f"  ptxas[{name}]: {line.strip()}")

    # ---- 2. kernels against their plain versions --------------------------
    parity_mode()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    fir_err = fir_parity(torch, dev, gen)
    adjoint_err, adjoint_rows = fir_adjoint(torch, dev, gen, bandwidth)
    attn_err = attention_parity(torch, dev, gen)
    bwd_err = attention_bwd_parity(torch, dev, gen)
    say(f"attention times below, before any path is profiled: {smi}")
    b3_times, b4_times = attention_times(torch, dev, gen, bandwidth, fp32_peak, tf32_peak)
    say(f"bf16 attention times below (phase 11's), before any path is profiled: {smi}")
    b3_bf16, b4_bf16 = attention_bf16_times(torch, dev, gen, bandwidth, tf32_peak, bf16_peak)
    say(f"FIR times below, before any path is profiled: {smi}")
    fir = fir_times(torch, dev, gen, bandwidth, fp32_peak)

    # ---- 3. the main path -----------------------------------------------------
    parser = argparse.ArgumentParser()
    common.add_common_args(parser, training=True)
    argv = ["--mtype", "1", "--img_size", str(IMG_SIZE), "--start_features", "64", "--random_init",
            "--batch_size", str(BATCH), "--seed", str(SEED)]
    t0 = time.perf_counter()
    bundle = common.build_bundle(parser.parse_args(argv + ["--device", CARD]))
    torch.cuda.synchronize()
    say(f"bundle: mtype 1 at {IMG_SIZE}px (startf 64, maxf 512, layer_count {bundle.layer_count}) "
        f"built in {time.perf_counter() - t0:.2f} s")
    blurs_per_request = 2 * (bundle.layer_count - 1)  # two decodes, a blur in each block but the first
    check(blurs_per_request == 2 * len(PATH_BLURS), "PATH_BLURS does not match the generator")

    cuda.reset_launches()
    upfirdn.reset_layout_launches()
    for seed in REQUEST_SEEDS:
        imgs1, imgs2 = infer_e.run(bundle, BATCH, seed)
        torch.cuda.synchronize()
        for label, img in (("imgs1", imgs1), ("imgs2", imgs2)):
            check(tuple(img.shape) == (BATCH, IMG_SIZE, IMG_SIZE, 3), f"{label} shape {tuple(img.shape)}")
            check(bool(torch.isfinite(img).all()), f"{label} of seed {seed} is not finite")
    launches = dict(cuda.launches)
    layouts = dict(upfirdn.layout_launches)
    want = blurs_per_request * len(REQUEST_SEEDS)
    check(launches == expected_launches(upfirdn2d=want),
          f"main path launches {launches}, expected {want} upfirdn2d and no attention")
    # tpugan's dispatch sends each blur by its channel count: two decodes a request
    want_layouts = {key: 2 * len(REQUEST_SEEDS) * sum(upfirdn.tpu_layout(c, 1, 1, 3, 3) == key
                                                      for c, _ in PATH_BLURS) for key in layouts}
    check(layouts == want_layouts, f"main path FIR launches by TPU kernel {layouts}, expected {want_layouts}")
    say(f"main path: {len(REQUEST_SEEDS)} requests, launches {launches} "
        f"({blurs_per_request} per request); upfirdn2d by the TPU kernel it replaces {layouts}")

    # the same explicit inputs, drawn on the CPU, through the plain versions there
    cpu = common.build_bundle(parser.parse_args(argv + ["--device", "cpu"]))
    seed = REQUEST_SEEDS[0]
    request = infer_e.draw_request(cpu, BATCH, seed)
    cuda.reset_launches()
    on_gpu = infer_e.serve(bundle, request.to(dev))
    torch.cuda.synchronize()
    check(cuda.launches["upfirdn2d"] == blurs_per_request, f"cuda request launches {cuda.launches}")
    on_cpu = infer_e.serve(cpu, request)
    check(cuda.launches["upfirdn2d"] == blurs_per_request, "the CPU request launched the kernel")
    for label, g, c in zip(("imgs1", "imgs2"), on_gpu, on_cpu):
        err = (g.cpu() - c).abs().max().item()
        say(f"cuda vs cpu {label}: max |err| {err:.3e} (max |ref| {c.abs().max().item():.3f})")
        check(err <= CPU_GPU_ATOL, f"{label}: cuda and cpu differ by {err:.3e} > {CPU_GPU_ATOL:g}")

    with cudnn_deterministic(torch):  # the comment at CPU_GPU_ATOL
        grad_launches = sgv1_gradient(torch, dev, parser, argv)

    # ---- 4. times ----------------------------------------------------------
    say(f"times below: {smi}; device times from torch.profiler, request times from the host clock")

    run = lambda s: infer_e.run(bundle, BATCH, s)  # noqa: E731
    median = request_latency(torch, run, seed, "fp32, TF32 off")
    request_device_time(torch, run, seed, median, "upfirdn2d_kernel", "upfirdn2d")
    with pytorch_defaults(torch):
        request_latency(torch, run, seed, "PyTorch defaults (cuDNN convolutions in TF32)")

    for name, part in fir["split"].items():
        part["launches"] = layouts[name]

    attn = biggan_path(torch, dev, parser, smi)
    del bundle, cpu
    torch.cuda.empty_cache()
    attn_bwd = training_path(torch, dev, smi)
    sg2 = sg2_serving_path(torch, dev, parser, smi, bandwidth, fp32_peak)
    sgv1_train = sgv1_training_path(torch, dev, smi)
    t0 = time.perf_counter()
    sg2_train = sg2_training_path(torch, dev, smi, bandwidth, fp32_peak)
    say(f"phase 9 (StyleGAN2-{SG2_SIZE} training) took {time.perf_counter() - t0:.1f} s; the script "
        f"{time.perf_counter() - start:.1f} s")

    # ---- 10. bf16 (e_align --bf16) ----------------------------------------
    t0 = time.perf_counter()
    bf16_err = fir_bf16_parity(torch, dev, gen)
    say(f"bf16 parity took {time.perf_counter() - t0:.1f} s")
    fp32_times = {f"SG2 {k}": v for k, v in sg2_train["times"].items()}
    fp32_times.update({f"SGv1 {k}": v for k, v in sgv1_train["times"].items()})
    bf16 = bf16_training_path(torch, dev, smi, bandwidth, fp32_peak, fp32_times)
    say(f"phase 10 (bf16 training) took {time.perf_counter() - t0:.1f} s; the script "
        f"{time.perf_counter() - start:.1f} s")

    # ---- 11. bf16 on the BigGAN-deep-256 path (e_align --mtype 4 --bf16) ----
    t0 = time.perf_counter()
    attn_bf16_err = attention_bf16_parity(torch, dev, gen)
    big16 = biggan_bf16_training_path(torch, dev, smi, attn_bwd["times"])
    b3_bf16_launches = big16["launches"]["sagan_attention_bf16"]
    b4_bf16_launches = sum(big16["launches"][f"{name}_bf16"] for name in B4_KERNELS)
    check(b3_bf16_launches > 0 and all(big16["launches"][f"{name}_bf16"] > 0 for name in B4_KERNELS),
          f"the bf16 BigGAN path launched {big16['launches']}")
    say(f"phase 11 (bf16 on the BigGAN-deep-{BIGGAN_SIZE} path) took {time.perf_counter() - t0:.1f} s; the "
        f"script {time.perf_counter() - start:.1f} s")

    # ---- 12. real-image inversion (embedding, rec_real_img, edit, baseline_i2s) ----
    t0 = time.perf_counter()
    inv = inversion_path(torch, dev, smi)
    inv_forms = inv["forms"]
    fir_inv = {label: f["launches"]["upfirdn2d"] for label, f in inv_forms.items() if f["launches"]["upfirdn2d"]}
    fir_inv.update(inv["clis"]["launches"])
    fir16_inv = {label: f["launches"]["upfirdn2d_bf16"] for label, f in inv_forms.items()
                 if f["launches"]["upfirdn2d_bf16"]}
    big_inv = inv_forms["BigGAN fine-tune E"]["launches"]
    check(all(fir_inv.values()) and fir16_inv and big_inv["sagan_attention"] > 0
          and all(big_inv[name] > 0 for name in B4_KERNELS), "the inversion path missed a kernel")
    inv_err = {}  # each kernel's max |err| on the inversion's own inputs, over the forms
    for f in inv_forms.values():
        for name, err in f["max_abs_err"].items():
            inv_err[name] = max(inv_err.get(name, 0.0), err)
    check(set(inv_err) == {"upfirdn2d", "upfirdn2d_bf16", "sagan_attention", "sagan_attention_bwd"},
          f"the inversion held only {sorted(inv_err)} on its own inputs")
    say(f"phase 12 (inversion) took {time.perf_counter() - t0:.1f} s; the script {time.perf_counter() - start:.1f} s")
    inversion = {"launches_per_iteration_are": "derived from the modules and counted: the run's, forward and "
                                               "adjoint by TPU kernel, and each timed iteration's",
                 "per_iteration": {label: f["per_iteration"] for label, f in inv_forms.items()},
                 "times": {label: f["times"] for label, f in inv_forms.items()},
                 "replay": inv["replay"], "clis": inv["clis"]}

    # ---- 13. Grad-CAM: e_mis_align, infer_e --gradcam, embedding --gradcam ----
    t0 = time.perf_counter()
    cam = gradcam_path(torch, dev, smi)
    mis, cam_inv = cam["training"], cam["inversion"]
    cam_label = GRADCAM_INVERSION[0]
    check(mis["launches"] > 0 and mis["launches_bf16"] > 0 and cam["request"]["launches"] > 0
          and cam_inv["launches"]["sagan_attention"] > 0
          and all(cam_inv["launches"][name] > 0 for name in B4_KERNELS), "the Grad-CAM paths missed a kernel")
    check(set(cam_inv["max_abs_err"]) == {"sagan_attention", "sagan_attention_bwd"},
          f"the Grad-CAM inversion held only {sorted(cam_inv['max_abs_err'])} on its own inputs")
    say(f"phase 13 (Grad-CAM) took {time.perf_counter() - t0:.1f} s; the script {time.perf_counter() - start:.1f} s")
    gradcam = {"e_mis_align": {"launches_per_step_are": f"FIR launches of one step at batch {MIS_BATCH}, by the TPU "
                                                        "kernel each replaces, as counted and derived from the "
                                                        "modules (no adjoint)",
                               "per_step": mis["per_step"], "times": mis["times"], "replay": mis["replay"]},
               "infer_e --gradcam": cam["request"],
               "embedding --gradcam": {"per_iteration": cam_inv["per_iteration"], "times": cam_inv["times"]}}

    # ---- 14. slice 7a: --resume, remat (A3), converted weights ----
    t0 = time.perf_counter()
    s7a = slice7a_path(torch, dev, smi)
    resumed, converted = s7a["resume"], s7a["converted"]
    s7a_fir = {f"resume: {label}": r["launches"]["upfirdn2d"] for label, r in resumed.items()}
    s7a_fir.update({f"remat: SG2 case 2 {label}": f["launches"] for label, f in s7a["remat"]["fp32"].items()})
    s7a_fir.update({f"converted: {label}": (c["launches"] if isinstance(c["launches"], int)
                                             else c["launches"]["upfirdn2d"])
                    for label, c in converted.items()})
    s7a_fir = {label: n for label, n in s7a_fir.items() if n}
    s7a_fir16 = {f"remat: SG2 case 2 {label} bf16": f["launches"] for label, f in s7a["remat"]["bf16"].items()}
    big_resume = resumed[f"e_align BigGAN-deep-{BIGGAN_SIZE} case 2"]["launches"]
    big_conv = converted[f"infer_e --mtype 4 (converted BigGAN-deep-{BIGGAN_SIZE} and E_BIG)"]["launches"]
    check(len(s7a_fir) == 8 and all(s7a_fir16.values()) and big_resume["sagan_attention"] > 0
          and all(big_resume[name] > 0 for name in B4_KERNELS) and big_conv["sagan_attention"] > 0,
          f"phase 14 missed a kernel: FIR {s7a_fir}, bf16 {s7a_fir16}, B3/B4 {big_resume}, {big_conv}")
    say(f"phase 14 (slice 7a) took {time.perf_counter() - t0:.1f} s; the script {time.perf_counter() - start:.1f} s")

    # ---- 15. slice 7b: synthesize and compare on every family, PGGAN-1024 with E_PG ----
    t0 = time.perf_counter()
    s7b = slice7b_path(torch, dev, smi, fp32_peak, tf32_peak)
    s7b_launches = {name: {f"synthesize {label} {form}": r["launches"][name] for label, forms in s7b["synthesize"].items()
                           for form, r in forms.items() if name in r["launches"]}
                    for name in ("upfirdn2d", "upfirdn2d_bf16", "sagan_attention", "sagan_attention_bf16")}
    check(all(len(v) == 1 for v in s7b_launches.values()), f"phase 15 missed a kernel: {s7b_launches}")
    say(f"phase 15 (slice 7b) took {time.perf_counter() - t0:.1f} s; the script {time.perf_counter() - start:.1f} s")

    # ---- 16. slice 7c: StyleGANv1 adversarial training (D with R1, G, EMA, LOD schedule) ----
    t0 = time.perf_counter()
    s7c = gan_training_path(torch, dev, smi, fp32_peak)
    check(s7c["launches"] > 0 and s7c["decode3_launches"] > 0, f"phase 16 missed the FIR kernel: {s7c['launches']}")
    say(f"phase 16 (slice 7c) took {time.perf_counter() - t0:.1f} s; the script {time.perf_counter() - start:.1f} s")

    # ---- 17. slice 7d: export_model through torch.export; profiling; PGGAN's D and pggan_alt ----
    t0 = time.perf_counter()
    s7d = slice7d_path(torch, dev, smi)
    s7d_launches = {name: {f"export: {label}": r["launches"][name] for label, r in s7d["artifacts"].items()
                           if name in r["launches"]}
                    for name in ("upfirdn2d", "upfirdn2d_bf16", "sagan_attention", "sagan_attention_bf16")}
    check(all(s7d_launches.values()), f"phase 17 missed a kernel: {s7d_launches}")
    say(f"phase 17 (slice 7d) took {time.perf_counter() - t0:.1f} s; the script {time.perf_counter() - start:.1f} s")

    sg2_bf16 = bf16["firs"]["SG2"][1]
    bf16_step = {k: sum(p_[k] for parts in sg2_bf16.values() for p_ in parts.values())
                 for k in ("ms", "fp32_ms", "plain_ms", "library_ms", "bound_ms")}

    say(f"card: {smi}")
    say(json.dumps({"kernels": [{
        "name": "upfirdn2d",
        "route": "cuda",
        "operator": "torch.ops.tpugan_torch.upfirdn2d",
        "source": "tpugan_torch/csrc/upfirdn2d.cu",
        "replaces": "tpugan/ops/pallas/upfirdn2d.py:96 (upfirdn2d_pallas); "
                    "tpugan/ops/pallas/upfirdn2d.py:153 (upfirdn2d_pallas_small_c)",
        "launches": (launches["upfirdn2d"] + sg2["launches"] + sgv1_train["launches"] + sg2_train["launches"]
                     + sum(fir_inv.values()) + mis["launches"] + cam["request"]["launches"] + sum(s7a_fir.values())
                     + sum(s7b_launches["upfirdn2d"].values()) + s7c["launches"] + s7c["decode3_launches"]
                     + sum(s7d_launches["upfirdn2d"].values())),
        "launches_by_path": {"SGv1 Cat256 serving": launches["upfirdn2d"],
                             f"StyleGAN2-{SG2_SIZE} serving": sg2["launches"],
                             "SGv1 Cat256 training": sgv1_train["launches"],
                             f"StyleGAN2-{SG2_SIZE} training": sg2_train["launches"],
                             **{f"inversion: {label}": n for label, n in fir_inv.items()},
                             "e_mis_align (batch 5)": mis["launches"],
                             "infer_e --gradcam": cam["request"]["launches"],
                             **s7a_fir, **s7b_launches["upfirdn2d"],
                             "SGv1 Cat256 GAN training": s7c["launches"], "decode3": s7c["decode3_launches"],
                             **s7d_launches["upfirdn2d"]},
        "max_abs_err": max(fir_err, adjoint_err, sg2["max_abs_err"], sg2_train["max_abs_err"], inv_err["upfirdn2d"],
                           mis["max_abs_err"], s7c["max_abs_err"]),
        "inversion": inversion,
        "gradcam": gradcam,
        "slice7a": s7a,
        "slice7b": s7b,
        "slice7d": s7d,
        "slice7c": {"gan_training": {k: v for k, v in s7c.items() if k not in ("launches", "decode3_launches")},
                    "launches_per_step_are": f"FIR launches of one D step and one G step at lod {s7c['lod']}, batch "
                                             f"{s7c['batch']}, by direction and TPU kernel, as counted in every "
                                             "step and derived from the modules"},
        **fir,
        "gradient_path_launches": grad_launches,
        "adjoint": adjoint_rows,
        "sg2": {"times_are": f"the FIRs of one StyleGAN2-{SG2_SIZE} request at batch {BATCH} on the "
                             "path's own inputs: each distinct shape once per decode, two decodes; "
                             "device times from CUDA events around 20 calls queued behind a "
                             "device-side sleep (queued_ms)",
                "per_request": sg2["per_request"], "split": sg2["split"], "per_shape": sg2["per_shape"]},
        "sgv1_training": {"launches_per_step_are": f"FIR launches of one step at batch {BATCH}, by the TPU "
                                                   "kernel each replaces, forward and adjoint, as counted "
                                                   f"over {TRAIN_STEPS} steps and derived from the modules",
                          "per_step": sgv1_train["per_step"], "times": sgv1_train["times"],
                          "replay": sgv1_train["replay"]},
        "sg2_training": {"launches_per_step_are": f"FIR launches of one step at batch {BATCH}, by the TPU "
                                                  "kernel each replaces, forward and adjoint, as counted "
                                                  f"over {TRAIN_STEPS} steps and derived from the modules",
                         "per_step": sg2_train["per_step"], "times": sg2_train["times"],
                         "fir_times_are": "every FIR of one case-2 step on the step's own inputs, device "
                                          "times from CUDA events around 20 calls queued behind a "
                                          "device-side sleep (queued_ms), summed per step",
                         "fir_per_step": sg2_train["fir_sums"], "fir_rows": sg2_train["fir_rows"],
                         "replay": sg2_train["replay"]},
    }, {
        "name": "upfirdn2d_bf16",
        "route": "cuda",
        "operator": "torch.ops.tpugan_torch.upfirdn2d",
        "source": "tpugan_torch/csrc/upfirdn2d.cu",
        "replaces": "tpugan/ops/pallas/upfirdn2d.py:96 (upfirdn2d_pallas, bf16); "
                    "tpugan/ops/pallas/upfirdn2d.py:153 (upfirdn2d_pallas_small_c, bf16)",
        "launches": (bf16["launches"] + sum(fir16_inv.values()) + mis["launches_bf16"] + sum(s7a_fir16.values())
                     + sum(s7b_launches["upfirdn2d_bf16"].values()) + sum(s7d_launches["upfirdn2d_bf16"].values())),
        "launches_by_path": {"bf16 training": bf16["launches"],
                             **{f"inversion: {label}": n for label, n in fir16_inv.items()},
                             "e_mis_align --bf16 (batch 5)": mis["launches_bf16"],
                             **s7a_fir16, **s7b_launches["upfirdn2d_bf16"], **s7d_launches["upfirdn2d_bf16"]},
        "max_abs_err": max(bf16_err, bf16["max_abs_err"], inv_err["upfirdn2d_bf16"], mis["max_abs_err_bf16"]),
        "ms": bf16_step["ms"],
        "plain_ms": bf16_step["plain_ms"],
        "bound_ms": bf16_step["bound_ms"],
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in bf16["firs"]["SG2"][0]) else "operations",
        "library_ms": bf16_step["library_ms"],
        "fp32_kernel_ms": bf16_step["fp32_ms"],
        "times_are": f"every FIR of one bf16 StyleGAN2-{SG2_SIZE} case-2 step at batch {BATCH}, forward and "
                     "adjoint, on the step's own inputs, summed per step; device times from CUDA events "
                     "around 20 calls queued behind a device-side sleep (queued_ms); the fp32 kernel on the "
                     "same values; library: one depthwise F.conv2d or F.conv_transpose2d in bf16; bound at 2 "
                     "bytes an element",
        "max_abs_err_is": "the bf16 kernel against the plain version (fp32 sums, one rounding): within one "
                          "bf16 ulp, and bitwise the fp32 kernel rounded to bf16",
        "per_step_by_tpu_kernel": {path: f[1] for path, f in bf16["firs"].items()},
        "fir_rows": {path: f[0] for path, f in bf16["firs"].items()},
        "training": {"launches_per_step": bf16["per_step"], "times": bf16["times"],
                     "fp32_times_of_this_run": fp32_times, "gates": bf16["gates"]},
    }, {
        "name": "sagan_attention",
        "route": "cuda",
        "operator": "torch.ops.tpugan_torch.sagan_attention, torch.ops.tpugan_torch.sagan_attention_lse",
        "source": "tpugan_torch/csrc/sagan_attention.cu",
        "replaces": "tpugan/ops/pallas/attention.py:68 (sagan_attention_pallas); "
                    "tpugan/ops/pallas/attention.py:77 (sagan_attention_pallas, return_lse=True)",
        "launches": (attn["launches"] + big_inv["sagan_attention"] + cam_inv["launches"]["sagan_attention"]
                     + big_resume["sagan_attention"] + big_conv["sagan_attention"]
                     + sum(s7b_launches["sagan_attention"].values()) + sum(s7d_launches["sagan_attention"].values())),
        "launches_by_path": {"BigGAN-deep-256 serving": attn["launches"],
                             "inversion: BigGAN fine-tune E": big_inv["sagan_attention"],
                             f"inversion: {cam_label}": cam_inv["launches"]["sagan_attention"],
                             "resume: E_BIG case 2": big_resume["sagan_attention"],
                             "converted: BigGAN-deep-256 request": big_conv["sagan_attention"],
                             **s7b_launches["sagan_attention"], **s7d_launches["sagan_attention"]},
        "max_abs_err": max(attn["max_abs_err"], attn_err, inv_err["sagan_attention"],
                           cam_inv["max_abs_err"]["sagan_attention"]),
        **b3_times,
    }, {
        "name": "sagan_attention_bwd",
        "route": "cuda",
        "operator": "torch.ops.tpugan_torch.sagan_attention_bwd",
        "source": "tpugan_torch/csrc/sagan_attention_bwd.cu",
        "replaces": "tpugan/ops/pallas/attention.py:149,168 (sagan_attention_bwd_pallas: _dq_kernel, "
                    "_dkv_kernel)",
        "launches": (attn_bwd["launches"] + sum(big_inv[name] for name in B4_KERNELS)
                     + sum(cam_inv["launches"][name] for name in B4_KERNELS)
                     + sum(big_resume[name] for name in B4_KERNELS)),
        "launches_by_path": {"E_BIG training": attn_bwd["launches"],
                             "inversion: BigGAN fine-tune E": sum(big_inv[name] for name in B4_KERNELS),
                             f"inversion: {cam_label}": sum(cam_inv["launches"][name] for name in B4_KERNELS),
                             "resume: E_BIG case 2": sum(big_resume[name] for name in B4_KERNELS)},
        "max_abs_err": max(attn_bwd["max_abs_err"], bwd_err, inv_err["sagan_attention_bwd"],
                           cam_inv["max_abs_err"]["sagan_attention_bwd"]),
        **b4_times,
    }, {
        "name": "sagan_attention_bf16",
        "route": "cuda",
        "operator": "torch.ops.tpugan_torch.sagan_attention, torch.ops.tpugan_torch.sagan_attention_lse",
        "source": "tpugan_torch/csrc/sagan_attention.cu",
        "entry_points": ["tpugan_sagan_attention_bf16"],
        "replaces": "tpugan/ops/pallas/attention.py:68 (sagan_attention_pallas, bf16); "
                    "tpugan/ops/pallas/attention.py:77 (sagan_attention_pallas, bf16, return_lse=True)",
        "launches": (b3_bf16_launches + sum(s7b_launches["sagan_attention_bf16"].values())
                     + sum(s7d_launches["sagan_attention_bf16"].values())),
        "launches_by_path": {"bf16 E_BIG training": b3_bf16_launches, **s7b_launches["sagan_attention_bf16"],
                             **s7d_launches["sagan_attention_bf16"]},
        "max_abs_err": max(attn_bf16_err, big16["max_abs_err"]),
        "max_abs_err_is": "bf16 outputs against the plain version run in float64 on the same bf16 values (one "
                          "bf16 ulp plus the fp32 contract); bitwise the fp32 kernel's on the widened inputs, "
                          "rounded",
        **b3_bf16,
        "training": {"launches_per_step_are": "counted over the bf16 case-2, case-1 and lean steps of phase 11",
                     "launches": big16["launches"], "times": big16["times"],
                     "fp32_times_of_this_run": attn_bwd["times"], "replay": big16["replay"]},
    }, {
        "name": "sagan_attention_bwd_bf16",
        "route": "cuda",
        "operator": "torch.ops.tpugan_torch.sagan_attention_bwd",
        "source": "tpugan_torch/csrc/sagan_attention_bwd.cu",
        "entry_points": [f"tpugan_{name}_bf16" for name in B4_KERNELS],
        "replaces": "tpugan/ops/pallas/attention.py:149,168 (sagan_attention_bwd_pallas on bf16: _dq_kernel, "
                    "_dkv_kernel)",
        "launches": b4_bf16_launches,
        "max_abs_err": max(attn_bf16_err, big16["max_abs_err"]),
        **b4_bf16,
    }]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
