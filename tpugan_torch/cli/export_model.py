"""Serving-artifact export CLI (counterpart of ``tpugan/cli/export_model.py``):
one ``torch.export`` artifact, loadable with ``tpugan_torch.io.export``
alone (no model code; the operators' registrations are all it imports).

``python -m tpugan_torch.cli.export_model --mtype 1 --img_size 256
--start_features 64 --random_init --out g.pt2`` exports the frozen
w -> image synthesis (mtype 3: z -> image; mtype 4: (z, one-hot label) ->
image). ``--what encode`` exports the encoder's image -> (const, w) forward
instead. Images are NHWC at the boundary, as in the port's other CLIs.

Artifact call conventions (tpugan's):
  * synthesis: ``f(w)`` with w ``[N, 2 * layer_count, 512]``; mtype 3 takes
    ``f(z)``, mtype 4 ``f(z, one_hot_label)``;
  * encode: ``f(imgs)`` for mtypes 1-3; mtype 4 (the conditional E_BIG)
    ``f(imgs, cond)`` with cond ``[N, 2 * z_dim]``.

The noise tpugan draws from ``PRNGKey(0)`` inside each call (StyleGANv1's
generator noise, the encoders' noise) is drawn once here, from a
``torch.Generator`` seeded 0, and held in the artifact as buffers.
``--bf16`` bakes in the bf16 generator (``precision.bf16_frozen`` and
``bf16_pipeline``); the encoder stays fp32, as in tpugan. ``--platforms``
names the one device the artifact is for (``cuda`` or ``cpu``; default
``--device``): an artifact holds that device's weights, so two platforms are
refused. ``--check`` reloads the file and compares one call with the live
function, bitwise.
"""

from __future__ import annotations

import argparse
import os
import time
from types import SimpleNamespace
from typing import Any, NamedTuple

import torch
from torch import nn

from tpugan_torch.cli.common import add_common_args, build_bundle, family_pipeline
from tpugan_torch.io.export import export_platform, export_program, load_exported_file, operator_nodes, serialise
from tpugan_torch.precision import bf16_frozen, bf16_pipeline
from tpugan_torch.train.e_align import SynthBatch, draw_noise, make_encode_fn
from tpugan_torch.utils import iteration_generator, one_hot

NOISE_SEED = 0  # tpugan's PRNGKey(0)


class NoiseBuffers(nn.Module):
    """Noise drawn once, held as buffers ``n<block>_<index>``: the blocks
    of tensors a generator or an encoder takes as ``noise``."""

    def __init__(self, blocks):
        super().__init__()
        self.layout = [len(block) for block in blocks]
        for i, block in enumerate(blocks):
            for j, t in enumerate(block):
                self.register_buffer(f"n{i}_{j}", t)

    def blocks(self) -> list:
        return [tuple(getattr(self, f"n{i}_{j}") for j in range(k)) for i, k in enumerate(self.layout)]


class Exported(NamedTuple):
    """What ``main`` exported: the file, the live function and the modules
    it reads, the example inputs, the operator nodes of the graph, the
    export's seconds (the trace and the serialisation), the artifact's
    bytes, and with ``--check`` the reloaded artifact."""

    path: str
    fn: Any
    modules: list
    example: tuple
    nodes: dict
    seconds: float
    size: int
    artifact: Any = None


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="export a serving artifact")
    add_common_args(parser, training=True)
    parser.add_argument("--out", required=True, help="output artifact path")
    parser.add_argument("--what", default="synthesis", choices=("synthesis", "encode"))
    parser.add_argument("--platforms", action="append", default=None, choices=("cuda", "cpu"),
                        help="the device the artifact is for (one; default: --device)")
    parser.add_argument("--bf16", action="store_true", help="bf16 generator compute baked into the artifact")
    parser.add_argument("--check", action="store_true",
                        help="reload the artifact and compare one call against the live function, bitwise")
    return parser


def _noise(shapes, device) -> NoiseBuffers:
    return NoiseBuffers([tuple(n.to(device) for n in block)
                         for block in draw_noise(shapes, iteration_generator(NOISE_SEED))])


def synthesis_program(bundle, batch_size: int, bf16: bool = False):
    """``(fn, modules, example)``: the frozen resynthesis as tpugan's
    artifact takes it, with example inputs drawn from seed 0."""
    generator, mapping = bundle.generator, bundle.mapping
    if bf16:
        generator = bf16_frozen(generator)
        mapping = None if mapping is None else bf16_frozen(mapping)
        _, resynth = bf16_pipeline(*family_pipeline(bundle, generator, mapping))
    else:
        resynth = bundle.resynth
    dev = bundle.device
    g = torch.Generator().manual_seed(0)
    modules = [generator]
    if bundle.mtype == 4:
        num_classes = generator.config.num_classes

        def fn(z, label):
            return resynth(z, SimpleNamespace(label=label))

        label = one_hot(torch.zeros(batch_size, dtype=torch.long), num_classes)
        return fn, modules, (torch.randn(batch_size, bundle.z_dim, generator=g).to(dev), label.to(dev))
    if bundle.mtype == 1:
        noise = _noise(bundle.generator.noise_shapes(batch_size), dev)
        modules.append(noise)

        def fn(w):
            return resynth(w, None, noise.blocks())
    else:
        def fn(w):
            return resynth(w, None)
    shape = (batch_size, bundle.z_dim) if bundle.mtype == 3 else (batch_size, bundle.num_style_layers, 512)
    return fn, modules, (torch.randn(*shape, generator=g).to(dev),)


def encode_program(bundle, batch_size: int):
    """``(fn, modules, example)``: the encoder's forward on NHWC images
    (and, for E_BIG, the condition), its noise as buffers, with example
    inputs drawn from seed 0."""
    dev, enc = bundle.device, bundle.encoder
    noise = _noise(enc.noise_shapes(batch_size, bundle.img_size), dev)
    encode = make_encode_fn(enc, conditional=bundle.mtype == 4)
    g = torch.Generator().manual_seed(0)
    imgs = (torch.rand(batch_size, bundle.img_size, bundle.img_size, 3, generator=g) * 2 - 1).to(dev)
    if bundle.mtype == 4:
        def fn(imgs, cond):
            return encode(SynthBatch(w1=None, imgs1=imgs, const1=cond), noise.blocks())

        return fn, [enc, noise], (imgs, torch.randn(batch_size, 2 * bundle.z_dim, generator=g).to(dev))

    def fn(imgs):
        return encode(SynthBatch(w1=None, imgs1=imgs, const1=None), noise.blocks())

    return fn, [enc, noise], (imgs,)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in _leaves(x)]
    if isinstance(tree, dict):
        return [leaf for x in tree.values() for leaf in _leaves(x)]
    return []


def check_artifact(path: str, fn, example):
    """One call of the reloaded artifact against the live function: every
    output bitwise equal; raises otherwise, else returns the artifact. Both
    run on cuDNN's
    deterministic algorithms: with its default ones two calls of the live
    function itself can differ on the card (in fp32, by 4.3e-6 at SGv1
    Cat256; chip_smoke.py phase 17)."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with torch.no_grad():
            artifact = load_exported_file(path)
            got, want = artifact(*example), fn(*example)
    finally:
        torch.backends.cudnn.deterministic = saved
    got, want = _leaves(got), _leaves(want)
    if len(got) != len(want):
        raise RuntimeError(f"the artifact returns {len(got)} tensors, the live function {len(want)}")
    for i, (a, b) in enumerate(zip(got, want)):
        if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
            err = (a.double() - b.double()).abs().max().item() if a.shape == b.shape else float("nan")
            raise RuntimeError(f"output {i}: the artifact differs from the live function "
                               f"({tuple(a.shape)} {a.dtype} against {tuple(b.shape)} {b.dtype}, "
                               f"max |err| {err:.3e})")
    return artifact


def main(argv=None) -> Exported:
    args = make_parser().parse_args(argv)
    if args.platforms:
        export_platform((), args.platforms)  # one platform, or the refusal
        args.device = args.platforms[0]
    bundle = build_bundle(args)
    if args.what == "synthesis":
        fn, modules, example = synthesis_program(bundle, args.batch_size, args.bf16)
    else:
        fn, modules, example = encode_program(bundle, args.batch_size)
    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    program = export_program(fn, *example, platforms=args.platforms, modules=modules)
    data = serialise(program)
    with open(args.out, "wb") as f:
        f.write(data)
    seconds = time.perf_counter() - t0
    nodes = operator_nodes(program)
    print(f"exported {args.what} -> {args.out} ({len(data)} bytes in {seconds:.2f} s; operator nodes {nodes})",
          flush=True)
    artifact = None
    if args.check:
        artifact = check_artifact(args.out, fn, example)
        print("check ok: artifact matches the live function bitwise", flush=True)
    return Exported(args.out, fn, modules, example, nodes, seconds, len(data), artifact)


if __name__ == "__main__":
    main()
