"""Validation grids (counterpart of ``tpugan/cli/synthesize.py``;
synthesized_IMG.py / synthesized_textBigGAN.py).

``python -m tpugan_torch.cli.synthesize --mtype 2 --img_size 1024
--start_features 16 --random_init`` (or ``--checkpoint_dir_GAN ...
--checkpoint_dir_E ...``) writes, for each held-out seed of
``--start_seed`` (30000) .. ``+ --count - 1``, the grid ``seed<k>.png`` of
G(z) over G(E(G(z))) to ``mtype<m>-synth/imgs``. A seed's request is
``infer_e``'s: :func:`~tpugan_torch.cli.infer_e.draw_request` draws it and
:func:`~tpugan_torch.cli.infer_e.serve` answers it, and
:func:`~tpugan_torch.eval.synthesize.synthesize_grids` writes its grid.

On the card the frozen generator runs in bf16 unless ``--fp32`` is given,
``tpugan``'s default on its accelerator: a bf16 copy of the generator (and
mapping), z and w cast down and the images back up
(``precision.bf16_pipeline``), the encoder in fp32. The FIRs then launch the
FIR kernel's bf16 form and BigGAN's attention the attention kernel's. On the
CPU it runs fp32, as ``tpugan`` does off its accelerator.
"""

from __future__ import annotations

import argparse

from tpugan_torch.cli import infer_e
from tpugan_torch.cli.common import GanBundle, add_common_args, build_bundle, family_pipeline, make_result_dirs
from tpugan_torch.eval.synthesize import synthesize_grids
from tpugan_torch.precision import bf16_frozen, bf16_pipeline

BF16_NOTE = ("note: bf16 generator compute auto-enabled on the GPU — outputs are not bitwise-comparable "
             "to the fp32 reference pipeline; pass --fp32 when comparing against reference-produced images")


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="synthesized validation grids")
    add_common_args(parser, training=True)
    parser.add_argument("--start_seed", type=int, default=30000)
    parser.add_argument("--count", type=int, default=5)
    parser.add_argument("--fp32", action="store_true",
                        help="keep the generator in fp32 on the GPU (bf16 there by default)")
    return parser


def bf16_bundle(bundle: GanBundle) -> GanBundle:
    """The bundle with its synth and resynth over bf16 copies of the frozen
    generator and mapping, z and w cast down, every image back to fp32."""
    mapping = None if bundle.mapping is None else bf16_frozen(bundle.mapping)
    synth, resynth = bf16_pipeline(*family_pipeline(bundle, bf16_frozen(bundle.generator), mapping))
    return bundle._replace(synth=synth, resynth=resynth)


def _on_card(bundle: GanBundle) -> bool:
    return bundle.device.type == "cuda"


def main(argv=None) -> list:
    args = make_parser().parse_args(argv)
    bundle = build_bundle(args)
    if not args.fp32 and _on_card(bundle):
        print(BF16_NOTE, flush=True)
        bundle = bf16_bundle(bundle)
    _, imgs_dir, _ = make_result_dirs(args.experiment_dir, f"mtype{args.mtype}-synth")
    paths = synthesize_grids(None, None, None, imgs_dir, batch_size=args.batch_size, start_seed=args.start_seed,
                             count=args.count, device=bundle.device,
                             serve_seed=lambda seed: infer_e.run(bundle, args.batch_size, seed))
    for p in paths:
        print(p)
    return paths


if __name__ == "__main__":
    main()
