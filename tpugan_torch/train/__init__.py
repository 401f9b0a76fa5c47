from tpugan_torch.train.e_align import (
    SynthBatch,
    build_biggan_pipeline,
    build_stylegan1_pipeline,
    make_encode_fn,
)
from tpugan_torch.train.e_mis_align import MisAlignInfo, make_mis_align_step, make_mis_align_visuals

__all__ = [
    "MisAlignInfo",
    "SynthBatch",
    "build_biggan_pipeline",
    "build_stylegan1_pipeline",
    "make_encode_fn",
    "make_mis_align_step",
    "make_mis_align_visuals",
]
