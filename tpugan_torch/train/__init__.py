from tpugan_torch.train.e_align import (
    SynthBatch,
    build_biggan_pipeline,
    build_stylegan1_pipeline,
    make_encode_fn,
)

__all__ = ["SynthBatch", "build_biggan_pipeline", "build_stylegan1_pipeline", "make_encode_fn"]
