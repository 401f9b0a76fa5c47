from tpugan_torch.models.encoders import Encoder, EncoderBlock
from tpugan_torch.models.stylegan1 import (
    DecodeBlock,
    StyleGANv1Generator,
    StyleGANv1Mapping,
    truncation_coefs,
)

__all__ = [
    "DecodeBlock",
    "Encoder",
    "EncoderBlock",
    "StyleGANv1Generator",
    "StyleGANv1Mapping",
    "truncation_coefs",
]
