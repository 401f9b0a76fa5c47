from tpugan_torch.models.biggan import (
    BigGAN,
    BigGANBatchNorm,
    BigGANConfig,
    BigGANGenerator,
    GenBlock,
    SelfAttn,
)
from tpugan_torch.models.encoders import BigGANEncoder, BigGANEncoderBlock, Encoder, EncoderBlock
from tpugan_torch.models.stylegan1 import (
    DecodeBlock,
    StyleGANv1Generator,
    StyleGANv1Mapping,
    truncation_coefs,
)

__all__ = [
    "BigGAN",
    "BigGANBatchNorm",
    "BigGANConfig",
    "BigGANEncoder",
    "BigGANEncoderBlock",
    "BigGANGenerator",
    "DecodeBlock",
    "Encoder",
    "EncoderBlock",
    "GenBlock",
    "SelfAttn",
    "StyleGANv1Generator",
    "StyleGANv1Mapping",
    "truncation_coefs",
]
