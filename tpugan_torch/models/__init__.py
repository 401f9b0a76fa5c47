from tpugan_torch.models.biggan import (
    BigGAN,
    BigGANBatchNorm,
    BigGANConfig,
    BigGANGenerator,
    GenBlock,
    SelfAttn,
)
from tpugan_torch.models.encoders import (
    BigGANEncoder,
    BigGANEncoderBlock,
    Encoder,
    EncoderBlock,
    PGEncoder,
    PGEncoderBlock,
)
from tpugan_torch.models.pggan import PGConvBlock, PGGANGenerator
from tpugan_torch.models.stylegan1 import (
    DecodeBlock,
    StyleGANv1Generator,
    StyleGANv1Mapping,
    truncation_coefs,
)
from tpugan_torch.models.stylegan2 import (
    ModulatedConv,
    SG2ConvBlock,
    SG2Dense,
    SG2Mapping,
    SG2Synthesis,
    SG2Truncation,
    StyleGAN2Generator,
    update_w_avg,
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
    "ModulatedConv",
    "PGConvBlock",
    "PGEncoder",
    "PGEncoderBlock",
    "PGGANGenerator",
    "SG2ConvBlock",
    "SG2Dense",
    "SG2Mapping",
    "SG2Synthesis",
    "SG2Truncation",
    "SelfAttn",
    "StyleGANv1Generator",
    "StyleGANv1Mapping",
    "StyleGAN2Generator",
    "truncation_coefs",
    "update_w_avg",
]
