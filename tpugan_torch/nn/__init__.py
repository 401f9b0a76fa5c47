from tpugan_torch.nn.layers import EqConv, EqLinear
from tpugan_torch.nn.spectral import SNDense

__all__ = ["EqConv", "EqLinear", "SNDense"]
