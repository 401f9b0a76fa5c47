from tpugan_torch.nn.layers import EqConv, EqLinear

__all__ = ["EqConv", "EqLinear"]
