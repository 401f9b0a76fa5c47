"""Tensor ops on NCHW tensors; ``upfirdn`` and ``attention`` dispatch to the
CUDA kernels through the PyTorch operators they register
(``torch.ops.tpugan_torch.*``). Importing this package registers them, which
is all that loading an exported program (``tpugan_torch.io.export``) needs."""

from tpugan_torch.ops import attention, upfirdn  # noqa: F401  (registers the operators)
