"""Tensor ops on NCHW tensors; ``upfirdn`` and ``attention`` dispatch to the
CUDA kernels."""
