"""Tensor ops on NCHW tensors; ``upfirdn`` dispatches to the CUDA kernel."""
