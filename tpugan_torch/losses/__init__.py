"""Losses of the training and inversion paths (counterpart of
``tpugan/losses``). Images are NHWC at these functions, as in ``tpugan``."""
