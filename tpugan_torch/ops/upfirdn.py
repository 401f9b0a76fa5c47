"""upfirdn2d — upsample, FIR filter, downsample, on NCHW tensors
(counterpart of ``tpugan/ops/upfirdn.py``).

Convention: cross-correlation with the taps as given (not StyleGAN2-CUDA's
flipped convolution); pads ``(pad0, pad1)`` apply to both spatial dims; the
output size is ``(H*up + pad0 + pad1 - kh) // down + 1``; ``gain``
multiplies the taps.

Dispatch: a CPU tensor takes :func:`upfirdn2d_plain`; a CUDA tensor launches
the hand-written kernel (``csrc/upfirdn2d.cu``) through
:func:`upfirdn2d_cuda`, which raises on any input outside the kernel's
contract. Nothing falls back. The kernel has no gradient yet (the FIR
adjoint comes with ROADMAP slice 3), so a CUDA input that requires one is
refused rather than given an output that silently drops it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from tpugan_torch.ops import cuda

MAX_TAPS = 8  # csrc/upfirdn2d.cu kMaxTaps


def setup_fir_kernel(taps) -> np.ndarray:
    """Normalized 2-D FIR kernel from 1-D taps (outer product), e.g.
    (1, 2, 1) -> the 3x3 binomial / 16."""
    k = np.asarray(taps, dtype=np.float32)
    if k.ndim == 1:
        k = np.outer(k, k)
    return k / k.sum()


def _taps(kernel, gain: float) -> np.ndarray:
    k = np.asarray(kernel, dtype=np.float32)
    if k.ndim != 2:
        raise ValueError(f"FIR kernel must be 2-D, got shape {k.shape}")
    return np.ascontiguousarray(k * np.float32(gain))


def _on_card(x: torch.Tensor) -> bool:
    return x.device.type != "cpu"


def upfirdn2d(x: torch.Tensor, kernel, up: int = 1, down: int = 1,
              pad: tuple[int, int] = (0, 0), gain: float = 1.0) -> torch.Tensor:
    """Upsample by ``up`` (zero-stuffing), pad, FIR-filter, downsample by
    ``down``. x: [N, C, H, W]; kernel: [kh, kw], applied depthwise."""
    if _on_card(x):
        return upfirdn2d_cuda(x, kernel, up, down, pad, gain)
    return upfirdn2d_plain(x, kernel, up, down, pad, gain)


def upfirdn2d_plain(x: torch.Tensor, kernel, up: int = 1, down: int = 1,
                    pad: tuple[int, int] = (0, 0), gain: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version (counterpart of ``_upfirdn2d_xla``): a depthwise
    conv on the zero-stuffed, padded input, then decimation."""
    n, c, h, w = x.shape
    k = torch.from_numpy(_taps(kernel, gain)).to(device=x.device, dtype=x.dtype)
    kh, kw = k.shape
    if up > 1:
        # the stuffed signal is H*up long: the trailing up-1 zeros are kept
        stuffed = x.new_zeros(n, c, h * up, w * up)
        stuffed[:, :, ::up, ::up] = x
        x = stuffed
    p0, p1 = pad
    x = F.pad(x, (p0, p1, p0, p1))
    return F.conv2d(x, k.expand(c, 1, kh, kw), stride=down, groups=c)


def upfirdn2d_cuda(x: torch.Tensor, kernel, up: int = 1, down: int = 1,
                   pad: tuple[int, int] = (0, 0), gain: float = 1.0) -> torch.Tensor:
    """Launch ``csrc/upfirdn2d.cu`` on PyTorch's current stream.

    Takes contiguous fp32 NCHW CUDA tensors, up and down in {1, 2}, kernels
    up to 8x8 and non-negative pads, that need no gradient; raises on
    anything else.
    """
    if x.dtype != torch.float32:
        raise TypeError(f"upfirdn2d_cuda takes float32, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("upfirdn2d_cuda takes a contiguous [N, C, H, W] tensor")
    taps = _taps(kernel, gain)
    kh, kw = taps.shape
    p0, p1 = (int(p) for p in pad)
    if up not in (1, 2) or down not in (1, 2):
        raise ValueError(f"up and down must be 1 or 2, got up={up}, down={down}")
    if not (1 <= kh <= MAX_TAPS and 1 <= kw <= MAX_TAPS):
        raise ValueError(f"kernel {kh}x{kw} exceeds {MAX_TAPS}x{MAX_TAPS}")
    if p0 < 0 or p1 < 0:
        raise ValueError(f"pads must be non-negative, got {pad}")
    n, c, h, w = x.shape
    ho = (h * up + p0 + p1 - kh) // down + 1
    wo = (w * up + p0 + p1 - kw) // down + 1
    if ho < 1 or wo < 1:
        raise ValueError(f"empty output {ho}x{wo} for input {h}x{w}")
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError(
            "upfirdn2d_cuda has no gradient yet: the FIR adjoint comes with ROADMAP slice 3 "
            "(SG2-1024 case 2); call it under torch.no_grad() or on a tensor that needs none"
        )
    if not x.is_cuda:
        raise ValueError(f"upfirdn2d_cuda needs a CUDA tensor, got one on {x.device}")
    y = torch.empty((n, c, ho, wo), dtype=x.dtype, device=x.device)
    fn = cuda.kernel("upfirdn2d")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), y.data_ptr(), n * c, h, w, ho, wo, up, down, p0, kh, kw,
            taps.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), x.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"upfirdn2d kernel launch failed: cudaError {rc}")
    cuda.launches["upfirdn2d"] += 1
    return y


_BLUR_TAPS = setup_fir_kernel((1.0, 2.0, 1.0))


def blur3x3(x: torch.Tensor) -> torch.Tensor:
    """Depthwise (1, 2, 1) binomial blur, same size."""
    return upfirdn2d(x, _BLUR_TAPS, pad=(1, 1))


def upsample_fir(x: torch.Tensor, kernel, factor: int = 2) -> torch.Tensor:
    """Zero-stuff by ``factor`` then FIR, gain factor^2."""
    p = kernel.shape[0] - factor
    return upfirdn2d(x, kernel, up=factor, pad=((p + 1) // 2 + factor - 1, p // 2),
                     gain=float(factor**2))


def downsample_fir(x: torch.Tensor, kernel, factor: int = 2) -> torch.Tensor:
    """FIR then stride-``factor`` decimation."""
    p = kernel.shape[0] - factor
    return upfirdn2d(x, kernel, down=factor, pad=((p + 1) // 2, p // 2))
