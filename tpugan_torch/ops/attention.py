"""SAGAN attention, ``softmax(q @ k^T) @ v`` over the keys with no 1/sqrt(d)
scaling (counterpart of ``tpugan/ops/attention.py``'s forward).

q ``[N, Lq, dk]``, k ``[N, Lk, dk]``, v ``[N, Lk, dv]`` -> ``[N, Lq, dv]``;
with ``return_lse`` also the per-row logsumexp ``[N, Lq, 1]`` in fp32, which
a flash backward reads.

Dispatch: a CPU tensor takes :func:`sagan_attention_plain`; a CUDA tensor
launches the hand-written kernel (``csrc/sagan_attention.cu``) through
:func:`sagan_attention_cuda`, which raises on any input outside the
kernel's contract. Nothing falls back: unlike ``tpugan``'s dispatcher, which
leaves lengths that are not multiples of 128 to XLA, the kernel masks its
tails and takes any length. The backward comes with the training slice.
"""

from __future__ import annotations

import torch

from tpugan_torch.ops import cuda

MAX_DK = 128  # csrc/sagan_attention.cu kMaxDk
MAX_DV = 256  # csrc/sagan_attention.cu kMaxDv


def sagan_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, return_lse: bool = False):
    """``softmax(q k^T) v``; ``(out, lse)`` when ``return_lse``."""
    if q.device.type == "cpu":
        return sagan_attention_plain(q, k, v, return_lse)
    return sagan_attention_cuda(q, k, v, return_lse)


def sagan_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          return_lse: bool = False):
    """Plain PyTorch version (counterpart of ``_attention_xla``): the whole
    score matrix in fp32, then the softmax and the second product."""
    s = torch.bmm(q.float(), k.float().transpose(1, 2))
    out = torch.bmm(torch.softmax(s, dim=-1), v.float()).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1, keepdim=True)
    return out


def sagan_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         return_lse: bool = False):
    """Launch ``csrc/sagan_attention.cu`` on PyTorch's current stream.

    Takes contiguous fp32 ``[N, L, d]`` CUDA tensors on one device, any
    lengths, dk <= 128 and dv <= 256; raises on anything else.
    """
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.float32:
            raise TypeError(f"sagan_attention_cuda takes float32, got {name} as {x.dtype}")
        if x.dim() != 3 or not x.is_contiguous():
            raise ValueError(f"sagan_attention_cuda takes contiguous [N, L, d] tensors ({name})")
    n, lq, dk = q.shape
    _, lk, dv = v.shape
    if k.shape != (n, lk, dk) or v.shape[0] != n:
        raise ValueError(f"shapes do not fit: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if min(n, lq, lk, dk, dv) < 1:
        raise ValueError(f"empty input: q {tuple(q.shape)}, v {tuple(v.shape)}")
    if dk > MAX_DK or dv > MAX_DV:
        raise ValueError(f"dk {dk} > {MAX_DK} or dv {dv} > {MAX_DV}")
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"sagan_attention_cuda needs CUDA tensors on one device, got "
                         f"{q.device}, {k.device}, {v.device}")
    out = torch.empty((n, lq, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((n, lq, 1), dtype=torch.float32, device=q.device) if return_lse else None
    fn = cuda.kernel("sagan_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), n, lq, lk, dk, dv, q.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"sagan_attention kernel launch failed: cudaError {rc}")
    cuda.launches["sagan_attention"] += 1
    return (out, lse) if return_lse else out
