"""SAGAN attention, ``softmax(q @ k^T) @ v`` over the keys with no 1/sqrt(d)
scaling, and its gradient (counterpart of ``tpugan/ops/attention.py``).

q ``[N, Lq, dk]``, k ``[N, Lk, dk]``, v ``[N, Lk, dv]`` -> ``[N, Lq, dv]``;
with ``return_lse`` also the per-row logsumexp ``[N, Lq, 1]`` in fp32, which
the backward reads.

Dispatch: a CPU tensor takes the plain versions (:func:`sagan_attention_plain`,
:func:`sagan_attention_bwd_plain`); a CUDA tensor launches the hand-written
kernels through :func:`sagan_attention_cuda` (``csrc/sagan_attention.cu``)
and :func:`sagan_attention_bwd_cuda` (``csrc/sagan_attention_bwd.cu``), which
raise on any input outside the kernels' contract. Nothing falls back: the
kernels mask their tails and take any length.

When a gradient is wanted (grad mode on and an input that requires grad),
:func:`sagan_attention` runs as an :class:`torch.autograd.Function`: the
forward keeps the logsumexp and the backward is the flash backward, on both
devices. ``tpugan``'s policy of when to take its flash backward (a VMEM
budget, and a score matrix of at least 64 M entries, set on a TPU) is not
carried over: every CUDA input that needs a gradient goes through the kernel.
"""

from __future__ import annotations

import torch

from tpugan_torch.ops import cuda

MAX_DK = 128  # csrc/sagan_attention.cu and sagan_attention_bwd.cu kMaxDk
MAX_DV = 256  # csrc/sagan_attention.cu and sagan_attention_bwd.cu kMaxDv
# the backward's p/ds scratch comes in tiles of SCRATCH_KEYS keys x SCRATCH_ROWS
# query rows (csrc/sagan_attention_bwd.cu kDkvKeys, kDkvRows), inside the
# workspace that the kernels' operands are packed into
SCRATCH_KEYS = 64
SCRATCH_ROWS = 32


def _on_card(x: torch.Tensor) -> bool:
    return x.device.type != "cpu"


def sagan_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, return_lse: bool = False):
    """``softmax(q k^T) v``, differentiable with respect to q, k and v; or
    ``(out, lse)`` when ``return_lse``, a form with no gradient that raises
    when one is wanted, on either device."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if return_lse:
            raise ValueError("sagan_attention(..., return_lse=True) carries no gradient: call it "
                             "under torch.no_grad() or on detached inputs")
        return _SaganAttention.apply(q, k, v)
    if _on_card(q):
        return sagan_attention_cuda(q, k, v, return_lse)
    return sagan_attention_plain(q, k, v, return_lse)


def sagan_attention_bwd(q, k, v, o, lse, do):
    """``(dq, dk, dv)`` of the attention from its forward's output ``o`` and
    logsumexp ``lse`` and the output's gradient ``do``."""
    if _on_card(q):
        return sagan_attention_bwd_cuda(q, k, v, o, lse, do)
    return sagan_attention_bwd_plain(q, k, v, o, lse, do)


class _SaganAttention(torch.autograd.Function):
    """Forward with the logsumexp saved, flash backward."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = sagan_attention(q, k, v, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        return sagan_attention_bwd(q, k, v, out, lse, do.contiguous())


def sagan_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          return_lse: bool = False):
    """Plain PyTorch version (counterpart of ``_attention_xla``): the whole
    score matrix in fp32, then the softmax and the second product."""
    s = torch.bmm(q.float(), k.float().transpose(1, 2))
    out = torch.bmm(torch.softmax(s, dim=-1), v.float()).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1, keepdim=True)
    return out


def sagan_attention_bwd_plain(q, k, v, o, lse, do):
    """Plain PyTorch version of the flash backward: p recomputed from the
    logsumexp, ``delta = rowsum(do * o)``, ``ds = p (do v^T - delta)``;
    returns ``(dq, dk, dv)``."""
    p = torch.exp(torch.bmm(q, k.transpose(1, 2)) - lse)
    delta = (do * o).sum(-1, keepdim=True)
    ds = p * (torch.bmm(do, v.transpose(1, 2)) - delta)
    return torch.bmm(ds, k), torch.bmm(ds.transpose(1, 2), q), torch.bmm(p.transpose(1, 2), do)


def _check(tensors: dict, name: str) -> None:
    for label, x in tensors.items():
        if x.dtype != torch.float32:
            raise TypeError(f"{name} take float32, got {label} as {x.dtype}")
        if x.dim() != 3 or not x.is_contiguous():
            raise ValueError(f"{name} take contiguous [N, L, d] tensors ({label})")


def check_attention_args(q, k, v) -> tuple[int, int, int, int, int]:
    """The kernels' contract on q, k, v, short of the device: contiguous
    fp32 ``[N, L, d]``, shapes that fit, no empty dimension, dk <= 128 and
    dv <= 256. Returns ``(n, lq, lk, dk, dv)``; raises on anything else."""
    _check({"q": q, "k": k, "v": v}, "the attention kernels")
    n, lq, dk = q.shape
    _, lk, dv = v.shape
    if k.shape != (n, lk, dk) or v.shape[0] != n:
        raise ValueError(f"shapes do not fit: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if min(n, lq, lk, dk, dv) < 1:
        raise ValueError(f"empty input: q {tuple(q.shape)}, v {tuple(v.shape)}")
    if dk > MAX_DK or dv > MAX_DV:
        raise ValueError(f"dk {dk} > {MAX_DK} or dv {dv} > {MAX_DV}")
    return n, lq, lk, dk, dv


def check_attention_bwd_args(q, k, v, o, lse, do) -> tuple[int, int, int, int, int]:
    """:func:`check_attention_args`, and o and do ``[N, Lq, dv]``, lse
    ``[N, Lq, 1]``, all contiguous fp32."""
    n, lq, lk, dk, dv = check_attention_args(q, k, v)
    _check({"o": o, "lse": lse, "do": do}, "the attention backward kernels")
    if o.shape != (n, lq, dv) or do.shape != (n, lq, dv) or lse.shape != (n, lq, 1):
        raise ValueError(f"shapes do not fit: q {tuple(q.shape)}, v {tuple(v.shape)}, "
                         f"o {tuple(o.shape)}, lse {tuple(lse.shape)}, do {tuple(do.shape)}")
    return n, lq, lk, dk, dv


def _check_device(tensors, name: str) -> None:
    first = tensors[0]
    if not (first.is_cuda and all(x.device == first.device for x in tensors)):
        raise ValueError(f"{name} needs CUDA tensors on one device, got "
                         + ", ".join(str(x.device) for x in tensors))


def sagan_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         return_lse: bool = False):
    """Launch ``csrc/sagan_attention.cu`` on PyTorch's current stream.

    Takes contiguous fp32 ``[N, L, d]`` CUDA tensors on one device, any
    lengths, dk <= 128 and dv <= 256; raises on anything else. The output
    carries no gradient: :func:`sagan_attention` is the differentiable form.
    """
    n, lq, lk, dk, dv = check_attention_args(q, k, v)
    _check_device((q, k, v), "sagan_attention_cuda")
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


def sagan_attention_bwd_cuda(q, k, v, o, lse, do):
    """Launch ``csrc/sagan_attention_bwd.cu``'s three kernels on PyTorch's
    current stream: pack (k, v, do and q laid out for the tensor cores, hi
    and lo, in a workspace allocated here), dq (which also writes p and ds
    to the workspace's scratch), then dk and dv from that scratch.
    ``delta = rowsum(do * o)`` is computed here in plain PyTorch, as
    ``tpugan`` computes it outside its kernels.

    Takes the contract of :func:`check_attention_bwd_args` on CUDA tensors
    of one device; raises on anything else. Returns ``(dq, dk, dv)``.
    """
    n, lq, lk, dk, dv = check_attention_bwd_args(q, k, v, o, lse, do)
    _check_device((q, k, v, o, lse, do), "sagan_attention_bwd_cuda")
    delta = (do * o).sum(-1)
    dq = torch.empty_like(q)
    dk_out = torch.empty_like(k)
    dv_out = torch.empty_like(v)
    floats = cuda.helper("sagan_attention_bwd_workspace")(n, lq, lk, dk, dv)
    if floats < 0:
        raise ValueError(f"the attention backward kernels refuse q {tuple(q.shape)}, v {tuple(v.shape)}")
    workspace = torch.empty(floats, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    dims = (n, lq, lk, dk, dv, q.device.index, stream)
    calls = (
        ("sagan_attention_bwd_pack", (q, k, v, do, workspace)),
        ("sagan_attention_bwd_dq", (q, do, lse, delta, dq, workspace)),
        ("sagan_attention_bwd_dkv", (workspace, dk_out, dv_out)),
    )
    for name, args in calls:
        rc = cuda.kernel(name)(*(x.data_ptr() for x in args), *dims)
        if rc != 0:
            raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
        cuda.launches[name] += 1
    return dq, dk_out, dv_out
