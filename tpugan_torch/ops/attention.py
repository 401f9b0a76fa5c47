"""SAGAN attention, ``softmax(q @ k^T) @ v`` over the keys with no 1/sqrt(d)
scaling, and its gradient (counterpart of ``tpugan/ops/attention.py``).

q ``[N, Lq, dk]``, k ``[N, Lk, dk]``, v ``[N, Lk, dv]`` -> ``[N, Lq, dv]``;
with ``return_lse`` also the per-row logsumexp ``[N, Lq, 1]`` in fp32, which
the backward reads. q, k and v are fp32 or bf16, all three alike, as
``tpugan``'s Pallas kernels take them: the sums are fp32 and the output and
the gradients come back in the inputs' dtype.

Dispatch: every call goes through a PyTorch operator
(``torch.library``), so that ``torch.export`` keeps it as one node:
``torch.ops.tpugan_torch.sagan_attention`` and ``sagan_attention_lse`` (the
forward without and with the logsumexp) and ``sagan_attention_bwd`` (the
backward's pack, dq and dkv kernels). Their CPU implementations are the
plain versions (:func:`sagan_attention_plain`,
:func:`sagan_attention_bwd_plain`); their CUDA ones launch the hand-written
kernels (``csrc/sagan_attention.cu``, ``csrc/sagan_attention_bwd.cu``),
reached through :func:`sagan_attention_cuda` and
:func:`sagan_attention_bwd_cuda`, which raise on any input outside the
kernels' contract; their fake ones give shapes and dtypes alone. Nothing
falls back: the kernels mask their tails and take any length. A bf16 input
launches the kernels' bf16 entry points (``KERNEL_OF_DTYPE``,
``BWD_KERNELS_OF_DTYPE``), which read and write bf16 themselves.

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
# the C entry point of each element type (csrc/sagan_attention.cu), and the
# backward's pack, dq and dkv (csrc/sagan_attention_bwd.cu)
KERNEL_OF_DTYPE = {torch.float32: "sagan_attention", torch.bfloat16: "sagan_attention_bf16"}
BWD_KERNELS_OF_DTYPE = {
    dtype: tuple(f"sagan_attention_bwd_{part}{suffix}" for part in ("pack", "dq", "dkv"))
    for dtype, suffix in ((torch.float32, ""), (torch.bfloat16, "_bf16"))
}


def _on_card(x: torch.Tensor) -> bool:
    """Whether ``x`` takes the card's route: a CUDA tensor (tests route CPU
    tensors that way by replacing this and the launching functions)."""
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
    return _forward_op(return_lse)(q, k, v)


def sagan_attention_bwd(q, k, v, o, lse, do):
    """``(dq, dk, dv)`` of the attention from its forward's output ``o`` and
    logsumexp ``lse`` and the output's gradient ``do``."""
    if _on_card(q):
        return sagan_attention_bwd_cuda(q, k, v, o, lse, do)
    return torch.ops.tpugan_torch.sagan_attention_bwd.default(q, k, v, o, lse, do)


def _forward_op(return_lse: bool):
    ops = torch.ops.tpugan_torch
    return ops.sagan_attention_lse.default if return_lse else ops.sagan_attention.default


def _attention_cpu(q, k, v):
    """``softmax(q k^T) v`` on the CPU: the plain version, or the card's
    route where :func:`_on_card` says so."""
    if _on_card(q):
        return _launch_attention(q, k, v, False)
    return sagan_attention_plain(q, k, v)


def _attention_lse_cpu(q, k, v):
    if _on_card(q):
        return _launch_attention(q, k, v, True)
    return sagan_attention_plain(q, k, v, True)


def _attention_bwd_cpu(q, k, v, o, lse, do):
    if _on_card(q):
        return _launch_attention_bwd(q, k, v, o, lse, do)
    return sagan_attention_bwd_plain(q, k, v, o, lse, do)


def _attention_fake(q, k, v):
    return q.new_empty((q.shape[0], q.shape[1], v.shape[2]))


def _attention_lse_fake(q, k, v):
    return _attention_fake(q, k, v), q.new_empty((q.shape[0], q.shape[1], 1), dtype=torch.float32)


def _attention_bwd_fake(q, k, v, o, lse, do):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


# The forward without and with the logsumexp, and the backward; none carries
# a gradient (``_SaganAttention`` is the differentiable form). Defined with
# torch.library's define/impl, not custom_op, whose Python dispatch costs
# more host time a call (tpugan_torch/tools/operator_overhead.py).
for _name, _schema, _cpu, _cuda, _fake in (
        ("sagan_attention", "(Tensor q, Tensor k, Tensor v) -> Tensor", _attention_cpu,
         lambda q, k, v: _launch_attention(q, k, v, False), _attention_fake),
        ("sagan_attention_lse", "(Tensor q, Tensor k, Tensor v) -> (Tensor, Tensor)", _attention_lse_cpu,
         lambda q, k, v: _launch_attention(q, k, v, True), _attention_lse_fake),
        ("sagan_attention_bwd", "(Tensor q, Tensor k, Tensor v, Tensor o, Tensor lse, Tensor do) "
         "-> (Tensor, Tensor, Tensor)", _attention_bwd_cpu,
         lambda q, k, v, o, lse, do: _launch_attention_bwd(q, k, v, o, lse, do), _attention_bwd_fake)):
    torch.library.define(f"tpugan_torch::{_name}", _schema)
    torch.library.impl(f"tpugan_torch::{_name}", "cpu", _cpu)
    torch.library.impl(f"tpugan_torch::{_name}", "cuda", _cuda)
    torch.library.register_fake(f"tpugan_torch::{_name}", _fake)
del _name, _schema, _cpu, _cuda, _fake


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
    returns ``(dq, dk, dv)`` in the dtypes of q, k and v. Computes in fp32
    from bf16 inputs, as ``tpugan``'s kernels do (float64 stays float64)."""
    q_, k_, v_, o_, lse_, do_ = (x.to(torch.promote_types(x.dtype, torch.float32))
                                 for x in (q, k, v, o, lse, do))
    p = torch.exp(torch.bmm(q_, k_.transpose(1, 2)) - lse_)
    delta = (do_ * o_).sum(-1, keepdim=True)
    ds = p * (torch.bmm(do_, v_.transpose(1, 2)) - delta)
    return (torch.bmm(ds, k_).to(q.dtype), torch.bmm(ds.transpose(1, 2), q_).to(k.dtype),
            torch.bmm(p.transpose(1, 2), do_).to(v.dtype))


def _check(tensors: dict, name: str, dtype=None) -> None:
    """Every tensor of ``tensors`` of one dtype, ``dtype`` where given, else
    fp32 or bf16; contiguous ``[N, L, d]``."""
    dtypes = {x.dtype for x in tensors.values()}
    if len(dtypes) != 1 or dtypes - ({dtype} if dtype else set(KERNEL_OF_DTYPE)):
        want = str(dtype).removeprefix("torch.") if dtype else "float32 or bfloat16"
        raise TypeError(f"{name} take {', '.join(tensors)} all {want}, got "
                        + ", ".join(f"{label} as {x.dtype}" for label, x in tensors.items()))
    for label, x in tensors.items():
        if x.dim() != 3 or not x.is_contiguous():
            raise ValueError(f"{name} take contiguous [N, L, d] tensors ({label})")


def check_attention_args(q, k, v) -> tuple[int, int, int, int, int]:
    """The kernels' contract on q, k, v, short of the device: contiguous
    ``[N, L, d]``, all fp32 or all bf16, shapes that fit, no empty
    dimension, dk <= 128 and dv <= 256. Returns ``(n, lq, lk, dk, dv)``;
    raises on anything else."""
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
    """:func:`check_attention_args`, and o and do ``[N, Lq, dv]`` of q's
    dtype, lse ``[N, Lq, 1]`` fp32, all contiguous."""
    n, lq, lk, dk, dv = check_attention_args(q, k, v)
    _check({"o": o, "do": do}, "the attention backward kernels", q.dtype)
    _check({"lse": lse}, "the attention backward kernels", torch.float32)
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
    """``csrc/sagan_attention.cu`` on PyTorch's current stream, through the
    operator (one launch).

    Takes contiguous ``[N, L, d]`` CUDA tensors on one device, all fp32 or
    all bf16 (the output in their dtype, lse fp32), any lengths, dk <= 128
    and dv <= 256; raises on anything else. The output carries no gradient:
    :func:`sagan_attention` is the differentiable form.
    """
    check_attention_args(q, k, v)
    _check_device((q, k, v), "sagan_attention_cuda")
    return _forward_op(return_lse)(q, k, v)


def _launch_attention(q, k, v, return_lse):
    """One launch of the forward kernel of q's dtype, counted under its name
    in ``cuda.launches``."""
    n, lq, lk, dk, dv = check_attention_args(q, k, v)
    _check_device((q, k, v), "sagan_attention_cuda")
    out = torch.empty((n, lq, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((n, lq, 1), dtype=torch.float32, device=q.device) if return_lse else None
    name = KERNEL_OF_DTYPE[q.dtype]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = cuda.kernel(name)(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                           None if lse is None else lse.data_ptr(), n, lq, lk, dk, dv, q.device.index,
                           stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    cuda.launches[name] += 1
    return (out, lse) if return_lse else out


def sagan_attention_bwd_cuda(q, k, v, o, lse, do):
    """``csrc/sagan_attention_bwd.cu``'s three kernels on PyTorch's current
    stream, through the operator ``tpugan_torch::sagan_attention_bwd``:
    pack (k, v, do and q laid out for the tensor cores, hi and lo, in a
    workspace allocated there), dq (which also writes p and ds to the
    workspace's scratch), then dk and dv from that scratch.
    ``delta = rowsum(do * o)`` is computed in plain PyTorch, in fp32, as
    ``tpugan`` computes it outside its kernels. bf16 inputs launch the bf16
    entry points, which return bf16 gradients.

    Takes the contract of :func:`check_attention_bwd_args` on CUDA tensors
    of one device; raises on anything else. Returns ``(dq, dk, dv)``.
    """
    check_attention_bwd_args(q, k, v, o, lse, do)
    _check_device((q, k, v, o, lse, do), "sagan_attention_bwd_cuda")
    return torch.ops.tpugan_torch.sagan_attention_bwd.default(q, k, v, o, lse, do)


def _launch_attention_bwd(q, k, v, o, lse, do):
    """The backward's pack, dq and dkv launches of q's dtype, each counted
    under its name in ``cuda.launches``."""
    n, lq, lk, dk, dv = check_attention_bwd_args(q, k, v, o, lse, do)
    _check_device((q, k, v, o, lse, do), "sagan_attention_bwd_cuda")
    delta = (do.float() * o.float()).sum(-1)
    dq = torch.empty_like(q)
    dk_out = torch.empty_like(k)
    dv_out = torch.empty_like(v)
    floats = cuda.helper("sagan_attention_bwd_workspace")(n, lq, lk, dk, dv)
    if floats < 0:
        raise ValueError(f"the attention backward kernels refuse q {tuple(q.shape)}, v {tuple(v.shape)}")
    workspace = torch.empty(floats, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    dims = (n, lq, lk, dk, dv, q.device.index, stream)
    pack, dq_kernel, dkv = BWD_KERNELS_OF_DTYPE[q.dtype]
    calls = (
        (pack, (q, k, v, do, workspace)),
        (dq_kernel, (q, do, lse, delta, dq, workspace)),
        (dkv, (workspace, dk_out, dv_out)),
    )
    for name, args in calls:
        rc = cuda.kernel(name)(*(x.data_ptr() for x in args), *dims)
        if rc != 0:
            raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
        cuda.launches[name] += 1
    return dq, dk_out, dv_out
