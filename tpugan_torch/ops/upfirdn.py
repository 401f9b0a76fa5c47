"""upfirdn2d — upsample, FIR filter, downsample, on NCHW tensors
(counterpart of ``tpugan/ops/upfirdn.py``).

Convention: cross-correlation with the taps as given (not StyleGAN2-CUDA's
flipped convolution); pads ``(pad0, pad1)`` apply to both spatial dims; the
output size is ``(H*up + pad0 + pad1 - kh) // down + 1``; ``gain``
multiplies the taps.

Dispatch: every FIR goes through one PyTorch operator,
``torch.ops.tpugan_torch.upfirdn2d`` (``torch.library``), so that
``torch.export`` keeps each call as one node of its graph. Its CPU
implementation is :func:`upfirdn2d_plain`'s arithmetic; its CUDA one launches
the hand-written kernel (``csrc/upfirdn2d.cu``), which raises on any input
outside the kernel's contract (:func:`upfirdn2d_cuda` is one call of it);
its fake one gives the output's shape and dtype alone. Nothing falls back.
Each launch is counted in ``cuda.launches``, under ``upfirdn2d`` (fp32) or
``upfirdn2d_bf16`` (bf16), and, by the TPU kernel that tpugan runs for the
same FIR (:func:`tpu_layout`), in :data:`layout_launches`; a trace counts
nothing.

dtypes: fp32 and bf16, as the Pallas kernels take them. A bf16 FIR reads
bf16, sums in fp32 with fp32 taps and rounds each output once to bf16, on
both devices.

Gradient: when one is wanted, :func:`upfirdn2d` runs as a
:class:`torch.autograd.Function` on both devices. Its backward is the
adjoint FIR, as tpugan's custom VJP: the gradient stuffed by ``down``,
correlated with the flipped taps at the same gain and decimated by ``up``,
with pads taken per axis (``kh`` for H, ``kw`` for W) so that the input's
size comes back, in the gradient's dtype, as tpugan's custom VJP runs it.
On the card that is one more launch of the same kernel;
pads it does not take (negative, or unequal front pads of H and W) are
applied to the gradient in torch first (:func:`_fir_cuda`).
"""

from __future__ import annotations

import functools
from dataclasses import astuple, dataclass

import numpy as np
import torch
import torch.nn.functional as F

from tpugan_torch.ops import cuda

MAX_TAPS = 8  # csrc/upfirdn2d.cu kMaxTaps
THREADS = 128  # kMaxThreads: threads of a block, at most
STRIP_ROWS = 4  # kStripRows: output rows of a thread's strip
MAX_SHARED_BYTES = 48 * 1024  # kMaxSharedBytes: a block's staged tile, at most
MAX_STRIP_COLS = 64  # strips across a tile of a wide plane
WIDE_STRIP_MIN_COLS = 32  # same-size FIRs on rows this wide take 4-column strips
BLOCKS_PER_SM = 2  # blocks a launch should have per SM before small planes share one
VEC_BYTES = 16  # a cp.async copy of a staged row, where rows allow it
# the C entry point of each dtype, by its name in cuda.KERNELS
KERNEL_OF_DTYPE = {torch.float32: "upfirdn2d", torch.bfloat16: "upfirdn2d_bf16"}


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


@dataclass(frozen=True)
class FirPlan:
    """The launch plan of ``csrc/upfirdn2d.cu`` (its ``PlanField`` order).

    A block owns ``planes_per_block`` planes and, in each, an output tile of
    ``tile_rows`` x ``tile_cols`` at (tile_y * tile_rows, tile_x *
    tile_cols); blocks run planes-group-major, then tile_y, then tile_x. It
    stages ``in_rows`` input rows of ``in_stride`` elements of
    ``elem_bytes`` bytes per plane from row ``(oy0*down - pad0 - phase) //
    up`` and column ``(ox0*down - pad0 - phase) // up`` on; with ``vec``
    (16-byte copies, of 4 floats or 8 bf16) the first column is rounded down
    to a multiple of the copy and reads start ``lead`` columns in. Each
    thread computes ``rh`` x ``rw`` outputs."""

    rh: int
    rw: int
    tile_rows: int
    tile_cols: int
    tiles_y: int
    tiles_x: int
    planes_per_block: int
    in_rows: int
    in_stride: int
    phase: int
    vec: int
    threads: int
    blocks: int
    shared_bytes: int
    elem_bytes: int

    def as_array(self) -> np.ndarray:
        return np.array(astuple(self), dtype=np.int32)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def strip_width(up: int, down: int, wo: int) -> int:
    """Output columns of a thread's strip: a pair for up 2 (so each
    column's phase is fixed); for a same-size FIR four (16-byte stores) on
    rows of WIDE_STRIP_MIN_COLS or more, one on narrower ones, where more
    threads a plane finish sooner; one otherwise."""
    if (up, down) == (2, 1):
        return 2
    return 4 if (up, down) == (1, 1) and wo >= WIDE_STRIP_MIN_COLS else 1


def fir_plan(planes: int, h: int, w: int, up: int, down: int, pad0: int, kh: int, kw: int,
             ho: int, wo: int, *, min_blocks: int, aligned: bool = True,
             rw: int | None = None, elem_bytes: int = 4) -> FirPlan:
    """The launch plan for ``planes`` planes of h x w -> ho x wo.

    Small planes (a whole plane in at most THREADS strips) go several to a
    block, as many as keep ``min_blocks`` blocks (:func:`min_blocks`);
    larger ones are cut into bands of rows across the full width, or 2-D
    tiles of MAX_STRIP_COLS strips for wide planes. A tile whose staged
    input exceeds MAX_SHARED_BYTES holds fewer planes, then fewer rows, then
    fewer columns. ``elem_bytes``: 4 (fp32) or 2 (bf16). ``aligned``: the
    input's base is 16-byte aligned; when w is a multiple of a 16-byte copy
    (4 floats, 8 bf16) every row is, and the tile is copied 16 bytes at a
    time. ``rw``: the strip width, :func:`strip_width` unless given (a
    same-size FIR runs with 1 or 4)."""
    if elem_bytes not in (2, 4):
        raise ValueError(f"elements of 4 (fp32) or 2 (bf16) bytes, got {elem_bytes}")
    rh = STRIP_ROWS
    rw = strip_width(up, down, wo) if rw is None else rw
    phase = -pad0 % up
    v = VEC_BYTES // elem_bytes
    vec = int(aligned and w % v == 0)

    def staged(tile_rows, tile_cols):
        rows = (phase + (tile_rows - 1) * down + kh - 1) // up + 1
        cols = (phase + (tile_cols - 1) * down + kw - 1) // up + 1
        return rows, (-(-(cols + v - 1) // v) * v if vec else cols)

    strip_cols, strip_rows = _cdiv(wo, rw), _cdiv(ho, rh)
    if strip_cols * strip_rows <= THREADS:
        per_block = min(THREADS // (strip_cols * strip_rows), max(1, _cdiv(planes, min_blocks)),
                        max(1, planes))
    else:
        per_block = 1
        strip_cols = min(strip_cols, MAX_STRIP_COLS)
        strip_rows = min(strip_rows, THREADS // strip_cols)
    while True:
        in_rows, in_stride = staged(strip_rows * rh, strip_cols * rw)
        if per_block * in_rows * in_stride * elem_bytes <= MAX_SHARED_BYTES:
            break
        if per_block > 1:
            per_block -= 1
        elif strip_rows > 1:
            strip_rows -= 1
        else:
            strip_cols = max(1, strip_cols // 2)
    tile_rows, tile_cols = strip_rows * rh, strip_cols * rw
    tiles_y, tiles_x = _cdiv(ho, tile_rows), _cdiv(wo, tile_cols)
    return FirPlan(
        rh=rh, rw=rw, tile_rows=tile_rows, tile_cols=tile_cols, tiles_y=tiles_y, tiles_x=tiles_x,
        planes_per_block=per_block, in_rows=in_rows, in_stride=in_stride, phase=phase, vec=vec,
        threads=_cdiv(per_block * strip_rows * strip_cols, 32) * 32,
        blocks=_cdiv(planes, per_block) * tiles_y * tiles_x,
        shared_bytes=per_block * in_rows * in_stride * elem_bytes, elem_bytes=elem_bytes,
    )


@functools.lru_cache(maxsize=None)
def min_blocks(device: torch.device) -> int:
    """BLOCKS_PER_SM blocks for each streaming multiprocessor of ``device``
    (264 on an H100 SXM)."""
    return BLOCKS_PER_SM * torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=256)
def _plan_array(*args, **kwargs) -> np.ndarray:
    """fir_plan(...) as the kernel reads it; a model's few shapes recur, so
    the plan is made once per shape."""
    plan = fir_plan(*args, **kwargs).as_array()
    plan.flags.writeable = False
    return plan


def tpu_layout(c: int, up: int, down: int, kh: int, kw: int, pad: tuple[int, int] = (0, 0)) -> str:
    """The TPU kernel that tpugan's dispatch (``tpugan/ops/upfirdn.py``,
    ``_dispatch``) gives this FIR on C channels: "B1" (``upfirdn2d_pallas``,
    C % 128 == 0), "B2" (``upfirdn2d_pallas_small_c``, same-size with
    128 % C == 0), or "XLA" (none; tpugan runs its XLA form, as for a
    negative pad). The port runs one kernel for all three;
    :data:`layout_launches` counts its launches by this key."""
    if kh == kw <= MAX_TAPS and min(pad) >= 0:
        if (up, down) in ((1, 1), (1, 2), (2, 1)) and c % 128 == 0:
            return "B1"
        if (up, down) == (1, 1) and 128 % c == 0:
            return "B2"
    return "XLA"


layout_launches = {"B1": 0, "B2": 0, "XLA": 0}


def reset_layout_launches() -> None:
    for key in layout_launches:
        layout_launches[key] = 0


def _on_card(x: torch.Tensor) -> bool:
    """Whether ``x`` takes the card's route: a CUDA tensor (tests route CPU
    tensors that way by replacing this and :func:`_launch`)."""
    return x.device.type != "cpu"


def upfirdn2d(x: torch.Tensor, kernel, up: int = 1, down: int = 1,
              pad: tuple[int, int] = (0, 0), gain: float = 1.0) -> torch.Tensor:
    """Upsample by ``up`` (zero-stuffing), pad, FIR-filter, downsample by
    ``down``. x: [N, C, H, W]; kernel: [kh, kw], applied depthwise.
    Differentiable with respect to x on both devices."""
    p0, p1 = (int(p) for p in pad)
    return _fir(x, _taps(kernel, gain), up, down, (p0, p1, p0, p1))


def _fir(x, taps, up, down, pads):
    """upfirdn2d with the gain folded into ``taps`` and pads per axis,
    ``(top, bottom, left, right)``, any of them negative (a crop)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _UpFirDn2d.apply(x, taps, up, down, pads)
    if _on_card(x):
        return _fir_cuda(x, taps, up, down, pads)
    return _fir_op(x, taps, up, down, pads, _layout_key(x.shape[1], taps, up, down, pads))


def _layout_key(c, taps, up, down, pads):
    """The TPU kernel a FIR with pads per axis is counted under: tpugan's
    own FIR where the pads of H and W agree (the VJP's back pads; its front
    pad is kh's on both axes), else its XLA form."""
    kh, kw = taps.shape
    py0, py1, px0, px1 = pads
    return tpu_layout(c, up, down, kh, kw, (py0, py1)) if (py0, py1) == (px0, px1) else "XLA"


def _fir_op(x, taps, up, down, pads, key):
    """One call of the operator ``tpugan_torch::upfirdn2d``: the taps as a
    list of floats with their shape, the pads as a list."""
    kh, kw = taps.shape
    return torch.ops.tpugan_torch.upfirdn2d.default(x, taps.ravel().tolist(), kh, kw, up, down, list(pads), key)


def _out_size(size, up, down, pad0, pad1, k):
    return (size * up + pad0 + pad1 - k) // down + 1


def _upfirdn2d_cpu(x, taps, kh, kw, up, down, pads, key):
    """The operator on the CPU: the plain version (any pads), or the card's
    route where :func:`_on_card` says so (tests route CPU tensors through
    the launch code that way)."""
    if _on_card(x):
        return _fir_kernel(x, taps, kh, kw, up, down, pads, key)
    return _fir_plain(x, np.asarray(taps, dtype=np.float32).reshape(kh, kw), up, down, tuple(pads))


def _fir_kernel(x, taps, kh, kw, up, down, pads, key):
    """The operator on the card: one launch of the kernel, which takes one
    non-negative front pad for both axes and any output size (the back pads
    follow from it); other pads are applied in torch before the operator
    (:func:`_fir_cuda`)."""
    py0, py1, px0, px1 = pads
    if py0 != px0 or py0 < 0:
        raise ValueError(f"the FIR kernel takes one non-negative front pad for both axes, got pads {pads}")
    ho, wo = _out_size(x.shape[2], up, down, py0, py1, kh), _out_size(x.shape[3], up, down, px0, px1, kw)
    return _launch(x, np.asarray(taps, dtype=np.float32).reshape(kh, kw), up, down, py0, ho, wo, key)


def _upfirdn2d_fake(x, taps, kh, kw, up, down, pads, key):
    """The operator under tracing: the output's shape and dtype alone."""
    n, c, h, w = x.shape
    py0, py1, px0, px1 = pads
    return x.new_empty((n, c, _out_size(h, up, down, py0, py1, kh), _out_size(w, up, down, px0, px1, kw)))


# The FIR of ``taps`` (kh x kw, the gain folded in) with pads ``(top, bottom,
# left, right)``; ``key`` is the TPU kernel a launch is counted under. It
# carries no gradient (``_UpFirDn2d`` is the differentiable form). Defined
# with torch.library's define/impl, not custom_op, whose Python dispatch
# costs more host time a call (tpugan_torch/tools/operator_overhead.py).
torch.library.define("tpugan_torch::upfirdn2d",
                     "(Tensor x, float[] taps, int kh, int kw, int up, int down, int[] pads, str key) -> Tensor")
torch.library.impl("tpugan_torch::upfirdn2d", "cpu", _upfirdn2d_cpu)
torch.library.impl("tpugan_torch::upfirdn2d", "cuda", _fir_kernel)
torch.library.register_fake("tpugan_torch::upfirdn2d", _upfirdn2d_fake)


class _UpFirDn2d(torch.autograd.Function):
    """upfirdn2d whose backward is the adjoint FIR (tpugan's custom VJP)."""

    @staticmethod
    def forward(ctx, x, taps, up, down, pads):
        ctx.geometry = (x.shape[2], x.shape[3], taps, up, down, pads)
        return _fir(x, taps, up, down, pads)

    @staticmethod
    def backward(ctx, g):
        h, w, taps, up, down, pads = ctx.geometry
        return _fir(g.contiguous(), *adjoint(h, w, g.shape[2], g.shape[3], taps, up, down, pads)), \
            None, None, None, None


def adjoint(h, w, gh, gw, taps, up, down, pads):
    """``(taps, up, down, pads)`` of the FIR whose output is the gradient of
    an h x w input from a gh x gw output's gradient: the taps flipped, up and
    down swapped, front pads ``kh - 1 - top`` and ``kw - 1 - left``, back pads
    that give h x w. tpugan's VJP (``tpugan/ops/upfirdn.py:115-139``) takes
    the front pad from kh on both axes, which is wrong where kh != kw."""
    kh, kw = taps.shape
    py0, _, px0, _ = pads
    return (taps[::-1, ::-1].copy(), down, up,
            (kh - 1 - py0, (h - 1) * up + 1 + py0 - gh * down,
             kw - 1 - px0, (w - 1) * up + 1 + px0 - gw * down))


def _stuff(x: torch.Tensor, up: int) -> torch.Tensor:
    """Zero-stuffing: x at every ``up``-th row and column of an H*up x W*up
    signal (the trailing up-1 zeros are kept)."""
    if up == 1:
        return x
    n, c, h, w = x.shape
    stuffed = x.new_zeros(n, c, h * up, w * up)
    stuffed[:, :, ::up, ::up] = x
    return stuffed


def _fir_plain(x, taps, up, down, pads):
    """The FIR as a depthwise conv; bf16 is summed in fp32 with fp32 taps
    and rounded once at the end, as the Pallas kernels compute it."""
    n, c, h, w = x.shape
    work = torch.float32 if x.dtype == torch.bfloat16 else x.dtype
    k = torch.from_numpy(taps).to(device=x.device, dtype=work)
    kh, kw = k.shape
    py0, py1, px0, px1 = pads
    xp = F.pad(_stuff(x.to(work), up), (px0, px1, py0, py1))
    return F.conv2d(xp, k.expand(c, 1, kh, kw), stride=down, groups=c).to(x.dtype)


def upfirdn2d_plain(x: torch.Tensor, kernel, up: int = 1, down: int = 1,
                    pad: tuple[int, int] = (0, 0), gain: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version (counterpart of ``_upfirdn2d_xla``): a depthwise
    conv on the zero-stuffed, padded input, then decimation."""
    p0, p1 = pad
    return _fir_plain(x, _taps(kernel, gain), up, down, (p0, p1, p0, p1))


def _fir_cuda(x, taps, up, down, pads):
    """A FIR with pads per axis (a forward, or an adjoint) on the card's
    route: equal non-negative front pads reach the operator as they are;
    otherwise the input is stuffed and padded (or cropped) here, in torch,
    and the kernel runs with up 1 and no pad. Counted by the TPU kernel
    tpugan runs (:func:`_layout_key`)."""
    key = _layout_key(x.shape[1], taps, up, down, pads)
    py0, py1, px0, px1 = pads
    if py0 == px0 >= 0:
        return _fir_op(x, taps, up, down, pads, key)
    x = F.pad(_stuff(x, up), (px0, px1, py0, py1)).contiguous()
    return _fir_op(x, taps, 1, down, (0, 0, 0, 0), key)


def upfirdn2d_cuda(x: torch.Tensor, kernel, up: int = 1, down: int = 1,
                   pad: tuple[int, int] = (0, 0), gain: float = 1.0) -> torch.Tensor:
    """Launch ``csrc/upfirdn2d.cu`` on PyTorch's current stream.

    Takes contiguous fp32 or bf16 NCHW CUDA tensors, up and down in {1, 2},
    kernels up to 8x8 and non-negative pads; raises on anything else. The output
    carries no gradient: :func:`upfirdn2d` is the differentiable form.
    """
    p0, p1 = (int(p) for p in pad)
    if p0 < 0 or p1 < 0:
        raise ValueError(f"pads must be non-negative, got {pad}")
    if x.dim() != 4:
        raise ValueError("upfirdn2d_cuda takes a contiguous [N, C, H, W] tensor")
    taps = _taps(kernel, gain)
    kh, kw = taps.shape
    check_launch(x, taps, up, down, p0, _out_size(x.shape[2], up, down, p0, p1, kh),
                 _out_size(x.shape[3], up, down, p0, p1, kw))
    if not x.is_cuda:
        raise ValueError(f"upfirdn2d_cuda needs a CUDA tensor, got one on {x.device}")
    return _fir_cuda(x, taps, up, down, (p0, p1, p0, p1))


def check_launch(x, taps, up, down, pad0, ho, wo) -> None:
    """The kernel's contract, short of the device: a contiguous fp32 or bf16
    [N, C, H, W] tensor, up and down in {1, 2}, up to 8x8 taps, a
    non-negative front pad and a non-empty output; raises on anything else."""
    if x.dtype not in KERNEL_OF_DTYPE:
        raise TypeError(f"upfirdn2d_cuda takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("upfirdn2d_cuda takes a contiguous [N, C, H, W] tensor")
    kh, kw = taps.shape
    if up not in (1, 2) or down not in (1, 2):
        raise ValueError(f"up and down must be 1 or 2, got up={up}, down={down}")
    if not (1 <= kh <= MAX_TAPS and 1 <= kw <= MAX_TAPS):
        raise ValueError(f"kernel {kh}x{kw} exceeds {MAX_TAPS}x{MAX_TAPS}")
    if pad0 < 0:
        raise ValueError(f"pads must be non-negative, got a front pad of {pad0}")
    if ho < 1 or wo < 1:
        raise ValueError(f"empty output {ho}x{wo} for input {x.shape[2]}x{x.shape[3]}")


def _launch(x, taps, up, down, pad0, ho, wo, key):
    """One launch of the kernel of x's dtype, ``ho`` x ``wo`` outputs from
    front pad ``pad0``, counted under its name in ``cuda.launches`` and
    under ``key`` in :data:`layout_launches`."""
    check_launch(x, taps, up, down, pad0, ho, wo)
    if not x.is_cuda:
        raise ValueError(f"upfirdn2d_cuda needs a CUDA tensor, got one on {x.device}")
    n, c, h, w = x.shape
    kh, kw = taps.shape
    y = torch.empty((n, c, ho, wo), dtype=x.dtype, device=x.device)
    plan = _plan_array(n * c, h, w, up, down, pad0, kh, kw, ho, wo, min_blocks=min_blocks(x.device),
                       aligned=x.data_ptr() % VEC_BYTES == 0, elem_bytes=x.element_size())
    name = KERNEL_OF_DTYPE[x.dtype]
    fn = cuda.kernel(name)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), y.data_ptr(), n * c, h, w, ho, wo, up, down, pad0, kh, kw,
            taps.ctypes.data, plan.ctypes.data, x.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"upfirdn2d kernel launch failed: cudaError {rc}")
    cuda.launches[name] += 1
    layout_launches[key] += 1
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
