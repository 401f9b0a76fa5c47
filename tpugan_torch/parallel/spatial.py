"""Row-sharded forms of the ops on the encoder side and in the losses (the
``space`` axis; counterpart of tpugan's ``P(DATA_AXIS, SPACE_AXIS)``
constraint on the images, ``tpugan/parallel/mesh.py:11-13``, where XLA
inserts the halo exchanges).

A rank of a space group holds rows ``[start, start + h)`` of each
image-shaped tensor of ``total`` rows (:class:`Rows`): equal shares in rank
order on the encoder side, a crop's share (possibly uneven or empty) in the
losses. Every op here takes the group explicitly and is the plain op where
it is ``None``:

* a convolution takes a halo of its reach (``parallel.mesh.halo_rows``): a
  3x3 stride-1 conv 1 row above and below, the fused 4x4 stride-2 conv of
  E_Blur (pad 1) 1 and 1 with shards starting on even rows; it runs on the
  halo'd rows with no H padding, W padded as before; a 1x1 conv is local;
* the blur is the FIR with a 1-row halo (``ops.upfirdn.blur3x3_rows``),
  forward and adjoint, counted under the whole image's TPU kernel;
* instance norm and the style statistics sum over H x W in tpugan's two
  fp32 passes (float64 for float64), each pass's sums over the rows
  all-reduced across the group (``ops.basic.moments32``);
* the average pools and VGG16's 2x2 max pools are local on shards of even
  rows;
* a level whose shards would be too thin (:func:`runs_on_rows`: no row, or
  an odd count where the level ends by halving its rows) is gathered whole
  on every rank (``parallel.mesh.all_gather_rows``) and the rest of the
  network runs whole;
* affine maps with a per-image condition (E_BIG's batch norms, which
  normalise by stored statistics) and 1x1 convolutions are local.

Each rank differentiates its share of the loss, the loss over the group's
size; the collectives' backwards are their transposes, so the shares'
gradients sum to the loss's and work replicated on every rank (the style
heads, a level gathered because it is too thin to shard) counts once.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from tpugan_torch.ops import basic, upfirdn
from tpugan_torch.ops.eq_lr import transform_kernel_2d
from tpugan_torch.parallel.mesh import all_gather_rows, all_sum_grad, group_rank, group_size, halo_rows, take_rows


class Rows(NamedTuple):
    """This rank's rows ``[start, start + h)`` of a tensor of ``total`` rows
    split over the space ``group``."""

    group: Any
    start: int
    total: int

    @classmethod
    def even(cls, group, rows: int) -> "Rows":
        """Equal shares of ``rows`` rows a rank, in rank order."""
        return cls(group, group_rank(group) * rows, rows * group_size(group))


def conv2d_rows(x, weight, bias, stride: int, padding: int, group):
    """``F.conv2d(x, weight, bias, stride, padding)`` of the whole image,
    this rank's output rows from its input rows (NCHW, equal shares
    starting on a multiple of ``stride``): a halo of ``padding`` rows above
    and ``k - stride - padding`` below, then no H padding."""
    k = weight.shape[2]
    above, below = padding, k - stride - padding
    if x.shape[2] % stride or below < 0:
        raise ValueError(f"a {k}x{k} conv at stride {stride} does not run on shards of {x.shape[2]} rows")
    xh = halo_rows(x, above, below, group)
    return F.conv2d(xh, weight, bias, stride=stride, padding=(0, padding))


def runs_on_rows(rows: int, halves: bool) -> bool:
    """Whether a level of ``rows`` rows a rank runs on shards: at least one
    row (a 3x3 convolution's halo comes from a neighbour's shard) and, where
    the level ends by halving its rows (a pool, a stride-2 convolution), an
    even count. Else the level is gathered whole (the thin-level rule)."""
    return rows >= 1 and not (halves and rows % 2)


class RowOps:
    """The encoder block's ops on this rank's rows of a space ``group``, or
    the plain ops where ``group`` is ``None``."""

    def __init__(self, group=None):
        self.group = group

    def total(self, x) -> int:
        """The whole image's rows at ``x``'s level."""
        return x.shape[2] * group_size(self.group)

    def rows(self, noise):
        """This rank's rows of a whole image's noise [N, 1, H, W] (``None``
        kept)."""
        if noise is None or self.group is None:
            return noise
        return take_rows(noise, self.group, 2)

    def whole_sum(self):
        """Sums over this rank's rows -> the whole image's (an all-reduce
        whose backward is one too), ``None`` for a whole image."""
        if self.group is None:
            return None
        return lambda sums: all_sum_grad(sums, self.group)

    def moments(self, x):
        return basic.instance_moments(x, self.whole_sum(), self.total(x) * x.shape[3])

    def instance_norm(self, x):
        return basic.instance_norm(x, whole_sum=self.whole_sum(), count=self.total(x) * x.shape[3])

    def conv(self, module, x):
        """An ``EqConv`` (not transposed) or a plain ``nn.Conv2d`` (square
        kernel, the same stride and padding on both axes: ``plain_conv``'s)
        on the rows; a 1x1 convolution is local."""
        if self.group is None or module.weight.shape[2] == 1:
            return module(x)
        if isinstance(module, nn.Conv2d):
            return conv2d_rows(x, module.weight, module.bias, module.stride[0], module.padding[0], self.group)
        w = transform_kernel_2d(module.weight, average=True) if module.transform_kernel else module.weight
        return conv2d_rows(x, w, module.bias, module.stride, module.padding, self.group)

    def max_pool(self, x):
        """VGG16's 2x2 max pool, local on shards of even rows."""
        if self.group is not None and x.shape[2] % 2:
            raise ValueError(f"a 2x2 max pool does not run on shards of {x.shape[2]} rows")
        return F.max_pool2d(x, 2)

    def gather(self, x) -> tuple[torch.Tensor, "RowOps"]:
        """``(x whole on every rank, the plain ops)``: a level too thin to
        shard (:func:`runs_on_rows`) and the rest of the network after it."""
        if self.group is None:
            return x, self
        return all_gather_rows(x, self.group), RowOps()

    def blur(self, x):
        if self.group is None:
            return upfirdn.blur3x3(x)
        return upfirdn.blur3x3_rows(halo_rows(x, 1, 1, self.group))


def crop_rows(x: torch.Tensor, rows: Rows, lo: int, hi: int, dim: int = 1):
    """This rank's part of the whole image's rows ``[lo, hi)`` from its
    rows ``x`` (``dim`` is H): ``(piece, its Rows in the crop)``; the piece
    may be empty."""
    h = x.shape[dim]
    a = min(max(lo - rows.start, 0), h)
    b = min(max(hi - rows.start, 0), h)
    return x.narrow(dim, a, b - a), Rows(rows.group, min(max(rows.start + a, lo), hi) - lo, hi - lo)


def gather(x: torch.Tensor, rows: Rows, dim: int = 1) -> torch.Tensor:
    """The whole tensor on every rank from each rank's ``rows``
    (``parallel.mesh.all_gather_rows``)."""
    return all_gather_rows(x, rows.group, rows.start, rows.total, dim)
