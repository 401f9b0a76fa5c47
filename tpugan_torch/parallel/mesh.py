"""Process mesh and the data-parallel collectives (counterpart of
``tpugan/parallel/mesh.py``).

tpugan shards a step's batch over the ``data`` axis of a device mesh and
XLA runs one global program. Here each GPU is a process (``torchrun``,
``runtime.init_distributed``) and the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over process ranks, with
dimension names ``("data", "space")``. A rank draws the global batch and
keeps its rows (:func:`shard_batch`); the ``make_*_step`` functions take the mesh and
sum each batch-coupled reduction over the data group, so that a step with a
mesh computes the one-process step on the global batch (the cosine
distance's dot products, the logged statistics, Grad-CAM's majority class,
the parameters' gradients).

The ``space`` axis shards image height across the ranks of a space group
(:func:`space_group`): each rank holds its rows of every image-shaped tensor
on the encoder side and in the losses (``parallel/spatial.py``), and the
step computes the one-process step on the global batch. Its collectives are
:func:`halo_rows` (a convolution's rows from the neighbours) and
:func:`all_gather_rows` (a level too thin to shard), both differentiable.
Every rank of a space group differentiates its share of the loss, the
loss over the group's size, and each collective's backward is its
transpose, so the shares' gradients sum to the loss's. The space axis on
``e_mis_align``, E_PG and E_BIG (mtypes 3 and 4) is ROADMAP A 1's part 2:
:data:`SPACE_AXIS_PART2` is what asking for it raises.

With ``group=None`` every collective here is the identity, so a path
without a mesh runs the one-process code. Every collective is an
all-reduce or a broadcast, the only ones gloo offers on CUDA tensors, so
one code path serves gloo and NCCL.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

DATA_AXIS = "data"
SPACE_AXIS = "space"
SPACE_AXIS_PART2 = ("the space axis (spatial parallelism: --space_shards > 1, spatial=True) runs e_align and "
                    "embedding on StyleGANv1 and StyleGAN2 (mtypes 1 and 2); e_mis_align's Grad-CAM over rows, "
                    "BigGAN/E_BIG (mtype 4) and PGGAN/E_PG (mtype 3) come with ROADMAP A 1's part 2")


def _world() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def make_mesh(ranks: Optional[Sequence[int]] = None, space: int = 1, device_type: str = "cuda"):
    """The (data, space) mesh over process ``ranks`` (every rank of the
    group by default) on ``device_type`` ("cpu" for a run on the CPU).
    Every rank of the group must call it, also those it leaves out (their
    coordinate is ``None``)."""
    from torch.distributed.device_mesh import DeviceMesh

    ranks = list(range(_world()) if ranks is None else ranks)
    n = len(ranks)
    assert n % space == 0, f"{n} ranks not divisible by space={space}"
    layout = torch.tensor(ranks, dtype=torch.int).reshape(n // space, space)
    return DeviceMesh(device_type, layout, mesh_dim_names=(DATA_AXIS, SPACE_AXIS))


def mesh_shape(batch_size: int, devices: int, space: int = 1) -> Optional[tuple[int, int]]:
    """tpugan's ``auto_mesh`` arithmetic: the data axis is the largest
    divisor of ``batch_size`` that fits ``devices // space``; ``None`` where
    that leaves one device. Prints tpugan's note where some are left out."""
    if space > devices:
        raise ValueError(f"space={space} exceeds {devices} available devices")
    data_room = devices // space
    data = max(d for d in range(1, min(batch_size, data_room) + 1) if batch_size % d == 0)
    used = data * space
    if used == 1:
        return None
    if used < devices:
        print(f"note: mesh uses {used} of {devices} devices "
              f"(data={data} x space={space}; batch {batch_size} "
              f"constrains the data axis to its largest divisor)")
    return data, space


def auto_mesh(batch_size: int, space: int = 1, ranks: Optional[Sequence[int]] = None,
              device_type: str = "cuda"):
    """The largest mesh the batch can fill over the group's ranks (one per
    GPU), or ``None`` where one rank would be used (also without a group).
    Ranks past the mesh take no part in the step: :func:`takes_part`."""
    ranks = list(range(_world()) if ranks is None else ranks)
    shape = mesh_shape(batch_size, len(ranks), space)
    if shape is None:
        return None
    return make_mesh(ranks[:shape[0] * shape[1]], space=space, device_type=device_type)


def takes_part(mesh) -> bool:
    """Whether this process runs the step: a member of ``mesh``, or rank 0
    where there is no mesh."""
    if mesh is None:
        return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0
    return mesh.get_coordinate() is not None


def data_group(mesh):
    """The process group of ``mesh``'s data axis (``None`` without a mesh)."""
    return None if mesh is None else mesh.get_group(DATA_AXIS)


def space_group(mesh):
    """The process group of ``mesh``'s space axis (``None`` without a mesh)."""
    return None if mesh is None else mesh.get_group(SPACE_AXIS)


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def take_rows(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's equal share of ``x`` along ``dim`` over ``group`` (rank
    order); ``x`` as it is without a group. Differentiable (the backward
    pads with zeros)."""
    n = group_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"{x.shape[dim]} rows do not split over {n} ranks")
    share = x.shape[dim] // n
    return x.narrow(dim, group_rank(group) * share, share)


def shard_batch(mesh, batch, spatial: bool = False, h_dim: int = 1):
    """This rank's rows of a global batch: a tensor, or a tuple, list or
    NamedTuple of them (``None`` kept), each split along dim 0 over the data
    axis and, with ``spatial``, then along ``h_dim`` over the space axis
    (images NHWC: 1; the encoder's noise NCHW: 2). The batch as it is
    without a mesh."""
    if mesh is None:
        return batch
    group = data_group(mesh)

    def rows(x):
        if x is None:
            return None
        if isinstance(x, torch.Tensor):
            x = take_rows(x, group, 0)
            return take_rows(x, space_group(mesh), h_dim) if spatial else x
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(rows(v) for v in x))
        if isinstance(x, (tuple, list)):
            return type(x)(rows(v) for v in x)
        raise TypeError(f"cannot shard a {type(x).__name__}")

    return rows(batch)


def replicate(mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast ``module``'s parameters and buffers from the mesh's first
    rank to every rank of the mesh, in place (tpugan's replicated
    placement): along the space axis from each row's first rank, then along
    the data axis from the first row. ``module`` as it is without a mesh."""
    if mesh is None:
        return module
    layout = mesh.mesh.reshape(-1, mesh.mesh.shape[-1])
    row, col = mesh.get_coordinate()
    with torch.no_grad():
        for t in [*module.parameters(), *module.buffers()]:
            dist.broadcast(t.data, src=int(layout[row, 0]), group=space_group(mesh))
            dist.broadcast(t.data, src=int(layout[0, col]), group=data_group(mesh))
    return module


def barrier(mesh) -> None:
    """Wait for every rank of ``mesh`` (no-op without one): its space
    axis, then its data axis."""
    if mesh is not None:
        dist.barrier(group=space_group(mesh))
        dist.barrier(group=data_group(mesh))


def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group's ranks, without gradient."""
    if group is None:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, group=group)
    return x


def all_sum_grad(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group's ranks, differentiable: its backward
    sums the incoming gradient over the ranks too, so a term of the loss
    that every rank computes from the sum reaches each rank's inputs once
    per rank (:func:`average_gradients` divides that back out)."""
    if group is None:
        return x
    import torch.distributed.nn.functional as dist_nn

    return dist_nn.all_reduce(x, group=group)


def all_min(x: torch.Tensor, group) -> torch.Tensor:
    if group is None:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, op=dist.ReduceOp.MIN, group=group)
    return x


def batch_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean over the group's ranks of a per-rank mean (equal shares)."""
    return x if group is None else all_sum(x, group) / group_size(group)


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The global batch of a per-rank tensor, rows in rank order (the
    inverse of :func:`shard_batch`), without gradient; an all-reduce of
    zero-padded copies, so it takes only the collective that gloo offers on
    CUDA tensors."""
    if group is None:
        return x
    n, rank = group_size(group), dist.get_rank(group)
    share = x.shape[0]
    full = x.new_zeros((share * n,) + tuple(x.shape[1:]))
    full[rank * share:(rank + 1) * share] = x.detach()
    dist.all_reduce(full, group=group)
    return full


def average_gradients(grads, group, replicated: bool = True, space=None):
    """A gradient list (``None`` kept) of one rank's share of the loss ->
    the global loss's gradient: summed over the ``space`` group (its ranks'
    shares of one data rank's loss), then summed over the data ``group``
    and divided by its size for ``replicated`` parameters, divided alone for
    a data rank's own tensors (its rows of w). One all-reduce a group for
    the whole list."""
    if group is None and space is None:
        return grads
    present = [g for g in grads if g is not None]
    if not present:
        return grads
    flat = torch.cat([g.reshape(-1) for g in present])
    for reduce_over in ((space,) if space is not None else ()) + ((group,) if replicated and group is not None else ()):
        dist.all_reduce(flat, group=reduce_over)
    present = [p.view_as(g) for p, g in zip(flat.split([g.numel() for g in present]), present)]
    n = group_size(group)
    out, it = [], iter(present)
    for g in grads:
        out.append(None if g is None else next(it) / n)
    return out


class _HaloRows(torch.autograd.Function):
    """:func:`halo_rows`; the backward sends each halo row's gradient back
    to its owner, which adds it to its own."""

    @staticmethod
    def forward(ctx, x, above, below, group, dim):
        n, rank = group_size(group), group_rank(group)
        h = x.shape[dim]
        if h < max(above, below):
            raise ValueError(f"a halo of {above} + {below} rows needs shards of as many rows, got {h}")
        ctx.geometry = (above, below, group, dim, h)
        xt = x.movedim(dim, 0)
        slots = xt.new_zeros((n, above + below) + tuple(xt.shape[1:]))
        slots[rank, :above] = xt[h - above:]  # to the rank below, as its top halo
        slots[rank, above:] = xt[:below]  # to the rank above, as its bottom halo
        dist.all_reduce(slots, group=group)
        top = slots[rank - 1, :above] if rank > 0 else xt.new_zeros((above,) + tuple(xt.shape[1:]))
        bottom = slots[rank + 1, above:] if rank + 1 < n else xt.new_zeros((below,) + tuple(xt.shape[1:]))
        return torch.cat([top, xt, bottom]).movedim(0, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        above, below, group, dim, h = ctx.geometry
        n, rank = group_size(group), group_rank(group)
        gt = g.movedim(dim, 0)
        slots = gt.new_zeros((n, above + below) + tuple(gt.shape[1:]))
        if rank > 0:
            slots[rank - 1, :above] = gt[:above]
        if rank + 1 < n:
            slots[rank + 1, above:] = gt[above + h:]
        dist.all_reduce(slots, group=group)
        out = gt[above:above + h].clone()
        out[h - above:] += slots[rank, :above]
        out[:below] += slots[rank, above:]
        return out.movedim(0, dim).contiguous(), None, None, None, None


def halo_rows(x: torch.Tensor, above: int, below: int, group, dim: int = 2) -> torch.Tensor:
    """This rank's rows of ``x`` (equal shares along ``dim`` over ``group``,
    rank order) with ``above`` rows of the rank before it on top and
    ``below`` rows of the rank after it underneath; zero rows at the image's
    true top and bottom edges, as a convolution's zero padding. One
    all-reduce forward and one backward, whose halo gradients return to
    their owners and add there. ``x`` as it is without a group."""
    if group is None:
        return x
    return _HaloRows.apply(x, above, below, group, dim)


class _GatherRows(torch.autograd.Function):
    """:func:`all_gather_rows`; its backward is the gather's transpose:
    the incoming gradients summed over the group, this rank's rows of it."""

    @staticmethod
    def forward(ctx, x, group, start, total, dim):
        ctx.geometry = (group, start, x.shape[dim], dim)
        shape = list(x.shape)
        shape[dim] = total
        full = x.new_zeros(shape)
        full.narrow(dim, start, x.shape[dim]).copy_(x)
        dist.all_reduce(full, group=group)
        return full

    @staticmethod
    def backward(ctx, g):
        group, start, h, dim = ctx.geometry
        g = g.contiguous().clone()
        dist.all_reduce(g, group=group)
        return g.narrow(dim, start, h).contiguous(), None, None, None, None


def all_gather_rows(x: torch.Tensor, group, start: int | None = None, total: int | None = None,
                    dim: int = 2) -> torch.Tensor:
    """The whole tensor on every rank of ``group`` from each rank's rows
    ``[start, start + x.shape[dim])`` of ``total`` (by default equal shares
    in rank order; a crop's shares may differ or be empty): an all-reduce of
    zero-padded copies, differentiable. Each rank's share of the loss reads
    the result alike, so the backward sums their gradients and keeps this
    rank's rows. ``x`` as it is without a group."""
    if group is None:
        return x
    h = x.shape[dim]
    if start is None:
        start, total = group_rank(group) * h, h * group_size(group)
    return _GatherRows.apply(x, group, start, total, dim)
