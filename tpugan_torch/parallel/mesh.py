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
the parameters' gradients). The ``space`` axis (image height across ranks)
is ROADMAP A item 10: :data:`SPACE_AXIS_TODO` is what asking for it raises.

With ``group=None`` every collective here is the identity, so a path
without a mesh runs the one-process code.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

DATA_AXIS = "data"
SPACE_AXIS = "space"
SPACE_AXIS_TODO = ("the space axis (image height sharded across ranks: --space_shards > 1, spatial=True) "
                   "comes with ROADMAP A item 10 (spatial parallelism)")


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


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def shard_batch(mesh, batch, spatial: bool = False):
    """This rank's rows of a global batch: a tensor, or a tuple, list or
    NamedTuple of them (``None`` kept), each split along dim 0 over the data
    axis. The batch as it is without a mesh."""
    if spatial:
        raise NotImplementedError(SPACE_AXIS_TODO)
    if mesh is None:
        return batch
    group = data_group(mesh)
    n, rank = group_size(group), dist.get_rank(group)

    def rows(x):
        if x is None:
            return None
        if isinstance(x, torch.Tensor):
            if x.shape[0] % n:
                raise ValueError(f"a batch of {x.shape[0]} does not split over {n} ranks")
            share = x.shape[0] // n
            return x[rank * share:(rank + 1) * share]
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(rows(v) for v in x))
        if isinstance(x, (tuple, list)):
            return type(x)(rows(v) for v in x)
        raise TypeError(f"cannot shard a {type(x).__name__}")

    return rows(batch)


def replicate(mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast ``module``'s parameters and buffers from the mesh's first
    rank over its data axis, in place (tpugan's replicated placement).
    ``module`` as it is without a mesh."""
    if mesh is None:
        return module
    group = data_group(mesh)
    src = int(mesh.mesh.flatten()[0])
    with torch.no_grad():
        for t in [*module.parameters(), *module.buffers()]:
            dist.broadcast(t.data, src=src, group=group)
    return module


def barrier(mesh) -> None:
    """Wait for every rank of ``mesh``'s data axis (no-op without one)."""
    if mesh is not None:
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


def average_gradients(grads, group, replicated: bool = True):
    """A gradient list (``None`` kept) of one rank's share of the loss ->
    the global loss's gradient: summed over the ranks and divided by their
    count for ``replicated`` parameters, divided alone for a rank's own
    tensors (its rows of w). One all-reduce for the whole list."""
    if group is None:
        return grads
    n = group_size(group)
    present = [g for g in grads if g is not None]
    if not present:
        return grads
    if replicated:
        flat = torch.cat([g.reshape(-1) for g in present])
        dist.all_reduce(flat, group=group)
        present = [p.view_as(g) for p, g in zip(flat.split([g.numel() for g in present]), present)]
    out, it = [], iter(present)
    for g in grads:
        out.append(None if g is None else next(it) / n)
    return out
