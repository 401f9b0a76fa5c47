"""Device selection, numerics settings and the process group.

The port never falls back to the CPU on its own: an entry point runs on
``cuda`` unless the caller asks for ``cpu``, and raises if no GPU is there.
A data-parallel run is one process per GPU (``torchrun``, or
:func:`init_distributed` with an explicit group).
"""

from __future__ import annotations

import os

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises when CUDA is asked for
    and absent (pass ``device="cpu"`` to run on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def parity_mode() -> None:
    """Full-fp32 matmuls and convolutions on the GPU.

    cuDNN runs fp32 convolutions in TF32 by default (about three decimal
    digits), which is too coarse to compare against the fp32 reference.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name, "")
    return int(value) if value.strip() else default


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
) -> bool:
    """Join this process to a group of processes, one per GPU
    (``torch.distributed.init_process_group``; counterpart of tpugan's
    ``jax.distributed.initialize``), so that ``parallel.auto_mesh`` spans
    them all.

    ``backend`` defaults to ``nccl`` where CUDA is available, else ``gloo``.
    With no arguments the group comes from torchrun's environment
    (``env://``: ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``); ``coordinator_address`` (``host:port``, or a URL such as
    ``tcp://...`` or ``file://...``), ``num_processes`` and ``process_id``
    give it explicitly. On CUDA each process takes the card
    ``LOCAL_RANK % device_count``. Returns True when a group of more than
    one process came up (or was already up), False for a single process.

    Failure rule (tpugan's): where the caller or the environment describes a
    group of more than one process, a failure raises, since falling back
    would leave N independent jobs running; a single process that cannot
    start a group returns False quietly."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size() > 1
    env_world = _env_int("WORLD_SIZE", 1)
    world = num_processes if num_processes is not None else env_world
    rank = process_id if process_id is not None else _env_int("RANK", 0)
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    try:
        if torch.cuda.is_available() and torch.cuda.device_count():
            torch.cuda.set_device(_env_int("LOCAL_RANK", rank) % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    except Exception as e:
        explicit_group = coordinator_address is not None or (num_processes or 0) > 1
        if explicit_group or env_world > 1:
            raise RuntimeError(
                "init_distributed: torch.distributed.init_process_group failed for a group of "
                f"{world} processes; refusing to fall back to independent single-process jobs "
                f"({type(e).__name__}: {e})"
            ) from e
        print(f"init_distributed: single-process fallback ({type(e).__name__}: {e})")
        return False
    n = dist.get_world_size()
    if n > 1:
        print(f"init_distributed: {n} processes over {backend}")
    return n > 1


def is_primary_host() -> bool:
    """True on rank 0 of the process group, and where there is no group.
    The CLIs gate their writes (the loss log, the grids, the checkpoints)
    on it, so that the processes of a group do not race on the same
    files."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0
