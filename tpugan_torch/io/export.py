"""Ahead-of-time export of the port's functions (serving artifacts;
counterpart of ``tpugan/io/export.py``).

``torch.export`` traces a function into an ATen graph, and
``torch.export.save`` writes it, with its weights, into one file. The
port's kernels are PyTorch operators (``torch.ops.tpugan_torch.*``,
registered by ``tpugan_torch.ops``), so each FIR and attention call is one
node of the graph, and a loaded artifact launches the same hand-written
kernels. A tpugan artifact carries its Pallas kernels as custom calls in
its StableHLO; a port artifact carries ``tpugan_torch::*`` nodes, so
**loading one needs only the operators' registrations**: this module
imports ``tpugan_torch.ops`` and nothing of ``models``, ``train`` or
``cli``::

    synth = lambda w: resynth(w, None, noise)       # G closed over
    blob = export_jit(synth, w_example, modules=[gen])
    ...ship blob...
    f = load_exported(blob)                         # callable, no model code
    imgs = f(w)

Artifacts are shape-specialised, as tpugan's are: a call with another shape
raises. An artifact holds one device's weights, so it runs on the device
it was exported on (``platforms``): tpugan's dual-platform artifact has no
counterpart here.
"""

from __future__ import annotations

import io
from typing import Callable, Iterable, Optional, Sequence

import torch

import tpugan_torch.ops  # noqa: F401  (registers the operators an artifact calls)

PLATFORMS = ("cuda", "cpu")


class _Program(torch.nn.Module):
    """``fn`` as a module whose submodules are the modules it reads, so that
    their parameters and buffers are the exported program's state, not
    constants lifted out of the trace."""

    def __init__(self, fn: Callable, modules: Iterable[torch.nn.Module]):
        super().__init__()
        self.fn = fn
        self.held = torch.nn.ModuleList(modules)

    def forward(self, *args):
        return self.fn(*args)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def export_platform(example_args, platforms: Optional[Sequence[str]] = None) -> str:
    """The one device an artifact is exported for: ``platforms`` (``cuda``
    or ``cpu``, one of them) where given, else the example inputs' device.
    Raises on two platforms, an unknown one, or examples on another
    device."""
    if isinstance(platforms, str):
        platforms = (platforms,)
    devices = {t.device.type for t in _tensors(example_args)}
    if len(devices) > 1:
        raise ValueError(f"the example inputs lie on several devices: {sorted(devices)}")
    if not platforms:
        return devices.pop() if devices else "cpu"
    if len(set(platforms)) != 1:
        raise ValueError(f"one platform per artifact, got {list(platforms)}: a torch.export artifact holds "
                         "one device's weights (tpugan's dual-platform artifact has no counterpart)")
    platform = platforms[0]
    if platform not in PLATFORMS:
        raise ValueError(f"unknown platform {platform!r}; use one of {PLATFORMS}")
    if devices and devices != {platform}:
        raise ValueError(f"exporting for {platform}, but the example inputs lie on {devices.pop()}")
    return platform


def export_program(fn: Callable, *example_args, platforms: Optional[Sequence[str]] = None,
                   modules: Iterable[torch.nn.Module] = ()) -> torch.export.ExportedProgram:
    """``fn(*example_args)`` traced into a ``torch.export.ExportedProgram``.

    ``fn`` is an ``nn.Module`` or a function; name the modules a function
    reads in ``modules`` so that their weights are the artifact's state.
    Traced under ``torch.no_grad()`` by ``torch.export.export(...,
    strict=False)``: no kernel runs and nothing is counted."""
    export_platform(example_args, platforms)
    program = fn if isinstance(fn, torch.nn.Module) else _Program(fn, modules)
    with torch.no_grad():
        return torch.export.export(program, tuple(example_args), strict=False)


def serialise(program: torch.export.ExportedProgram) -> bytes:
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def export_jit(fn: Callable, *example_args, platforms: Optional[Sequence[str]] = None,
               modules: Iterable[torch.nn.Module] = ()) -> bytes:
    """Serialise ``fn(*example_args)`` to an artifact (bytes):
    :func:`export_program`, then ``torch.export.save``."""
    return serialise(export_program(fn, *example_args, platforms=platforms, modules=modules))


def load_program(data: bytes) -> torch.export.ExportedProgram:
    """The ``torch.export.ExportedProgram`` of an artifact (its graph and
    state)."""
    return torch.export.load(io.BytesIO(data))


def load_exported(data: bytes) -> Callable:
    """Deserialise an :func:`export_jit` artifact into a callable."""
    return load_program(data).module()


def save_exported(path: str, fn: Callable, *example_args, **kw) -> None:
    with open(path, "wb") as f:
        f.write(export_jit(fn, *example_args, **kw))


def load_exported_file(path: str) -> Callable:
    with open(path, "rb") as f:
        return load_exported(f.read())


def operator_nodes(program: torch.export.ExportedProgram) -> dict:
    """How many nodes of each ``tpugan_torch`` operator the program's graph
    holds, by operator name (``upfirdn2d``, ``sagan_attention``, ...)."""
    counts: dict = {}
    for node in program.graph.nodes:
        target = getattr(node.target, "_schema", None)
        if node.op == "call_function" and target is not None and target.name.startswith("tpugan_torch::"):
            name = target.name.split("::", 1)[1]
            counts[name] = counts.get(name, 0) + 1
    return counts
