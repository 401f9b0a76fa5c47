"""Build and load the port's native libraries (``tpugan_torch/csrc``).

Each CUDA source (``*.cu``) is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with plain C entry points and loaded with :mod:`ctypes` (no
PyTorch headers, so a build takes seconds). A kernel is one entry point;
several kernels may share a source and so a library; sources share the
headers (``*.cuh``) beside them. Host C++ sources (``*.cpp``,
:data:`HOST_LIBRARIES`: the PNG loader) are built the same way with ``g++``
and their link flags. Libraries go to ``tpugan_torch/_build/`` under a name
that hashes the source, the headers and the flags, so an edited source or
header is rebuilt. Nothing is built at import: :func:`build` runs on first
use, or ahead of it.

``launches`` counts, per kernel, the launches its wrapper made, so a run can
show that its path went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")

_c_int = ctypes.c_int
_c_ptr = ctypes.c_void_p
# kernel name -> (source, C symbol, argtypes)
KERNELS = {
    "upfirdn2d": (
        "upfirdn2d.cu",
        "tpugan_upfirdn2d_f32",
        [_c_ptr, _c_ptr, ctypes.c_int64] + [_c_int] * 10 + [_c_ptr, _c_ptr, _c_int, _c_ptr],
    ),
    # the same kernel on bf16 tensors (fp32 taps and sums)
    "upfirdn2d_bf16": (
        "upfirdn2d.cu",
        "tpugan_upfirdn2d_bf16",
        [_c_ptr, _c_ptr, ctypes.c_int64] + [_c_int] * 10 + [_c_ptr, _c_ptr, _c_int, _c_ptr],
    ),
    "sagan_attention": (
        "sagan_attention.cu",
        "tpugan_sagan_attention_f32",
        [_c_ptr] * 5 + [_c_int] * 6 + [_c_ptr],
    ),
    "sagan_attention_bwd_pack": (
        "sagan_attention_bwd.cu",
        "tpugan_sagan_attention_bwd_pack_f32",
        [_c_ptr] * 5 + [_c_int] * 6 + [_c_ptr],
    ),
    "sagan_attention_bwd_dq": (
        "sagan_attention_bwd.cu",
        "tpugan_sagan_attention_bwd_dq_f32",
        [_c_ptr] * 6 + [_c_int] * 6 + [_c_ptr],
    ),
    "sagan_attention_bwd_dkv": (
        "sagan_attention_bwd.cu",
        "tpugan_sagan_attention_bwd_dkv_f32",
        [_c_ptr] * 3 + [_c_int] * 6 + [_c_ptr],
    ),
    # the attention kernels on bf16 q, k, v, o, do and gradients (fp32 lse,
    # delta, workspace and sums)
    "sagan_attention_bf16": (
        "sagan_attention.cu",
        "tpugan_sagan_attention_bf16",
        [_c_ptr] * 5 + [_c_int] * 6 + [_c_ptr],
    ),
    "sagan_attention_bwd_pack_bf16": (
        "sagan_attention_bwd.cu",
        "tpugan_sagan_attention_bwd_pack_bf16",
        [_c_ptr] * 5 + [_c_int] * 6 + [_c_ptr],
    ),
    "sagan_attention_bwd_dq_bf16": (
        "sagan_attention_bwd.cu",
        "tpugan_sagan_attention_bwd_dq_bf16",
        [_c_ptr] * 6 + [_c_int] * 6 + [_c_ptr],
    ),
    "sagan_attention_bwd_dkv_bf16": (
        "sagan_attention_bwd.cu",
        "tpugan_sagan_attention_bwd_dkv_bf16",
        [_c_ptr] * 3 + [_c_int] * 6 + [_c_ptr],
    ),
}
# C functions that launch nothing: name -> (source, C symbol, argtypes, restype)
HELPERS = {
    "sagan_attention_bwd_workspace": (
        "sagan_attention_bwd.cu",
        "tpugan_sagan_attention_bwd_workspace_floats",
        [_c_int] * 5,
        ctypes.c_int64,
    ),
    "sagan_attention_last_instance": (
        "sagan_attention.cu",
        "tpugan_sagan_attention_last_instance",
        [ctypes.POINTER(_c_int)],
        None,
    ),
}

# host C++ libraries: name -> (source, link flags), built with g++
HOST_LIBRARIES = {
    "image_io": ("image_io.cpp", ("-lpthread",)),
}

launches = {name: 0 for name in KERNELS}

_funcs: dict = {}
_libs: dict = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin)")


def cxx_path() -> str:
    found = shutil.which(os.environ.get("CXX", "g++"))
    if found:
        return found
    raise RuntimeError("no C++ compiler found (looked for $CXX, else g++, on PATH)")


def _source(name: str) -> tuple[str, tuple]:
    """(source file, link flags) of kernel, helper or host library ``name``."""
    if name in HOST_LIBRARIES:
        return HOST_LIBRARIES[name]
    return {**KERNELS, **HELPERS}[name][0], ()


def library_path(name: str) -> Path:
    """The library that holds kernel, helper or host library ``name``: one
    per source, named by a hash of the source, the headers beside a CUDA
    source and the flags."""
    source, libs = _source(name)
    path = CSRC / source
    if path.suffix == ".cpp":
        extra, flags = b"", CXX_FLAGS + libs
    else:
        extra, flags = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh"))), NVCC_FLAGS
    digest = hashlib.sha256(path.read_bytes() + extra + " ".join(flags).encode())
    return BUILD_DIR / f"lib{path.stem}-{digest.hexdigest()[:16]}.so"


def _command(source: str, libs: tuple, out: Path) -> list:
    if source.endswith(".cpp"):
        return [cxx_path(), *CXX_FLAGS, "-o", str(out), str(CSRC / source), *libs]
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(CSRC / source)]


def build(names=None) -> dict[str, str]:
    """Compile the sources of the named kernels (all by default) or host
    libraries that are not built yet, one compiler per source, all started
    together. Returns the compiler's output by source (``nvcc -Xptxas -v``:
    registers, shared memory, spills); raises with the log if any build
    fails."""
    names = list(KERNELS) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in names:
        source, libs = _source(name)
        out = library_path(name)
        if source in running or out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(_command(source, libs, tmp), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[source] = (proc, tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in running.items():
        logs[name], _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing
        else:
            failed.append(name)
    if failed:
        raise RuntimeError(
            "the build failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[name] for name in failed)
        )
    return logs


def host_library(name: str) -> ctypes.CDLL:
    """Host library ``name`` of :data:`HOST_LIBRARIES`, built and loaded on
    first use; raises if it cannot build or load."""
    with _lock:
        path = library_path(name)
        lib = _libs.get(path)
        if lib is None:
            build([name])
            lib = _libs[path] = ctypes.CDLL(str(path))
    return lib


def kernel(name: str):
    """The C entry point of kernel ``name``, built and loaded on first use."""
    return _function(name, *KERNELS[name][1:], ctypes.c_int)


def helper(name: str):
    """The C function ``name`` of HELPERS, built and loaded on first use."""
    return _function(name, *HELPERS[name][1:])


def _function(name, symbol, argtypes, restype):
    with _lock:
        fn = _funcs.get(name)
        if fn is None:
            build([name])
            path = library_path(name)
            lib = _libs.get(path)
            if lib is None:
                lib = _libs[path] = ctypes.CDLL(str(path))
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = restype
            _funcs[name] = fn
    return fn
