"""The threaded PNG loader (counterpart of ``tpugan/io/native.py``).

tpugan's native loader decodes PNGs with libpng and resizes them bilinearly
with aligned corners and no antialias. Here PIL decodes each file to 8-bit
RGB (PNG is lossless, so these are libpng's pixels) in ``n_threads``
threads, and ``csrc/image_io.cpp``, tpugan's resize in C++, resizes the
batch in worker threads into a float32 NHWC buffer: the port's real-image
CLIs read tpugan's pixels, and the port needs no libpng. The library is
built with ``g++`` at first use (``ops/cuda.py``'s
:data:`~tpugan_torch.ops.cuda.HOST_LIBRARIES`) and bound with
:mod:`ctypes`.

Unlike tpugan, nothing falls back quietly: where the library cannot build
or load, the loaders raise with the compiler's log, because PIL's resize
gives other pixels (up to 0.305 on [0, 1] at 40 -> 32 px). A directory that
holds a JPEG goes through :func:`~tpugan_torch.io.image.load_image_dir`
(PIL), as in tpugan. :func:`load_png_batch_plain` is the plain version:
the same decode and the library's resize arithmetic in numpy.
"""

from __future__ import annotations

import ctypes
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from tpugan_torch.ops import cuda

LIBRARY = "image_io"
_bound = None


def _lib() -> ctypes.CDLL:
    """The resize library with its entry points typed; raises if it cannot
    build or load."""
    global _bound
    if _bound is None:
        lib = cuda.host_library(LIBRARY)
        lib.tg_resize_rgb8.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                       ctypes.c_int, ctypes.c_int]
        lib.tg_resize_rgb8.restype = ctypes.c_int
        lib.tg_resize_batch.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
                                        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
        lib.tg_resize_batch.restype = ctypes.c_int
        _bound = lib
    return _bound


def available() -> bool:
    """Whether the library builds and loads here (a C++ compiler)."""
    try:
        _lib()
    except (RuntimeError, OSError):
        return False
    return True


def decode_rgb8(path) -> np.ndarray:
    """A PNG -> [H, W, 3] uint8, as libpng reads it (palette and gray
    expanded, alpha stripped, 16 bits cut to the high byte); raises
    ``IOError`` where the file cannot be read."""
    from PIL import Image

    try:
        with Image.open(path) as img:
            if img.mode.startswith("I;16"):
                gray = (np.asarray(img).astype(np.uint16) >> 8).astype(np.uint8)
                return np.ascontiguousarray(np.repeat(gray[..., None], 3, axis=-1))
            return np.ascontiguousarray(np.asarray(img.convert("RGB")))
    except (OSError, SyntaxError, ValueError) as e:
        raise IOError(f"cannot decode {path}: {e}") from e


def _decode_all(paths, n_threads: int) -> list:
    with ThreadPoolExecutor(max(1, min(n_threads, len(paths)))) as pool:
        return list(pool.map(decode_rgb8, paths))


def load_png_batch(paths, size: int, n_threads: int = 8) -> np.ndarray:
    """PNG paths -> [N, size, size, 3] float32 in [0, 1], decoded and
    resized in ``n_threads`` threads; raises ``IOError`` if a file cannot
    be read."""
    lib = _lib()
    images = _decode_all(paths, n_threads) if len(paths) else []
    n = len(images)
    out = np.empty((n, size, size, 3), dtype=np.float32)
    ptrs = (ctypes.c_void_p * n)(*[im.ctypes.data for im in images])
    heights = (ctypes.c_int * n)(*[im.shape[0] for im in images])
    widths = (ctypes.c_int * n)(*[im.shape[1] for im in images])
    rc = lib.tg_resize_batch(ptrs, heights, widths, n, size, size, out.ctypes.data, n_threads)
    if rc != 0:
        raise IOError(f"native resize failed (code {rc})")
    return out


def _image_files(path) -> list:
    files = sorted(os.path.join(path, f) for f in os.listdir(path)
                   if f.lower().endswith((".png", ".jpg", ".jpeg")))
    if not files:
        raise FileNotFoundError(f"no images under {path}")
    return files


def load_image_dir_fast(path, size: int, n_threads: int = 8) -> np.ndarray:
    """Directory -> [N, size, size, 3] in [0, 1], sorted by file name:
    through the library where every image is a PNG, else through PIL
    (:func:`~tpugan_torch.io.image.load_image_dir`)."""
    files = _image_files(path)
    if all(f.lower().endswith(".png") for f in files):
        return load_png_batch(files, size, n_threads)
    from tpugan_torch.io.image import load_image_dir

    return load_image_dir(path, size)


def resize_plain(rgb: np.ndarray, size: int) -> np.ndarray:
    """[H, W, 3] uint8 -> [size, size, 3] float32 in [0, 1]: the library's
    bilinear resize (aligned corners, no antialias), its fp32 operations in
    its order."""
    h, w = rgb.shape[:2]
    f32 = np.float32

    def axis(n_in):
        scale = f32(n_in - 1) / f32(size - 1) if n_in > 1 and size > 1 else f32(0.0)
        pos = np.arange(size, dtype=f32) * scale
        i0 = pos.astype(np.int64)
        return i0, np.minimum(i0 + 1, n_in - 1), pos - i0.astype(f32)

    y0, y1, wy = axis(h)
    x0, x1, wx = axis(w)
    v = rgb.astype(f32)
    wx = wx[None, :, None]
    top = v[y0][:, x0] + (v[y0][:, x1] - v[y0][:, x0]) * wx
    bot = v[y1][:, x0] + (v[y1][:, x1] - v[y1][:, x0]) * wx
    return (top + (bot - top) * wy[:, None, None]) / f32(255.0)


def load_png_batch_plain(paths, size: int) -> np.ndarray:
    """The plain version of :func:`load_png_batch`: :func:`decode_rgb8`
    and :func:`resize_plain`, one image after the other."""
    return np.stack([resize_plain(decode_rgb8(p), size) for p in paths])
