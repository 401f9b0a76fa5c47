"""tpugan_torch's PNG loader (``io/native.py``, ``csrc/image_io.cpp``) vs
tpugan's native loader (``tpugan/io/native.py``, libpng) (CPU).

The port decodes with PIL and resizes with its C++ library, tpugan's resize
arithmetic (aligned corners, no antialias, fp32); tpugan decodes with
libpng. Both are held bitwise: at the images' own size and at a resize, for
every PNG colour type PIL and libpng read alike, with 1 and 8 threads. The
plain version (PIL's decode, the resize in numpy) is bitwise the library.
The fault this slice repairs: the port's real-image CLIs read their
directory through PIL's ``resize`` (up to 0.305 from tpugan's pixels at
40 -> 32 px); ``rec_real_img`` and ``embedding`` now read tpugan's pixels.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from tpugan.io import native as jnative
from tpugan.io.image import load_image_dir as jload_image_dir
from tpugan_torch.cli import embedding, rec_real_img
from tpugan_torch.io import native
from tpugan_torch.io.image import from_unit, load_image_dir
from tpugan_torch.ops import cuda


def _write(directory, shapes, seed=0, mode="RGB", suffix=".png"):
    """Random images of (height, width) in ``mode``, named in order."""
    rng = np.random.default_rng(seed)
    directory.mkdir(parents=True, exist_ok=True)
    paths = []
    for i, (h, w) in enumerate(shapes):
        rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        img = Image.fromarray(rgb)
        if mode == "I;16":
            img = Image.fromarray(rng.integers(0, 65536, (h, w), dtype=np.uint16))
        elif mode == "P":
            img = img.quantize(colors=64)
        elif mode != "RGB":
            img = img.convert(mode)
        path = directory / f"{i:03d}{suffix}"
        img.save(path)
        paths.append(str(path))
    return paths


@pytest.fixture(scope="module")
def tpugan_library():
    assert jnative.available(), "tpugan's native loader did not build (g++ and libpng)"


@pytest.mark.parametrize("shapes,size", [
    (((40, 40),) * 3, 40),
    (((40, 40),) * 3, 32),
    (((24, 32),), 16),
    (((33, 17), (5, 70)), 24),
], ids=["40-same", "40-to-32", "24x32-to-16", "odd-to-24"])
def test_library_is_tpugans_load_png_batch(tmp_path, tpugan_library, shapes, size):
    paths = _write(tmp_path, shapes)
    got = native.load_png_batch(paths, size)
    want = jnative.load_png_batch(paths, size)
    assert got.shape == want.shape == (len(paths), size, size, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["RGBA", "L", "LA", "P", "I;16"])
def test_every_colour_type_decodes_as_libpng(tmp_path, tpugan_library, mode):
    """Palette, gray, alpha and 16-bit PNGs: PIL's pixels are libpng's
    (palette and gray expanded, alpha stripped, 16 bits cut to the high
    byte)."""
    paths = _write(tmp_path, ((20, 28), (9, 9)), seed=3, mode=mode)
    np.testing.assert_array_equal(native.load_png_batch(paths, 16), jnative.load_png_batch(paths, 16))


def test_one_and_eight_threads_agree(tmp_path):
    paths = _write(tmp_path, ((40, 40),) * 5 + ((23, 31),) * 4, seed=1)
    np.testing.assert_array_equal(native.load_png_batch(paths, 32, n_threads=1),
                                  native.load_png_batch(paths, 32, n_threads=8))


def test_plain_version_is_the_library(tmp_path):
    paths = _write(tmp_path, ((40, 40), (24, 32), (1, 1), (7, 3)), seed=2)
    for size in (1, 16, 32, 40, 57):
        np.testing.assert_array_equal(native.load_png_batch_plain(paths, size), native.load_png_batch(paths, size))


def test_a_missing_or_broken_file_raises_ioerror(tmp_path):
    paths = _write(tmp_path, ((8, 8),))
    with pytest.raises(IOError):
        native.load_png_batch(paths + [str(tmp_path / "missing.png")], 8)
    (tmp_path / "broken.png").write_bytes(b"not a png")
    with pytest.raises(IOError):
        native.load_png_batch([str(tmp_path / "broken.png")], 8)


def test_a_directory_with_a_jpeg_goes_through_pil(tmp_path):
    """As tpugan's ``load_image_dir_fast``: a JPEG in the directory sends it
    all through ``io/image.load_image_dir``; an empty one raises."""
    _write(tmp_path, ((40, 40),), seed=4)
    _write(tmp_path / "jpg", ((40, 40),), seed=5, suffix=".jpg")
    (tmp_path / "jpg" / "001.png").write_bytes((tmp_path / "000.png").read_bytes())
    got = native.load_image_dir_fast(str(tmp_path / "jpg"), 32)
    np.testing.assert_array_equal(got, load_image_dir(str(tmp_path / "jpg"), 32))
    np.testing.assert_array_equal(got, jnative.load_image_dir_fast(str(tmp_path / "jpg"), 32))
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        native.load_image_dir_fast(str(tmp_path / "empty"), 32)


def test_the_library_is_built_from_the_checkout_and_nothing_falls_back(monkeypatch):
    """The library is ``csrc/image_io.cpp`` built with g++ into ``_build/``
    under a hash of the source and flags; where it cannot build, the loader
    raises (tpugan falls back to PIL quietly) and ``available`` says so."""
    path = cuda.library_path(native.LIBRARY)
    assert path.parent == cuda.BUILD_DIR and path.name.startswith("libimage_io-")
    assert cuda.HOST_LIBRARIES[native.LIBRARY][0] == "image_io.cpp"

    def broken(name):
        raise RuntimeError("the build failed for image_io.cpp: ...")

    monkeypatch.setattr(native, "_bound", None)
    monkeypatch.setattr(cuda, "host_library", broken)
    assert not native.available()
    with pytest.raises(RuntimeError, match="build failed"):
        native.load_png_batch(["x.png"], 8)


@pytest.fixture
def png_dir(tmp_path):
    """Three 40 x 40 PNGs, read at 32 px: tpugan's pixels and PIL's resize
    part by up to 0.305."""
    directory = tmp_path / "img"
    _write(directory, ((40, 40),) * 3, seed=6)
    want = jnative.load_image_dir_fast(str(directory), 32)
    assert np.abs(want - jload_image_dir(str(directory), 32)).max() > 0.1
    return directory, want


def test_rec_real_img_reads_tpugans_pixels(tmp_path, png_dir, tpugan_library):
    """The fault: ``rec_real_img`` writes the images it read (``*_real.png``);
    they are tpugan's loader's, quantized as the CLI writes them."""
    directory, want = png_dir
    out = tmp_path / "out"
    rec_real_img.main(["--mtype", "1", "--img_size", "32", "--start_features", "64", "--random_init",
                       "--device", "cpu", "--batch_size", "1", "--img_dir", str(directory),
                       "--experiment_dir", str(out)])
    for i in range(3):
        got = np.asarray(Image.open(out / "imgs" / f"{i:05d}_real.png"))
        quantized = np.clip(want[i] * 255.0 + 0.5, 0, 255).astype(np.uint8)
        np.testing.assert_array_equal(got, quantized)


class _Read(Exception):
    pass


def test_embedding_inverts_tpugans_pixels(tmp_path, png_dir, tpugan_library):
    """The fault: the batch ``embedding`` inverts is tpugan's loader's
    pixels in [-1, 1], bitwise."""
    directory, want = png_dir
    args = embedding.make_parser().parse_args([
        "--mtype", "1", "--img_size", "32", "--start_features", "64", "--random_init", "--device", "cpu",
        "--batch_size", "3", "--iterations", "1", "--img_dir", str(directory),
        "--experiment_dir", str(tmp_path / "out")])
    inverter = embedding.build_inverter(args)
    seen = []

    def invert(batch, chunk_callback=None):
        seen.append(batch)
        raise _Read

    with pytest.raises(_Read):
        embedding.run(inverter._replace(invert=invert), args)
    torch.testing.assert_close(seen[0], torch.from_numpy(from_unit(want)), rtol=0, atol=0)
