"""tpugan_torch's weight fetching (``io/fetch.py``) vs tpugan's
(``tpugan/io/fetch.py``) (CPU). Nothing is downloaded: each test replaces
``urllib.request.urlretrieve`` with a copy of a local file, so no socket is
opened."""

import argparse
import os
import shutil
import urllib.request

import pytest

from tpugan.io import fetch as jfetch
from tpugan_torch.cli import common
from tpugan_torch.io import convert, fetch

URL = "https://example.com/weights/lpips_vgg.pth"


@pytest.fixture
def offline(monkeypatch, tmp_path):
    """``urlretrieve`` copies ``source`` in place of a download and counts
    its calls."""
    source = tmp_path / "source.pth"
    source.write_bytes(b"weights")
    calls = []

    def urlretrieve(url, filename):
        calls.append(url)
        shutil.copyfile(source, filename)
        return filename, None

    monkeypatch.setattr(urllib.request, "urlretrieve", urlretrieve)
    return calls


def test_a_url_is_fetched_once_under_tpugans_name(tmp_path, offline):
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    got = fetch.cached_path(URL, cache_dir=str(ours))
    want = jfetch.cached_path(URL, cache_dir=str(theirs))
    assert fetch.cache_name(URL) == os.path.basename(want)
    assert got == str(ours / fetch.cache_name(URL)) and open(got, "rb").read() == b"weights"
    assert fetch.cached_path(URL, cache_dir=str(ours)) == got
    assert offline == [URL, URL]  # once each package: the second call reads the cache
    assert not list(ours.glob("*.tmp"))


def test_a_local_path_is_returned_and_anything_else_raises(tmp_path, offline):
    local = tmp_path / "w.pth"
    local.write_bytes(b"x")
    assert fetch.cached_path(str(local)) == str(local) == jfetch.cached_path(str(local))
    for missing in (str(tmp_path / "missing.pth"), "s3://bucket/w.pth", "ftp://host/w.pth"):
        with pytest.raises(FileNotFoundError):
            fetch.cached_path(missing)
        with pytest.raises(FileNotFoundError):
            jfetch.cached_path(missing)
    assert offline == []
    assert fetch.PRETRAINED_BIGGAN == jfetch.PRETRAINED_BIGGAN
    assert fetch.DEFAULT_CACHE.endswith("tpugan_torch")


@pytest.mark.parametrize("flag,maker", [("lpips_weights", "build_lpips_fn"), ("vgg_weights", "build_vgg16")])
def test_the_weight_flags_take_a_url(tmp_path, monkeypatch, offline, flag, maker):
    """``--lpips_weights`` and ``--vgg_weights`` resolve a URL through the
    cache before converting the file, as tpugan's do."""
    monkeypatch.setattr(fetch, "DEFAULT_CACHE", str(tmp_path / "cache"))
    read = []

    def load(path):
        read.append(path)
        raise RuntimeError("stop")

    monkeypatch.setattr(convert, "load_torch_state_dict", load)
    args = common.add_common_args(argparse.ArgumentParser()).parse_args(
        [f"--{flag}", URL, "--device", "cpu"])
    with pytest.raises(RuntimeError, match="stop"):
        getattr(common, maker)(args)
    assert offline == [URL] and read == [str(tmp_path / "cache" / fetch.cache_name(URL))]
