"""Weight files by path or URL (counterpart of ``tpugan/io/fetch.py``).

A local path is used as it is; an http(s) URL is downloaded once, with the
standard library, into a cache directory under a name made of the URL's
hash and its file name, through a temporary file renamed into place, so a
cut download leaves no file behind.
"""

from __future__ import annotations

import hashlib
import os
import urllib.request

DEFAULT_CACHE = os.path.join(os.path.expanduser("~"), ".cache", "tpugan_torch")

# the reference's hosted BigGAN weights (biggan_generator.py:33-46)
PRETRAINED_BIGGAN = {
    name: (
        f"https://s3.amazonaws.com/models.huggingface.co/biggan/{name}-pytorch_model.bin",
        f"https://s3.amazonaws.com/models.huggingface.co/biggan/{name}-config.json",
    )
    for name in ("biggan-deep-128", "biggan-deep-256", "biggan-deep-512")
}


def cache_name(url: str) -> str:
    """The file name a URL is cached under: ``sha256(url)[:16]-<basename>``."""
    return hashlib.sha256(url.encode()).hexdigest()[:16] + "-" + os.path.basename(url)


def cached_path(path_or_url: str, cache_dir: str | None = None) -> str:
    """A local path, as it is (it must exist); an http(s) URL, the local
    copy in ``cache_dir`` (:data:`DEFAULT_CACHE` by default), downloaded on
    first use. Anything else raises ``FileNotFoundError``."""
    path_or_url = str(path_or_url)
    if os.path.exists(path_or_url):
        return path_or_url
    if not path_or_url.startswith(("http://", "https://")):
        raise FileNotFoundError(path_or_url)
    cache_dir = cache_dir or DEFAULT_CACHE
    os.makedirs(cache_dir, exist_ok=True)
    target = os.path.join(cache_dir, cache_name(path_or_url))
    if not os.path.exists(target):
        tmp = target + ".tmp"
        urllib.request.urlretrieve(path_or_url, tmp)
        os.replace(tmp, target)
    return target
