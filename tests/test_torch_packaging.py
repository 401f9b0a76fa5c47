"""The port's packaging: an installed ``tpugan_torch`` ships every file its
CUDA sources include, so that it can build its kernels outside a checkout."""

import fnmatch
import pathlib
import re
import tomllib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = ROOT / "tpugan_torch" / "csrc"


def _package_data_globs():
    config = tomllib.loads((ROOT / "pyproject.toml").read_text())
    return config["tool"]["setuptools"]["package-data"]["tpugan_torch"]


def _shipped(relative: str) -> bool:
    return any(fnmatch.fnmatch(relative, glob) for glob in _package_data_globs())


@pytest.mark.parametrize("source", sorted(CSRC.glob("*.cu")), ids=lambda p: p.name)
def test_every_quoted_include_of_a_source_is_shipped(source):
    """Each ``#include "..."`` of a ``csrc/*.cu`` names a file beside it that
    the package-data globs match, and the source itself is shipped."""
    assert _shipped(f"csrc/{source.name}")
    for header in re.findall(r'^\s*#\s*include\s+"([^"]+)"', source.read_text(), re.MULTILINE):
        assert (CSRC / header).is_file(), f"{source.name} includes {header}, which is not in csrc/"
        assert _shipped(f"csrc/{header}"), f"{source.name} includes {header}, which is not shipped"


def test_the_attention_header_is_shipped():
    """B3 and B4 include ``tf32_wgmma.cuh``; an install without it cannot
    build either."""
    assert _shipped("csrc/tf32_wgmma.cuh")
