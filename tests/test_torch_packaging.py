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


def _scripts():
    return tomllib.loads((ROOT / "pyproject.toml").read_text())["project"]["scripts"]


@pytest.mark.parametrize("name", sorted(n for n in _scripts() if n.startswith("tpugan-") and not
                                        n.startswith("tpugan-torch-")))
def test_every_tpugan_console_script_has_the_ports(name):
    """Each of tpugan's console scripts has a ``tpugan-torch-`` twin whose
    target is the port's module of the same name, with a ``main``."""
    import importlib

    scripts = _scripts()
    module, _, func = scripts[name].partition(":")
    twin = scripts[name.replace("tpugan-", "tpugan-torch-", 1)]
    assert twin == f"{module.replace('tpugan.', 'tpugan_torch.', 1)}:{func}"
    port_module, _, port_func = twin.partition(":")
    assert callable(getattr(importlib.import_module(port_module), port_func))
