"""The port's native sources ship in its wheel: every file under
`shifu_tpu_torch/csrc/` and `shifu_tpu_torch/runtime/csrc/` matches a
package-data glob of pyproject.toml (the scorer includes its header, and
the kernels' selftest builds `csrc/tools/`)."""

import fnmatch
import os
import tomllib

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE_DIRS = {"shifu_tpu_torch": "shifu_tpu_torch/csrc",
               "shifu_tpu_torch.runtime": "shifu_tpu_torch/runtime/csrc"}


def _matches(path: str, pattern: str) -> bool:
    """setuptools' glob: `*` stays inside one path component."""
    parts, pats = path.split("/"), pattern.split("/")
    return len(parts) == len(pats) and all(
        fnmatch.fnmatchcase(a, p) for a, p in zip(parts, pats))


def _package_data() -> dict:
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        return tomllib.load(f)["tool"]["setuptools"]["package-data"]


def _files(package: str) -> list:
    pkg_dir = os.path.join(ROOT, *package.split("."))
    root = os.path.join(ROOT, SOURCE_DIRS[package])
    out = []
    for dirpath, _dirs, files in os.walk(root):
        out += [os.path.relpath(os.path.join(dirpath, f), pkg_dir)
                for f in files]
    return sorted(out)


@pytest.mark.parametrize("package", sorted(SOURCE_DIRS))
def test_every_native_source_is_package_data(package):
    globs = _package_data().get(package, [])
    files = _files(package)
    assert files
    missing = [f for f in files
               if not any(_matches(f, g) for g in globs)]
    assert not missing, f"{package}: not in package data: {missing}"


def test_the_scorer_header_ships():
    assert "csrc/shifu_scorer.h" in _files("shifu_tpu_torch.runtime")
    assert not _matches("csrc/tools/guard_alloc.cu", "csrc/*.cu")
