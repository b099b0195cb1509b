"""Nothing the harness or the reference loads is JAX or the JAX package
(top-level module names compared whole: `shifu_tpu_torch` begins with
`shifu_tpu`), and the reference loads nothing of the program."""

import ast
import os
import subprocess
import sys

import pytest

from perfbench import run
from perfbench.core import manifest

FORBIDDEN = {"jax", "jaxlib", "flax", "shifu_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    for root, _dirs, files in os.walk(os.path.join(manifest.HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        assert not set(_imports(path)) & FORBIDDEN, path


def test_reference_sources_import_torch_alone():
    for path in _sources("reference"):
        assert set(_imports(path)) <= {"__future__", "contextlib", "math",
                                       "torch"}, path


def _loaded(code):
    p = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    return set(p.stdout.split())


def test_reference_loads_nothing_of_the_program():
    mods = _loaded("import sys; import perfbench.reference.ft_transformer;"
                   "print(' '.join({m.split('.')[0] for m in sys.modules}))")
    assert "torch" in mods
    assert not mods & (FORBIDDEN | {"shifu_tpu_torch"})


@pytest.mark.parametrize("cell,ov", [
    ("ft-b2-d128.train", "{'rows': 1024, 'batch_rows': 128}"),
    ("ft-b3-d192.score", "{'pool_rows': 600, 'batch_rows': 128}")])
def test_a_run_loads_neither_jax_nor_the_jax_package(cell, ov):
    mods = _loaded(
        "import sys; from perfbench import run; "
        f"run.execute({cell!r}, 7, 0.2, False, 'cpu', overrides={ov}); "
        "print(' '.join({m.split('.')[0] for m in sys.modules}))")
    assert "shifu_tpu_torch" in mods
    assert not mods & FORBIDDEN
    assert run.FORBIDDEN == tuple(sorted(FORBIDDEN, key=run.FORBIDDEN.index))


def test_forbidden_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "shifu_tpu_torch_fake", sys)
    assert "shifu_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "shifu_tpu.fake", sys)
    assert "shifu_tpu" in run.forbidden_modules()
