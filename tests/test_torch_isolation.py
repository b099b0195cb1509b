"""The port stands alone: no module of shifu_tpu_torch, and neither
chip_smoke.py nor kernel_ab.py, imports JAX, Flax, Optax or the JAX
package."""

import os
import re
import subprocess
import sys

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG = os.path.join(_ROOT, "shifu_tpu_torch")
_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "shifu_tpu")
_IMPORT = re.compile(
    r"^\s*(?:from|import)\s+(" + "|".join(_FORBIDDEN) + r")(?:[.\s,]|$)",
    re.MULTILINE)


def _sources():
    out = [os.path.join(_ROOT, f) for f in ("chip_smoke.py", "kernel_ab.py")]
    for dirpath, _dirs, files in os.walk(_PKG):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import shifu_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    shifu_tpu_torch.__path__, 'shifu_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke, kernel_ab\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{_FORBIDDEN!r})\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad or len(names) < 35 else 0)\n")
    env = dict(os.environ, PYTHONPATH=_ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=_ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, _ROOT))
def test_no_forbidden_import_statement(path):
    with open(path) as f:
        found = _IMPORT.findall(f.read())
    assert not found, f"{path} imports {found}"


def test_scan_catches_a_forbidden_import():
    assert _IMPORT.findall("import jax.numpy as jnp\n") == ["jax"]
    assert _IMPORT.findall("    from shifu_tpu.ops import x\n") == [
        "shifu_tpu"]
    assert _IMPORT.findall("from shifu_tpu_torch.ops import x\n") == []
    assert _IMPORT.findall("from . import jaxlike\n") == []


@pytest.mark.parametrize("sub", ["launcher", "chaos", "runtime", "utils",
                                 "export", "obs", "models", "tools"])
def test_the_launcher_slice_is_scanned_and_imports_alone(sub):
    """The operator's command and what it needs (the launcher, the chaos
    plane, the native parser's build, the XML overlay), and the serving
    plane (the artifact and its program, the telemetry with drift, SLO
    and tracing, the daemon, wire server and loadtest, every model): the
    import scan covers their files, and each subpackage imports no JAX by
    itself."""
    mine = [p for p in _sources()
            if p.startswith(os.path.join(_PKG, sub) + os.sep)]
    assert mine
    code = (
        "import importlib, pkgutil, sys\n"
        f"pkg = importlib.import_module('shifu_tpu_torch.{sub}')\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{_FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=_ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=_ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
