"""Sanitizer selftests of the port's host C++ components (ASan + UBSan + TSan).

The counterparts of `tests/test_sanitizers.py` on the port's own copies of
the parser and the scorer (`shifu_tpu_torch/runtime/csrc/`), built by the
port's `runtime.nativelib.build_selftest`: each source's
-DSHIFU_SELFTEST_MAIN entry drives its kernels (the multithreaded chunked
parse; the tiled matmul, layernorm, softmax and the threaded batch split,
remainder paths included) under -fsanitize=address,undefined and under
-fsanitize=thread, and 60 mutants of a `model.bin` the port packed go
through the scorer's loader under ASan.  Last, each package's selftest
loader reads the other package's `model.bin`.
"""

import gzip
import re
import shutil
import subprocess

import numpy as np
import pytest

from shifu_tpu_torch.runtime.nativelib import build_selftest

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None, reason="no g++ in environment")

# Only the sanitizer runtime being absent is a reason to skip (a toolchain
# without libasan/libubsan/libtsan); any other build error fails the test.
_MISSING_RUNTIME = re.compile(
    r"cannot find -l(asan|ubsan|tsan)|lib(a|ub|t)san[^\n]*(not found|No such)",
    re.IGNORECASE)
PARSER_LIBS = ["-lz", "-pthread", "-ldl"]
SCORER_LIBS = ["-pthread"]


def _build_or_skip(build, source: str, **kw) -> str:
    try:
        return build(source, **kw)
    except RuntimeError as e:
        if _MISSING_RUNTIME.search(str(e)):
            pytest.skip(f"sanitizer runtime unavailable: {str(e)[:120]}")
        raise


def _port_exe(source: str, **kw) -> str:
    return _build_or_skip(build_selftest, source, **kw)


def test_parser_selftest_asan_ubsan(tmp_path):
    exe = _port_exe("shifu_parser.cc", extra_flags=PARSER_LIBS)
    # a gzip file on the command line: inflate and count under ASan too
    rows = np.random.default_rng(0).standard_normal((500, 8))
    text = "\n".join("|".join(f"{v:.5g}" for v in r) for r in rows) + "\n"
    gz = tmp_path / "part.gz"
    with gzip.open(gz, "wt") as f:
        f.write(text)
    proc = subprocess.run([exe, str(gz)], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "parser selftest ok" in proc.stdout


def test_parser_selftest_tsan():
    """Races in the threaded chunked parse (offset prefix sum, disjoint
    writes into one output buffer)."""
    exe = _port_exe("shifu_parser.cc", sanitize="thread",
                    extra_flags=PARSER_LIBS)
    proc = subprocess.run([exe], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "WARNING: ThreadSanitizer" not in proc.stderr
    assert "parser selftest ok" in proc.stdout


@pytest.fixture(scope="module")
def port_model_bin(tmp_path_factory):
    """A moe_mlp artifact made by the port (its init, `save_artifact` and
    `pack_native`): the widest op set (dense, softmax, expert_dense,
    moe_combine), so that mutations reach every record reader."""
    from shifu_tpu_torch.config import (DataConfig, JobConfig, ModelSpec,
                                        OptimizerConfig, TrainConfig)
    from shifu_tpu_torch.data import synthetic
    from shifu_tpu_torch.export.artifact import save_artifact
    from shifu_tpu_torch.runtime import pack_native
    from shifu_tpu_torch.train import init_state

    schema = synthetic.make_schema(num_features=8)
    job = JobConfig(
        schema=schema, data=DataConfig(batch_size=32),
        model=ModelSpec(model_type="moe_mlp", hidden_nodes=(16, 8),
                        activations=("relu", "tanh"), num_experts=3),
        train=TrainConfig(epochs=1, loss="weighted_mse",
                          optimizer=OptimizerConfig(name="adadelta")),
    ).validate()
    state = init_state(job, 8, device="cpu")
    out = str(tmp_path_factory.mktemp("port_fuzz") / "model")
    save_artifact(state.model, job.model, schema, out)
    return pack_native(out)


@pytest.fixture(scope="module")
def jax_model_bin(tmp_path_factory):
    """The same moe_mlp made by the JAX package (as tests/test_sanitizers.py
    makes its fixture)."""
    import jax

    from shifu_tpu.config import (
        DataConfig, JobConfig, ModelSpec, OptimizerConfig, TrainConfig)
    from shifu_tpu.data import synthetic
    from shifu_tpu.export import save_artifact
    from shifu_tpu.runtime import pack_native
    from shifu_tpu.train import init_state

    schema = synthetic.make_schema(num_features=8)
    job = JobConfig(
        schema=schema, data=DataConfig(batch_size=32),
        model=ModelSpec(model_type="moe_mlp", hidden_nodes=(16, 8),
                        activations=("relu", "tanh"), num_experts=3),
        train=TrainConfig(epochs=1, loss="weighted_mse",
                          optimizer=OptimizerConfig(name="adadelta")),
    ).validate()
    state = init_state(job, 8)
    out = str(tmp_path_factory.mktemp("jax_fuzz") / "model")
    save_artifact(jax.device_get(state.params), job, out)
    return pack_native(out)


def _load(exe: str, model_bin: str) -> subprocess.CompletedProcess:
    return subprocess.run([exe, model_bin], capture_output=True, text=True,
                          timeout=120)


def test_model_bin_fuzz_asan(port_model_bin, tmp_path):
    """Truncated or corrupted copies of the port's model.bin are rejected
    or scored, never crash: every mutant goes through the ASan/UBSan
    selftest's loader, so an out-of-bounds read fails here even where it
    would not segfault."""
    exe = _port_exe("shifu_scorer.cc", extra_flags=SCORER_LIBS)
    blob = bytearray(open(port_model_bin, "rb").read())
    proc = _load(exe, port_model_bin)
    assert proc.returncode == 0 and "model load ok" in proc.stdout, (
        proc.stdout + proc.stderr)

    rng = np.random.default_rng(0)
    mutant = tmp_path / "mutant.bin"
    for trial in range(60):
        m = bytearray(blob)
        kind = trial % 3
        if kind == 0:  # truncation
            m = m[: rng.integers(0, len(m))]
        elif kind == 1:  # one byte flipped
            i = int(rng.integers(0, len(m)))
            m[i] ^= int(rng.integers(1, 256))
        else:  # a 4-byte header or length field overwritten
            i = int(rng.integers(0, max(1, len(m) // 4))) * 4
            m[i:i + 4] = rng.integers(0, 256, 4, dtype=np.uint8).tobytes()
        mutant.write_bytes(bytes(m))
        proc = _load(exe, str(mutant))
        assert proc.returncode == 0, (
            f"trial {trial} (kind {kind}): rc={proc.returncode}\n"
            + proc.stdout + proc.stderr)


def test_scorer_selftest_tsan():
    """Races in the scorer's threaded batch split and shared arena pool
    (the selftest scores with SHIFU_SCORER_THREADS=3)."""
    exe = _port_exe("shifu_scorer.cc", sanitize="thread",
                    extra_flags=SCORER_LIBS)
    proc = subprocess.run([exe], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "WARNING: ThreadSanitizer" not in proc.stderr
    assert "scorer selftest ok" in proc.stdout


def test_scorer_selftest_asan_ubsan():
    exe = _port_exe("shifu_scorer.cc", extra_flags=SCORER_LIBS)
    proc = subprocess.run([exe], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "scorer selftest ok" in proc.stdout


@pytest.mark.parametrize("loader", ["jax", "port"])
def test_model_bin_cross_load_asan(loader, port_model_bin, jax_model_bin,
                                   tmp_path):
    """Each package's ASan/UBSan selftest loader reads and scores the other
    package's model.bin."""
    if loader == "jax":
        from shifu_tpu.runtime.nativelib import build_selftest as jax_build
        # into tmp_path: the JAX package's cache writes its output in place,
        # and tests/test_sanitizers.py may build the same one in another
        # worker
        exe = _build_or_skip(jax_build, "shifu_scorer.cc",
                             extra_flags=SCORER_LIBS, out_dir=str(tmp_path))
        model_bin = port_model_bin
    else:
        exe = _port_exe("shifu_scorer.cc", extra_flags=SCORER_LIBS)
        model_bin = jax_model_bin
    proc = _load(exe, model_bin)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "model load ok" in proc.stdout, proc.stdout + proc.stderr
