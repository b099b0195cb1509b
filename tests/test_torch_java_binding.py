"""The JVM binding (`bindings/`) on the port's scorer and artifacts.

`tests/test_java_binding.py` holds the binding to the JAX package's
library and artifacts; this file holds the same call sequence to the
port's: a port-trained MLP artifact (the same 8-feature, 12-unit fixture),
its `model.bin` packed by the port's `pack_native`, the library built by
`shifu_tpu_torch.runtime.build_library()`.

- `bindings/ffm_harness.c` (the Java binding's exact java.lang.foreign
  call sequence, in C) built with g++ and run against the port's library:
  its single and batch scores equal to the port's `NativeScorer` (1e-7 /
  1e-6, the JAX file's tolerances) and to the JAX package's `NativeScorer`
  on the same `model.bin`; a missing `model.bin` exits 3;
- every `shifu_scorer_*` symbol the Java sources look up is exported by
  the port's `runtime/csrc/shifu_scorer.cc` (`bindings/java/
  check_java.py`'s own functions, given the port's source);
- the `ShifuTpuComputable` sidecar contract on the port's
  `GenericModelConfig.json`.
"""

import importlib.util
import json
import os
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HARNESS_SRC = os.path.join(REPO, "bindings", "ffm_harness.c")
JAVA_DIR = os.path.join(REPO, "bindings", "java")
PORT_SCORER_CC = os.path.join(REPO, "shifu_tpu_torch", "runtime", "csrc",
                              "shifu_scorer.cc")

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="g++ not available")

N_ROWS = 16
F = 8
SINGLE_ATOL = 1e-7
BATCH_ATOL = 1e-6


def _gen(k: np.ndarray) -> np.ndarray:
    """The harness's deterministic row generator, in numpy."""
    return ((k * 1103515245 + 12345) % 1000) / 1000.0 - 0.5


def _rows():
    single = _gen(np.arange(F, dtype=np.int64)).astype(np.float64)
    kb = np.arange(N_ROWS * F, dtype=np.int64).reshape(N_ROWS, F)
    return single, _gen(kb).astype(np.float32)


@pytest.fixture(scope="module")
def port_artifact(tmp_path_factory):
    """A port-trained MLP artifact (2 epochs on the CPU) with the port's
    model.bin, the port's scorer library, and the port NativeScorer's
    scores of the harness's rows."""
    from shifu_tpu_torch.config import (DataConfig, JobConfig, ModelSpec,
                                        OptimizerConfig, TrainConfig)
    from shifu_tpu_torch.data import pipeline as pipe
    from shifu_tpu_torch.data import synthetic
    from shifu_tpu_torch.export.artifact import save_artifact
    from shifu_tpu_torch.runtime import (NativeScorer, build_library,
                                         pack_native)
    from shifu_tpu_torch.train.loop import train

    schema = synthetic.make_schema(num_features=F)
    job = JobConfig(
        schema=schema,
        data=DataConfig(batch_size=64),
        model=ModelSpec(model_type="mlp", hidden_nodes=(12,),
                        activations=("relu",), compute_dtype="float32"),
        train=TrainConfig(epochs=2, optimizer=OptimizerConfig(
            name="adam", learning_rate=0.01)),
    ).validate()
    rng = np.random.default_rng(0)

    def ds(n):
        x = rng.standard_normal((n, F)).astype(np.float32)
        y = (x[:, :1] + 0.3 * x[:, 1:2] > 0).astype(np.float32)
        return pipe.TabularDataset(x, y, np.ones((n, 1), np.float32))

    result = train(job, ds(512), ds(128), console=lambda s: None,
                   device="cpu")
    out = str(tmp_path_factory.mktemp("port_binding") / "model")
    save_artifact(result.state.model, job.model, job.schema, out)
    pack_native(out)
    lib = build_library()
    single_row, batch_rows = _rows()
    ns = NativeScorer(out, lib_path=lib)
    single = float(ns.compute(single_row))
    batch = ns.compute_batch(batch_rows)
    ns.close()
    return lib, out, single, batch


def _harness(tmp_path) -> str:
    exe = str(tmp_path / "ffm_harness")
    subprocess.run(["g++", "-O2", "-o", exe, HARNESS_SRC, "-ldl"],
                   check=True, capture_output=True, text=True)
    return exe


def _parse(text: str) -> tuple[float, np.ndarray]:
    assert f"num_features={F} num_heads=1" in text
    m = re.search(r"single=([\d.]+)", text)
    assert m
    rows = re.findall(r"row(\d+)=([\d.,]+)", text)
    assert len(rows) == N_ROWS
    got = np.array([[float(v) for v in vals.split(",")]
                    for _, vals in sorted(rows, key=lambda r: int(r[0]))])
    return float(m.group(1)), got


def test_the_ffm_call_sequence_scores_through_the_ports_library(
        port_artifact, tmp_path):
    """dlopen -> dlsym x6 -> load -> dims -> compute(double*) ->
    compute_batch(float*, int, float*) -> free on the port's library and
    the port's model.bin, equal to the port's NativeScorer."""
    lib, artifact, single, batch = port_artifact
    assert os.path.dirname(lib) == os.path.join(REPO, "shifu_tpu_torch",
                                                "_build")
    exe = _harness(tmp_path)
    r = subprocess.run(
        [exe, lib, os.path.join(artifact, "model.bin"), str(N_ROWS)],
        capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stdout + r.stderr
    got_single, got_batch = _parse(r.stdout)
    assert got_single == pytest.approx(single, abs=SINGLE_ATOL)
    np.testing.assert_allclose(got_batch, batch, atol=BATCH_ATOL)
    # the binding's NULL-handle path: a missing model.bin exits 3
    r2 = subprocess.run([exe, lib, os.path.join(artifact, "nope.bin"), "1"],
                        capture_output=True, text=True, timeout=60)
    assert r2.returncode == 3


def test_the_jax_scorer_agrees_on_the_ports_model_bin(port_artifact):
    """The JAX package's NativeScorer (its own library) on the same
    model.bin the port packed: the same scores, and the file left as the
    port wrote it."""
    from shifu_tpu.runtime import NativeScorer as JaxNativeScorer

    _lib, artifact, single, batch = port_artifact
    bin_path = os.path.join(artifact, "model.bin")
    before = Path(bin_path).read_bytes()
    single_row, batch_rows = _rows()
    ns = JaxNativeScorer(artifact)
    try:
        assert float(ns.compute(single_row)) == pytest.approx(
            single, abs=SINGLE_ATOL)
        np.testing.assert_allclose(ns.compute_batch(batch_rows), batch,
                                   atol=BATCH_ATOL)
    finally:
        ns.close()
    assert Path(bin_path).read_bytes() == before


def _check_java():
    spec = importlib.util.spec_from_file_location(
        "check_java_port", os.path.join(JAVA_DIR, "check_java.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_symbol_the_java_looks_up_is_exported_by_the_port():
    cj = _check_java()
    port_syms = cj.exported_c_symbols(Path(PORT_SCORER_CC))
    jax_syms = cj.exported_c_symbols(
        Path(REPO) / "shifu_tpu" / "runtime" / "csrc" / "shifu_scorer.cc")
    sources = sorted(Path(JAVA_DIR).rglob("*.java"))
    assert len(sources) == 3
    looked_up = set()
    for src in sources:
        cj.check_file(src, port_syms)  # raises JavaCheckError on a miss
        looked_up |= set(re.findall(r"\"(shifu_\w+)\"", src.read_text()))
    assert len(looked_up) == 6 and looked_up <= port_syms
    assert {s for s in port_syms if s.startswith("shifu_scorer_")} == {
        s for s in jax_syms if s.startswith("shifu_scorer_")}
    # the check has teeth on the port's source too
    model = Path(JAVA_DIR) / "ml" / "shifu" / "shifu" / "tpu" / \
        "ShifuTpuModel.java"
    with pytest.raises(cj.JavaCheckError):
        cj.check_abi(model.read_text().replace('"shifu_scorer_load"',
                                               '"shifu_scorer_laod"', 1),
                     str(model), port_syms)


def test_the_computable_sidecar_contract_on_the_ports_artifact(
        port_artifact):
    """ShifuTpuComputable's init() replayed on the port's
    GenericModelConfig.json (the properties Shifu injects), and its
    delegation target, shifu_scorer_compute through the port's library,
    giving the fixture's score."""
    from shifu_tpu_torch.runtime import NativeScorer

    lib, artifact, single, _batch = port_artifact
    adapter = open(os.path.join(JAVA_DIR, "ml", "shifu", "shifu", "tpu",
                                "ShifuTpuComputable.java")).read()
    for key in ('"modelpath"', '"outputnames"', '"tags"', '"nativelib"'):
        assert key in adapter
    assert "model.compute(input.getData())" in adapter
    with open(os.path.join(artifact, "GenericModelConfig.json")) as f:
        sidecar = json.load(f)
    props = dict(sidecar["properties"])
    props["modelpath"] = artifact
    props["nativelib"] = lib  # where a deployment points the adapter
    inputnames = sidecar["inputnames"]
    assert inputnames and inputnames[0] == "shifu_input_0"
    out = props.get("outputnames")
    assert isinstance(out, str) and out
    tags = props.get("tags")
    assert isinstance(tags, list) and tags
    for name in inputnames[1:]:
        assert name in props
    ns = NativeScorer(props["modelpath"], lib_path=props["nativelib"])
    try:
        assert ns.compute(_rows()[0]) == pytest.approx(single, abs=1e-12)
    finally:
        ns.close()
