"""The port's native C++ scorer (shifu_tpu_torch/runtime/native_scorer.py
and its copy of runtime/csrc/shifu_scorer.cc) against the JAX package's,
on the CPU: the counterparts of tests/test_native_scorer.py.

- `model.bin` (and its `.meta` digest) is byte for byte what the JAX
  package's `pack_native` writes for the same artifact, on every ladder
  model, with and without categorical columns.
- The native engine scores within 1e-5 of the numpy `Scorer` on every
  ladder model; each package's engine loads the other's `model.bin`
  without repacking it.
- The loader rejects a corrupt file, out-of-range gather positions, a
  redefined buffer and giant length fields; a threaded batch is bitwise
  the single-threaded one; one handle serves concurrent calls.
- An edited sidecar (the extra inputs' values) repacks: `_is_current`'s
  source digest.
"""

import concurrent.futures
import ctypes
import json
import os
import shutil
import struct

import numpy as np
import pytest

from shifu_tpu.runtime import native_scorer as jax_native
from shifu_tpu_torch.export import scorer
from shifu_tpu_torch.runtime import native_scorer as native

import test_torch_program as tp

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="g++ not available")

NATIVE_TOL = dict(rtol=1e-5, atol=1e-5)


def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(native.build_library())
    lib.shifu_scorer_load.restype = ctypes.c_void_p
    lib.shifu_scorer_load.argtypes = [ctypes.c_char_p]
    return lib


@pytest.fixture(scope="module")
def mlp_dir(tmp_path_factory):
    return tp._saved(tmp_path_factory.mktemp("native"), "mlp", 0)[1]


def test_build_library_in_the_port():
    lib = native.build_library()
    assert os.path.exists(lib)
    assert os.path.dirname(lib).endswith(os.path.join("shifu_tpu_torch",
                                                      "_build"))
    assert native.MODEL_BIN == jax_native.MODEL_BIN
    assert (native._MAGIC, native._VERSION) == (jax_native._MAGIC,
                                                jax_native._VERSION)


@pytest.mark.parametrize("n_cat", [0, 3])
@pytest.mark.parametrize("model_type", tp.TYPES)
def test_model_bin_is_byte_identical_to_jax(tmp_path, model_type, n_cat):
    _, out = tp._saved(tmp_path, model_type, n_cat, seed=3)
    path = native.pack_native(out)
    with open(path, "rb") as f:
        ours = f.read()
    with open(path + ".meta") as f:
        ours_meta = json.load(f)
    assert jax_native.pack_native(out) == path
    with open(path, "rb") as f:
        theirs = f.read()
    with open(path + ".meta") as f:
        theirs_meta = json.load(f)
    assert ours == theirs
    assert ours_meta == theirs_meta


@pytest.mark.parametrize("n_cat", [0, 3])
@pytest.mark.parametrize("model_type", tp.TYPES)
def test_native_matches_the_numpy_scorer_on_every_ladder_model(
        tmp_path, model_type, n_cat):
    _, out = tp._saved(tmp_path, model_type, n_cat, seed=4)
    x = tp._rows(64, n_cat, seed=5)
    nat = native.NativeScorer(out)
    try:
        got = nat.compute_batch(x)
        want = scorer.Scorer(out).compute_batch(x)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **NATIVE_TOL)
        single = nat.compute(x[0].astype(np.float64))
        assert single == pytest.approx(float(want[0, 0]), abs=1e-5)
    finally:
        nat.close()


@pytest.mark.parametrize("packer", ["jax", "port"])
def test_each_package_loads_the_others_model_bin(tmp_path, monkeypatch,
                                                 packer):
    """A model.bin packed by one package is current for the other's engine
    (the same format version and source digest): it loads without a
    repack, and both engines score the same bits."""
    _, out = tp._saved(tmp_path, "ft_transformer", 3, seed=6)
    (jax_native if packer == "jax" else native).pack_native(out)
    with open(os.path.join(out, native.MODEL_BIN), "rb") as f:
        packed = f.read()

    def no_repack(_):
        raise AssertionError("the other package's model.bin was repacked")

    monkeypatch.setattr(native, "pack_native", no_repack)
    monkeypatch.setattr(jax_native, "pack_native", no_repack)
    x = tp._rows(40, 3, seed=7)
    ours = native.NativeScorer(out)
    theirs = jax_native.NativeScorer(out)
    try:
        np.testing.assert_array_equal(ours.compute_batch(x),
                                      theirs.compute_batch(x))
    finally:
        ours.close()
        theirs.close()
    with open(os.path.join(out, native.MODEL_BIN), "rb") as f:
        assert f.read() == packed


def test_an_edited_sidecar_repacks(tmp_path):
    """`_is_current` digests the topology and the sidecar: an edited extra
    input value (the reference's runtime-configurable properties,
    TensorflowModel.java:74-87) repacks model.bin instead of serving the
    baked-in constant, in step with the numpy Scorer."""
    _, out = tp._saved(tmp_path, "mlp", 0, seed=8)
    topo_path = os.path.join(out, "topology.json")
    with open(topo_path) as f:
        topo = json.load(f)
    prog = topo["program"]
    last = prog[-1]
    assert last["op"] == "activation" and last["fn"] == "sigmoid"
    prog[-1] = {"op": "add", "srcs": [last["src"], "input:aux_shift"],
                "out": "shifted"}
    prog.append({"op": "activation", "src": "shifted", "out": last["out"],
                 "fn": "sigmoid"})
    with open(topo_path, "w") as f:
        json.dump(topo, f)
    side_path = os.path.join(out, "GenericModelConfig.json")
    x = tp._rows(32, 0, seed=9)
    for shift in (0.7, -0.4):
        with open(side_path) as f:
            side = json.load(f)
        side["inputnames"] = ["shifu_input_0", "aux_shift"]
        side["properties"]["aux_shift"] = [shift]
        with open(side_path, "w") as f:
            json.dump(side, f)
        nat = native.NativeScorer(out)
        try:
            np.testing.assert_allclose(
                nat.compute_batch(x), scorer.Scorer(out).compute_batch(x),
                **NATIVE_TOL)
        finally:
            nat.close()
    with pytest.raises(ValueError, match="extra named inputs"):
        scorer.ExportScorer(out, device="cpu")


def test_threaded_batch_is_bitwise_the_single_thread(mlp_dir, monkeypatch):
    nat = native.NativeScorer(mlp_dir)
    try:
        rows = tp._rows(4 * 512 + 3, 0, seed=10)
        monkeypatch.setenv("SHIFU_SCORER_THREADS", "1")
        single = nat.compute_batch(rows)
        monkeypatch.setenv("SHIFU_SCORER_THREADS", "4")
        np.testing.assert_array_equal(nat.compute_batch(rows), single)
    finally:
        nat.close()


def test_corrupt_file_is_rejected(tmp_path):
    bad = tmp_path / "model.bin"
    bad.write_bytes(b"NOTAMODEL")
    assert _lib().shifu_scorer_load(str(bad).encode()) is None


def test_out_of_range_positions_are_rejected_at_load(tmp_path):
    bad = tmp_path / "model.bin"
    # header: magic, v2, 4 features, 1 head, 2 buffers, 1 op; a gather_cols
    # (code 1) of position 99 >= 4
    bad.write_bytes(struct.pack("<6I", 0x55464853, 2, 4, 1, 2, 1)
                    + struct.pack("<3I", 1, 1, 0) + struct.pack("<2I", 1, 99))
    assert _lib().shifu_scorer_load(str(bad).encode()) is None


def test_buffer_redefinition_is_rejected(tmp_path):
    bad = tmp_path / "model.bin"
    op = struct.pack("<3I", 1, 1, 0) + struct.pack("<2I", 1, 0)
    bad.write_bytes(struct.pack("<6I", 0x55464853, 2, 4, 1, 2, 2) + op + op)
    assert _lib().shifu_scorer_load(str(bad).encode()) is None


def test_giant_length_fields_are_rejected(tmp_path):
    lib = _lib()
    header = struct.pack("<6I", 0x55464853, 2, 4, 1, 2, 1)
    bad1 = tmp_path / "m1.bin"
    bad1.write_bytes(header + struct.pack("<3I", 1, 1, 0)
                     + struct.pack("<I", 0xFFFFFFFF))
    assert lib.shifu_scorer_load(str(bad1).encode()) is None
    bad2 = tmp_path / "m2.bin"
    bad2.write_bytes(header + struct.pack("<3I", 2, 1, 0)
                     + struct.pack("<3I", 4, 2**31, 2**31))
    assert lib.shifu_scorer_load(str(bad2).encode()) is None


def test_concurrent_scoring_on_one_handle(mlp_dir):
    nat = native.NativeScorer(mlp_dir)
    try:
        rows = tp._rows(512, 0, seed=11)
        want_batch = nat.compute_batch(rows)
        want_single = [nat.compute(r.astype(np.float64)) for r in rows[:32]]

        def worker(_):
            np.testing.assert_array_equal(nat.compute_batch(rows),
                                          want_batch)
            assert [nat.compute(r.astype(np.float64))
                    for r in rows[:32]] == want_single
            return True

        with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
            assert all(f.result(timeout=120)
                       for f in [ex.submit(worker, i) for i in range(16)])
    finally:
        nat.close()
