"""The op-list program (format v2) of the port's artifacts
(shifu_tpu_torch/export/program.py, export/scorer.py `run_program` and
`Scorer`, export/artifact.py, runtime/fleet.py) against the JAX
package's, on the CPU.

- `build_program_v2` is the JAX package's, op for op, for every model type
  of the ladder, on a schema with and without categorical columns (and
  with no schema for the layout-free models).
- The port's `run_program` equals the JAX package's on the same weights
  and rows within 1e-6.
- The JAX package's numpy `Scorer` scores an artifact the port saved, for
  all six model types, within 1e-5 of the port's `Scorer` and of the
  port's f32 `TorchScorer`; so does its native C++ scorer where g++
  builds it.
- The JAX package's `read_sync_manifest` and `sync_artifact` verify the
  port's `sync_manifest.json`; a failure to write it raises in the port
  (a deliberate difference: the JAX exporter swallows it).
"""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

from shifu_tpu.config import schema as jax_schema
from shifu_tpu.data import synthetic as jax_synth
from shifu_tpu.export import program as jax_program
from shifu_tpu.export import scorer as jax_scorer
from shifu_tpu_torch.config import schema as port_schema
from shifu_tpu_torch.export import artifact, program, scorer
from shifu_tpu_torch.models.registry import build_model
from shifu_tpu_torch.runtime import fleet

F = 9
VOCAB = 11

MODEL_KW = {
    "mlp": dict(hidden_nodes=(12, 6), activations=("relu", "tanh")),
    "wide_deep": dict(hidden_nodes=(12,), activations=("relu",),
                      embedding_dim=4),
    "deepfm": dict(hidden_nodes=(12,), activations=("relu",),
                   embedding_dim=4),
    "multitask": dict(hidden_nodes=(12, 8), activations=("relu", "relu"),
                      num_heads=2,
                      head_names=("shifu_output_0", "shifu_output_1")),
    "ft_transformer": dict(token_dim=16, num_layers=2, num_attention_heads=2,
                           fused_block="off"),
    "moe_mlp": dict(hidden_nodes=(12, 6), activations=("relu", "sigmoid"),
                    num_experts=3),
}
TYPES = sorted(MODEL_KW)


def _jax_spec(model_type):
    spec = jax_schema.ModelSpec(model_type=model_type,
                                compute_dtype="float32",
                                **MODEL_KW[model_type])
    spec.validate()
    return spec


def _jax_schema(n_cat):
    return jax_synth.make_schema(F, num_categorical=n_cat, vocab_size=VOCAB,
                                 num_targets=1)


def _port(jspec, jschema):
    return (port_schema._from_dict(port_schema.ModelSpec,
                                   dataclasses.asdict(jspec)),
            port_schema._from_dict(port_schema.DataSchema,
                                   dataclasses.asdict(jschema)))


def _rows(n, n_cat, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, F)).astype(np.float32)
    if n_cat:
        # ids past the vocab and below 0 exercise the clip
        x[:, F - n_cat:] = rng.integers(-2, VOCAB + 3, size=(n, n_cat))
    return x


@pytest.mark.parametrize("n_cat", [0, 3])
@pytest.mark.parametrize("model_type", TYPES)
def test_program_is_jax_op_for_op(model_type, n_cat):
    jspec, jschema = _jax_spec(model_type), _jax_schema(n_cat)
    pspec, pschema = _port(jspec, jschema)
    want = jax_program.build_program_v2(jspec, jschema)
    got = program.build_program_v2(pspec, pschema)
    assert got == want and got
    assert program.weight_keys(got) == jax_program.weight_keys(want)
    assert program.PROGRAM_VERSION == jax_program.PROGRAM_VERSION == 2
    assert program.WEIGHT_FIELDS == jax_program.WEIGHT_FIELDS
    # no schema: only the layout-free models lower
    assert program.build_program_v2(pspec, None) \
        == jax_program.build_program_v2(jspec, None)


def _saved(tmp_path, model_type, n_cat, seed=0):
    jspec, jschema = _jax_spec(model_type), _jax_schema(n_cat)
    pspec, pschema = _port(jspec, jschema)
    model = build_model(pspec, pschema, device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    out = artifact.save_artifact(model, pspec, pschema,
                                 str(tmp_path / f"{model_type}-{n_cat}"))
    return model, out


@pytest.mark.parametrize("n_cat", [0, 3])
@pytest.mark.parametrize("model_type", TYPES)
def test_run_program_matches_jax(tmp_path, model_type, n_cat):
    _, out = _saved(tmp_path, model_type, n_cat, seed=1)
    topo = json.loads(open(os.path.join(out, "topology.json")).read())
    with np.load(os.path.join(out, "weights.npz")) as z:
        weights = {k: z[k].astype(np.float32) for k in z.files}
    x = _rows(33, n_cat, seed=2)
    got = scorer.run_program(topo["program"], weights, x)
    want = jax_scorer.run_program(topo["program"], weights, x)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_run_program_binds_extra_inputs_like_jax():
    rng = np.random.default_rng(3)
    weights = {"k": rng.normal(size=(5, 2)).astype(np.float32),
               "b": np.zeros(2, np.float32)}
    prog = [{"op": "concat", "srcs": ["input", "input:aux"], "out": "c"},
            {"op": "dense", "src": "c", "out": "y", "kernel": "k",
             "bias": "b", "activation": "sigmoid"}]
    x = rng.normal(size=(4, 3)).astype(np.float32)
    sidecar = {"inputnames": ["shifu_input_0", "aux"],
               "properties": {"aux": [0.5, -1.0]}}
    extra = scorer.extra_inputs_from_sidecar(sidecar)
    np.testing.assert_array_equal(
        extra["aux"], jax_scorer.extra_inputs_from_sidecar(sidecar)["aux"])
    np.testing.assert_allclose(
        scorer.run_program(prog, weights, x, extra),
        jax_scorer.run_program(prog, weights, x, extra), rtol=1e-6)
    with pytest.raises(ValueError, match="missing"):
        scorer.extra_inputs_from_sidecar({"inputnames": ["a", "b"],
                                          "properties": {}})


@pytest.mark.parametrize("model_type", TYPES)
def test_jax_numpy_scorer_scores_port_artifacts(tmp_path, model_type):
    n_cat = 0 if model_type in ("mlp", "multitask", "moe_mlp") else 3
    model, out = _saved(tmp_path, model_type, n_cat, seed=4)
    x = _rows(21, n_cat, seed=5)
    mine = scorer.Scorer(out)
    got = mine.compute_batch(x)
    heads = MODEL_KW[model_type].get("num_heads", 1)
    assert got.shape == (21, heads)
    theirs = jax_scorer.Scorer(out)   # the bare TypeError on "program": null
    assert theirs.program == mine.program
    np.testing.assert_allclose(theirs.compute_batch(x), got, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(
        scorer.TorchScorer(out, device="cpu").compute_batch(x), got,
        rtol=1e-5, atol=1e-5)
    assert mine.compute(x[0]) == pytest.approx(float(got[0, 0]), rel=1e-6)
    topo = json.loads(open(os.path.join(out, "topology.json")).read())
    assert topo["program_version"] == 2 and topo["model_type"] == model_type


def test_numpy_scorer_refuses_an_artifact_without_a_program(tmp_path):
    _, out = _saved(tmp_path, "mlp", 0)
    path = os.path.join(out, "topology.json")
    topo = json.loads(open(path).read())
    topo["program"] = None
    with open(path, "w") as f:
        json.dump(topo, f)
    with pytest.raises(ValueError, match="no op-list program"):
        scorer.Scorer(out)


@pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")
@pytest.mark.parametrize("model_type", ["mlp", "moe_mlp", "ft_transformer"])
def test_jax_native_scorer_scores_a_port_artifact(tmp_path, model_type):
    from shifu_tpu.runtime import NativeScorer
    n_cat = 3 if model_type == "ft_transformer" else 0
    _, out = _saved(tmp_path, model_type, n_cat, seed=6)
    x = _rows(17, n_cat, seed=7)
    native = NativeScorer(out)
    try:
        np.testing.assert_allclose(native.compute_batch(x),
                                   scorer.Scorer(out).compute_batch(x),
                                   rtol=1e-5, atol=1e-5)
    finally:
        native.close()


def test_the_sync_manifest_verifies_in_the_jax_package(tmp_path):
    from shifu_tpu.runtime import fleet as jax_fleet
    prof = _profile()
    model, _ = _saved(tmp_path, "mlp", 0)
    jspec, jschema = _jax_spec("mlp"), _jax_schema(0)
    pspec, pschema = _port(jspec, jschema)
    out = artifact.save_artifact(model, pspec, pschema,
                                 str(tmp_path / "with_profile"),
                                 baseline_profile=prof)
    mine = fleet.read_sync_manifest(out)
    theirs = jax_fleet.read_sync_manifest(out)
    assert mine == theirs and mine["algo"] == "blake2b-16"
    assert sorted(mine["files"]) == sorted(
        f for f in os.listdir(out) if f != "sync_manifest.json")
    assert "baseline_profile.json" in mine["files"]
    dest = jax_fleet.sync_artifact(out, str(tmp_path / "cache"), 1)
    assert sorted(os.listdir(dest)) == sorted(mine["files"])
    # a byte changed after the save: the JAX pull refuses it
    with open(os.path.join(out, "weights.npz"), "ab") as f:
        f.write(b"x")
    with pytest.raises(jax_fleet.SyncError, match="digest mismatch"):
        jax_fleet.sync_artifact(out, str(tmp_path / "cache"), 2)


def _profile():
    from shifu_tpu_torch.obs import sketch
    fs = sketch.FeatureSketch(F)
    fs.update(_rows(100, 0))
    ss = sketch.ScoreSketch()
    ss.update(np.linspace(0, 1, 50))
    return sketch.build_profile(fs, ss, train_auc=0.7, epoch=1)


def test_a_failed_manifest_write_raises_where_jax_swallows_it(
        tmp_path, monkeypatch):
    """Deliberate difference (ROADMAP.md section C): the JAX exporter
    ignores a failure to write sync_manifest.json; the port's
    save_artifact raises it."""
    from shifu_tpu.runtime import fleet as jax_fleet
    jspec, jschema = _jax_spec("mlp"), _jax_schema(0)
    pspec, pschema = _port(jspec, jschema)
    model = build_model(pspec, pschema, device="cpu")

    def broken(export_dir):
        raise OSError("disk full")

    monkeypatch.setattr(fleet, "write_sync_manifest", broken)
    with pytest.raises(OSError, match="disk full"):
        artifact.save_artifact(model, pspec, pschema, str(tmp_path / "p"))
    monkeypatch.setattr(jax_fleet, "write_sync_manifest", broken)
    import jax
    from shifu_tpu.config import JobConfig
    from shifu_tpu.export.artifact import save_artifact as jax_save
    from shifu_tpu.models.registry import build_model as jax_build
    params = jax_build(jspec, jschema).init(
        jax.random.PRNGKey(0), np.zeros((2, F), np.float32))["params"]
    jax_save(params, JobConfig(schema=jschema, model=jspec),
             str(tmp_path / "j"))
    assert not os.path.exists(tmp_path / "j" / "sync_manifest.json")


def test_an_invalid_baseline_profile_is_refused(tmp_path):
    jspec, jschema = _jax_spec("mlp"), _jax_schema(0)
    pspec, pschema = _port(jspec, jschema)
    model = build_model(pspec, pschema, device="cpu")
    with pytest.raises(ValueError, match="not a baseline profile"):
        artifact.save_artifact(model, pspec, pschema, str(tmp_path / "p"),
                               baseline_profile={"kind": "other"})
