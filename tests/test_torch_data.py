"""The port's config ingestion and data pipeline (shifu_tpu_torch/config,
shifu_tpu_torch/data) against the JAX package's.

Everything here is host code on numpy, so the two packages must agree
exactly: the same JobConfig from the same Shifu files, the same parsed
rows, split, synthetic rows, wire bytes and epoch order.
"""

import copy
import dataclasses
import gzip
import json

import numpy as np
import pytest

from shifu_tpu import config as jax_config
from shifu_tpu.data import pipeline as jax_pipe
from shifu_tpu.data import reader as jax_reader
from shifu_tpu.data import split as jax_split
from shifu_tpu.data import synthetic as jax_synth
from shifu_tpu_torch import config as port_config
from shifu_tpu_torch.config import schema as port_schema
from shifu_tpu_torch.data import pipeline as pipe
from shifu_tpu_torch.data import reader, split, synthetic

# the fixture of tests/test_config.py
MODEL_CONFIG = {
    "basic": {"name": "wdbc"},
    "dataSet": {"targetColumnName": "diagnosis", "weightColumnName": None},
    "train": {
        "baggingSampleRate": 1.0,
        "validSetRate": 0.2,
        "numTrainEpochs": 7,
        "algorithm": "NN",
        "params": {
            "NumHiddenLayers": 2,
            "NumHiddenNodes": [30, 10],
            "ActivationFunc": ["tanh", "ReLU"],
            "LearningRate": 0.05,
            "Propagation": "Q",
        },
    },
}


def make_column_config():
    cols = [
        {"columnNum": 0, "columnName": "id", "columnFlag": "Meta",
         "finalSelect": False},
        {"columnNum": 1, "columnName": "diagnosis", "columnFlag": "Target",
         "finalSelect": False},
    ]
    for i in range(2, 32):
        cols.append({"columnNum": i, "columnName": f"f{i}",
                     "columnType": "N", "finalSelect": i < 30})
    return cols


def _variant(name):
    mc = copy.deepcopy(MODEL_CONFIG)
    params = mc["train"]["params"]
    if name == "sagn":
        mc["train"]["algorithm"] = "SAGN"
    elif name == "loss_log_adam_cosine":
        params.update(Loss="log", Optimizer="Adam",
                      LearningRateSchedule="cosine", DecaySteps=100,
                      EndLearningRateFactor=0.1)
    elif name == "dropout_accumulate_early_stop":
        params.update(DropoutRate=0.25, AccumulateSteps=4,
                      EarlyStopPatience=3, EarlyStopMinDelta=1e-4)
        mc["train"]["baggingSampleRate"] = 0.5
    elif name == "escaped_delimiter":
        mc["dataSet"]["dataDelimiter"] = "\\t"
    elif name == "ft_transformer":
        mc["train"]["algorithm"] = "FT_TRANSFORMER"
        params.update(TokenDim=32, NumTransformerLayers=2,
                      NumAttentionHeads=4)
    return mc


@pytest.mark.parametrize("variant", ["base", "sagn", "loss_log_adam_cosine",
                                     "dropout_accumulate_early_stop",
                                     "escaped_delimiter", "ft_transformer"])
def test_job_config_from_shifu_matches_jax(variant, tmp_path):
    mc = tmp_path / "ModelConfig.json"
    cc = tmp_path / "ColumnConfig.json"
    mc.write_text(json.dumps(_variant(variant)))
    cc.write_text(json.dumps(make_column_config()))
    want = jax_config.job_config_from_shifu(str(mc), str(cc),
                                            data_paths=("/data",))
    got = port_config.job_config_from_shifu(str(mc), str(cc),
                                            data_paths=("/data",))
    assert got.to_dict() == want.to_dict()


def test_shifu_config_errors_match_jax():
    mc = copy.deepcopy(MODEL_CONFIG)
    mc["train"]["params"]["NumHiddenNodes"] = [30]
    for pkg in (jax_config, port_config):
        with pytest.raises(pkg.ConfigError):
            pkg.parse_model_config(mc)


def test_from_dict_parses_a_jax_job_dict():
    jax_job = jax_config.JobConfig(
        schema=jax_synth.make_schema(30),
        data=jax_config.DataConfig(batch_size=65536, wire_dtype="int8"),
        model=jax_config.ModelSpec(hidden_nodes=(100, 100, 100),
                                   activations=("relu",) * 3),
        train=jax_config.TrainConfig(epochs=2)).validate()
    port_job = port_config.JobConfig.from_dict(
        json.loads(jax_job.to_json())).validate()
    assert port_job.to_dict() == jax_job.to_dict()


@pytest.mark.parametrize("cls", ["DataConfig", "OptimizerConfig",
                                 "TrainConfig", "ModelSpec", "JobConfig",
                                 "CheckpointConfig", "RuntimeConfig"])
def test_config_fields_and_defaults_match_jax(cls):
    def fields(c):
        return {f.name: (f.default if f.default is not dataclasses.MISSING
                         else dataclasses.asdict(f.default_factory()))
                for f in dataclasses.fields(c)}
    assert fields(getattr(port_schema, cls)) == fields(
        getattr(jax_config.schema, cls))


@pytest.mark.parametrize("bad", [
    {"data": {"wire_dtype": "int4"}},
    {"data": {"wire_int8_clip": 0.0}},
    {"data": {"resident_format": "fp8"}},
    {"train": {"optimizer": {"schedule": "cosine"}}},
    {"train": {"early_stop_patience": -1}},
    {"embed": {"dedup": "bogus"}},
    {"embed": {"hot_fraction": 0.0}},
    {"runtime": {"mesh": {"data": 0}}},
    {"obs": {"trace_epochs": "nonsense"}},
])
def test_validation_errors_match_jax(bad):
    messages = []
    for pkg in (jax_config, port_config):
        job = pkg.JobConfig.from_dict({"schema": dataclasses.asdict(
            jax_synth.make_schema(4)), **bad})
        with pytest.raises(pkg.ConfigError) as err:
            job.validate()
        messages.append(str(err.value))
    assert messages[0] == messages[1]


@pytest.mark.parametrize("spec", [
    "", "off", " OFF ", "0", "false", "none", None, "first", "on", "true",
    "every:3", "EVERY:1", "0,2,5", " 4 , 7 ,", "3",
    "nonsense", "every:0", "every:-2", "every:x", "every:", "1,two",
    "first,2", "every:2,3",
])
def test_trace_epochs_grammar_matches_jax(spec):
    from shifu_tpu.obs import devprof as jax_devprof
    from shifu_tpu_torch.obs import devprof

    def outcome(parse):
        try:
            pred = parse(spec)
        except ValueError as e:
            return "raises", str(e)
        return "parses", [pred(e, s) for e in range(8) for s in (0, 2)]

    assert (outcome(devprof.parse_trace_epochs)
            == outcome(jax_devprof.parse_trace_epochs))


def test_int8_requires_categorical_free_features():
    for pkg, synth in ((jax_config, jax_synth), (port_config, synthetic)):
        job = pkg.JobConfig(schema=synth.make_schema(6, num_categorical=2),
                            data=pkg.DataConfig(wire_dtype="int8"))
        with pytest.raises(pkg.ConfigError, match="categorical-free"):
            job.validate()


_SCHEMAS = {
    "plain": dict(num_features=12),
    "weighted": dict(num_features=7, with_weight=True),
    "categorical": dict(num_features=9, num_categorical=3, vocab_size=50),
    "multitarget": dict(num_features=5, num_targets=3),
}


@pytest.mark.parametrize("kind", sorted(_SCHEMAS))
def test_synthetic_rows_bitwise(kind):
    want_schema = jax_synth.make_schema(**_SCHEMAS[kind])
    got_schema = synthetic.make_schema(**_SCHEMAS[kind])
    assert dataclasses.asdict(got_schema) == dataclasses.asdict(want_schema)
    for seed in (0, 7):
        want = jax_synth.make_rows(500, want_schema, seed=seed)
        got = synthetic.make_rows(500, got_schema, seed=seed)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_written_files_and_read_files_match_jax(tmp_path):
    schema = synthetic.make_schema(10, with_weight=True)
    rows = synthetic.make_rows(1234, schema, seed=3)
    got_paths = synthetic.write_files(rows, str(tmp_path / "port"), 3)
    want_paths = jax_synth.write_files(rows, str(tmp_path / "jax"), 3)
    for g, w in zip(got_paths, want_paths):
        with gzip.open(g) as fg, gzip.open(w) as fw:
            assert fg.read() == fw.read()
    files = reader.list_data_files(str(tmp_path / "port"))
    assert files == jax_reader.list_data_files(str(tmp_path / "port"))
    got = reader.read_files(files)
    want = jax_reader.read_files(files)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(np.concatenate(got), rows, rtol=1e-5,
                               atol=1e-6)


def test_parse_rows_ragged_and_bad_cells_match_jax():
    text = "1|2|3\n\n4|x|6\n7|8\n  \n9|10|11|12\n"
    np.testing.assert_array_equal(reader.parse_rows(text),
                                  jax_reader.parse_rows(text))
    plain = b"0.5|1e-3|-2\n3|4|5\n"
    np.testing.assert_array_equal(reader.parse_rows(plain),
                                  jax_reader.parse_rows(plain))


def test_project_columns_matches_jax():
    schema = synthetic.make_schema(6, with_weight=True)
    rows = synthetic.make_rows(50, schema, seed=1)
    rows[3, 2] = np.nan           # a NaN feature is imputed
    rows[4, schema.weight_index] = -1.0  # a negative weight clamps to 1
    got = reader.project_columns(rows, schema)
    want = jax_reader.project_columns(rows, jax_synth.make_schema(
        6, with_weight=True))
    for k in ("features", "target", "weight"):
        np.testing.assert_array_equal(got[k], want[k])


def test_split_masks_bitwise():
    ids = np.arange(10_000, dtype=np.uint64) + (np.uint64(3) << np.uint64(40))
    for ratio, seed in ((0.1, 0), (0.25, 17)):
        for a, b in zip(split.train_valid_mask(ids, ratio, seed),
                        jax_split.train_valid_mask(ids, ratio, seed)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(split.bagging_mask(ids, 0.6, 42),
                                  jax_split.bagging_mask(ids, 0.6, 42))


@pytest.mark.parametrize("clip", [8.0, 3.0])
def test_wire_grid_and_quantize_bitwise(clip):
    schema = synthetic.make_schema(12)
    data = port_config.DataConfig(wire_int8_clip=clip)
    jdata = jax_config.DataConfig(wire_int8_clip=clip)
    (s, o), (js, jo) = (pipe.wire_params(schema, data),
                        jax_pipe.wire_params(schema, jdata))
    np.testing.assert_array_equal(s, js)
    np.testing.assert_array_equal(o, jo)
    x = np.random.default_rng(0).normal(scale=4, size=(300, 12)).astype(
        np.float32)
    q = pipe.wire_quantize(x, s, o)
    np.testing.assert_array_equal(q, jax_pipe.wire_quantize(x, js, jo))
    np.testing.assert_array_equal(pipe.wire_dequantize(q, s, o),
                                  jax_pipe.wire_dequantize(q, js, jo))


@pytest.mark.parametrize("compact", [False, True, (True, True),
                                     (True, False)])
@pytest.mark.parametrize("wire", ["int8", "float32", "auto"])
def test_wire_cast_fn_bitwise(wire, compact):
    schema = synthetic.make_schema(8)
    rng = np.random.default_rng(1)
    batch = {"features": rng.normal(size=(64, 8)).astype(np.float32),
             "target": rng.integers(0, 2, (64, 1)).astype(np.float32),
             "weight": np.ones((64, 1), np.float32)}
    fn = pipe.wire_cast_fn(schema, port_config.DataConfig(wire_dtype=wire),
                           "float32", compact=compact)
    jfn = jax_pipe.wire_cast_fn(schema, jax_config.DataConfig(
        wire_dtype=wire), "float32", compact=compact)
    assert (fn is None) == (jfn is None)
    if fn is None:
        return
    got, want = fn(dict(batch)), jfn(dict(batch))
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_compact_detection_matches_jax():
    t = np.array([[0.0], [1.0], [3.0]], np.float32)
    for arr in (t, t + 0.5, -t, np.array([[256.0]], np.float32)):
        assert pipe.target_u8_exact(arr) == jax_pipe.target_u8_exact(arr)
    for w in (np.ones((4, 1), np.float32), np.full((4, 1), 2.0, np.float32)):
        assert pipe.weight_all_ones(w) == jax_pipe.weight_all_ones(w)


def test_wire_modes_match_jax():
    for schema in (synthetic.make_schema(5),
                   synthetic.make_schema(5, num_categorical=2)):
        for wire in ("auto", "float32", "bfloat16", "int8"):
            for resident in ("auto", "wire", "int8"):
                for cdt in ("bfloat16", "float32"):
                    d = port_config.DataConfig(wire_dtype=wire,
                                               resident_format=resident)
                    jd = jax_config.DataConfig(wire_dtype=wire,
                                               resident_format=resident)
                    assert (pipe.wire_mode(schema, d, cdt)
                            == jax_pipe.wire_mode(schema, jd, cdt))
                    assert (pipe.resident_feature_format(schema, d, cdt)
                            == jax_pipe.resident_feature_format(schema, jd,
                                                                cdt))


def test_epoch_permutation_and_batches_bitwise():
    for n, seed, epoch in ((1000, 0, 0), (1000, 5, 3), (17, 2, 1)):
        np.testing.assert_array_equal(
            pipe.epoch_permutation(n, seed=seed, epoch=epoch),
            jax_pipe.epoch_permutation(n, seed=seed, epoch=epoch))
    np.testing.assert_array_equal(
        pipe.epoch_permutation(9, shuffle=False),
        jax_pipe.epoch_permutation(9, shuffle=False))
    rng = np.random.default_rng(0)
    arrays = (rng.normal(size=(103, 4)).astype(np.float32),
              rng.integers(0, 2, (103, 1)).astype(np.float32),
              rng.uniform(size=(103, 1)).astype(np.float32))
    ds, jds = pipe.TabularDataset(*arrays), jax_pipe.TabularDataset(*arrays)
    for drop in (True, False):
        got = list(pipe.batch_iterator(ds, 10, seed=4, epoch=2,
                                       drop_remainder=drop))
        want = list(jax_pipe.batch_iterator(jds, 10, seed=4, epoch=2,
                                            drop_remainder=drop))
        assert len(got) == len(want) == (10 if drop else 11)
        assert pipe.num_batches(ds, 10, drop) == jax_pipe.num_batches(
            jds, 10, drop)
        for g, w in zip(got, want):
            for k in g:
                np.testing.assert_array_equal(g[k], w[k])
    tail = list(pipe.batch_iterator(ds, 10, shuffle=False,
                                    drop_remainder=False))[-1]
    for (g, gm), (w, wm) in ((pipe.pad_to_batch(tail, 10),
                              jax_pipe.pad_to_batch(tail, 10)),):
        np.testing.assert_array_equal(gm, wm)
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("feature_dtype", ["int8c8", "float32"])
def test_load_datasets_matches_jax(feature_dtype, tmp_path, monkeypatch):
    monkeypatch.delenv("SHIFU_TPU_DATA_CACHE", raising=False)
    schema = synthetic.make_schema(10, with_weight=True)
    rows = synthetic.make_rows(3000, schema, seed=9)
    synthetic.write_files(rows, str(tmp_path / "a"), 3)
    synthetic.write_files(rows[:500], str(tmp_path / "b"), 1, compress=False)
    paths = (str(tmp_path / "a"), str(tmp_path / "b"))
    data = port_config.DataConfig(paths=paths, valid_ratio=0.2, split_seed=3)
    jdata = jax_config.DataConfig(paths=paths, valid_ratio=0.2, split_seed=3)
    got = pipe.load_datasets(schema, data, feature_dtype=feature_dtype)
    want = jax_pipe.load_datasets(jax_synth.make_schema(10, with_weight=True),
                                  jdata, feature_dtype=feature_dtype)
    for g, w in zip(got, want):
        assert g.num_rows == w.num_rows > 0
        for k in ("features", "target", "weight"):
            assert getattr(g, k).dtype == getattr(w, k).dtype
            np.testing.assert_array_equal(getattr(g, k), getattr(w, k))
