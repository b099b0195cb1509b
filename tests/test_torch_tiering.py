"""The sparse embedding engine's host side in the port against the JAX
package's, on the CPU: the per-batch dedup report (embed/dedup.py's
`embed_dedup_report`, flushed at the loop's teardown) and the
frequency-tiered table (embed/tiering.py).

- A 2-epoch DeepFM job through both packages' `train` command journals
  `embed_dedup_report` with equal `batches`, `rows_touched`, `raw_cells`
  and `dedup_ratio` (exact: the same batches, the same ids).
- A `TieredTable` cold store built by either package is byte for byte the
  other's, and each opens the other's: f32 lookups exact, int8 within half
  a step of the wire grid (scale / 2) and equal across packages; the hit
  counters equal; the `embed.offload` drill journals the fallback and
  serves the same rows.
- The embed config keys validate as the JAX package's.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

from shifu_tpu.data import synthetic as jax_synth
from shifu_tpu.embed import TieredTable as JaxTieredTable
from shifu_tpu_torch import obs
from shifu_tpu_torch.embed.tiering import TieredTable

NC, V, D = 3, 200, 4

# what a `train` command exports into os.environ, which an earlier test
# file in the worker may have left behind
_CLI_ENV = ("SHIFU_TPU_CHAOS_PLAN", "SHIFU_TPU_CHAOS_STATE",
            "SHIFU_TPU_METRICS_DIR", "SHIFU_TPU_DATA_CACHE",
            "SHIFU_TPU_PDEATHSIG")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    from shifu_tpu import chaos as jax_chaos
    from shifu_tpu import obs as jax_obs
    from shifu_tpu_torch import chaos
    for var in _CLI_ENV:
        monkeypatch.delenv(var, raising=False)
    for m in (obs, jax_obs, chaos, jax_chaos):
        m.reset_for_tests()
    yield
    for var in _CLI_ENV:
        os.environ.pop(var, None)
    for m in (obs, jax_obs, chaos, jax_chaos):
        m.reset_for_tests()


def _port_schema(jschema):
    from shifu_tpu_torch.config import schema as port_schema
    return port_schema._from_dict(port_schema.DataSchema,
                                  dataclasses.asdict(jschema))


# -- the dedup report through both `train` commands ----------------------------

def _write_deepfm_job(tmp_path, vocab=30, rows=600):
    """Shifu files of a DeepFM job: 8 features, the last 3 categorical
    (vocab `vocab`), 2 epochs, batch 64 on the per-batch tier with the
    sparse update on (the tier that dedups)."""
    from shifu_tpu_torch.utils import xmlconfig

    schema = jax_synth.make_schema(num_features=8, num_categorical=3,
                                   vocab_size=vocab)
    jax_synth.write_files(jax_synth.make_rows(rows, schema, seed=11),
                          str(tmp_path / "data"), num_files=2)
    mc = {"basic": {"name": "deepfm"},
          "dataSet": {"targetColumnName": "target", "dataDelimiter": "|"},
          "train": {"validSetRate": 0.2, "numTrainEpochs": 2,
                    "algorithm": "DeepFM",
                    "params": {"NumHiddenLayers": 1, "NumHiddenNodes": [8],
                               "ActivationFunc": ["relu"],
                               "LearningRate": 0.5, "Propagation": "Q",
                               "Loss": "squared", "EmbeddingDim": 4}}}
    cc = []
    for c in schema.columns:
        entry = {"columnNum": c.index, "columnName": c.name,
                 "columnFlag": "Target" if c.is_target else None,
                 "columnType": "C" if c.is_categorical else "N",
                 "finalSelect": c.is_selected}
        if c.is_categorical:  # vocab = categories + the unseen bin
            entry["columnBinning"] = {
                "binCategory": [str(i) for i in range(vocab - 1)]}
        cc.append(entry)
    (tmp_path / "ModelConfig.json").write_text(json.dumps(mc))
    (tmp_path / "ColumnConfig.json").write_text(json.dumps(cc))
    xmlconfig.write_configuration_xml(
        {"shifu.application.batch-size": "64",
         "shifu.data.staged": "false",
         "shifu.train.sparse-embedding-update": "on",
         "shifu.checkpoint.save-seconds": "0",
         "shifu.liveness.seconds": "0"}, str(tmp_path / "global.xml"))
    return ["train", "--modelconfig", str(tmp_path / "ModelConfig.json"),
            "--columnconfig", str(tmp_path / "ColumnConfig.json"),
            "--data", str(tmp_path / "data"),
            "--globalconfig", str(tmp_path / "global.xml")]


def _dedup_reports(job_dir):
    recs = obs.read_journal(str(job_dir / "telemetry" / "journal.jsonl"))
    return [{k: r[k] for k in ("batches", "rows_touched", "raw_cells",
                               "dedup_ratio")}
            for r in recs if r["kind"] == "embed_dedup_report"]


def test_dedup_report_equal_through_both_train_commands(tmp_path):
    from shifu_tpu import obs as jax_obs
    from shifu_tpu.launcher import cli as jax_cli
    from shifu_tpu_torch.launcher import cli

    argv = _write_deepfm_job(tmp_path)
    assert jax_cli.main(argv + ["--output", str(tmp_path / "j")]) == 0
    jax_obs.reset_for_tests()
    assert cli.main(argv + ["--output", str(tmp_path / "p"),
                            "--device", "cpu"]) == 0
    obs.reset_for_tests()
    want = _dedup_reports(tmp_path / "j")
    got = _dedup_reports(tmp_path / "p")
    # one tail report (2 epochs of 7 batches: under the 256-batch cadence)
    assert len(want) == 1 and want[0]["batches"] == 2 * (480 // 64)
    assert got == want
    prom = (tmp_path / "p" / "telemetry" / "metrics.prom").read_text()
    assert "embed_dedup_ratio" in prom
    # `top`'s embed row and `profile`'s embed rollup read it back
    from shifu_tpu.obs import render as jax_render
    from shifu_tpu_torch.obs import render
    got_top = render.top_summary(str(tmp_path / "p"))["embed"]
    assert got_top == jax_render.top_summary(str(tmp_path / "j"))["embed"]
    assert got_top == {"dedup_ratio": want[0]["dedup_ratio"]}
    assert render.profile_summary(str(tmp_path / "p"))["embed"] == \
        jax_render.profile_summary(str(tmp_path / "j"))["embed"]


def test_attach_dedup_reports_on_its_cadence_and_flushes_the_tail(tmp_path):
    from shifu_tpu.embed import dedup as jax_dedup
    from shifu_tpu_torch.embed import dedup
    from shifu_tpu_torch.models.embedding import field_layout

    jschema = jax_synth.make_schema(num_features=6, num_categorical=NC,
                                    vocab_size=V)
    layout = field_layout(_port_schema(jschema))
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(5):
        feats = rng.standard_normal((16, 6)).astype(np.float32)
        feats[:, 6 - NC:] = rng.integers(0, 8, (16, NC)).astype(np.float32)
        batches.append({"features": feats})
    obs.configure(str(tmp_path / "p"), flush_every=1)
    transform = dedup.attach_dedup(layout, sentinel=V, report_every=2)
    for b in batches:
        transform(b)
    transform.finalize()
    obs.flush()
    got = [{k: r[k] for k in ("batches", "rows_touched", "raw_cells",
                              "dedup_ratio")}
           for r in obs.read_journal(str(tmp_path / "p" / "journal.jsonl"))
           if r["kind"] == "embed_dedup_report"]
    assert [r["batches"] for r in got] == [2, 4, 5]
    # the JAX transform on the same batches counts the same
    jstate = jax_dedup.attach_dedup(layout, sentinel=V, report_every=2)
    for b in batches:
        jstate(b)
    s = jstate.dedup_state
    assert got[-1] == {"batches": s["batches"], "rows_touched": s["unique"],
                       "raw_cells": s["cells"],
                       "dedup_ratio": round(s["unique"] / s["cells"], 4)}
    assert obs.gauge("embed_dedup_ratio").value() == pytest.approx(
        s["unique"] / s["cells"])


def test_attach_dedup_kicks_the_tiered_prefetch(tmp_path):
    from shifu_tpu_torch.embed import dedup
    from shifu_tpu_torch.models.embedding import field_layout

    jschema = jax_synth.make_schema(num_features=6, num_categorical=NC,
                                    vocab_size=V)
    layout = field_layout(_port_schema(jschema))

    class Recorder:
        def __init__(self):
            self.calls = []

        def prefetch(self, unique):
            self.calls.append(unique)

    rec = Recorder()
    transform = dedup.attach_dedup(layout, sentinel=V, tiered=rec)
    feats = np.zeros((8, 6), np.float32)
    feats[:, 6 - NC:] = np.arange(8)[:, None] % 3
    out = transform({"features": feats})
    assert len(rec.calls) == 1
    assert np.array_equal(rec.calls[0], out["embed_unique"])


# -- the tiered table ----------------------------------------------------------

def _table(seed=7, v=V):
    return np.random.default_rng(seed).standard_normal(
        (NC, v, D)).astype(np.float32)


def _files(entry):
    return {n: open(os.path.join(entry, n), "rb").read()
            for n in sorted(os.listdir(entry))}


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_cold_store_byte_identical_across_packages(tmp_path, dtype):
    table = _table()
    freq = np.random.default_rng(3).integers(0, 100, (NC, V))
    jt = JaxTieredTable.build(table, str(tmp_path / "j"), hot_rows=16,
                              tier_dtype=dtype, freq=freq)
    pt = TieredTable.build(table, str(tmp_path / "p"), hot_rows=16,
                           tier_dtype=dtype, freq=freq)
    assert _files(pt.cold_dir) == _files(jt.cold_dir)
    assert np.array_equal(pt.hot_ids, jt.hot_ids)
    assert np.array_equal(pt.hot_rows, jt.hot_rows)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("builder", ["jax", "port"])
def test_each_package_opens_the_others_store(tmp_path, dtype, builder):
    table = _table()
    build = JaxTieredTable.build if builder == "jax" else TieredTable.build
    built = build(table, str(tmp_path), hot_rows=16, tier_dtype=dtype)
    # open the same store in both packages, the hot set carried over
    pt = TieredTable(built.cold_dir, built.hot_ids, built.hot_rows)
    jt = JaxTieredTable(built.cold_dir, built.hot_ids, built.hot_rows)
    rng = np.random.default_rng(8)
    ids = rng.integers(0, V, (40, NC)).astype(np.int32)
    ids[0] = V  # the dedup sentinel: zero rows
    got, want = pt.lookup(ids), jt.lookup(ids)
    assert np.array_equal(got, want)
    ref = np.stack([table[f, np.clip(ids[:, f], 0, V - 1)]
                    for f in range(NC)], axis=1)
    ref[0] = 0.0
    if dtype == "float32":
        assert np.array_equal(got, ref)
    else:
        scale = float(pt.manifest["scale"])
        assert np.max(np.abs(got - ref)) <= scale / 2 + 1e-6
    for key in ("lookups", "hits", "misses", "cold_bytes"):
        assert pt.stats[key] == jt.stats[key], key
    assert pt.stats["hits"] > 0 and pt.stats["misses"] > 0


def test_zipf_hit_rates_equal_and_prefetch_serves_cold_rows(tmp_path):
    table = _table(v=2000)
    pt = TieredTable.build(table, str(tmp_path / "p"), hot_rows=64,
                           tier_dtype="int8")
    jt = JaxTieredTable.build(table, str(tmp_path / "j"), hot_rows=64,
                              tier_dtype="int8")
    rng = np.random.default_rng(11)
    ids = ((rng.zipf(1.1, size=(6, 256, NC)) - 1) % 2000).astype(np.int32)
    pt.prefetch(ids[0]).join()
    jt.prefetch(ids[0]).join()
    for s in range(6):
        assert np.array_equal(pt.lookup(ids[s]), jt.lookup(ids[s]))
    obs.configure(str(tmp_path / "tele"), flush_every=1)
    rep = pt.tier_report()
    jrep = dict(jt.stats)
    total = jrep["hits"] + jrep["misses"]
    assert rep["hit_rate"] == round(jrep["hits"] / total, 4)
    assert 0 < rep["hit_rate"] < 1
    for key in ("hits", "misses", "prefetch_hits", "cold_bytes"):
        assert rep[key] == jrep[key], key
    assert rep["prefetch_hits"] > 0
    assert (rep["hot_rows"], rep["vocab"]) == (64, 2000)
    obs.flush()
    recs = obs.read_journal(str(tmp_path / "tele" / "journal.jsonl"))
    assert [r["hit_rate"] for r in recs
            if r["kind"] == "embed_tier_report"] == [rep["hit_rate"]]


def test_embed_offload_drill_journals_the_fallback(tmp_path):
    from shifu_tpu_torch import chaos
    from shifu_tpu_torch.chaos import plan as plan_mod
    from shifu_tpu_torch.obs import render

    obs.configure(str(tmp_path / "tele"), flush_every=1)
    table = _table(seed=10)
    tt = TieredTable.build(table, str(tmp_path / "a"), hot_rows=16)
    clean = TieredTable.build(table, str(tmp_path / "b"), hot_rows=16)
    chaos.configure(plan_mod.parse_plan({"faults": [
        {"site": "embed.offload", "at_call": 1, "max_times": 1}]}))
    ids = np.random.default_rng(10).integers(16, V, (32, NC)).astype(
        np.int32)
    got = tt.lookup(ids)
    chaos.reset_for_tests()
    assert tt.stats["fallbacks"] == 1
    assert np.array_equal(got, clean.lookup(ids))
    assert tt.tier_report()["fallbacks"] == 1
    obs.flush()
    recs = obs.read_journal(str(tmp_path / "tele" / "journal.jsonl"))
    fb = [r for r in recs if r["kind"] == "embed_offload_fallback"]
    assert len(fb) == 1 and fb[0]["error"] == "ChaosError"
    summary = render.profile_summary(str(tmp_path / "tele"))
    assert summary["embed"]["offload_fallbacks"] == 1
    assert summary["embed"]["tier"]["fallbacks"] == 1


def test_keep_source_serves_the_fallback_from_the_table(tmp_path):
    from shifu_tpu_torch import chaos
    from shifu_tpu_torch.chaos import plan as plan_mod

    table = _table(seed=12)
    tt = TieredTable.build(table, str(tmp_path), hot_rows=8,
                           keep_source=True)
    chaos.configure(plan_mod.parse_plan({"faults": [
        {"site": "embed.offload", "every": 1}]}))
    ids = np.full((4, NC), V - 1, np.int32)
    got = tt.lookup(ids)
    chaos.reset_for_tests()
    assert tt.stats["fallbacks"] == NC
    assert np.array_equal(got, np.stack([table[f, ids[:, f]]
                                         for f in range(NC)], axis=1))


def test_build_rejects_an_unknown_dtype(tmp_path):
    with pytest.raises(ValueError, match="float32|int8"):
        TieredTable.build(_table(), str(tmp_path), tier_dtype="bf16")


def test_embed_config_keys_validate_as_jax(tmp_path):
    from shifu_tpu.config import ConfigError as JaxConfigError
    from shifu_tpu.config import EmbedConfig as JaxEmbedConfig
    from shifu_tpu_torch.config.schema import ConfigError, EmbedConfig

    good = dict(tiering="host", tier_dtype="int8", hot_rows=1024,
                hot_fraction=0.1, cold_dir=str(tmp_path))
    EmbedConfig(**good).validate()
    JaxEmbedConfig(**good).validate()
    for bad in (dict(tiering="device"), dict(tier_dtype="bf16"),
                dict(hot_rows=-1), dict(hot_fraction=0.0),
                dict(hot_fraction=1.5), dict(dedup="on")):
        with pytest.raises(ConfigError):
            EmbedConfig(**bad).validate()
        with pytest.raises(JaxConfigError):
            JaxEmbedConfig(**bad).validate()
