"""The port's parse-once cache (shifu_tpu_torch/data/cache.py and the cache
tier of data/pipeline.py) against the JAX package's: the same entry names,
byte-identical entries, each package hot on the other's cache for the
float32, bfloat16 and int8 wires, the same hot-cache decision, the v1 and
legacy upgrade, the `cache` command's scan and prune, and a chaos
`data.cache` read fault taking the journaled fallback."""

import dataclasses
import json
import os
import shutil
import time

import numpy as np
import pytest

from shifu_tpu import chaos as jax_chaos
from shifu_tpu import obs as jax_obs
from shifu_tpu.config import schema as jax_schema
from shifu_tpu.data import cache as jax_cache
from shifu_tpu.data import pipeline as jax_pipe
from shifu_tpu.data import reader as jax_reader
from shifu_tpu_torch import chaos, obs
from shifu_tpu_torch.config import schema as port_schema
from shifu_tpu_torch.data import cache, pipeline as pipe, reader, synthetic

FEATURE_DTYPES = ("float32", "bfloat16", "int8c8")


@pytest.fixture(autouse=True)
def _clean():
    for m in (obs, jax_obs):
        m.reset_for_tests()
    chaos.reset_for_tests()
    jax_chaos.reset_for_tests()
    yield
    for m in (obs, jax_obs):
        m.reset_for_tests()
    chaos.reset_for_tests()
    jax_chaos.reset_for_tests()


def _files(tmp_path, rows=500, num_files=3, seed=3):
    schema = synthetic.make_schema(num_features=6, with_weight=True)
    rows_arr = synthetic.make_rows(rows, schema, seed=seed)
    synthetic.write_files(rows_arr, str(tmp_path / "data"),
                          num_files=num_files)
    return schema, str(tmp_path / "data")


def _configs(schema, data_dir, cache_dir, **kw):
    pdata = port_schema.DataConfig(paths=(data_dir,), cache_dir=cache_dir,
                                   ingest_workers=1, **kw)
    jdata = jax_schema.DataConfig(**dataclasses.asdict(pdata))
    jsch = jax_schema.JobConfig.from_dict(
        {"schema": dataclasses.asdict(schema)}).schema
    return jsch, jdata, pdata


def _feat_bits(f):
    f = np.asarray(f)
    if f.dtype.name == "bfloat16":
        return f.view(np.uint16)
    return f


def _same(pds, jds):
    for p, j in zip(pds, jds):
        assert np.array_equal(_feat_bits(p.features), _feat_bits(j.features))
        assert np.array_equal(p.target, j.target)
        assert np.array_equal(p.weight, j.weight)
        assert p.target.dtype == j.target.dtype == np.float32


def _tree(d):
    out = {}
    for root, _dirs, names in os.walk(d):
        for n in names:
            full = os.path.join(root, n)
            with open(full, "rb") as f:
                out[os.path.relpath(full, d)] = f.read()
    return out


def _no_parse(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("parsed despite a hot cache")
    monkeypatch.setattr(reader, "read_file", refuse)
    monkeypatch.setattr(jax_reader, "read_file", refuse)


def test_entry_names_match_jax(tmp_path):
    schema, data_dir = _files(tmp_path)
    jsch, jdata, pdata = _configs(schema, data_dir, None)
    for file_idx, path in pipe.source_files(pdata):
        for v in (None, 1, 2):
            assert cache.cache_entry_name(path, "|", version=v) \
                == jax_cache.cache_entry_name(path, "|", version=v)
            for fd in FEATURE_DTYPES:
                assert cache.projected_entry_name(
                    path, "|", file_idx, schema, 0.1, 0, fd, version=v) \
                    == jax_cache.projected_entry_name(
                        path, "|", file_idx, jsch, 0.1, 0, fd, version=v)
        assert cache.legacy_projected_path("x/a.npd") \
            == jax_cache.legacy_projected_path("x/a.npd")
    assert pipe.resolved_cache_format(pdata) \
        == jax_pipe.resolved_cache_format(jdata) == 2


@pytest.mark.parametrize("fd", FEATURE_DTYPES)
def test_entries_are_byte_identical_and_hot_across_packages(
        tmp_path, monkeypatch, fd):
    schema, data_dir = _files(tmp_path)
    pc, jc = str(tmp_path / "pc"), str(tmp_path / "jc")
    jsch, jdata, pdata = _configs(schema, data_dir, pc)
    assert not pipe.projected_cache_complete(schema, pdata, fd)
    port_cold = pipe.load_datasets(schema, pdata, feature_dtype=fd)
    jdata_own = dataclasses.replace(jdata, cache_dir=jc)
    jax_cold = jax_pipe.load_datasets(jsch, jdata_own, feature_dtype=fd)
    _same(port_cold, jax_cold)
    assert _tree(pc) == _tree(jc)  # the same names, the same bytes
    if fd == "bfloat16":
        assert port_cold[0].features.dtype == np.uint16
        assert any(n.endswith("features_bf16.npy") for n in _tree(pc))
    # each package hot on the other's cache: no parse at all
    assert pipe.projected_cache_complete(schema,
                                         dataclasses.replace(pdata,
                                                             cache_dir=jc),
                                         fd)
    assert jax_pipe.projected_cache_complete(jsch, jdata, 0, 1, fd)
    _no_parse(monkeypatch)
    port_hot = pipe.load_datasets(
        schema, dataclasses.replace(pdata, cache_dir=jc), feature_dtype=fd)
    jax_hot = jax_pipe.load_datasets(jsch, jdata, feature_dtype=fd)
    _same(port_hot, port_cold)
    _same(jax_hot, jax_cold)
    assert isinstance(port_hot[0].features, np.ndarray)


def test_hot_decision_follows_the_sources(tmp_path):
    schema, data_dir = _files(tmp_path)
    jsch, jdata, pdata = _configs(schema, data_dir, str(tmp_path / "c"))
    fd = "int8c8"
    pipe.load_datasets(schema, pdata, feature_dtype=fd)
    assert pipe.projected_cache_complete(schema, pdata, fd)
    assert jax_pipe.projected_cache_complete(jsch, jdata, 0, 1, fd)
    # another wire format, another split: cold for both
    for d_p, d_j, f in (
            (pdata, jdata, "float32"),
            (dataclasses.replace(pdata, valid_ratio=0.2),
             dataclasses.replace(jdata, valid_ratio=0.2), fd)):
        assert not pipe.projected_cache_complete(schema, d_p, f)
        assert not jax_pipe.projected_cache_complete(jsch, d_j, 0, 1, f)
    # a rewritten source: cold for both
    part = sorted(os.listdir(data_dir))[1]
    path = os.path.join(data_dir, part)
    os.utime(path, ns=(time.time_ns(), time.time_ns() + 10 ** 9))
    assert not pipe.projected_cache_complete(schema, pdata, fd)
    assert not jax_pipe.projected_cache_complete(jsch, jdata, 0, 1, fd)
    assert not pipe.projected_cache_complete(
        schema, dataclasses.replace(pdata, cache_dir=None), fd)


def test_a_v1_entry_is_served_and_upgraded(tmp_path, monkeypatch):
    schema, data_dir = _files(tmp_path)
    c = str(tmp_path / "c")
    jsch, jdata, pdata = _configs(schema, data_dir, c)
    fd = "float32"
    # the JAX package pinned to format 1 writes v1 entries
    want = jax_pipe.load_datasets(
        jsch, dataclasses.replace(jdata, cache_format=1), feature_dtype=fd)
    v1 = sorted(os.listdir(c))
    assert all(json.load(open(os.path.join(c, n, "entry.json")))["version"]
               == 1 for n in v1)
    assert pipe.projected_cache_complete(schema, pdata, fd)
    got = pipe.load_datasets(schema, pdata, feature_dtype=fd)
    _same(got, want)
    v2 = sorted(os.listdir(c))
    assert not set(v1) & set(v2) and len(v2) == len(v1)
    assert all(json.load(open(os.path.join(c, n, "entry.json")))["version"]
               == 2 for n in v2)
    _no_parse(monkeypatch)
    _same(pipe.load_datasets(schema, pdata, feature_dtype=fd), want)


def test_a_legacy_npz_entry_loads_alike(tmp_path):
    schema, data_dir = _files(tmp_path)
    c = str(tmp_path / "c")
    os.makedirs(c)
    rng = np.random.default_rng(0)
    arrays = {"features": rng.normal(size=(20, 6)).astype(np.float32),
              "target": rng.integers(0, 2, size=(20, 1)).astype(np.float32),
              "weight": np.full((20, 1), 2.0, np.float32),
              "valid_mask": rng.random(20) < 0.2}
    np.savez(os.path.join(c, "abc-def-p0.npz"), **arrays)
    got = cache.load_projected_entry(c, "abc-def-p0.npd")
    want = jax_cache.load_projected_entry(c, "abc-def-p0.npd")
    for k in arrays:
        assert np.array_equal(got[k], want[k]) and np.array_equal(got[k],
                                                                   arrays[k])


def test_raw_tier_round_trips_like_jax(tmp_path):
    schema, data_dir = _files(tmp_path)
    files = [p for _, p in pipe.source_files(
        port_schema.DataConfig(paths=(data_dir,)))]
    pc, jc = str(tmp_path / "pc"), str(tmp_path / "jc")
    got = reader.read_files(files, cache_dir=pc)
    want = jax_reader.read_files(files, cache_dir=jc)
    assert _tree(pc) == _tree(jc)
    hot = reader.read_files(files, cache_dir=jc)
    for a, b, h in zip(got, want, hot):
        assert np.array_equal(a, b, equal_nan=True)
        assert np.array_equal(a, h, equal_nan=True)


def _scan_fixture(tmp_path):
    schema, data_dir = _files(tmp_path, num_files=4)
    c = str(tmp_path / "c")
    jsch, jdata, pdata = _configs(schema, data_dir, c)
    pipe.load_datasets(schema, pdata, feature_dtype="int8c8")
    reader.read_files([os.path.join(data_dir, sorted(os.listdir(data_dir))[0])],
                      cache_dir=c)
    parts = sorted(os.listdir(data_dir))
    # one stale source, one gone, one old tmp leftover, one fresh tmp
    st = os.stat(os.path.join(data_dir, parts[1]))
    os.utime(os.path.join(data_dir, parts[1]),
             ns=(st.st_atime_ns, st.st_mtime_ns + 10 ** 9))
    os.remove(os.path.join(data_dir, parts[2]))
    old = os.path.join(c, "leftover.tmp")
    os.makedirs(old)
    open(os.path.join(old, "x.npy"), "wb").write(b"123")
    past = time.time() - 2 * cache.TMP_GRACE_SECONDS
    os.utime(old, (past, past))
    os.makedirs(os.path.join(c, "live.tmp"))
    open(os.path.join(c, ".hidden"), "w").write("not ours")
    return c


def test_scan_and_prune_match_jax(tmp_path):
    c = _scan_fixture(tmp_path)
    c2 = str(tmp_path / "c2")
    shutil.copytree(c, c2)
    old = time.time() - 2 * cache.TMP_GRACE_SECONDS
    os.utime(os.path.join(c2, "leftover.tmp"), (old, old))
    got, want = cache.scan_cache(c), jax_cache.scan_cache(c)
    assert got == want
    statuses = sorted(r["status"] for r in got)
    assert statuses.count("stale") == 1 and statuses.count("orphaned") == 1
    assert statuses.count("tmp") == 1
    removed = cache.prune_cache(c)
    jremoved = jax_cache.prune_cache(c2)
    assert [r["name"] for r in removed] == [r["name"] for r in jremoved]
    assert sorted(os.listdir(c)) == sorted(os.listdir(c2))
    assert os.path.exists(os.path.join(c, "live.tmp"))
    assert os.path.exists(os.path.join(c, ".hidden"))
    assert cache.PRUNE_STATUSES == jax_cache.PRUNE_STATUSES


def test_a_cache_read_fault_takes_the_journaled_fallback(tmp_path):
    schema, data_dir = _files(tmp_path)
    jsch, jdata, pdata = _configs(schema, data_dir, str(tmp_path / "c"))
    fd = "int8c8"
    want = pipe.load_datasets(schema, pdata, feature_dtype=fd)
    results = {}
    for name, ch, o, load in (
            ("port", chaos, obs,
             lambda: pipe.load_datasets(schema, pdata, feature_dtype=fd)),
            ("jax", jax_chaos, jax_obs,
             lambda: jax_pipe.load_datasets(jsch, jdata, feature_dtype=fd))):
        o.configure(str(tmp_path / f"tele_{name}"))
        ch.configure(ch.parse_plan({"faults": [
            {"site": "data.cache", "at_call": 1, "action": "raise"}]}))
        got = load()
        o.flush()
        ev = o.read_journal(str(tmp_path / f"tele_{name}" / "journal.jsonl"))
        results[name] = [(e["kind"], e.get("site"), e.get("op"))
                         for e in ev if e["kind"] in ("chaos_inject",
                                                      "cache_fallback")]
        fb = [e for e in ev if e["kind"] == "cache_fallback"]
        assert len(fb) == 1 and fb[0]["reason"].startswith("read fault")
        _same(got, want)
        o.reset_for_tests()
        ch.reset_for_tests()
    assert results["port"] == results["jax"] == [
        ("chaos_inject", "data.cache", "read"), ("cache_fallback", None, None)]


def test_a_corrupt_entry_is_removed_and_reparsed(tmp_path):
    schema, data_dir = _files(tmp_path)
    c = str(tmp_path / "c")
    jsch, jdata, pdata = _configs(schema, data_dir, c)
    want = pipe.load_datasets(schema, pdata, feature_dtype="float32")
    victim = sorted(os.listdir(c))[0]
    with open(os.path.join(c, victim, "features.npy"), "wb") as f:
        f.write(b"garbage")
    got = pipe.load_datasets(schema, pdata, feature_dtype="float32")
    _same(got, want)
    assert pipe.projected_cache_complete(schema, pdata, "float32")


def test_async_writer_drains_on_close(tmp_path):
    w = cache.AsyncEntryWriter(max_pending=1)
    seen = []
    arrays = {"features": np.ones((3, 2), np.int8),
              "target": np.zeros((3, 1), np.float32),
              "weight": np.ones((3, 1), np.float32),
              "valid_mask": np.zeros(3, bool)}
    for i in range(4):
        w.submit(str(tmp_path), f"a{i}-b-p.npd", arrays, record=seen.append)
    w.close()
    w.close()
    assert len(seen) == 4
    for i in range(4):
        got = cache.load_projected_entry(str(tmp_path), f"a{i}-b-p.npd")
        assert "weight" in got and got["target"].dtype == np.float32
        manifest = json.load(open(tmp_path / f"a{i}-b-p.npd" / "entry.json"))
        assert manifest["weight_mode"] == "elided"
        assert manifest["target_dtype"] == "uint8"


@pytest.mark.parametrize("tier_kw", [{"device_resident_bytes": 0}, {}],
                         ids=["staged", "resident"])
def test_bf16_bits_train_as_f32_cast_on_the_card(tmp_path, tier_kw):
    """Under a bfloat16 wire the loader keeps bf16 bits (uint16); they
    train exactly as float32 features cast on the card would."""
    from shifu_tpu_torch.train.loop import train
    schema, data_dir = _files(tmp_path, rows=900)
    _jsch, _jdata, pdata = _configs(schema, data_dir, str(tmp_path / "c"))
    data = dataclasses.replace(pdata, batch_size=64, wire_dtype="bfloat16",
                               stream_first_epoch=False, **tier_kw)
    job = port_schema.JobConfig(
        schema=schema, data=data,
        model=port_schema.ModelSpec(hidden_nodes=(8,), activations=("relu",),
                                    compute_dtype="bfloat16"),
        train=port_schema.TrainConfig(epochs=2, seed=1)).validate()
    got = train(job, console=lambda s: None, device="cpu")
    f32 = pipe.load_datasets(schema, dataclasses.replace(data, cache_dir=None),
                             feature_dtype="float32")
    bits = pipe.load_datasets(schema, data, feature_dtype="bfloat16")
    assert bits[0].features.dtype == np.uint16
    assert np.array_equal(pipe.features_f32(pipe.bf16_bits(
        f32[0].features)), pipe.features_f32(bits[0].features))
    want = train(job, *f32, console=lambda s: None, device="cpu")
    assert got.tier == want.tier
    assert [(m.train_error, m.valid_error) for m in got.history] \
        == [(m.train_error, m.valid_error) for m in want.history]
