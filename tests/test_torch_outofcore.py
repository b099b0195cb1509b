"""The port's out-of-core datasets (shifu_tpu_torch/data/outofcore.py)
against the JAX package's: the consolidated arrays and meta byte for byte,
an atomic rebuild when a source changes, and training on the memmaps."""

import dataclasses
import json
import os

import numpy as np
import pytest

from shifu_tpu.config import schema as jax_schema
from shifu_tpu.data import outofcore as jax_ooc
from shifu_tpu.data import pipeline as jax_pipe
from shifu_tpu_torch.config import schema as port_schema
from shifu_tpu_torch.data import cache, outofcore, pipeline as pipe, synthetic

FEATURE_DTYPES = ("float32", "bfloat16", "int8c8")


def _setup(tmp_path, rows=700, num_files=3, weight=False):
    schema = synthetic.make_schema(num_features=6, with_weight=weight)
    synthetic.write_files(synthetic.make_rows(rows, schema, seed=11),
                          str(tmp_path / "data"), num_files=num_files)
    pdata = port_schema.DataConfig(paths=(str(tmp_path / "data"),),
                                   out_of_core=True, ingest_workers=1,
                                   shuffle_seed=5)
    jdata = jax_schema.DataConfig(**dataclasses.asdict(pdata))
    jsch = jax_schema.JobConfig.from_dict(
        {"schema": dataclasses.asdict(schema)}).schema
    return schema, jsch, pdata, jdata


def _dataset_dirs(c):
    return sorted(n for n in os.listdir(c) if n.startswith("dataset-"))


def _files(d):
    out = {}
    for n in sorted(os.listdir(d)):
        with open(os.path.join(d, n), "rb") as f:
            out[n] = f.read()
    return out


@pytest.mark.parametrize("chunk_rows", [262_144, 64])
@pytest.mark.parametrize("fd", FEATURE_DTYPES)
def test_consolidated_arrays_equal_jax_bitwise(tmp_path, monkeypatch, fd,
                                               chunk_rows):
    monkeypatch.setattr(outofcore, "_CHUNK_ROWS", chunk_rows)
    monkeypatch.setattr(jax_ooc, "_CHUNK_ROWS", chunk_rows)
    schema, jsch, pdata, jdata = _setup(tmp_path, weight=(fd == "float32"))
    pc, jc = str(tmp_path / "pc"), str(tmp_path / "jc")
    ptr, pva = pipe.load_datasets(
        schema, dataclasses.replace(pdata, cache_dir=pc), feature_dtype=fd)
    jtr, jva = jax_pipe.load_datasets(
        jsch, dataclasses.replace(jdata, cache_dir=jc), feature_dtype=fd)
    assert _dataset_dirs(pc) == _dataset_dirs(jc)
    (name,) = _dataset_dirs(pc)
    pfiles, jfiles = (_files(os.path.join(pc, name)),
                      _files(os.path.join(jc, name)))
    meta_p = json.loads(pfiles.pop("meta.json"))
    meta_j = json.loads(jfiles.pop("meta.json"))
    assert meta_p == meta_j
    assert pfiles == jfiles  # every .npy byte for byte
    for p, j in ((ptr, jtr), (pva, jva)):
        assert isinstance(p.features, np.memmap)
        jf = np.asarray(j.features)
        if jf.dtype.name == "bfloat16":
            jf = jf.view(np.uint16)
        assert np.array_equal(np.asarray(p.features), jf)
        assert np.array_equal(p.target, j.target)
        assert np.array_equal(p.weight, j.weight)
    # the per-file v2 entries beside it are the JAX package's too
    assert sorted(os.listdir(pc)) == sorted(os.listdir(jc))


def test_entry_key_matches_jax(tmp_path):
    schema, jsch, pdata, jdata = _setup(tmp_path)
    mine = pipe.source_files(pdata)
    for fd in FEATURE_DTYPES:
        assert outofcore._entry_key(schema, pdata, mine, fd) \
            == jax_ooc._entry_key(jsch, jdata, mine, fd)


def test_a_changed_source_rebuilds_atomically(tmp_path, monkeypatch):
    schema, jsch, pdata, jdata = _setup(tmp_path)
    c = str(tmp_path / "c")
    data = dataclasses.replace(pdata, cache_dir=c)
    first = pipe.load_datasets(schema, data, feature_dtype="int8c8")
    (old,) = _dataset_dirs(c)
    # a build that dies mid-copy leaves nothing servable behind
    part = os.path.join(pdata.paths[0], sorted(os.listdir(pdata.paths[0]))[0])
    synthetic.write_files(synthetic.make_rows(300, schema, seed=99),
                          str(tmp_path / "new"), num_files=1)
    os.replace(os.path.join(tmp_path / "new", "part-00000.gz"), part)
    real_open = np.lib.format.open_memmap
    calls = {"n": 0}

    def dying_open(*a, **k):
        if k.get("mode") == "w+":  # the build's allocations, not reads
            calls["n"] += 1
            if calls["n"] == 4:
                raise OSError("disk full")
        return real_open(*a, **k)

    monkeypatch.setattr(np.lib.format, "open_memmap", dying_open)
    with pytest.raises(OSError, match="disk full"):
        pipe.load_datasets(schema, data, feature_dtype="int8c8")
    assert _dataset_dirs(c) == [old]
    assert not any(n.startswith(".building-") for n in os.listdir(c))
    monkeypatch.setattr(np.lib.format, "open_memmap", real_open)
    second = pipe.load_datasets(schema, data, feature_dtype="int8c8")
    dirs = _dataset_dirs(c)
    assert len(dirs) == 2 and old in dirs
    assert second[0].num_rows != first[0].num_rows or not np.array_equal(
        np.asarray(second[0].features), np.asarray(first[0].features))
    stale = {r["name"]: r["status"] for r in cache.scan_cache(c)}
    assert stale[old] == "stale"
    assert all(stale[d] == "ok" for d in dirs if d != old)


def test_out_of_core_needs_a_cache_dir(tmp_path):
    schema, _jsch, pdata, _jdata = _setup(tmp_path)
    with pytest.raises(ValueError, match="need a cache directory"):
        pipe.load_datasets(schema, pdata)


def test_training_on_the_memmaps(tmp_path):
    """train() on an out-of-core job loads the memmaps (no streamed epoch)
    and trains the staged tier exactly as on the same arrays in RAM."""
    from shifu_tpu_torch.train.loop import train
    schema, _jsch, pdata, _jdata = _setup(tmp_path, rows=1200)
    data = dataclasses.replace(pdata, cache_dir=str(tmp_path / "c"),
                               batch_size=64, device_resident_bytes=0,
                               wire_dtype="int8")
    job = port_schema.JobConfig(
        schema=schema, data=data,
        model=port_schema.ModelSpec(hidden_nodes=(8,), activations=("relu",),
                                    compute_dtype="float32"),
        train=port_schema.TrainConfig(epochs=2, seed=3)).validate()
    lines = []
    res = train(job, console=lines.append, device="cpu")
    assert res.tier == "staged"
    assert not any(ln.startswith("Streaming") for ln in lines)
    tr, va = pipe.load_datasets(schema, data, feature_dtype="int8c8")
    assert isinstance(tr.features, np.memmap)
    in_ram = [pipe.TabularDataset(np.array(d.features), np.array(d.target),
                                  np.array(d.weight)) for d in (tr, va)]
    ref = train(dataclasses.replace(
        job, data=dataclasses.replace(data, out_of_core=False)),
        *in_ram, console=lambda s: None, device="cpu")
    assert [m.train_error for m in res.history] \
        == [m.train_error for m in ref.history]
    assert [m.valid_error for m in res.history] \
        == [m.valid_error for m in ref.history]
