"""The port's input plane (shifu_tpu_torch/data/pipeline.py: EpochFeeder,
StreamingLoader, the staged blocks, the order digest) and the overlap on
`train()`, on the CPU, against the JAX package's on the same inputs.

The counterparts of tests/test_overlap.py's tests that need no chaos, then
the port's own.  Held bitwise: block contents, order digests (the JAX
package's hex digest for the same arguments), the streamed blocks and
their counts, and the port's losses with the overlap on and off.  Held to
the JAX package: streamed epoch-0 losses within rtol 1e-4 (the train()
tolerance of tests/test_torch_train.py).
"""

import dataclasses
import json
import time

import numpy as np
import pytest

from shifu_tpu.data import pipeline as jax_pipe
from shifu_tpu_torch import obs
from shifu_tpu_torch.config import schema as port_schema
from shifu_tpu_torch.data import pipeline as pipe
from shifu_tpu_torch.data import reader, synthetic
from shifu_tpu_torch.train import loop


@pytest.fixture(autouse=True)
def _clean_obs():
    obs.reset_for_tests()
    yield
    obs.reset_for_tests()


def _dataset(n=512, f=8, seed=0):
    rng = np.random.default_rng(seed)
    return pipe.TabularDataset(
        rng.standard_normal((n, f)).astype(np.float32),
        (rng.random((n, 1)) < 0.5).astype(np.float32),
        np.ones((n, 1), np.float32))


def _as_jax(ds):
    return jax_pipe.TabularDataset(ds.features, ds.target, ds.weight)


# -- the counterparts of tests/test_overlap.py -------------------------------

def test_next_prefetch_depth_policy():
    assert pipe.next_prefetch_depth(2, 0.5) == 4     # starved: double
    assert pipe.next_prefetch_depth(8, 0.5) == 8     # cap (8 chunks)
    assert pipe.next_prefetch_depth(6, 0.5) == 8     # doubling clamps
    assert pipe.next_prefetch_depth(4, 0.0) == 3     # hidden: decay
    assert pipe.next_prefetch_depth(2, 0.0) == 2     # floor
    assert pipe.next_prefetch_depth(4, 0.03) == 4    # dead band: hold
    for cur in range(1, 10):
        for frac in (0.0, 0.005, 0.01, 0.03, 0.05, 0.06, 0.9):
            assert pipe.next_prefetch_depth(cur, frac) == \
                jax_pipe.next_prefetch_depth(cur, frac)


def test_feeder_matches_per_epoch_path_byte_identical():
    ds = _dataset(n=200, f=4)
    bs, bb, seed = 16, 3, 11

    def source(ep):
        return pipe.staged_epoch_blocks(ds, bs, shuffle=True, seed=seed,
                                        epoch=ep, block_batches=bb)

    feeder = pipe.EpochFeeder(source, lambda b: b, range(3), depth=2,
                              host_depth=2)
    try:
        for ep in range(3):
            got = list(feeder.epoch(ep))
            want = list(source(ep))
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                for k in w:
                    np.testing.assert_array_equal(g[k], w[k])
            assert feeder.production_seconds(ep) > 0
    finally:
        feeder.close()


def test_feeder_runs_ahead_across_the_epoch_boundary():
    ds = _dataset(n=64, f=4)

    def source(ep):
        return pipe.staged_epoch_blocks(ds, 16, shuffle=True, seed=1,
                                        epoch=ep, block_batches=2)

    feeder = pipe.EpochFeeder(source, lambda b: b, range(2), depth=4,
                              host_depth=4)
    try:
        list(feeder.epoch(0))
        deadline = time.monotonic() + 10.0
        while feeder.ready_ahead() == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert feeder.ready_ahead() > 0  # epoch 1 placed before asked for
        got = list(feeder.epoch(1))
        want = list(source(1))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["features"], w["features"])
    finally:
        feeder.close()


def test_feeder_source_error_forwarded_and_death_detected():
    def bad_source(ep):
        raise RuntimeError("shard went away")
        yield  # pragma: no cover

    feeder = pipe.EpochFeeder(bad_source, lambda b: b, range(1), depth=2)
    try:
        with pytest.raises(RuntimeError, match="shard went away"):
            list(feeder.epoch(0))
    finally:
        feeder.close()

    # an exhausted feeder, or one closed before it is read, raises
    # FeederError at the consumer's next poll instead of blocking forever
    feeder = pipe.EpochFeeder(lambda ep: iter(()), lambda b: b, [])
    with pytest.raises(pipe.FeederError):
        list(feeder.epoch(0))
    feeder.close()
    feeder = pipe.EpochFeeder(lambda ep: iter(()), lambda b: b, [])
    feeder.close()
    with pytest.raises(pipe.FeederError):
        list(feeder.epoch(0))


def test_depth_gate_resize_absorbs_and_grows():
    g = pipe._DepthGate(2)
    assert g.acquire(timeout=0.1) and g.acquire(timeout=0.1)
    assert not g.acquire(timeout=0.05)  # bound enforced
    g.resize(3)
    assert g.acquire(timeout=0.1)       # grew by one slot
    g.resize(1)                          # shrink: next 2 releases absorbed
    g.release()
    g.release()
    assert not g.acquire(timeout=0.05)
    g.release()                          # now a real slot again
    assert g.acquire(timeout=0.1)


def test_staged_order_model_matches_real_iterator():
    n, bs, bb, seed, epoch = 20, 3, 2, 9, 4
    ds = pipe.TabularDataset(
        np.arange(n, dtype=np.float32).reshape(n, 1),
        np.zeros((n, 1), np.float32), np.ones((n, 1), np.float32))
    got_rows = np.concatenate([
        blk["features"].reshape(-1) for blk in pipe.staged_epoch_blocks(
            ds, bs, shuffle=True, seed=seed, epoch=epoch, block_batches=bb)])
    nb_total = n // bs
    slack = n - nb_total * bs
    offset = (epoch * 997) % (slack + 1)
    order = np.random.default_rng(
        np.random.PCG64(seed * 1_000_003 + epoch)).permutation(nb_total)
    want_rows = np.concatenate(
        [np.arange(offset + i * bs, offset + (i + 1) * bs) for i in order])
    np.testing.assert_array_equal(got_rows.astype(np.int64), want_rows)


def test_epoch_order_digest_properties():
    d = lambda **kw: pipe.epoch_order_digest("staged", 1000, 64, seed=3,
                                             **kw)
    assert d(epoch=1) == d(epoch=1)          # pure in (seed, epoch)
    assert d(epoch=1) != d(epoch=2)
    assert d(epoch=1, shuffle=False) != d(epoch=1)
    assert pipe.epoch_order_digest("stream", 1000, 64) is None
    assert pipe.epoch_order_digest("batch", 0, 64) is None
    for tier in ("staged", "batch", "resident"):
        h = pipe.epoch_order_digest(tier, 1000, 64, seed=1, epoch=0)
        int(h, 16)  # hex digest
        assert len(h) == 32


# -- end-to-end train runs ---------------------------------------------------

def _staged_job(epochs=3, overlap=True, ckpt_dir=None, prefetch_depth=3,
                **data_kw):
    job = port_schema.JobConfig(
        schema=synthetic.make_schema(num_features=10),
        data=port_schema.DataConfig(**{
            "batch_size": 64, "valid_ratio": 0.1,
            "device_resident_bytes": 0,  # force the staged tier
            "prefetch_depth": prefetch_depth, "overlap_epochs": overlap,
            **data_kw}),
        model=port_schema.ModelSpec(model_type="mlp", hidden_nodes=(8,),
                                    activations=("relu",),
                                    compute_dtype="float32"),
        train=port_schema.TrainConfig(
            epochs=epochs, optimizer=port_schema.OptimizerConfig(
                name="adam", learning_rate=1e-2)))
    if ckpt_dir:
        job = dataclasses.replace(job, runtime=dataclasses.replace(
            job.runtime, checkpoint=dataclasses.replace(
                job.runtime.checkpoint, directory=str(ckpt_dir))))
    return job.validate()


def _train_data(schema, n=2048):
    rows = synthetic.make_rows(n, schema, seed=5, noise=0.3)
    cols = reader.project_columns(rows, schema)
    full = pipe.TabularDataset(cols["features"], cols["target"],
                               cols["weight"])
    split = int(n * 0.9)
    return full.take(np.arange(split)), full.take(np.arange(split, n))


def _run(job, tmp_path, tag, train_ds, valid_ds):
    tele = tmp_path / f"tele_{tag}"
    obs.reset_for_tests()
    obs.configure(str(tele), flush_every=1)
    r = loop.train(job, train_ds, valid_ds, console=lambda s: None,
                   device="cpu")
    obs.flush()
    recs = obs.read_journal(str(tele / "journal.jsonl"))
    obs.shutdown()
    return r, recs


def _reports(recs):
    return {r["epoch"]: r for r in recs if r["kind"] == "overlap_report"}


def test_overlap_on_off_identical_training_and_order(tmp_path):
    """The parity gate: with the overlap on and off, the port's losses and
    metrics are bitwise equal, and so are the journaled order digests."""
    job_on, job_off = _staged_job(overlap=True), _staged_job(overlap=False)
    train_ds, valid_ds = _train_data(job_on.schema)
    r_on, recs_on = _run(job_on, tmp_path, "on", train_ds, valid_ds)
    r_off, recs_off = _run(job_off, tmp_path, "off", train_ds, valid_ds)
    assert r_on.tier == r_off.tier == "staged"
    assert len(r_on.history) == len(r_off.history) == 3
    for a, b in zip(r_on.history, r_off.history):
        assert (a.train_error, a.valid_error, a.valid_auc) == \
            (b.train_error, b.valid_error, b.valid_auc)
    rep_on, rep_off = _reports(recs_on), _reports(recs_off)
    assert sorted(rep_on) == sorted(rep_off) == [0, 1, 2]
    for ep in rep_on:
        assert rep_on[ep]["tier"] == rep_off[ep]["tier"] == "staged"
        assert rep_on[ep]["order_digest"] == rep_off[ep]["order_digest"]
        assert rep_on[ep]["order_digest"] == jax_pipe.epoch_order_digest(
            "staged", train_ds.num_rows, 64, seed=0, epoch=ep)
    assert all(rep_on[ep]["overlap"] is True for ep in rep_on)
    assert all(rep_off[ep]["overlap"] is False for ep in rep_off)


def test_overlap_resume_order_byte_identical(tmp_path):
    """Kill + resume at an epoch boundary: the resumed overlap run draws
    the same per-epoch order (digests) and trains the same losses, bit for
    bit, as an uninterrupted run with the overlap off."""
    ckpt = tmp_path / "ckpt"
    job2 = _staged_job(epochs=2, overlap=True, ckpt_dir=ckpt)
    train_ds, valid_ds = _train_data(job2.schema)
    _run(job2, tmp_path, "first", train_ds, valid_ds)
    job4 = _staged_job(epochs=4, overlap=True, ckpt_dir=ckpt)
    r_resumed, recs_resumed = _run(job4, tmp_path, "resumed", train_ds,
                                   valid_ds)
    assert r_resumed.resumed_from_epoch == 2
    assert [m.epoch for m in r_resumed.history] == [2, 3]
    r_straight, recs_straight = _run(_staged_job(epochs=4, overlap=False),
                                     tmp_path, "straight", train_ds,
                                     valid_ds)
    d_res, d_str = _reports(recs_resumed), _reports(recs_straight)
    straight = {m.epoch: m for m in r_straight.history}
    for m in r_resumed.history:
        assert d_res[m.epoch]["order_digest"] == \
            d_str[m.epoch]["order_digest"] is not None
        assert m.train_error == straight[m.epoch].train_error
        assert m.valid_auc == straight[m.epoch].valid_auc


def test_perbatch_tier_overlap_parity(tmp_path):
    def job_for(overlap):
        return _staged_job(epochs=2, overlap=overlap, staged=False)

    train_ds, valid_ds = _train_data(job_for(True).schema, n=1024)
    r_on, recs_on = _run(job_for(True), tmp_path, "pb_on", train_ds,
                         valid_ds)
    r_off, recs_off = _run(job_for(False), tmp_path, "pb_off", train_ds,
                           valid_ds)
    for a, b in zip(r_on.history, r_off.history):
        assert a.train_error == b.train_error
        assert a.valid_auc == b.valid_auc

    def digests(recs):
        return {e: (r["tier"], r["order_digest"])
                for e, r in _reports(recs).items()}

    assert digests(recs_on) == digests(recs_off)
    assert all(t == "batch" for t, _ in digests(recs_on).values())
    assert digests(recs_on)[1][1] == jax_pipe.epoch_order_digest(
        "batch", train_ds.num_rows, 64, seed=0, epoch=1)


# -- the port's own ------------------------------------------------------------

@pytest.mark.parametrize("tier", ["staged", "batch", "resident"])
@pytest.mark.parametrize("rows,batch,seed,epoch", [
    (1000, 64, 0, 0), (1000, 64, 3, 5), (4097, 128, 11, 2),
    (65, 64, 1, 1), (20, 3, 9, 4)])
def test_epoch_order_digest_equals_jax(tier, rows, batch, seed, epoch):
    for shuffle in (True, False):
        kw = dict(shuffle=shuffle, seed=seed, epoch=epoch)
        assert pipe.epoch_order_digest(tier, rows, batch, **kw) == \
            jax_pipe.epoch_order_digest(tier, rows, batch, **kw)


@pytest.mark.parametrize("n,bs,bb,epoch", [
    (200, 16, 3, 0), (200, 16, 3, 7), (1000, 64, 4, 2), (64, 64, 2, 1)])
def test_staged_blocks_equal_jax(n, bs, bb, epoch):
    ds = _dataset(n=n, f=5, seed=n)
    assert pipe.staged_epoch_offset(n, bs, epoch=epoch) == \
        jax_pipe.staged_epoch_offset(n, bs, epoch=epoch)
    got = list(pipe.staged_epoch_blocks(ds, bs, seed=4, epoch=epoch,
                                        block_batches=bb))
    want = list(jax_pipe.staged_epoch_blocks(_as_jax(ds), bs, seed=4,
                                             epoch=epoch, block_batches=bb))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])


def test_feeder_close_mid_epoch_stops_both_threads():
    ds = _dataset(n=4096, f=4)

    def source(ep):
        return pipe.staged_epoch_blocks(ds, 16, epoch=ep, block_batches=1)

    feeder = pipe.EpochFeeder(source, lambda b: b, range(5), depth=2,
                              host_depth=2)
    it = feeder.epoch(0)
    next(it)
    feeder.close()
    assert not any(t.is_alive() for t in feeder._threads)
    feeder.close()  # idempotent


def test_feeder_placement_error_reaches_the_consumer():
    ds = _dataset(n=64, f=4)

    def put(b):
        raise ValueError("placement failed")

    feeder = pipe.EpochFeeder(
        lambda ep: pipe.staged_epoch_blocks(ds, 16, epoch=ep), put, range(1))
    try:
        with pytest.raises(ValueError, match="placement failed"):
            list(feeder.epoch(0))
    finally:
        feeder.close()


def test_feeder_epoch_mismatch_raises():
    ds = _dataset(n=64, f=4)
    feeder = pipe.EpochFeeder(
        lambda ep: pipe.staged_epoch_blocks(ds, 16, epoch=ep), lambda b: b,
        range(2))
    try:
        with pytest.raises(pipe.FeederError, match="mismatch"):
            list(feeder.epoch(1))
    finally:
        feeder.close()


def test_prefetch_to_device_forwards_errors_and_keeps_order():
    items = [{"x": np.full((2,), i)} for i in range(10)]
    got = list(pipe.prefetch_to_device(iter(items), lambda b: b["x"][0],
                                       size=2))
    assert got == list(range(10))
    assert list(pipe.prefetch_to_device(iter(items), lambda b: 1,
                                        size=0)) == [1] * 10

    def bad():
        yield items[0]
        raise OSError("disk went away")

    with pytest.raises(OSError, match="disk went away"):
        list(pipe.prefetch_to_device(bad(), lambda b: b, size=2))


def _write_parts(tmp_path, schema, n=1500, parts=3):
    synthetic.write_files(synthetic.make_rows(n, schema, seed=2),
                          str(tmp_path), parts)
    return port_schema.DataConfig(paths=(str(tmp_path),), batch_size=64)


@pytest.mark.parametrize("pad_tail", [True, False])
@pytest.mark.parametrize("bs,bb", [(64, 4), (50, 3), (1000, 2)])
def test_streaming_loader_blocks_equal_jax(tmp_path, pad_tail, bs, bb):
    """Both packages' streaming loaders yield the same blocks, block count
    and real_batches from the same gzip files, and then the datasets
    load_datasets builds."""
    schema = synthetic.make_schema(num_features=6)
    data = _write_parts(tmp_path, schema)
    from shifu_tpu.config import schema as jax_schema
    jdata = jax_schema.DataConfig(paths=data.paths, batch_size=64)
    from shifu_tpu.data import synthetic as jax_synth
    jsch = jax_synth.make_schema(num_features=6)
    pl = pipe.StreamingLoader(schema, data, "float32")
    jl = jax_pipe.StreamingLoader(jsch, jdata, "float32")
    got = list(pl.first_epoch_blocks(bs, bb, pad_tail=pad_tail))
    want = list(jl.first_epoch_blocks(bs, bb, pad_tail=pad_tail))
    assert len(got) == len(want)
    assert pl.real_batches == jl.real_batches
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    (ptr, pva), (jtr, jva) = pl.datasets(), jl.datasets()
    for a, b in ((ptr, jtr), (pva, jva)):
        np.testing.assert_array_equal(a.features, b.features)
        np.testing.assert_array_equal(a.target, b.target)
    ltr, _ = pipe.load_datasets(schema, data)
    np.testing.assert_array_equal(ptr.features, ltr.features)


def test_streaming_loader_parse_error_reaches_the_consumer(tmp_path):
    schema = synthetic.make_schema(num_features=4)
    data = _write_parts(tmp_path, schema, n=100, parts=1)
    import os
    os.unlink(next(str(p) for p in tmp_path.iterdir()))
    (tmp_path / "part-00009.gz").write_bytes(b"\x1f\x8b not gzip")
    loader = pipe.StreamingLoader(schema, data)
    with pytest.raises(Exception):
        list(loader.first_epoch_blocks(16, 2))


def test_streaming_loader_queue_uses_prefetch_depth():
    schema = synthetic.make_schema(num_features=4)
    loader = pipe.StreamingLoader(schema,
                                  port_schema.DataConfig(prefetch_depth=2))
    assert loader._q.maxsize == 2
    loader.datasets()
    loader = pipe.StreamingLoader(schema,
                                  port_schema.DataConfig(prefetch_depth=0))
    assert loader._q.maxsize == 4
    loader.datasets()


def test_streamed_epoch_then_staged_in_both_packages(tmp_path, monkeypatch):
    """A job given files (past the resident budget) streams epoch 0 and
    stages the rest in both packages; with the port's weights carried from
    the JAX package's init, the per-epoch losses agree within rtol 1e-4,
    and the journaled tiers are stream, staged, staged in both."""
    import jax

    from shifu_tpu import obs as jax_obs
    from shifu_tpu.config import schema as jax_schema
    from shifu_tpu.data import synthetic as jax_synth
    from shifu_tpu.export.artifact import _flatten_params
    from shifu_tpu.train import loop as jax_loop
    from shifu_tpu_torch.export.artifact import params_from_jax

    jsch = jax_synth.make_schema(num_features=10)
    synthetic.write_files(synthetic.make_rows(2000, jsch, seed=3),
                          str(tmp_path / "data"), 3)
    jjob = jax_schema.JobConfig(
        schema=jsch,
        data=jax_schema.DataConfig(paths=(str(tmp_path / "data"),),
                                   batch_size=64, device_resident_bytes=0),
        model=jax_schema.ModelSpec(hidden_nodes=(8,), activations=("relu",),
                                   compute_dtype="float32"),
        train=jax_schema.TrainConfig(
            epochs=3, optimizer=jax_schema.OptimizerConfig(
                name="adam", learning_rate=1e-2))).validate()
    pjob = port_schema.JobConfig.from_dict(
        json.loads(jjob.to_json())).validate()
    jinit = jax_loop.init_state(jjob, 10)
    real_init = loop.init_state

    def carried(job, num_features, device=None):
        state = real_init(job, num_features, device)
        flat = {k: np.asarray(v) for k, v in
                _flatten_params(jax.device_get(jinit.params)).items()}
        state.model.load_state_dict(params_from_jax(flat, state.model))
        return state

    monkeypatch.setattr(loop, "init_state", carried)
    jax_obs.reset_for_tests()
    jax_obs.configure(str(tmp_path / "jt"), flush_every=1)
    try:
        jres = jax_loop.train(jjob, console=lambda s: None)
        jax_obs.flush()
        jrecs = jax_obs.read_journal(str(tmp_path / "jt" / "journal.jsonl"))
    finally:
        jax_obs.reset_for_tests()
    obs.configure(str(tmp_path / "pt"), flush_every=1)
    pres = loop.train(pjob, console=lambda s: None, device="cpu")
    obs.flush()
    precs = obs.read_journal(str(tmp_path / "pt" / "journal.jsonl"))
    assert pres.tier == "staged"
    tiers = [[r["tier"] for r in recs if r["kind"] == "overlap_report"]
             for recs in (precs, jrecs)]
    assert tiers[0] == tiers[1] == ["stream", "staged", "staged"]
    for g, w in zip(pres.history, jres.history):
        assert g.train_error == pytest.approx(w.train_error, rel=1e-4)
        assert abs(g.valid_auc - w.valid_auc) <= 1e-3


def test_deepfm_feeder_on_off_bitwise_with_dedup(tmp_path):
    """The per-batch tier under a sparse plan dedups on the feeder's
    assembly thread: losses, parameters and dedup counts are the same with
    the overlap on and off."""
    import torch

    schema = synthetic.make_schema(num_features=10, num_categorical=3,
                                   vocab_size=50)

    def job(overlap):
        return port_schema.JobConfig(
            schema=schema,
            data=port_schema.DataConfig(batch_size=64, staged=False,
                                        overlap_epochs=overlap),
            model=port_schema.ModelSpec(model_type="deepfm",
                                        hidden_nodes=(8,),
                                        activations=("relu",),
                                        embedding_dim=4,
                                        compute_dtype="float32"),
            train=port_schema.TrainConfig(
                epochs=2, sparse_embedding_update="on",
                optimizer=port_schema.OptimizerConfig(
                    name="adadelta", learning_rate=0.5))).validate()

    rows = synthetic.make_rows(1200, schema, seed=3)
    cols = reader.project_columns(rows, schema)
    full = pipe.TabularDataset(cols["features"], cols["target"],
                               cols["weight"])
    ds = (full.take(np.arange(1000)), full.take(np.arange(1000, 1200)))
    a = loop.train(job(True), *ds, console=lambda s: None, device="cpu")
    b = loop.train(job(False), *ds, console=lambda s: None, device="cpu")
    assert a.tier == b.tier == "batch"
    assert [m.train_error for m in a.history] == \
        [m.train_error for m in b.history]
    assert a.dedup == b.dedup and a.dedup["batches"] == 2 * (1000 // 64)
    for (k, x), y in zip(a.state.model.state_dict().items(),
                         b.state.model.state_dict().values()):
        assert torch.equal(x, y), k


def test_auto_prefetch_depth_moves_between_epochs(tmp_path):
    job = _staged_job(epochs=3, overlap=True, prefetch_depth=0)
    train_ds, valid_ds = _train_data(job.schema)
    _r, recs = _run(job, tmp_path, "auto", train_ds, valid_ds)
    depths = [r["prefetch_depth"] for r in _reports(recs).values()]
    assert all(2 <= d <= 8 for d in depths)
    for r in _reports(recs).values():
        assert r["input_hidden_s"] <= r["input_production_s"] + 1e-9
        assert r["prefetched_chunks"] >= 0


def test_make_placer_on_the_cpu_is_to_device():
    job = _staged_job()
    put, ready = loop.make_placer(job, __import__("torch").device("cpu"))
    b = {"features": np.ones((4, 10), np.float32),
         "target": np.zeros((4, 1), np.uint8)}
    out = ready(put(b))
    assert out["features"].dtype.is_floating_point
    assert out["target"].shape == (4, 1)
    assert ready(out) is out
