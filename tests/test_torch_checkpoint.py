"""The port's checkpoint and resume (shifu_tpu_torch/train/checkpoint.py,
and `train()`'s resume, time-cadence saves and SIGTERM drain) on the CPU.

The counterparts of tests/test_checkpoint.py's single-host tests, then the
port's own: the digest ladder, the manifest's state tree, retention, the
sparse tables' slots, dropout across a resume, and a kill-and-resume held
bitwise against an unbroken run in the port and, from the same carried
weights, to the JAX package's run of the same schedule within the
`train()` tolerance of tests/test_torch_train.py (per-epoch train_error
rtol 1e-4, valid_auc within 1e-3).
"""

import dataclasses
import json
import os
import signal

import numpy as np
import pytest
import torch

from shifu_tpu_torch import obs
from shifu_tpu_torch.config import schema as port_schema
from shifu_tpu_torch.data import pipeline as pipe
from shifu_tpu_torch.data import reader, synthetic
from shifu_tpu_torch.train import checkpoint as ckpt_lib
from shifu_tpu_torch.train import loop
from shifu_tpu_torch.train import step as step_lib

F = 30


@pytest.fixture(autouse=True)
def _clean_obs():
    obs.reset_for_tests()
    yield
    obs.reset_for_tests()


def _job(epochs=3, directory="", data_kw=None, train_kw=None, model_kw=None,
         ckpt_kw=None):
    """The conftest `small_job` (30 features, 2 x 16 tanh MLP, Adam 3e-3,
    batch 64) as a port job, with a checkpoint directory."""
    return port_schema.JobConfig(
        schema=synthetic.make_schema(num_features=F),
        data=port_schema.DataConfig(**{"batch_size": 64, "valid_ratio": 0.1,
                                       **(data_kw or {})}),
        model=port_schema.ModelSpec(model_type="mlp", hidden_nodes=(16, 16),
                                    activations=("tanh", "tanh"),
                                    compute_dtype="float32",
                                    **(model_kw or {})),
        train=port_schema.TrainConfig(
            epochs=epochs, optimizer=port_schema.OptimizerConfig(
                name="adam", learning_rate=3e-3), **(train_kw or {})),
        runtime=port_schema.RuntimeConfig(
            checkpoint=port_schema.CheckpointConfig(
                directory=directory, save_every_epochs=1,
                **(ckpt_kw or {})))).validate()


def _with(job, **sections):
    """`job` with fields of its sections replaced, e.g. train={...}."""
    out = {name: dataclasses.replace(getattr(job, name), **kw)
           for name, kw in sections.items()}
    return dataclasses.replace(job, **out)


@pytest.fixture(scope="module")
def data():
    rows = synthetic.make_rows(2048, synthetic.make_schema(num_features=F),
                               seed=7, noise=0.3)
    cols = reader.project_columns(rows, synthetic.make_schema(num_features=F))
    full = pipe.TabularDataset(cols["features"], cols["target"],
                               cols["weight"])
    return full.take(np.arange(1843)), full.take(np.arange(1843, 2048))


def _train(job, data, **kw):
    kw.setdefault("console", lambda s: None)
    return loop.train(job, *data, device="cpu", **kw)


def _params(state):
    return {k: v.detach().clone() for k, v in state.model.state_dict().items()}


def _assert_params_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


# -- the counterparts of tests/test_checkpoint.py ------------------------------

def test_save_and_auto_resume(tmp_path, data):
    job = _job(3, str(tmp_path / "ckpt"))
    r1 = _train(job, data)
    assert len(r1.history) == 3
    lines = []
    r2 = _train(job, data, console=lines.append)
    assert r2.resumed_from_epoch == 3
    assert r2.history == []
    assert any("Resumed" in ln for ln in lines)


def test_resume_continues_training(tmp_path, data):
    """2 of 4 epochs, then a resume: the resumed run ends with the
    uninterrupted run's parameters, bit for bit."""
    d = str(tmp_path / "a")
    _train(_job(2, d), data)
    r_resumed = _train(_job(4, d), data)
    assert r_resumed.resumed_from_epoch == 2
    assert [m.epoch for m in r_resumed.history] == [2, 3]
    r_straight = _train(_job(4, str(tmp_path / "b")), data)
    _assert_params_equal(_params(r_resumed.state), _params(r_straight.state))
    assert r_resumed.state.step == r_straight.state.step


def test_terminal_checkpoint_holds_best_params(tmp_path, data):
    d = str(tmp_path / "ckpt")
    job = _with(_job(6, d), train={
        "early_stop_patience": 2,
        # SGD at 200 bounces on this init: best != last
        "optimizer": port_schema.OptimizerConfig(name="sgd",
                                                 learning_rate=200.0)})
    result = _train(job, data)
    assert len(result.history) < 6  # early stop fired
    state = loop.init_state(job, F, "cpu")
    restored, _ = ckpt_lib.restore_latest(ckpt_lib.make_manager(d), state)
    _assert_params_equal(_params(restored), _params(result.state))

    r2 = _train(job, data)  # an early-stopped run is complete
    assert r2.resumed_from_epoch == 6
    assert r2.history == []

    job10 = _with(job, train={"epochs": 10, "early_stop_patience": 0})
    lines = []
    r3 = _train(job10, data, console=lines.append)
    assert r3.resumed_from_epoch == 6
    assert any("optimizer state reinitialized" in ln for ln in lines)
    assert len(r3.history) == 4
    assert np.isfinite(r3.history[-1].train_error)


def test_resume_disabled(tmp_path, data):
    d = str(tmp_path / "ckpt")
    _train(_job(2, d), data)
    r = _train(_job(2, d, ckpt_kw={"resume": False}), data)
    assert r.resumed_from_epoch == 0
    assert len(r.history) == 2


def test_staged_tier_saves_mid_epoch(tmp_path, data):
    """The staged tier saves at chunk boundaries on the time cadence, and
    the terminal save still wins when it lands on the step of the last
    chunk's cadence save: the finished job resumes as done."""
    d = str(tmp_path / "ckpt")
    job = _job(1, d, data_kw={"batch_size": 256, "device_resident_bytes": 0,
                              "block_batches": 2},
               ckpt_kw={"save_every_seconds": 1e-6})
    r1 = _train(job, data)
    assert r1.tier == "staged"
    assert len(ckpt_lib.make_manager(d).all_steps()) > 1
    r2 = _train(job, data)
    assert r2.resumed_from_epoch == 1
    assert r2.history == []


def test_save_same_step_wins(tmp_path):
    d = str(tmp_path / "ckpt")
    mgr = ckpt_lib.make_manager(d)
    state = loop.init_state(_job(), F, "cpu")
    ckpt_lib.save(mgr, 5, state, extra={"epoch": 0}, block=True)
    ckpt_lib.save(mgr, 5, state, extra={"epoch": 1}, block=True)
    _st, extra, step = ckpt_lib.restore_latest(mgr, state, with_extra=True)
    assert extra["epoch"] == 1
    assert step >= 5  # a bumped key: ordering only
    assert mgr.all_steps() == [5, 6]  # nothing was deleted first
    with open(os.path.join(d, ckpt_lib.PROGRESS_MARKER)) as f:
        assert json.load(f)["epoch"] == 1


def test_async_save_defers_progress_marker(tmp_path):
    """With block=False the PROGRESS marker and the manifest are written
    at the next wait point (the next save, or finalize), never while the
    save may be in flight; the committed step's own extra.json records
    its epoch as soon as the step exists."""
    d = str(tmp_path / "ckpt")
    mgr = ckpt_lib.make_manager(d)
    state = loop.init_state(_job(), F, "cpu")
    marker = os.path.join(d, ckpt_lib.PROGRESS_MARKER)

    ckpt_lib.save(mgr, 1, state, extra={"epoch": 0}, block=False)
    assert not os.path.exists(marker)
    mgr.wait_until_finished()  # committed, marker not flushed
    assert not os.path.exists(marker)
    assert not os.path.exists(ckpt_lib.manifest_path(d, 1))
    with open(os.path.join(d, "1", ckpt_lib.EXTRA_FILE)) as f:
        assert json.load(f)["epoch"] == 0

    ckpt_lib.save(mgr, 2, state, extra={"epoch": 1}, block=False)
    with open(marker) as f:  # step 1 became durable inside save()
        assert json.load(f)["epoch"] == 0
    ckpt_lib.finalize(mgr)
    with open(marker) as f:
        assert json.load(f)["epoch"] == 1
    assert ckpt_lib.verify_manifest(d, 2) is True


def test_async_save_resume_equivalence(tmp_path, data):
    d = str(tmp_path / "async")
    _train(_job(2, d, ckpt_kw={"async_save": True}), data)
    r = _train(_job(4, d, ckpt_kw={"async_save": True}), data)
    assert r.resumed_from_epoch == 2
    assert [m.epoch for m in r.history] == [2, 3]
    r_sync = _train(_job(4, str(tmp_path / "sync")), data)
    _assert_params_equal(_params(r.state), _params(r_sync.state))


def test_incompatible_checkpoint_raises(tmp_path, data, monkeypatch):
    """Another model's checkpoint raises CheckpointIncompatibleError with
    the JAX package's message form, before any tensor is loaded."""
    d = str(tmp_path / "ckpt")
    _train(_job(1, d), data)
    bigger = _with(_job(2, d), model={"hidden_nodes": (32, 32)})

    def no_load(*a, **k):
        raise AssertionError("a tensor was loaded")

    monkeypatch.setattr(torch, "load", no_load)
    with pytest.raises(ckpt_lib.CheckpointIncompatibleError,
                       match=r"checkpoint step \d+ is incompatible with the "
                             r"restore target at '/model/.*': saved "):
        _train(bigger, data)


def test_time_based_checkpoint_cadence(tmp_path, data, monkeypatch):
    """save_every_seconds adds mid-epoch saves on the per-batch tier."""
    import time as time_mod
    d = str(tmp_path / "ckpt")
    job = _job(1, d, data_kw={"staged": False, "device_resident_bytes": 0},
               ckpt_kw={"save_every_seconds": 1})
    tick = {"t": 0.0}

    def fake_monotonic():
        tick["t"] += 10.0
        return tick["t"]

    monkeypatch.setattr(time_mod, "monotonic", fake_monotonic)
    r = _train(job, data)
    assert r.tier == "batch"
    assert len(ckpt_lib.make_manager(d).all_steps()) > 1


def _sigterm_at(monkeypatch, at_step: int):
    """Make the train step send this process SIGTERM when the state
    reaches `at_step`: the drain then lands at the next chunk boundary."""
    real = step_lib.make_train_step

    def make(job):
        inner = real(job)

        def stepped(state, batch):
            state, m = inner(state, batch)
            if state.step == at_step:
                os.kill(os.getpid(), signal.SIGTERM)
            return state, m
        return stepped

    monkeypatch.setattr(loop, "make_train_step", make)


def test_sigterm_saves_and_exits_75(tmp_path, data, monkeypatch):
    """SIGTERM in the middle of an epoch: the loop saves the current step
    at the next chunk boundary, journals `preemption_grace` and exits 75;
    the job then resumes from that checkpoint and finishes."""
    d = str(tmp_path / "ckpt")
    obs.configure(str(tmp_path / "tele"), flush_every=1)
    job = _job(50, d, data_kw={"staged": False})
    spe = data[0].num_rows // 64
    _sigterm_at(monkeypatch, spe + 5)  # mid-epoch 1
    lines = []
    old = signal.getsignal(signal.SIGTERM)
    with pytest.raises(SystemExit) as exc:
        _train(job, data, console=lines.append)
    assert exc.value.code == 75
    assert signal.getsignal(signal.SIGTERM) == old  # handler restored
    assert any("SIGTERM" in ln for ln in lines)
    mgr = ckpt_lib.make_manager(d)
    assert mgr.latest_step() == spe + 5
    grace = [r for r in obs.read_journal(str(tmp_path / "tele" /
                                             "journal.jsonl"))
             if r["kind"] == "preemption_grace"]
    assert grace == [dict(grace[0], epoch=1, step=spe + 5, saved=True)]
    monkeypatch.undo()
    r = _train(_job(3, d, data_kw={"staged": False}), data)
    assert r.resumed_from_epoch == 1  # the interrupted epoch replays
    assert [m.epoch for m in r.history] == [1, 2]


def test_sigterm_without_checkpoint_dir_still_exits(data, monkeypatch):
    _sigterm_at(monkeypatch, 3)
    lines = []
    with pytest.raises(SystemExit) as exc:
        _train(_job(200, "", data_kw={"staged": False}), data,
               console=lines.append)
    assert exc.value.code == 75
    assert any("no checkpoint directory" in ln for ln in lines)


# -- the port's own ------------------------------------------------------------

def _flip_byte(path: str, at: int = -16) -> None:
    with open(path, "r+b") as f:
        f.seek(at, os.SEEK_END)
        b = f.read(1)
        f.seek(at, os.SEEK_END)
        f.write(bytes([b[0] ^ 0xFF]))


def test_digest_corruption_falls_back_and_journals(tmp_path, data):
    """A flipped byte in the newest step fails its manifest: the resume
    takes the newest earlier step and journals `checkpoint_fallback`."""
    d = str(tmp_path / "ckpt")
    _train(_job(2, d), data)
    mgr = ckpt_lib.make_manager(d)
    steps = mgr.all_steps()
    assert len(steps) == 2
    assert ckpt_lib.verify_manifest(d, steps[-1]) is True
    _flip_byte(os.path.join(d, str(steps[-1]), ckpt_lib.STATE_FILE))
    assert ckpt_lib.verify_manifest(d, steps[-1]) is False
    obs.configure(str(tmp_path / "tele"), flush_every=1)
    r = _train(_job(3, d), data)
    assert r.resumed_from_epoch == 1  # epoch 0's save
    recs = obs.read_journal(str(tmp_path / "tele" / "journal.jsonl"))
    fb = [x for x in recs if x["kind"] == "checkpoint_fallback"]
    assert len(fb) == 1 and fb[0]["failed_step"] == steps[-1]
    assert fb[0]["reason"] == "CheckpointCorruptError"
    assert fb[0]["remaining_steps"] == [steps[0]]
    assert any(x["kind"] == "checkpoint_fallback_resolved" for x in recs)


def test_verify_off_skips_the_rehash(tmp_path, data, monkeypatch):
    d = str(tmp_path / "ckpt")
    _train(_job(2, d), data)
    newest = ckpt_lib.make_manager(d).latest_step()
    _flip_byte(os.path.join(d, str(newest), ckpt_lib.STATE_FILE))
    monkeypatch.setenv("SHIFU_TPU_CKPT_VERIFY", "0")
    state = loop.init_state(_job(), F, "cpu")
    _st, step = ckpt_lib.restore_latest(ckpt_lib.make_manager(d), state)
    assert step == newest


def test_unreadable_step_falls_back_and_all_bad_reraises_first(tmp_path,
                                                               data):
    d = str(tmp_path / "ckpt")
    _train(_job(2, d), data)
    mgr = ckpt_lib.make_manager(d)
    old, new = mgr.all_steps()
    for s in (old, new):  # legacy-style: no manifest, so no re-hash
        os.unlink(ckpt_lib.manifest_path(d, s))
    with open(os.path.join(d, str(new), ckpt_lib.STATE_FILE), "wb") as f:
        f.write(b"truncated")
    state = loop.init_state(_job(), F, "cpu")
    _st, step = ckpt_lib.restore_latest(mgr, state)
    assert step == old
    with open(os.path.join(d, str(old), ckpt_lib.STATE_FILE), "wb") as f:
        f.write(b"also gone")
    with pytest.raises(Exception) as err:
        ckpt_lib.restore_latest(mgr, state)
    assert not isinstance(err.value, ckpt_lib.CheckpointIncompatibleError)


def test_manifest_records_files_and_state_tree(tmp_path, data):
    d = str(tmp_path / "ckpt")
    r = _train(_job(1, d), data)
    step = ckpt_lib.make_manager(d).latest_step()
    m = ckpt_lib.read_manifest(d, step)
    assert m["algo"] == "blake2b-128" and m["step"] == step
    assert set(m["files"]) == {ckpt_lib.STATE_FILE, ckpt_lib.EXTRA_FILE}
    tree = {p: (tuple(s), dt) for p, s, dt in m["state_tree"]}
    for k, v in r.state.model.state_dict().items():
        assert tree[f"/model/{k}"] == (tuple(v.shape), "float32")
    assert tree["/step"] == ((), "int")
    assert step == r.state.step


def test_retention_gc_is_journaled(tmp_path, data):
    d = str(tmp_path / "ckpt")
    obs.configure(str(tmp_path / "tele"), flush_every=1)
    _train(_job(4, d, ckpt_kw={"max_to_keep": 2}), data)
    mgr = ckpt_lib.make_manager(d)
    kept = mgr.all_steps()
    assert len(kept) == 2
    manifests = sorted(n for n in os.listdir(d)
                       if n.startswith(ckpt_lib.MANIFEST_PREFIX))
    assert manifests == sorted(f"manifest-{s}.json" for s in kept)
    gc = [r for r in obs.read_journal(str(tmp_path / "tele" /
                                          "journal.jsonl"))
          if r["kind"] == "checkpoint_gc"]
    assert len(gc) == 2 and all(r["freed_bytes"] > 0 for r in gc)
    reg = obs.default_registry()
    assert reg.counter("checkpoint_gc_total").value() == 2
    assert reg.counter("checkpoint_saves_total").value(mode="blocking") == 4


def _deepfm_job(epochs, directory, **data_kw):
    schema = synthetic.make_schema(num_features=10, num_categorical=3,
                                   vocab_size=50)
    return port_schema.JobConfig(
        schema=schema,
        data=port_schema.DataConfig(batch_size=64, **data_kw),
        model=port_schema.ModelSpec(model_type="deepfm", hidden_nodes=(8,),
                                    activations=("relu",), embedding_dim=4,
                                    compute_dtype="float32"),
        train=port_schema.TrainConfig(
            epochs=epochs, sparse_embedding_update="on",
            optimizer=port_schema.OptimizerConfig(name="adadelta",
                                                  learning_rate=0.5)),
        runtime=port_schema.RuntimeConfig(
            checkpoint=port_schema.CheckpointConfig(
                directory=directory))).validate()


@pytest.mark.parametrize("staged", [False, True])
def test_sparse_table_slots_survive_a_resume(tmp_path, staged):
    """Under a sparse plan the tables' moment slots ride the checkpoint:
    a resumed run equals the unbroken one bit for bit (per-batch tier with
    dedup, and the staged tier on raw ids)."""
    job = _deepfm_job(1, "", staged=staged, device_resident_bytes=0)
    rows = synthetic.make_rows(1200, job.schema, seed=3)
    cols = reader.project_columns(rows, job.schema)
    full = pipe.TabularDataset(cols["features"], cols["target"],
                               cols["weight"])
    ds = (full.take(np.arange(1000)), full.take(np.arange(1000, 1200)))
    d = str(tmp_path / "ckpt")
    a = loop.train(_deepfm_job(2, d, staged=staged, device_resident_bytes=0),
                   *ds, console=lambda s: None, device="cpu")
    assert a.state.table_slots
    b = loop.train(_deepfm_job(3, d, staged=staged, device_resident_bytes=0),
                   *ds, console=lambda s: None, device="cpu")
    c = loop.train(_deepfm_job(3, str(tmp_path / "u"), staged=staged,
                               device_resident_bytes=0),
                   *ds, console=lambda s: None, device="cpu")
    assert b.tier == ("staged" if staged else "batch")
    assert b.resumed_from_epoch == 2
    assert b.history[0].train_error == c.history[2].train_error
    _assert_params_equal(_params(b.state), _params(c.state))
    for name, slots in c.state.table_slots.items():
        for x, y in zip(slots, b.state.table_slots[name]):
            assert torch.equal(x, y)


def test_dropout_stream_resumes_at_the_saved_step(tmp_path, data):
    """Dropout masks depend on (train.seed, step): a resumed run with
    dropout equals the unbroken one bit for bit."""
    kw = {"model_kw": {"dropout_rate": 0.3}}
    d = str(tmp_path / "ckpt")
    _train(_job(2, d, **kw), data)
    b = _train(_job(3, d, **kw), data)
    c = _train(_job(3, str(tmp_path / "u"), **kw), data)
    assert b.history[0].train_error == c.history[2].train_error
    _assert_params_equal(_params(b.state), _params(c.state))


class _Killed(Exception):
    pass


def _kill_after(epoch: int):
    def cb(m):
        if m.epoch == epoch:
            raise _Killed  # the epoch's save landed before the callback
    return cb


def test_kill_and_resume_bitwise_and_held_to_jax(tmp_path, monkeypatch):
    """A job killed after epoch 1's save, then resumed, gives per-epoch
    losses bitwise equal to an unbroken run in the port, on the staged
    tier with the feeder; the JAX package runs the same schedule from the
    same carried weights, and the two agree within the train() tolerance
    of tests/test_torch_train.py."""
    import jax

    from shifu_tpu.config import schema as jax_schema
    from shifu_tpu.data import pipeline as jax_pipe
    from shifu_tpu.export.artifact import _flatten_params
    from shifu_tpu.train import loop as jax_loop
    from shifu_tpu_torch.export.artifact import params_from_jax

    from shifu_tpu.data import synthetic as jax_synth
    jschema = jax_synth.make_schema(num_features=F)

    def jax_job(directory):
        return jax_schema.JobConfig(
            schema=jschema,
            data=jax_schema.DataConfig(batch_size=64,
                                       device_resident_bytes=0),
            model=jax_schema.ModelSpec(hidden_nodes=(16, 16),
                                       activations=("tanh", "tanh"),
                                       compute_dtype="float32"),
            train=jax_schema.TrainConfig(
                epochs=3, optimizer=jax_schema.OptimizerConfig(
                    name="adam", learning_rate=3e-3)),
            runtime=jax_schema.RuntimeConfig(
                checkpoint=jax_schema.CheckpointConfig(
                    directory=directory))).validate()

    def port_job(directory):
        return port_schema.JobConfig.from_dict(
            json.loads(jax_job(directory).to_json())).validate()

    rows = jax_synth.make_rows(2048, jschema, seed=7, noise=0.3)
    from shifu_tpu.data import reader as jax_reader
    cols = jax_reader.project_columns(rows, jschema)

    def parts(mod):
        full = mod.TabularDataset(cols["features"], cols["target"],
                                  cols["weight"])
        return full.take(np.arange(1843)), full.take(np.arange(1843, 2048))

    jinit = jax_loop.init_state(jax_job(""), F)
    real_init = loop.init_state

    def carried(job, num_features, device=None):
        state = real_init(job, num_features, device)
        flat = {k: np.asarray(v) for k, v in
                _flatten_params(jax.device_get(jinit.params)).items()}
        state.model.load_state_dict(params_from_jax(flat, state.model))
        return state

    monkeypatch.setattr(loop, "init_state", carried)
    pdata = parts(pipe)

    def port_run(directory, callback=None):
        return loop.train(port_job(directory), *pdata,
                          console=lambda s: None, epoch_callback=callback,
                          device="cpu")

    unbroken = port_run(str(tmp_path / "p_unbroken"))
    with pytest.raises(_Killed):
        port_run(str(tmp_path / "p"), _kill_after(1))
    resumed = port_run(str(tmp_path / "p"))
    assert unbroken.tier == resumed.tier == "staged"
    assert resumed.resumed_from_epoch == 2
    assert [m.epoch for m in resumed.history] == [2]
    first = []
    with pytest.raises(_Killed):
        port_run(str(tmp_path / "p2"), lambda m: first.append(m)
                 or _kill_after(1)(m))
    port_losses = [m.train_error for m in first] + [
        m.train_error for m in resumed.history]
    assert port_losses == [m.train_error for m in unbroken.history]
    _assert_params_equal(_params(resumed.state), _params(unbroken.state))

    jdata = parts(jax_pipe)
    jfirst = []
    with pytest.raises(_Killed):
        jax_loop.train(jax_job(str(tmp_path / "j")), *jdata,
                       console=lambda s: None,
                       epoch_callback=lambda m: jfirst.append(m)
                       or _kill_after(1)(m))
    jres = jax_loop.train(jax_job(str(tmp_path / "j")), *jdata,
                          console=lambda s: None)
    assert jres.resumed_from_epoch == 2
    jhist = jfirst + list(jres.history)
    for g, w in zip(first + list(resumed.history), jhist):
        assert g.epoch == w.epoch
        assert g.train_error == pytest.approx(w.train_error, rel=1e-4)
        assert abs(g.valid_auc - w.valid_auc) <= 1e-3
