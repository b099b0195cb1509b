"""The remote half of the port's data/fsio.py and its callers, against the
JAX package's on pyarrow's in-memory mock:// filesystem (the counterparts
of tests/test_fsio.py): listing and reads, the board's write and tail, the
supervisor's committed-step probe, the retry ladder and its terminal
counters, `train --output mock://...` in-process, a checkpoint saved and
restored remotely, and v2 cache entries keyed from remote metadata.

mock:// is bucket-style, holds remote metadata (size, mtime) and no local
files, and needs no network; no test here touches a real remote scheme.
"""

import gzip
import json
import os
import threading
import time

import numpy as np
import pytest
from pyarrow import fs as pafs

from shifu_tpu import chaos as jax_chaos
from shifu_tpu import obs as jax_obs
from shifu_tpu.data import fsio as jax_fsio
from shifu_tpu.data import reader as jax_reader
from shifu_tpu_torch import chaos, obs
from shifu_tpu_torch.data import fsio, reader


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    # a chaos plan a `train` command of an earlier test file exported into
    # os.environ would fire in this file's commands
    for var in ("SHIFU_TPU_CHAOS_PLAN", "SHIFU_TPU_CHAOS_STATE",
                "SHIFU_TPU_METRICS_DIR"):
        monkeypatch.delenv(var, raising=False)
    for m in (obs, jax_obs, chaos, jax_chaos):
        m.reset_for_tests()
    yield
    for m in (obs, jax_obs, chaos, jax_chaos):
        m.reset_for_tests()


@pytest.fixture
def mock_fs(monkeypatch):
    """One mock filesystem behind mock:// in both packages, seeded with 3
    gzip shards and a marker file under bucket/data."""
    filesystem, _ = pafs.FileSystem.from_uri("mock://seed")
    for mod in (fsio, jax_fsio):
        monkeypatch.setitem(mod._fs_cache, ("mock", ""), filesystem)
    rng = np.random.default_rng(1)
    filesystem.create_dir("bucket/data")
    rows_by_file = {}
    for i in range(3):
        rows = rng.standard_normal((10, 4))
        rows_by_file[f"part-{i:05d}.gz"] = rows
        text = "\n".join("|".join(f"{v:.6g}" for v in r) for r in rows) + "\n"
        with filesystem.open_output_stream(
                f"bucket/data/part-{i:05d}.gz") as s:
            s.write(gzip.compress(text.encode()))
    with filesystem.open_output_stream("bucket/data/_SUCCESS") as s:
        s.write(b"")
    return filesystem, "mock://bucket/data", rows_by_file


def test_listing_reads_and_counts_equal_jax(mock_fs):
    filesystem, root, rows_by_file = mock_fs
    files = reader.list_data_files(root)
    assert files == jax_reader.list_data_files(root)
    assert [f.rsplit("/", 1)[1] for f in files] == sorted(rows_by_file)
    for f in files:
        got = reader.read_file(f)
        np.testing.assert_array_equal(got, jax_reader.read_file(f))
        assert reader.last_io_stats()["tier"] == "remote"
    np.testing.assert_allclose(reader.read_file(files[0]),
                               rows_by_file["part-00000.gz"], rtol=1e-5)
    assert fsio.count_data_lines(files[1]) == 10
    assert reader.count_rows(files) == jax_reader.count_rows(files) == 30
    assert fsio.walk_files(root) == jax_fsio.walk_files(root)
    assert fsio.file_info(files[0]) == jax_fsio.file_info(files[0])
    assert fsio.exists(files[0]) and not fsio.exists(root + "/missing.gz")
    for mod in (fsio, jax_fsio):
        with pytest.raises(FileNotFoundError):
            mod.read_bytes(root + "/missing.gz")
        with pytest.raises(FileNotFoundError):
            mod.list_files("mock://bucket/absent")
    fsio.write_bytes_atomic("mock://bucket/out/a.bin", b"abc")
    assert jax_fsio.read_bytes("mock://bucket/out/a.bin") == b"abc"


def test_remote_board_write_and_tail(mock_fs):
    """The board rewrites its object through fsio; a tail that shares only
    the URI sees lines written after it began, and stops when the board is
    removed."""
    from shifu_tpu_torch.launcher.console import ConsoleBoard, tail_board

    filesystem, _, _ = mock_fs
    board_uri = "mock://bucket/job/console.board"
    board = ConsoleBoard(board_uri, echo=False, flush_seconds=0.0)
    board("Epoch 0: train_error=0.5")
    got: list[str] = []
    done = threading.Event()

    def follow():
        for line in tail_board(board_uri, poll_seconds=0.02):
            got.append(line)
        done.set()

    threading.Thread(target=follow, daemon=True).start()
    deadline = time.monotonic() + 10
    while not got and time.monotonic() < deadline:
        time.sleep(0.02)
    assert any("Epoch 0" in line for line in got)
    board("Epoch 1: train_error=0.4")
    deadline = time.monotonic() + 10
    while len(got) < 2 and time.monotonic() < deadline:
        time.sleep(0.02)
    assert any("Epoch 1" in line for line in got), got
    board.close()
    filesystem.delete_file("bucket/job/console.board")
    assert done.wait(10), "the tail did not stop when the board went"


def test_committed_step_probe_and_progress_marker(mock_fs, tmp_path):
    """The supervisor's durable-progress probe on a remote checkpoint dir:
    the newest committed step tree (its extra.json written last) counts,
    an uncommitted newer one does not, and the PROGRESS marker wins when
    fresher; local and remote alike."""
    from shifu_tpu_torch.launcher.supervisor import (ProgressProbe,
                                                     checkpoint_progress)
    from shifu_tpu_torch.train import checkpoint as ckpt_lib

    filesystem, _, _ = mock_fs
    ck = "bucket/ckpt"
    filesystem.create_dir(f"{ck}/7")
    with filesystem.open_output_stream(f"{ck}/7/{ckpt_lib.EXTRA_FILE}") as s:
        s.write(json.dumps({"epoch": 2}).encode())
    filesystem.create_dir(f"{ck}/9")  # newer, uncommitted: no extra.json
    with filesystem.open_output_stream(f"{ck}/9/{ckpt_lib.STATE_FILE}") as s:
        s.write(b"partial")
    uri = "mock://bucket/ckpt"
    assert checkpoint_progress(uri) == 2
    probe = ProgressProbe(uri)
    ckpt_lib._write_progress_marker(uri, 14, {"epoch": 5})
    assert checkpoint_progress(uri) == 5 and probe.advanced()
    local = str(tmp_path / "ck")
    os.makedirs(local)
    assert checkpoint_progress(local) == -1
    ckpt_lib._write_progress_marker(local, 12, {"epoch": 3})
    assert checkpoint_progress(local) == 3
    assert not ProgressProbe(None).advanced()


class _Flaky:
    """A delegating filesystem proxy whose input streams fail first."""

    def __init__(self, filesystem, calls, message):
        self._fs, self._calls, self._message = filesystem, calls, message

    def open_input_stream(self, path, *a, **k):
        self._calls["n"] += 1
        if self._calls["n"] <= self._calls["fail_first"]:
            raise OSError(self._message)
        return self._fs.open_input_stream(path, *a, **k)

    def __getattr__(self, name):
        return getattr(self._fs, name)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_retry_ladder_and_terminal_counters(mock_fs, monkeypatch, tmp_path,
                                            pkg):
    """A transient error is retried (bounded); retries off fail at once;
    an auth-shaped error never retries; a persistent fault gives up at the
    deadline and journals `fsio_retry_exhausted` — the same attempts and
    records in both packages."""
    filesystem, root, _ = mock_fs
    mod, obs_mod = (fsio, obs) if pkg == "port" else (jax_fsio, jax_obs)
    uri = root + "/part-00001.gz"
    calls = {"n": 0, "fail_first": 1}
    monkeypatch.setitem(mod._fs_cache, ("mock", ""),
                        _Flaky(filesystem, calls, "transient datanode error"))
    monkeypatch.delenv("SHIFU_TPU_FS_RETRIES", raising=False)
    obs_mod.configure(str(tmp_path / "tele"), flush_every=1)
    assert gzip.decompress(mod.read_bytes(uri))
    assert calls["n"] == 2
    calls.update(n=0, fail_first=10 ** 9)
    monkeypatch.setenv("SHIFU_TPU_FS_RETRIES", "0")
    with pytest.raises(OSError, match="transient"):
        mod.read_bytes(uri)
    assert calls["n"] == 1
    monkeypatch.setenv("SHIFU_TPU_FS_RETRIES", "3")
    calls.update(n=0)
    monkeypatch.setitem(mod._fs_cache, ("mock", ""),
                        _Flaky(filesystem, calls,
                               "Permission denied: kerberos ticket expired"))
    with pytest.raises(OSError, match="Permission denied"):
        mod.read_bytes(uri)
    assert calls["n"] == 1
    monkeypatch.setenv("SHIFU_TPU_FS_RETRIES", "1000")
    monkeypatch.setenv("SHIFU_TPU_FS_RETRY_DEADLINE_S", "0.05")

    def down():
        raise OSError("transient datanode error")

    with pytest.raises(OSError, match="transient"):
        mod._retry_transient(down, op_name="read_bytes")
    obs_mod.flush()
    recs = [e for e in obs_mod.read_journal(str(tmp_path / "tele"
                                                / "journal.jsonl"))
            if e["kind"] == "fsio_retry_exhausted"]
    # retries off exhausted the attempts; the persistent fault the deadline
    assert [r["reason"] for r in recs] == ["attempts", "deadline"]
    assert set(recs[1]) >= {"op", "elapsed_s", "attempts", "deadline_s"}
    reasons = {}
    for line in _scrape(obs_mod, tmp_path).splitlines():
        if line.startswith("fsio_terminal_total{"):
            reasons[line.split("reason=\"")[1].split("\"")[0]] = \
                float(line.rsplit(" ", 1)[1])
    assert reasons == {"exhausted": 1.0, "auth": 1.0, "deadline": 1.0}


def _scrape(obs_mod, tmp_path) -> str:
    obs_mod.flush()
    with open(tmp_path / "tele" / "metrics.prom") as f:
        return f.read()


def test_checkpoint_saved_and_restored_on_mock(mock_fs):
    """The port's checkpoint format on a remote directory: a save commits
    with its extra.json last, its manifest verifies, retention deletes the
    oldest step trees, and a restore loads the state back."""
    import torch

    from shifu_tpu_torch.train import checkpoint as ckpt_lib

    class State:
        def __init__(self, v):
            self.model = torch.nn.Linear(3, 2)
            with torch.no_grad():
                self.model.weight.fill_(v)
            self.optimizer = torch.optim.SGD(self.model.parameters(), 0.1)
            self.step = 0
            self.table_slots = None

    uri = "mock://bucket/ck"
    manager = ckpt_lib.make_manager(uri, max_to_keep=2)
    for step, v in ((1, 1.0), (2, 2.0), (3, 3.0)):
        st = State(v)
        st.step = step
        ckpt_lib.save(manager, step, st, extra={"epoch": step})
    assert manager.all_steps() == [2, 3]
    assert ckpt_lib.verify_manifest(uri, 3) is True
    assert ckpt_lib.read_manifest(uri, 1) is None  # collected with its tree
    target = State(0.0)
    _, extra, step = ckpt_lib.restore_latest(manager, target,
                                             with_extra=True)
    assert (step, extra["epoch"], target.step) == (3, 3, 3)
    assert torch.equal(target.model.weight, torch.full((2, 3), 3.0))
    from shifu_tpu_torch.launcher.supervisor import checkpoint_progress
    assert checkpoint_progress(uri) == 3


def test_cache_entries_from_remote_metadata_match_jax(mock_fs, tmp_path):
    """v2 entries of remote sources key on the filesystem's (size, mtime)
    and the URI: the two packages write the same names and the same
    bytes, and an overwrite with new metadata is a miss."""
    from shifu_tpu.data import cache as jax_cache
    from shifu_tpu_torch.data import cache

    filesystem, root, _ = mock_fs
    uri = root + "/part-00000.gz"
    pc, jc = str(tmp_path / "pc"), str(tmp_path / "jc")
    np.testing.assert_array_equal(cache.read_file_cached(uri, cache_dir=pc),
                                  jax_cache.read_file_cached(uri,
                                                             cache_dir=jc))

    def tree(d):
        out = {}
        for base, _dirs, names in os.walk(d):
            for n in names:
                with open(os.path.join(base, n), "rb") as f:
                    out[os.path.relpath(os.path.join(base, n), d)] = f.read()
        return out

    assert tree(pc) == tree(jc) and tree(pc)
    name = cache.cache_entry_name(uri, "|")
    assert name == jax_cache.cache_entry_name(uri, "|")
    time.sleep(0.01)
    text = "\n".join("|".join("9" for _ in range(4)) for _ in range(5)) + "\n"
    with filesystem.open_output_stream("bucket/data/part-00000.gz") as s:
        s.write(gzip.compress(text.encode()))
    assert cache.cache_entry_name(uri, "|") != name
    np.testing.assert_array_equal(cache.read_file_cached(uri, cache_dir=pc),
                                  np.full((5, 4), 9.0, np.float32))


def _shifu_job(tmp_path, out_name):
    from shifu_tpu_torch.data import synthetic
    from shifu_tpu_torch.utils import xmlconfig

    mc = {"dataSet": {"targetColumnName": "target"},
          "train": {"validSetRate": 0.2, "numTrainEpochs": 1,
                    "algorithm": "NN",
                    "params": {"NumHiddenLayers": 1, "NumHiddenNodes": [8],
                               "ActivationFunc": ["relu"],
                               "LearningRate": 0.01, "Optimizer": "adam"}}}
    cols = [{"columnNum": 0, "columnName": "target", "columnFlag": "Target"}]
    cols += [{"columnNum": i, "columnName": f"f{i}", "columnType": "N",
              "finalSelect": True} for i in range(1, 9)]
    (tmp_path / "ModelConfig.json").write_text(json.dumps(mc))
    (tmp_path / "ColumnConfig.json").write_text(json.dumps(cols))
    if not (tmp_path / "data").exists():
        schema = synthetic.make_schema(num_features=8)
        rows = synthetic.make_rows(600, schema, seed=6, noise=0.3)
        synthetic.write_files(rows, str(tmp_path / "data"), num_files=2)
    gconf = tmp_path / f"{out_name}.xml"
    xmlconfig.write_configuration_xml(
        {"shifu.application.tmp-model-path": str(tmp_path / out_name)},
        str(gconf))
    return ["train",
            "--modelconfig", str(tmp_path / "ModelConfig.json"),
            "--columnconfig", str(tmp_path / "ColumnConfig.json"),
            "--data", str(tmp_path / "data"),
            "--globalconfig", str(gconf)]


def _remote_tree(filesystem, base: str) -> set:
    infos = filesystem.get_file_info(pafs.FileSelector(base, recursive=True))
    return {i.path[len(base) + 1:] for i in infos
            if i.type == pafs.FileType.File}


def test_train_output_on_mock_writes_the_jax_job_dir(mock_fs, tmp_path,
                                                     capsys):
    """`train --output mock://...` in-process: the configs, the board,
    metrics.jsonl, the telemetry and the artifact (built locally, then
    uploaded) land on the remote job dir, in the tree JAX's `train`
    writes: the same top-level files and directories; final_model holds
    the port's artifact files, each of which JAX's also writes, the native
    pack included, but for `scoring.pt2`, the port's counterpart of JAX's
    StableHLO export (`scoring.mlir`, `scoring.jaxexport`)."""
    from shifu_tpu.launcher import cli as jax_cli
    from shifu_tpu_torch.launcher import cli

    filesystem, _, _ = mock_fs
    argv = _shifu_job(tmp_path, "pck")
    assert cli.main(argv + ["--output", "mock://bucket/port",
                            "--device", "cpu"]) == 0
    obs.reset_for_tests()
    assert jax_cli.main(_shifu_job(tmp_path, "jck")
                        + ["--output", "mock://bucket/jax"]) == 0
    capsys.readouterr()
    port, jax = (_remote_tree(filesystem, f"bucket/{n}")
                 for n in ("port", "jax"))

    def top(tree):
        return {p.split("/", 1)[0] for p in tree}

    assert top(port) == top(jax)
    pm = {p for p in port if p.startswith("final_model/")}
    jm = {p for p in jax if p.startswith("final_model/")}
    assert "final_model/scoring.pt2" in pm
    assert "final_model/scoring.jaxexport" in jm
    assert pm - {"final_model/scoring.pt2"} <= jm
    assert "final_model/model.bin" in pm
    board = fsio.read_bytes("mock://bucket/port/console.board").decode()
    assert "Epoch 0:" in board and "model exported" in board
    metrics = fsio.read_bytes("mock://bucket/port/metrics.jsonl").decode()
    assert json.loads(metrics.splitlines()[0])["epoch"] == 0
    job_doc = json.loads(fsio.read_bytes("mock://bucket/port/job-config.json"))
    assert job_doc["train"]["epochs"] == 1
    assert fsio.read_bytes(
        "mock://bucket/port/final_model/weights.npz")[:2] == b"PK"
    assert obs.read_journal("mock://bucket/port/telemetry/journal.jsonl")
