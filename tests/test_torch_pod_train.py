"""Pod training through the port's `train` command on the CPU (gloo ranks
in child processes, one per simulated host).

- `train --hosts local:2 --device cpu`: each rank's per-step losses are
  bitwise those of the interleaved replay: the global batches of
  `interleaved_epoch_order`, the hosts' slices in rank order, through the
  port's train step on a mesh of two (JAX's
  `test_sharded_training_loss_identical_to_single_host` carried to the
  port); one process stepping the same global batches alone agrees within
  the f32 tolerance.
- The same on the staged data path over unequal shards (3 files, 2
  hosts): a streamed first epoch (rounds of one block a host, until the
  first host runs dry), then the resident or the staged tier, each
  replayed in the JAX loop's order (`epoch_permutation` over the resident
  blocks; `staged_epoch_blocks` over the epoch's `min_host_rows` subset).
- `--num-processes 2` trains what `--hosts local:2` trains.
- `host_skew` and `dcn_placement` carry the JAX loop's field sets (read
  from its source), the skew rows agree on both digests, and `pod-verify`
  passes the run.
- A pod rank does not catch SIGTERM (a one-host rank drains on it).
- `launch_gang` tears the gang down on a `pod.dispatch` fault and names
  the culprit; `supervise_pod` restarts the gang and the job resumes;
  three hosts with one down for good reshape to two.
- The ssh transport through a fake `ssh` on PATH, with one rc=255
  connect failure reconnected.
- SHIFU_TPU_CPU_DEVICES=2 x local:2 (four gloo ranks) trains within the
  f32 tolerance of the two-rank pod.

The children import the port from this checkout; a `sitecustomize.py` on
their PYTHONPATH records each rank's per-step losses and its SIGTERM
disposition (nothing of it is in the package).  Every gang has its own
deadline.
"""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from shifu_tpu.data import pipeline as jax_pipe
from shifu_tpu_torch.data import pipeline as pipe
from shifu_tpu_torch.data import synthetic
from shifu_tpu_torch.launcher import cli, pod
from shifu_tpu_torch.utils import xmlconfig

import torch_mesh_helpers as helpers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GANG_TIMEOUT_S = 180
XML = {"shifu.data.staged": "false",
       "shifu.application.batch-size": "64",
       "shifu.checkpoint.save-seconds": "0"}
_SITE = '''
import atexit, json, os, signal
_dir = os.environ.get("POD_TEST_RECORD")
if _dir:
    from shifu_tpu_torch.train import step as _step
    _rec = {"losses": [], "sigterm_default": None}
    _inner = _step._train_step_fn

    def _train_step_fn(*a, **k):
        fn = _inner(*a, **k)

        def recorded(state, batch):
            state, m = fn(state, batch)
            _rec["losses"].append(float(m["loss"]))
            if _rec["sigterm_default"] is None:
                _rec["sigterm_default"] = (
                    signal.getsignal(signal.SIGTERM) == signal.SIG_DFL)
            return state, m
        return recorded

    _step._train_step_fn = _train_step_fn

    def _write():
        if _rec["losses"]:
            rank = os.environ.get("SHIFU_TPU_PROCESS_ID", "x")
            with open(os.path.join(_dir, f"rank-{rank}-{os.getpid()}.json"),
                      "w") as f:
                json.dump(_rec, f)
    atexit.register(_write)
'''


def _files(tmp_path, rows=512, files=4, xml=None, valid=0.0):
    """Shifu files of an MLP over `files` equal parts (so that two hosts
    hold equal rows) and the train argv."""
    schema = synthetic.make_schema(num_features=8)
    synthetic.write_files(synthetic.make_rows(rows, schema, seed=7,
                                              noise=0.3),
                          str(tmp_path / "data"), num_files=files)
    mc = {"basic": {"name": "pod"},
          "dataSet": {"targetColumnName": "target", "dataDelimiter": "|"},
          "train": {"validSetRate": valid, "numTrainEpochs": 2,
                    "algorithm": "NN",
                    "params": {"NumHiddenLayers": 1, "NumHiddenNodes": [8],
                               "ActivationFunc": ["relu"],
                               "LearningRate": 0.05, "Propagation": "Q",
                               "Loss": "squared"}}}
    cc = [{"columnNum": c.index, "columnName": c.name,
           "columnFlag": "Target" if c.is_target else None,
           "columnType": "N", "finalSelect": c.is_selected}
          for c in schema.columns]
    (tmp_path / "ModelConfig.json").write_text(json.dumps(mc))
    (tmp_path / "ColumnConfig.json").write_text(json.dumps(cc))
    xmlconfig.write_configuration_xml(dict(XML, **(xml or {})),
                                      str(tmp_path / "global.xml"))
    return ["train", "--modelconfig", str(tmp_path / "ModelConfig.json"),
            "--columnconfig", str(tmp_path / "ColumnConfig.json"),
            "--data", str(tmp_path / "data"),
            "--globalconfig", str(tmp_path / "global.xml"),
            "--device", "cpu"]


def _env(tmp_path, record=None, **extra) -> dict:
    site = tmp_path / "site"
    site.mkdir(exist_ok=True)
    (site / "sitecustomize.py").write_text(_SITE)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("SHIFU_TPU_")}
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(site), REPO, os.environ.get("PYTHONPATH")) if p)
    if record is not None:
        record.mkdir(exist_ok=True)
        env["POD_TEST_RECORD"] = str(record)
    env.update(extra)
    return env


def _train(argv, env, cwd) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", "shifu_tpu_torch.launcher.cli", *argv],
        env=env, cwd=str(cwd), capture_output=True, text=True,
        timeout=GANG_TIMEOUT_S)


def _records(record_dir) -> dict:
    out = {}
    for name in sorted(os.listdir(record_dir)):
        rank = name.split("-")[1]
        with open(os.path.join(record_dir, name)) as f:
            out[rank] = json.load(f)
    return out


def _journal(job_dir) -> list:
    path = os.path.join(job_dir, "telemetry", "journal.jsonl")
    with open(path) as f:
        return [json.loads(ln) for ln in f]


def _weights(job_dir) -> dict:
    from shifu_tpu_torch.export.scorer import TorchScorer
    rows = np.random.default_rng(0).normal(size=(32, 8)).astype(np.float32)
    return TorchScorer(os.path.join(job_dir, "final_model"),
                       device="cpu").compute_batch(rows)


@pytest.fixture(autouse=True)
def _no_chaos_plan():
    """A dispatcher here probes with this process's chaos plan: none
    carried over from another test file."""
    from shifu_tpu_torch import chaos
    chaos.reset_for_tests()
    yield
    chaos.reset_for_tests()


@pytest.fixture(scope="module")
def pod_run(tmp_path_factory):
    """One `train --hosts local:2` run on the per-batch tier, its ranks
    recorded."""
    tmp = tmp_path_factory.mktemp("pod_train")
    argv = _files(tmp)
    out = tmp / "pod"
    r = _train(argv + ["--hosts", "local:2", "--output", str(out)],
               _env(tmp, record=tmp / "rec"), tmp)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return {"tmp": tmp, "argv": argv, "out": out, "stdout": r.stdout,
            "records": _records(tmp / "rec")}


def test_pod_losses_equal_the_interleaved_replay(pod_run):
    tmp, out = pod_run["tmp"], pod_run["out"]
    recs = pod_run["records"]
    assert sorted(recs) == ["0", "1"]
    assert recs["0"]["losses"] == recs["1"]["losses"]
    with open(out / "job-config.json") as f:
        from shifu_tpu_torch.config.schema import JobConfig
        job = JobConfig.from_json(f.read())
    # each host's shard as the loop loads it, its rows numbered after the
    # hosts before it in one concatenated table
    shards = [pipe.load_datasets(job.schema, job.data, h, 2)[0]
              for h in range(2)]
    assert shards[0].num_rows == shards[1].num_rows
    table = {k: np.concatenate([getattr(s, k) for s in shards])
             for k in ("features", "target", "weight")}
    offsets = np.cumsum([0] + [s.num_rows for s in shards])
    host_ids = [np.arange(offsets[h], offsets[h + 1]) for h in range(2)]
    lbs = job.data.batch_size // 2
    cast = pipe.wire_cast_fn(job.schema, job.data, job.model.compute_dtype,
                             compact=(True, True))
    batches = []
    for epoch in range(job.train.epochs):
        order = pipe.interleaved_epoch_order(
            host_ids, lbs, shuffle=job.data.shuffle,
            seed=job.data.shuffle_seed, epoch=epoch).reshape(-1, 2 * lbs)
        batches += [cast({k: v[ids] for k, v in table.items()})
                    for ids in order]
    from shifu_tpu_torch.config.schema import MeshConfig
    replay = helpers.run_ranks(helpers.dp_cases, 2, tmp, MeshConfig(data=2),
                               [(job, None, batches)])
    assert replay[0][0]["losses"] == recs["0"]["losses"]
    assert len(recs["0"]["losses"]) == len(batches)
    # one process stepping the same global batches alone: the same
    # trajectory within the f32 tolerance (the gradient sums differ in
    # their rounding order)
    alone = helpers.dp_cases(0, 1, MeshConfig(data=1), [(job, None, batches)])
    np.testing.assert_allclose(alone[0]["losses"], recs["0"]["losses"],
                               rtol=1e-4, atol=1e-6)


def _staged_subset(ds, min_rows: int, data, epoch: int):
    """A host's rows for one staged pod epoch, by the JAX loop's rule
    (`staged_source` in shifu_tpu/train/loop.py)."""
    if ds.num_rows <= min_rows:
        return ds
    if not data.shuffle:
        return ds.take(np.arange(min_rows))
    rng = np.random.default_rng(
        np.random.PCG64(data.shuffle_seed * 9176 + epoch))
    return ds.take(np.sort(rng.permutation(ds.num_rows)[:min_rows]))


def _concat_hosts(per_host: list) -> list:
    """Global batches from the hosts' blocks of one round each: batch j of
    a round is every host's batch j, in rank order."""
    out = []
    for blocks in per_host:
        for j in range(blocks[0]["features"].shape[0]):
            out.append({k: np.concatenate([b[k][j] for b in blocks])
                        for k in blocks[0]})
    return out


def _tier_replay(job, tier: str, nhosts: int = 2) -> list:
    """The pod's global batches, wire-cast: the streamed first epoch (each
    host's blocks in file order, rounds until the first host runs dry,
    the wide wire), then the loaded tier's epochs on the compact wire."""
    data, lbs = job.data, job.data.batch_size // nhosts
    loaders = [pipe.StreamingLoader(job.schema, data, "float32",
                                    host_index=h, num_hosts=nhosts)
               for h in range(nhosts)]
    streams = [list(ld.first_epoch_blocks(lbs, data.block_batches,
                                          pad_tail=False))
               for ld in loaders]
    wide = pipe.wire_cast_fn(job.schema, data, job.model.compute_dtype,
                             compact=False) or (lambda b: b)
    batches = [wide(b) for b in _concat_hosts(list(zip(*streams)))]
    shards = [ld.train_dataset() for ld in loaders]
    assert len({s.num_rows for s in shards}) > 1  # unequal shards
    compact = (all(pipe.target_u8_exact(s.target) for s in shards),
               all(pipe.weight_all_ones(s.weight) for s in shards))
    cast = pipe.wire_cast_fn(job.schema, data, job.model.compute_dtype,
                             compact=compact) or (lambda b: b)
    min_rows = min(s.num_rows for s in shards)
    for epoch in range(1, job.train.epochs):
        if tier == "resident":
            nb = min_rows // lbs
            order = jax_pipe.epoch_permutation(
                nb, shuffle=data.shuffle, seed=data.shuffle_seed,
                epoch=epoch)
            rounds = [[{k: getattr(s, k)[:nb * lbs].reshape(
                nb, lbs, *getattr(s, k).shape[1:])[order]
                for k in ("features", "target", "weight")}
                for s in shards]]
        else:
            rounds = list(zip(*[list(jax_pipe.staged_epoch_blocks(
                _staged_subset(s, min_rows, data, epoch), lbs,
                shuffle=data.shuffle, seed=data.shuffle_seed, epoch=epoch,
                block_batches=data.block_batches)) for s in shards]))
        batches += [cast(b) for b in _concat_hosts(rounds)]
    return batches


@pytest.mark.parametrize("tier,xml", [
    ("resident", {}),
    ("staged", {"shifu.data.device-resident-bytes": "1"})])
def test_staged_pod_losses_equal_the_tier_replay(tmp_path, tier, xml):
    """Unequal shards on the staged data path: the streamed first epoch,
    then the resident or staged tier, bitwise the replay of their order
    through the port's train step on a mesh of two."""
    argv = _files(tmp_path, files=3, xml={
        "shifu.data.staged": "true",
        "shifu.application.batch-size": "8", **xml})
    out = tmp_path / "pod"
    r = _train(argv + ["--hosts", "local:2", "--output", str(out)],
               _env(tmp_path, record=tmp_path / "rec"), tmp_path)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "Streaming first epoch" in r.stdout
    recs = _records(tmp_path / "rec")
    assert sorted(recs) == ["0", "1"]
    assert recs["0"]["losses"] == recs["1"]["losses"]
    with open(out / "job-config.json") as f:
        from shifu_tpu_torch.config.schema import JobConfig
        job = JobConfig.from_json(f.read())
    batches = _tier_replay(job, tier)
    from shifu_tpu_torch.config.schema import MeshConfig
    replay = helpers.run_ranks(helpers.dp_cases, 2, tmp_path,
                               MeshConfig(data=2), [(job, None, batches)])
    assert len(recs["0"]["losses"]) == len(batches)
    assert replay[0][0]["losses"] == recs["0"]["losses"]


def test_num_processes_two_equals_hosts_local_two(pod_run):
    tmp = pod_run["tmp"]
    out = tmp / "nproc"
    r = _train(pod_run["argv"] + ["--num-processes", "2", "--output",
                                  str(out)], _env(tmp), tmp)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert (out / "logs" / "host-1.attempt-1.log").exists()
    for name in ("metrics.jsonl",):
        a = [json.loads(ln) for ln in (pod_run["out"] / name).read_text()
             .splitlines()]
        b = [json.loads(ln) for ln in (out / name).read_text().splitlines()]
        keys = ("epoch", "train_error", "valid_error", "valid_auc")
        assert [{k: m[k] for k in keys} for m in a] == \
            [{k: m[k] for k in keys} for m in b]
    np.testing.assert_array_equal(_weights(out), _weights(pod_run["out"]))
    # --devices beside --num-processes is refused, as in JAX
    r = _train(pod_run["argv"] + ["--num-processes", "2", "--devices", "2",
                                  "--output", str(tmp / "bad")],
               _env(tmp), tmp)
    assert r.returncode == 1
    assert "--devices cannot combine with --num-processes" in r.stderr


def _jax_event_fields(relpath: str, kind: str) -> set:
    """The keyword names of the JAX package's `event(kind, ...)` call in
    `relpath`."""
    src = open(os.path.join(REPO, "shifu_tpu", relpath)).read()
    for node in ast.walk(ast.parse(src)):
        if (isinstance(node, ast.Call) and node.args
                and isinstance(node.args[0], ast.Constant)
                and node.args[0].value == kind):
            return {k.arg for k in node.keywords}
    raise AssertionError(f"no {kind} event in {relpath}")


def test_host_skew_and_dcn_placement_carry_jax_fields(pod_run, capsys):
    journal = _journal(pod_run["out"])
    meta = {"kind", "ts", "seq", "pid", "host", "src", "run_id", "rank"}
    skews = [e for e in journal if e["kind"] == "host_skew"]
    dcns = [e for e in journal if e["kind"] == "dcn_placement"]
    assert [e["epoch"] for e in skews] == [e["epoch"] for e in dcns] == [0, 1]
    want_skew = _jax_event_fields("obs/aggregate.py", "host_skew")
    want_dcn = _jax_event_fields("train/loop.py", "dcn_placement")
    for ev in skews:
        assert set(ev) - meta == want_skew
        assert ev["order_digest_agree"] is True
        assert ev["shard_digest_agree"] is True
        assert [r["rank"] for r in ev["hosts"]] == [0, 1]
        for row in ev["hosts"]:
            assert {"host", "rank", "input_s", "epoch_s", "valid_s",
                    "ingest_bytes", "ingest_s", "order_digest",
                    "shard_digest"} <= set(row)
            assert row["ingest_bytes"] > 0
    for ev in dcns:
        # the port adds the ranks and the backend the placement chose
        assert set(ev) - meta == want_dcn | {"ranks", "backend"}
        assert ev["hosts"] == 2 and ev["input_dcn_bytes"] == 0
        assert ev["input_dcn_saved_bytes"] == ev["input_local_bytes"] > 0
        assert ev["backend"] == "gloo" and ev["ranks"] == 2
    assert "hosts by input time (slowest first)" in pod_run["stdout"]
    assert "backend=gloo (cpu)" in pod_run["stdout"]
    capsys.readouterr()
    assert cli.main(["pod-verify", str(pod_run["out"])]) == 0
    assert capsys.readouterr().out.startswith("pod-verify: PASS")


def test_a_pod_rank_does_not_catch_sigterm(pod_run, tmp_path):
    assert all(r["sigterm_default"] is True
               for r in pod_run["records"].values())
    # a one-host gang's rank drains on SIGTERM: it has a handler
    r = _train(pod_run["argv"] + ["--devices", "2", "--output",
                                  str(tmp_path / "one_host")],
               _env(tmp_path, record=tmp_path / "rec"), tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    recs = _records(tmp_path / "rec")
    assert sorted(recs) == ["0", "1"]
    assert all(rec["sigterm_default"] is False for rec in recs.values())


def test_a_dispatch_fault_tears_the_gang_down_and_names_the_culprit(
        tmp_path, monkeypatch):
    """`pod.dispatch` fails host 1's transport (the site's second call, a
    raised fault that the dispatcher turns into a child exiting with its
    code): host 0,
    a dryrun rank sleeping through its epochs, is torn down, the gang
    exits with the fault's code and host 1 is the one culprit."""
    plan = {"faults": [{"site": "pod.dispatch", "at_call": 2,
                        "action": "raise", "exit_code": 29}]}
    monkeypatch.setenv("SHIFU_TPU_CHAOS_PLAN", json.dumps(plan))
    monkeypatch.delenv("SHIFU_TPU_CHAOS_STATE", raising=False)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    data = tmp_path / "data"
    synthetic.write_files(synthetic.make_rows(
        32, synthetic.make_schema(num_features=4), seed=1), str(data),
        num_files=2)
    from shifu_tpu_torch import chaos
    from shifu_tpu_torch.launcher.supervisor import JobDeadline
    chaos.reload_from_env()  # this process's plan: the dispatcher probes
    lines = []
    out = str(tmp_path / "out")
    try:
        rc, culprits = pod.launch_gang(
            pod.parse_hosts("local:2"),
            ["data-dryrun", "--data", str(data), "--out", out,
             "--features", "4", "--epochs", "50", "--epoch-seconds", "1"],
            out, attempt=1, echo=lines.append,
            deadline=JobDeadline(GANG_TIMEOUT_S))
    finally:
        monkeypatch.delenv("SHIFU_TPU_CHAOS_PLAN")
        chaos.reset_for_tests()
    assert (rc, culprits) == (29, (1,)), lines
    text = "\n".join(lines)
    assert "pod: chaos: host 1 dispatch fails" in text
    assert "host 1 (local) exited rc=29 — tearing down the gang" in text
    assert os.path.exists(os.path.join(out, "logs",
                                       "host-0.attempt-1.log"))


def test_supervise_pod_restarts_the_gang_and_resumes(tmp_path):
    """Rank 1 dies after epoch 0 (the legacy fault hook): the gang is
    torn down, restarted, resumes from the checkpoint and finishes, the
    final epoch trained once."""
    argv = _files(tmp_path, valid=0.1)
    out = tmp_path / "job"
    r = _train(argv + ["--hosts", "local:2", "--output", str(out),
                       "--max-restarts", "2"],
               _env(tmp_path, SHIFU_TPU_FAULT_EPOCH="0",
                    SHIFU_TPU_FAULT_PROCESS="1"), tmp_path)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "host 1 (local) exited rc=17" in r.stdout
    assert "pod: succeeded after 2 attempts" in r.stdout
    board = (out / "console.board").read_text()
    assert "Resumed from checkpoint" in board
    assert board.count("Epoch 1:") == 1
    for rank in range(2):
        assert (out / "logs" / f"host-{rank}.attempt-1.log").exists()
    assert "FAULT INJECTION" in (out / "logs" /
                                 "host-1.attempt-1.log").read_text()
    assert (out / "final_model").exists()


def test_an_elastic_reshape_from_three_hosts_to_two(tmp_path):
    """Host 2 is down for good (it dies at start every attempt): the
    same-shape budget is spent, the gang reshapes to two hosts with the
    shards rebalanced, and the job completes."""
    argv = _files(tmp_path, rows=600, files=6, valid=0.1,
                  xml={"shifu.pod.min-hosts": "2"})
    out = tmp_path / "job"
    r = _train(argv + ["--hosts", "local:3", "--output", str(out),
                       "--max-restarts", "1"],
               _env(tmp_path, SHIFU_TPU_FAULT_HOST_DOWN="2"), tmp_path)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "host 2 (local) exited rc=1" in r.stdout
    assert "presumed permanently lost" in r.stdout
    assert "reshaping the gang to 2 hosts" in r.stdout
    assert "pod: succeeded after" in r.stdout
    skews = [e for e in _journal(out) if e["kind"] == "host_skew"]
    assert skews and all(len(e["hosts"]) == 2 for e in skews)
    assert (out / "final_model").exists()


def test_the_ssh_transport_through_a_fake_ssh(tmp_path):
    """`--hosts localhost,127.0.0.1` over a fake ssh that runs the remote
    command here: the contract rides the command line, the first connect
    to 127.0.0.1 fails with 255 and is reconnected within the attempt."""
    fake_bin = tmp_path / "bin"
    fake_bin.mkdir()
    marker = tmp_path / "failed_once"
    (fake_bin / "ssh").write_text(
        "#!/bin/sh\n"
        "[ \"$1\" = -tt ] || { echo 'missing -tt' >&2; exit 64; }\n"
        "shift\n"
        "[ \"$1\" = -o ] && shift 2\n"
        "host=\"$1\"; shift\n"
        f"if [ \"$host\" = 127.0.0.1 ] && [ ! -e {marker} ]; then\n"
        f"  touch {marker}\n"
        "  echo 'ssh: connect to host 127.0.0.1 port 22: refused' >&2\n"
        "  exit 255\n"
        "fi\n"
        "echo \"FAKE-SSH host=$host cmd=$*\"\n"
        "exec sh -c \"$*\"\n")
    (fake_bin / "ssh").chmod(0o755)
    from shifu_tpu_torch.parallel.launch import free_port
    argv = _files(tmp_path, valid=0.1)
    out = tmp_path / "job"
    env = _env(tmp_path)
    env["PATH"] = f"{fake_bin}{os.pathsep}{env['PATH']}"
    r = _train(argv + ["--hosts", "localhost,127.0.0.1", "--output",
                       str(out), "--coordinator-port", str(free_port())],
               env, tmp_path)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "reconnect 1/3" in r.stdout
    assert "attempt 1 failed" not in r.stdout
    h0 = (out / "logs" / "host-0.attempt-1.log").read_text()
    h1 = (out / "logs" / "host-1.attempt-1.log").read_text()
    assert "FAKE-SSH host=localhost" in h0 and "SHIFU_TPU_PROCESS_ID=0" in h0
    assert "FAKE-SSH host=127.0.0.1" in h1 and "SHIFU_TPU_PROCESS_ID=1" in h1
    assert "SHIFU_TPU_NUM_HOSTS=2" in h0 and "Epoch 1:" in h0
    assert (out / "final_model").exists()


def test_two_cpu_devices_on_each_of_two_hosts(pod_run, tmp_path):
    """SHIFU_TPU_CPU_DEVICES=2 x local:2: each host runs two ranks of one
    group of four, splitting its host's batch; the run trains the two-rank
    pod's trajectory within the f32 tolerance."""
    out = tmp_path / "four"
    r = _train(pod_run["argv"] + ["--hosts", "local:2", "--output",
                                  str(out)],
               _env(tmp_path, record=tmp_path / "rec",
                    SHIFU_TPU_CPU_DEVICES="2"), tmp_path)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    recs = _records(tmp_path / "rec")
    assert sorted(recs) == ["0", "1", "2", "3"]
    np.testing.assert_allclose(recs["0"]["losses"],
                               pod_run["records"]["0"]["losses"],
                               rtol=1e-4, atol=1e-6)
    dcn = [e for e in _journal(out) if e["kind"] == "dcn_placement"]
    assert dcn and all((e["hosts"], e["local_devices"], e["ranks"])
                       == (2, 2, 4) for e in dcn)
    skews = [e for e in _journal(out) if e["kind"] == "host_skew"]
    assert all([r["rank"] for r in e["hosts"]] == [0, 1] for e in skews)


def test_process_local_steps_equal_the_one_host_steps(tmp_path):
    """A DeepFM with vocab-sharded tables and the sparse update on
    data=2 x model=2, over two hosts of two ranks: each rank fed only its
    rows of its host's slice steps exactly as a one-host rank fed the
    global batch (the update gathers the global batch's ids over the data
    group), bitwise.  (The MLP's dense step: the replay above.)"""
    from test_torch_vocab_shard import V, _deepfm_jobs

    rng = np.random.default_rng(5)
    data = []
    for _ in range(4):
        x = rng.standard_normal((32, 10)).astype(np.float32)
        x[:, 6:] = rng.integers(0, V, (32, 4))
        data.append({"features": x,
                     "target": (rng.random((32, 1)) < 0.5).astype(np.float32),
                     "weight": (rng.random((32, 1)) + 0.5).astype(np.float32)})
    _, job = _deepfm_jobs()
    mesh_cfg = job.runtime.mesh
    one_host = helpers.run_ranks(helpers.dp_cases, 4, tmp_path, mesh_cfg,
                                 [(job, None, data)])
    pod_ranks = helpers.run_ranks(helpers.pod_cases, 4, tmp_path, mesh_cfg,
                                  [(job, data)], 2)
    for a, b in zip(one_host, pod_ranks):
        assert a[0]["losses"] == b[0]["losses"]
        for k, v in a[0]["state"].items():
            assert np.array_equal(v, b[0]["state"][k]), k
