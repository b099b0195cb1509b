"""The port's pod data plane against the JAX package's (the counterpart of
tests/test_pod_data_plane.py).

- The shard scheme (`shard_rotation`, `host_shard_assignment`,
  `shard_assignment_digest`, `host_file_shard`) and the pod's global
  batch order (`interleaved_epoch_order`) equal JAX's, bit for bit, with
  its parametrisation (modes x 1-4 hosts x epochs).
- The journal audits (`pod_verify_events`, `_pod_close_rows`,
  `pod_ingest_rollup`, `digest_agreement`, `skew_line`) and `parse_hosts`
  with its coordinator-port rules equal JAX's on the same inputs.
- Four simulated hosts each read a quarter of the source bytes.
- The elastic drill: a `local:2` `data-dryrun` gang under `supervise_pod`,
  a chaos exit at `data.host_shard`; the port's `pod-verify` passes, and
  JAX's `pod_verify_events` on the port's journals gives the same report.
- The port's `data-dryrun` gang journals the `pod_epoch_close` digests
  and ingest bytes JAX's gang journals, per (epoch, rank).

Every gang here is a subprocess group with its own deadline.
"""

import json
import os

import numpy as np
import pytest

from shifu_tpu.config.schema import DataConfig as JaxDataConfig
from shifu_tpu.data import pipeline as jax_pipe
from shifu_tpu.launcher import pod as jax_pod
from shifu_tpu.obs import aggregate as jax_aggregate
from shifu_tpu_torch.config.schema import DataConfig
from shifu_tpu_torch.data import pipeline as pipe
from shifu_tpu_torch.data import synthetic
from shifu_tpu_torch.launcher import pod
from shifu_tpu_torch.obs import aggregate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GANG_TIMEOUT_S = 120.0


@pytest.fixture
def pod_env(monkeypatch):
    """The children import the port from this checkout and inherit no
    telemetry, cache or chaos setting of the test process."""
    for var in ("SHIFU_TPU_METRICS_DIR", "SHIFU_TPU_DATA_CACHE",
                "SHIFU_TPU_CHAOS_PLAN", "SHIFU_TPU_CHAOS_STATE",
                "SHIFU_TPU_COORDINATOR_PORT", "SHIFU_TPU_HOSTS"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    from shifu_tpu_torch import chaos
    chaos.reset_for_tests()  # the dispatcher probes with this process's plan
    yield monkeypatch
    chaos.reset_for_tests()


# -- the shard scheme --------------------------------------------------------


@pytest.mark.parametrize("mode", ["static", "auto", "rotate"])
@pytest.mark.parametrize("n_hosts", [1, 2, 3, 4])
@pytest.mark.parametrize("epoch", [0, 1, 5])
def test_shard_assignment_equals_jax(mode, n_hosts, epoch):
    for n_files in (1, 7, 16):
        for seed in (0, 3):
            got = [pipe.host_shard_assignment(n_files, h, n_hosts, seed=seed,
                                              epoch=epoch, mode=mode)
                   for h in range(n_hosts)]
            want = [jax_pipe.host_shard_assignment(
                n_files, h, n_hosts, seed=seed, epoch=epoch, mode=mode)
                for h in range(n_hosts)]
            assert got == want
            assert sorted(i for g in got for i in g) == list(range(n_files))
            assert pipe.shard_rotation(seed, epoch, n_hosts) == \
                jax_pipe.shard_rotation(seed, epoch, n_hosts)
            assert pipe.shard_assignment_digest(
                n_files, n_hosts, seed=seed, epoch=epoch, mode=mode) == \
                jax_pipe.shard_assignment_digest(
                    n_files, n_hosts, seed=seed, epoch=epoch, mode=mode)


@pytest.mark.parametrize("mode", ["static", "rotate"])
def test_host_file_shard_equals_jax(tmp_path, mode):
    schema = synthetic.make_schema(num_features=4)
    synthetic.write_files(synthetic.make_rows(90, schema, seed=1),
                          str(tmp_path / "a"), num_files=5)
    synthetic.write_files(synthetic.make_rows(60, schema, seed=2),
                          str(tmp_path / "b"), num_files=3)
    paths = (str(tmp_path / "a"), str(tmp_path / "b"))
    data = DataConfig(paths=paths, shuffle_seed=4, host_shard=mode)
    jdata = JaxDataConfig(paths=paths, shuffle_seed=4, host_shard=mode)
    assert pipe.count_source_files(data) == \
        jax_pipe.count_source_files(jdata) == 8
    for n_hosts in (1, 2, 3):
        for epoch in (0, 2):
            for h in range(n_hosts):
                assert pipe.host_file_shard(data, h, n_hosts, epoch=epoch) \
                    == jax_pipe.host_file_shard(jdata, h, n_hosts,
                                                epoch=epoch)


@pytest.mark.parametrize("n_hosts", [1, 2, 3, 4])
@pytest.mark.parametrize("epoch", [0, 1, 5])
def test_interleaved_epoch_order_equals_jax(n_hosts, epoch):
    rng = np.random.default_rng(n_hosts * 10 + epoch)
    hosts = [rng.integers(0, 1 << 40, size=int(rng.integers(20, 40)))
             for _ in range(n_hosts)]
    for lbs in (1, 4, 7):
        for shuffle in (True, False):
            got = pipe.interleaved_epoch_order(hosts, lbs, shuffle=shuffle,
                                               seed=2, epoch=epoch)
            want = jax_pipe.interleaved_epoch_order(
                hosts, lbs, shuffle=shuffle, seed=2, epoch=epoch)
            np.testing.assert_array_equal(got, want)
    assert pipe.interleaved_epoch_order([], 4).shape == (0,)


def test_four_host_ingest_reads_quarter_of_source_bytes(tmp_path,
                                                        monkeypatch):
    """Each of four simulated hosts reads at most 1.15 x a quarter of the
    source bytes, and the four together read the total once."""
    monkeypatch.delenv("SHIFU_TPU_DATA_CACHE", raising=False)
    from shifu_tpu_torch import obs
    from shifu_tpu_torch.data import cache as cache_mod

    schema = synthetic.make_schema(num_features=6)
    paths = synthetic.write_files(
        synthetic.make_rows(2048, schema, seed=4), str(tmp_path),
        num_files=8)
    total = cache_mod.source_bytes(paths)
    assert total > 0
    data = DataConfig(paths=(str(tmp_path),), valid_ratio=0.1)
    ctr = obs.default_registry().counter("ingest_source_bytes_total")
    per_host, rows = [], 0
    for h in range(4):
        before = ctr.total()
        tr, va = pipe.load_datasets(schema, data, h, 4)
        per_host.append(int(ctr.total() - before))
        rows += tr.num_rows + va.num_rows
    assert rows == 2048
    assert sum(per_host) == total
    for h, b in enumerate(per_host):
        assert b <= total / 4 * 1.15, (h, per_host)


# -- the journal audits ------------------------------------------------------


def _close(epoch, rank, hosts, od="od0", sd="sd0", b=100, s=1.0):
    return {"kind": "pod_epoch_close", "epoch": epoch, "rank": rank,
            "hosts": hosts, "order_digest": od, "shard_digest": sd,
            "ingest_bytes": b, "ingest_s": s}


_OK = [_close(e, r, 2, od=f"od{e}", sd=f"sd{e}", b=100 + r)
       for e in range(2) for r in range(2)]
_INJ = {"kind": "chaos_inject", "site": "data.host_shard", "rank": 1,
        "action": "exit", "epoch": 5}
_SKEW = {"kind": "host_skew", "epoch": 0, "hosts": [
    {"rank": 0, "host": "h0", "ingest_bytes": 500, "ingest_s": 2.0,
     "order_digest": "a", "shard_digest": "s", "input_s": 1.0},
    {"rank": 1, "host": "h1", "ingest_bytes": 510, "ingest_s": 2.1,
     "order_digest": "a", "shard_digest": "s", "input_s": 2.0}]}
_EVENT_LISTS = {
    "green": _OK,
    "hole": [r for r in _OK if not (r["epoch"] == 1 and r["rank"] == 1)],
    "desync": [dict(r, order_digest="DESYNC") if i == 3 else r
               for i, r in enumerate(_OK)],
    "lopsided": [_close(0, 0, 2, b=1000), _close(0, 1, 2, b=100)],
    "unrecovered": _OK + [_INJ],
    "recovered": _OK + [dict(_INJ, epoch=1)],
    "reshape": ([_close(0, r, 2) for r in range(2)] + [_close(1, 1, 2)]
                + [_close(1, 0, 1, od="od1b", sd="sd1b")]),
    "training": [_SKEW, dict(_SKEW, epoch=1)],
    "empty": [],
}


@pytest.mark.parametrize("case", sorted(_EVENT_LISTS))
def test_pod_verify_events_equal_jax(case):
    events = _EVENT_LISTS[case]
    assert pod._pod_close_rows(events) == jax_pod._pod_close_rows(events)
    for limit in (1.5, 3.0):
        got = pod.pod_verify_events(events, balance_limit=limit)
        assert got == jax_pod.pod_verify_events(events, balance_limit=limit)
    want = {"green": "PASS", "hole": "FAIL", "desync": "FAIL",
            "lopsided": "FAIL", "unrecovered": "FAIL", "recovered": "PASS",
            "reshape": "PASS", "training": "PASS", "empty": "FAIL"}[case]
    assert pod.pod_verify_events(events)["verdict"] == want


def test_ingest_rollup_agreement_and_skew_line_equal_jax():
    events = [
        {"kind": "ingest_report", "src": 0, "files": 4, "parse_s": 1.0,
         "inflate_s": 0.5, "source_bytes": 400},
        {"kind": "ingest_report", "src": 1, "host": "worker-1", "files": 4,
         "parse_s": 1.2, "inflate_s": 0.4, "source_bytes": 420},
        _SKEW, {"kind": "epoch", "epoch": 0}]
    assert aggregate.pod_ingest_rollup(events) == \
        jax_aggregate.pod_ingest_rollup(events)
    assert aggregate.pod_ingest_rollup([]) == \
        jax_aggregate.pod_ingest_rollup([])
    for rows, key in (([{"order_digest": "a"}, {"order_digest": "a"}],
                       "order_digest"),
                      ([{"order_digest": "a"}, {"order_digest": "b"}],
                       "order_digest"),
                      ([{"order_digest": "a"}, {}], "order_digest"),
                      ([{}, {}], "shard_digest")):
        assert aggregate.digest_agreement(rows, key) == \
            jax_aggregate.digest_agreement(rows, key)
    rows = [{"host": "h0", "rank": 0, "input_s": 1.0, "epoch_s": 3.0,
             "valid_s": 0.1, "ingest_bytes": 2_500_000, "ingest_s": 1.5},
            {"host": "h1", "rank": 1, "input_s": 2.0, "epoch_s": 3.0,
             "valid_s": 0.1}]
    assert aggregate.skew_line(2, rows) == jax_aggregate.skew_line(2, rows)
    # alone, the gather is the row itself and the skew journals nothing
    assert aggregate.gather_host_summaries({"rank": 0}) == [{"rank": 0}]
    assert aggregate.epoch_skew(0, 1.0, 2.0, 0.1) is None


def test_parse_hosts_with_the_coordinator_port_equals_jax(tmp_path,
                                                          monkeypatch):
    hostfile = tmp_path / "hosts"
    hostfile.write_text("# pod hosts\nh0\nh1\n\n")
    monkeypatch.delenv("SHIFU_TPU_COORDINATOR_PORT", raising=False)

    def both(*args):
        got, want = pod.parse_hosts(*args), jax_pod.parse_hosts(*args)
        assert (got.hosts, got.transport, got.coordinator_port) == (
            want.hosts, want.transport, want.coordinator_port)
        return got

    assert both("local:4").transport == "local"
    assert both("tpu-vm-0,tpu-vm-0,tpu-vm-1").hosts == (
        "tpu-vm-0", "tpu-vm-0", "tpu-vm-1")
    assert both(f"@{hostfile}").hosts == ("h0", "h1")
    assert both("h0,h1").coordinator_port == pod.DEFAULT_COORDINATOR_PORT
    assert both("h0,h1", 9000).coordinator_port == 9000
    monkeypatch.setenv("SHIFU_TPU_COORDINATOR_PORT", "9100")
    assert both("h0,h1").coordinator_port == 9100
    assert both("h0,h1", 9000).coordinator_port == 9000
    for bad_env, args in (("bogus", ("h0,h1",)), ("9100", ("h0,h1", 70000)),
                          ("9100", ("local:0",)), ("9100", (",",))):
        monkeypatch.setenv("SHIFU_TPU_COORDINATOR_PORT", bad_env)
        with pytest.raises(ValueError) as want:
            jax_pod.parse_hosts(*args)
        with pytest.raises(ValueError) as got:
            pod.parse_hosts(*args)
        assert str(got.value) == str(want.value)
    monkeypatch.setenv("SHIFU_TPU_COORDINATOR_PORT", "bogus")
    assert both("local:2").transport == "local"
    monkeypatch.delenv("SHIFU_TPU_COORDINATOR_PORT")
    monkeypatch.setenv("TPU_WORKER_HOSTNAMES", "a,b")
    monkeypatch.delenv("SHIFU_TPU_HOSTS", raising=False)
    assert pod.detect_hosts_env() is None is jax_pod.detect_hosts_env()
    monkeypatch.setenv("SHIFU_TPU_HOSTS", "x,y")
    assert pod.detect_hosts_env() == jax_pod.detect_hosts_env() == "x,y"
    # an ssh host's command carries the contract inline, in host order
    spec = pod.parse_hosts("h0,h1")
    contract = {"SHIFU_TPU_COORDINATOR": "h0:8476",
                "SHIFU_TPU_NUM_PROCESSES": "2", "SHIFU_TPU_PROCESS_ID": "1"}
    argv, env = pod._host_command(spec, 1, ["train"], contract)
    jargv, _ = jax_pod._host_command(jax_pod.parse_hosts("h0,h1"), 1,
                                     ["train"], contract)
    assert env is None and argv[:5] == jargv[:5] == [
        "ssh", "-tt", "-o", "BatchMode=yes", "h1"]
    assert argv[-1] == jargv[-1].replace("shifu_tpu.launcher.cli",
                                         "shifu_tpu_torch.launcher.cli")


# -- the data-dryrun gangs ---------------------------------------------------


def _drill_data(tmp_path, files=4, rows=64):
    data_dir = tmp_path / "data"
    data_dir.mkdir()
    schema = synthetic.make_schema(num_features=6)
    synthetic.write_files(synthetic.make_rows(rows, schema, seed=3),
                          str(data_dir), num_files=files)
    return str(data_dir)


def _close_rows(out_dir, load_merged):
    merged = load_merged(out_dir, tail_bytes=None)
    assert merged is not None
    return merged, {(e["epoch"], e["rank"]): e for e in merged["events"]
                    if e.get("kind") == "pod_epoch_close"}


def test_elastic_drill_kill_rebalance_rejoin(tmp_path, pod_env, capsys):
    """A local:2 data-dryrun gang whose rank 1 a chaos plan kills at
    `data.host_shard` in epoch 1: the gang restarts, the dead rank's
    epoch re-runs, and both packages' audits pass the port's journals
    alike: coverage, both digests, ingest balance, recovery."""
    from shifu_tpu_torch.launcher import cli
    from shifu_tpu_torch.obs import timeline

    data_dir = _drill_data(tmp_path)
    out = str(tmp_path / "out")
    plan = {"seed": 7, "faults": [{
        "site": "data.host_shard", "rank": 1, "at_epoch": 1,
        "action": "exit", "exit_code": 23, "scope": "job",
        "max_times": 1}]}
    pod_env.setenv("SHIFU_TPU_CHAOS_PLAN", json.dumps(plan))
    pod_env.setenv("SHIFU_TPU_CHAOS_STATE", str(tmp_path / "chaos.json"))
    lines = []
    rc = pod.supervise_pod(
        pod.parse_hosts("local:2"),
        child_args=["data-dryrun", "--data", data_dir, "--out", out,
                    "--features", "6", "--epochs", "2", "--seed", "5"],
        out_dir=out, max_restarts=2, echo=lines.append,
        timeout_seconds=GANG_TIMEOUT_S)
    assert rc == 0, lines
    assert any("exited rc=23" in ln for ln in lines), lines
    assert "pod: succeeded after 2 attempts" in lines
    merged, rows = _close_rows(out, timeline.load_merged)
    rep = pod.pod_verify_events(merged["events"])
    assert rep["verdict"] == "PASS", rep
    assert rep["counts"]["injections"] == 1
    assert rep["counts"]["ranks"] == 2
    assert jax_pod.pod_verify_events(merged["events"]) == rep
    assert {k for k in rows} == {(0, 0), (0, 1), (1, 0), (1, 1)}
    capsys.readouterr()
    assert cli.main(["pod-verify", out]) == 0
    text = capsys.readouterr().out
    assert text.startswith("pod-verify: PASS") and "[ok ] recovery" in text
    assert cli.main(["pod-verify", out, "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["verdict"] == "PASS"
    assert cli.main(["pod-verify", str(tmp_path / "nothing")]) == 1


def test_data_dryrun_digests_equal_jax(tmp_path, pod_env):
    """The two packages' data-dryrun gangs on the same files journal the
    same digests, rows and ingest bytes for every (epoch, rank)."""
    from shifu_tpu.obs import timeline as jax_timeline
    from shifu_tpu_torch.obs import timeline

    data_dir = _drill_data(tmp_path, files=6, rows=96)
    args = ["data-dryrun", "--data", data_dir, "--features", "6",
            "--epochs", "3", "--seed", "2", "--host-shard", "rotate"]
    port_out, jax_out = str(tmp_path / "port"), str(tmp_path / "jax")
    assert pod.supervise_pod(pod.parse_hosts("local:3"),
                             args + ["--out", port_out], port_out,
                             max_restarts=0, echo=lambda s: None,
                             timeout_seconds=GANG_TIMEOUT_S) == 0
    assert jax_pod.supervise_pod(jax_pod.parse_hosts("local:3"),
                                 args + ["--out", jax_out], jax_out,
                                 max_restarts=0, echo=lambda s: None,
                                 timeout_seconds=GANG_TIMEOUT_S) == 0
    _, got = _close_rows(port_out, timeline.load_merged)
    _, want = _close_rows(jax_out, jax_timeline.load_merged)
    assert sorted(got) == sorted(want) == [(e, r) for e in range(3)
                                           for r in range(3)]
    keys = ("hosts", "files", "rows", "order_digest", "shard_digest",
            "ingest_bytes")
    for k in got:
        assert {f: got[k][f] for f in keys} == {f: want[k][f] for f in keys}
    assert all(got[k]["ingest_bytes"] > 0 for k in got)
