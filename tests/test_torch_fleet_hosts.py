"""The port's fleet across hosts (HostPlane, launcher/pod.py's grammar, the
artifact sync, `fleet_verify_events` and the `fleet-verify` command)
against the JAX package's, on the CPU, and the port's drills on `local:N`
simulated hosts with the stub engine of test_torch_fleet.py: a whole-host
kill, a blackholed lease that rejoins as a standby, a corrupt sync, and a
swap applied exactly once per host and per member.
"""

import hashlib
import json
import os
import shutil
import signal
import socket
import threading

import numpy as np
import pytest

from shifu_tpu import chaos as jax_chaos
from shifu_tpu.chaos import plan as jax_plan
from shifu_tpu.launcher import pod as jax_pod
from shifu_tpu.runtime import fleet as jax_fleet
from shifu_tpu_torch import chaos, obs
from shifu_tpu_torch.chaos import plan as plan_mod
from shifu_tpu_torch.config.schema import FleetConfig, ServingConfig
from shifu_tpu_torch.launcher import pod
from shifu_tpu_torch.launcher.supervisor import ENV_PDEATHSIG
from shifu_tpu_torch.obs import timeline
from shifu_tpu_torch.runtime import fleet, loadtest
from shifu_tpu_torch.runtime.router import FleetRouter, RouterServer

from test_torch_fleet import (_reset_all, age_lease, file_tag_loader,
                              fleet_events, make_manager, make_tag_artifact,
                              verify_both, wait_for)


@pytest.fixture(autouse=True)
def _clean():
    _reset_all()
    yield
    _reset_all()


def journal(tmp_path) -> list:
    obs.flush()
    return obs.read_journal(str(tmp_path / "tele" / "journal.jsonl"))


# -- the host plane and the pod grammar -------------------------------------


def test_hostplane_places_like_jax(tmp_path):
    ours = fleet.HostPlane("local:3", str(tmp_path / "a"))
    theirs = jax_fleet.HostPlane("local:3", str(tmp_path / "b"))
    assert ours.host_ids == theirs.host_ids == ("local-0", "local-1",
                                                "local-2")
    seq = []
    for hp in (ours, theirs):
        got = [hp.place() for _ in range(5)]
        hp.release("local-0")
        hp.release("local-0")
        hp.release("nope")
        got += [hp.place() for _ in range(3)]
        seq.append(got)
    assert seq[0] == seq[1]
    assert seq[0][:5] == ["local-0", "local-1", "local-2", "local-0",
                          "local-1"]
    assert os.path.relpath(ours.cache_dir("local-1"), tmp_path / "a") == \
        os.path.relpath(theirs.cache_dir("local-1"), tmp_path / "b")
    ssh = fleet.HostPlane("tpu-a, tpu-b", str(tmp_path / "c"))
    assert ssh.host_ids == jax_fleet.HostPlane(
        "tpu-a, tpu-b", str(tmp_path / "d")).host_ids == ("tpu-a", "tpu-b")


@pytest.mark.parametrize("hosts", ["local:2", "tpu-a,tpu-b"])
def test_serve_command_is_jax_with_the_module_swapped(tmp_path, hosts):
    """The argv the host plane spawns a member with: JAX's, the port's CLI
    module in place of JAX's and `--device` added."""
    scfg, fcfg = ServingConfig(engine="torch"), FleetConfig()
    args = fleet.serve_args("/art", scfg, fcfg, 8601, "cuda:0")
    jax_args = args[:-2]
    assert args[-2:] == ["--device", "cuda:0"]
    assert jax_args == ["serve", "/art", "--engine", "torch", "--port",
                        "8601", "--host", "127.0.0.1", "--heartbeat-s",
                        "0.5", "--heartbeat-misses", "3"]
    contract = {"SHIFU_TPU_METRICS_DIR": "/tele/member-1"}
    got = fleet.HostPlane(hosts, str(tmp_path / "a")).serve_command(
        "local-1" if hosts.startswith("local") else "tpu-b", args, contract)
    want = jax_fleet.HostPlane(hosts, str(tmp_path / "b")).serve_command(
        "local-1" if hosts.startswith("local") else "tpu-b", jax_args,
        contract)
    swap = ("shifu_tpu.launcher.cli", "shifu_tpu_torch.launcher.cli")
    if hosts.startswith("local"):
        assert got[0] == [w.replace(*swap) for w in want[0]] + [
            "--device", "cuda:0"]
        assert got[1] == want[1]
        assert got[1][fleet.ENV_FLEET_HOST] == "local-1"
        assert got[1][ENV_PDEATHSIG] == f"{os.getpid()}:{int(signal.SIGKILL)}"
    else:
        assert got[0][:5] == want[0][:5] == ["ssh", "-tt", "-o",
                                             "BatchMode=yes", "tpu-b"]
        assert got[0][5] == want[0][5].replace(*swap) + " --device cuda:0"
        assert got[1] is want[1] is None


def test_parse_hosts_and_member_command_like_jax(tmp_path, monkeypatch):
    hostfile = tmp_path / "hosts.txt"
    hostfile.write_text("# pod\nh1\n\n h2 \n")
    for value in ("local:1", "local:4", "a,b, c", f"@{hostfile}"):
        got, want = pod.parse_hosts(value), jax_pod.parse_hosts(value)
        assert (got.hosts, got.transport, got.remote_python) == (
            want.hosts, want.transport, want.remote_python)
    for value in ("local:0", " , ", "local:x"):
        with pytest.raises(ValueError) as want:
            jax_pod.parse_hosts(value)
        with pytest.raises(ValueError) as got:
            pod.parse_hosts(value)
        assert str(got.value) == str(want.value)
    # the rendezvous port is JAX's: a bad environment value fails an ssh
    # host list with JAX's message and never a local:N one
    monkeypatch.setenv("SHIFU_TPU_COORDINATOR_PORT", "abc")
    with pytest.raises(ValueError) as want:
        jax_pod.parse_hosts("a,b")
    with pytest.raises(ValueError) as got:
        pod.parse_hosts("a,b")
    assert str(got.value) == str(want.value)
    assert pod.parse_hosts("local:2") == pod.PodSpec(("local",) * 2, "local")
    monkeypatch.delenv("SHIFU_TPU_COORDINATOR_PORT")
    assert pod.parse_hosts("a,b", 9000).coordinator_port == \
        jax_pod.parse_hosts("a,b", 9000).coordinator_port == 9000
    spec, jspec = pod.parse_hosts("a,b"), jax_pod.parse_hosts("a,b")
    for rank in (-1, 2):
        with pytest.raises(ValueError) as want:
            jax_pod.member_command(jspec, rank, ["serve"], {})
        with pytest.raises(ValueError) as got:
            pod.member_command(spec, rank, ["serve"], {})
        assert str(got.value) == str(want.value)


# -- the artifact sync --------------------------------------------------------


def _tree(path) -> dict:
    out = {}
    for dirpath, _dirs, files in os.walk(path):
        for f in files:
            full = os.path.join(dirpath, f)
            with open(full, "rb") as fh:
                out[os.path.relpath(full, path)] = hashlib.blake2b(
                    fh.read(), digest_size=16).hexdigest()
    return out


@pytest.mark.parametrize("writer", ["port", "jax", "none"])
def test_sync_artifact_equals_jax(tmp_path, writer):
    src = tmp_path / "src"
    (src / "sub").mkdir(parents=True)
    (src / "tag.txt").write_text("1.0")
    (src / "sub" / "weights.bin").write_bytes(bytes(range(256)) * 9)
    if writer == "port":
        fleet.write_sync_manifest(str(src))
    elif writer == "jax":
        jax_fleet.write_sync_manifest(str(src))
    ours = fleet.sync_artifact(str(src), str(tmp_path / "a"), 7,
                               host="local-0")
    theirs = jax_fleet.sync_artifact(str(src), str(tmp_path / "b"), 7,
                                     host="local-0")
    assert os.path.basename(ours) == os.path.basename(theirs) == \
        "gen-000007"
    assert _tree(ours) == _tree(theirs)
    assert fleet.read_sync_manifest(str(src)) == \
        jax_fleet.read_sync_manifest(str(src))
    assert sorted(fleet.read_sync_manifest(str(src))["files"]) == [
        "sub/weights.bin", "tag.txt"]
    # idempotent: the published generation returns untouched
    assert fleet.sync_artifact(str(src), str(tmp_path / "a"), 7) == ours


@pytest.mark.parametrize("action", ["corrupt", "raise"])
def test_a_bad_pull_raises_sync_error_and_cleans_staging(tmp_path, action):
    src = make_tag_artifact(tmp_path, "v0", 0.0)
    for pkg, ch, pm, name in ((fleet, chaos, plan_mod, "a"),
                              (jax_fleet, jax_chaos, jax_plan, "b")):
        cache = str(tmp_path / name)
        ch.configure(pm.parse_plan({"faults": [
            {"site": pkg.SYNC_SITE, "every": 1, "max_times": 1,
             "action": action}]}))
        with pytest.raises(pkg.SyncError):
            pkg.sync_artifact(src, cache, 1)
        assert os.listdir(cache) == []
        # the fault is spent: the retried pull verifies and publishes
        assert os.path.isdir(pkg.sync_artifact(src, cache, 1))
    assert _tree(tmp_path / "a") == _tree(tmp_path / "b")


def test_a_manifest_less_dir_that_cannot_take_one_is_a_sync_error(tmp_path):
    with pytest.raises(fleet.SyncError, match="cannot write manifest"):
        fleet.sync_artifact(str(tmp_path / "missing"), str(tmp_path / "c"),
                            1)


# -- fleet_verify_events and the fleet-verify command ------------------------


def _ev(kind, **kw):
    kw["kind"] = kind
    return kw


VERIFY_SHAPES = [
    [_ev("fleet_start"),
     _ev("fleet_member_swap", member="member-0", generation=1, via="fanout"),
     _ev("fleet_member_swap", member="member-1", generation=1, via="fanout"),
     _ev("fleet_swap", generation=1, swapped=["member-0", "member-1"],
         failed=[]),
     _ev("fleet_failover", member="member-1", standby="member-2"),
     _ev("fleet_member_swap", member="member-2", generation=1,
         via="promote"),
     _ev("fleet_rejoin", member="member-1", generation=1, caught_up=True)],
    [_ev("fleet_member_swap", member="m0", generation=1, via="fanout"),
     _ev("fleet_member_swap", member="m0", generation=1, via="retry"),
     _ev("fleet_swap", generation=1, swapped=["m0"], failed=[])],
    [_ev("fleet_swap", generation=1, swapped=["m0"], failed=["m1"]),
     _ev("fleet_member_swap", member="m0", generation=1, via="fanout")],
    [_ev("fleet_swap", generation=1, swapped=["m0"], failed=["m1"]),
     _ev("fleet_member_swap", member="m0", generation=1, via="fanout"),
     _ev("fleet_failover", member="m1", standby="m2")],
    [_ev("fleet_member_swap", member="m0", generation=2, via="fanout"),
     _ev("fleet_member_swap", member="m0", generation=1, via="retry")],
    [_ev("fleet_rejoin", member="m9")],
    [_ev("fleet_swap", generation=2, swapped=[], failed=[]),
     _ev("fleet_swap", generation=1, swapped=[], failed=[])],
    [_ev("fleet_failover", member="m0", standby=None)],
    [_ev("fleet_member_swap", member="m0", generation=1,
         baseline_digest="aa"),
     _ev("fleet_member_swap", member="m1", generation=1,
         baseline_digest="bb"),
     _ev("fleet_swap_degraded", member="m2"), _ev("fleet_sync")],
    [_ev("fleet_swap", generation="1", swapped=None, failed=None)],
    [],
]


@pytest.mark.parametrize("i", range(len(VERIFY_SHAPES)))
def test_fleet_verify_events_equals_jax(i):
    events = VERIFY_SHAPES[i]
    got = fleet.fleet_verify_events(events)
    assert got == jax_fleet.fleet_verify_events(events)
    assert got["verdict"] == ("PASS" if i in (0, 3, 10) else "FAIL")


@pytest.mark.parametrize("i", [0, 1, 5])
def test_fleet_verify_command_equals_jax(tmp_path, capsys, i):
    tele = tmp_path / "tele"
    tele.mkdir()
    with open(tele / "journal.jsonl", "w") as f:
        for e in VERIFY_SHAPES[i]:
            f.write(json.dumps({"ts": 1.0 + len(e), **e}) + "\n")
    rc, text, report = verify_both(capsys, tele)
    assert rc == (0 if i == 0 else 1)
    assert text.startswith(f"fleet-verify: {report['verdict']} — ")
    assert report["journals"] == [str(tele / "journal.jsonl")]


def test_fleet_verify_without_a_journal_fails_like_jax(tmp_path, capsys):
    rc, text, report = verify_both(capsys, tmp_path / "nope")
    assert (rc, text, report) == (1, "", None)


# -- the drills on local:2 ------------------------------------------------------


def _drive(mgr, front, seconds, action, at_s):
    """A socket loadtest through the router, `action` run at `at_s`."""
    timer = threading.Timer(at_s, action)
    timer.start()
    rep = loadtest.run_loadtest(connect=f"{front.host}:{front.port}",
                                rate=400.0, duration=seconds, senders=2,
                                seed=7)
    timer.join()
    return rep


def test_host_kill_promotes_on_the_surviving_host(tmp_path, capsys):
    """A whole host killed under load: the standby on the other host
    promotes, 0 errors, one incident on the merged timeline, and a
    request that spanned the kill shows both hops under one trace."""
    obs.configure(str(tmp_path / "tele"))
    mgr = make_manager(fleet, tmp_path / "fleet", n_daemons=2,
                       hosts="local:2")
    mgr.serving = mgr.serving.replace(trace_sample=1)
    mgr.router.trace_sample = 1
    del mgr._monitor_loop          # this drill runs the monitor
    mgr.start()
    front = RouterServer(mgr.router, manager=mgr).start()
    try:
        assert mgr.members["member-1"].host_id == "local-1"
        assert mgr.standbys[0].host_id == "local-0"
        killed = []
        rep = _drive(mgr, front, 1.5,
                     lambda: killed.extend(mgr.kill_host("local-1")), 0.5)
        assert killed == ["member-1"]
        assert rep["errors"] == 0 and rep["completed"] == rep["submitted"]
        assert wait_for(lambda: mgr.summary()["failovers"] == 1, 3.0)
        assert mgr.members["member-2"].host_id == "local-0"
        mgr.router.score_rows(np.ones((1, 4), np.float32))
        evs = journal(tmp_path)
        fo = [e for e in evs if e["kind"] == "fleet_failover"]
        assert [(e["member"], e["host"], e["standby_host"]) for e in fo] \
            == [("member-1", "local-1", "local-0")]
        incidents = [i for i in timeline.reconstruct_incidents(
            timeline.merged_fleet_events(str(tmp_path / "tele")))
            if i["kind"] == "fleet_failover"]
        assert len(incidents) == 1
        assert [s["step"] for s in incidents[0]["chain"]] == [
            "lease_expiry", "failover", "promotion", "recovery"]
        routes = [e for e in evs if e["kind"] == "route_trace"]
        assert len(routes) == rep["completed"] + 1
        assert any(len(r["hops"]) == 2 and r["hops"][0]["outcome"] != "ok"
                   and r["hops"][1]["outcome"] == "ok" for r in routes)
    finally:
        front.close()
        mgr.stop()
    rc, _text, report = verify_both(capsys, tmp_path / "tele")
    assert rc == 0 and report["counts"]["failovers"] == 1


def test_lease_blackhole_rejoins_as_a_standby(tmp_path, capsys):
    """member-1's lease writes fail (its daemon lives): the lease ages it
    out by hand, a standby promotes, a swap lands, then the writes heal
    and it rejoins as a STANDBY caught up to the new generation."""
    obs.configure(str(tmp_path / "tele"))
    mgr = make_manager(fleet, tmp_path / "fleet", n_daemons=2,
                       hosts="local:2", heartbeat_every_s=60.0)
    mgr.start()
    try:
        chaos.configure(plan_mod.parse_plan({"faults": [
            {"site": fleet.LEASE_SITE, "member": "member-1", "every": 1,
             "action": "raise"}]}))
        m1 = mgr.members["member-1"]
        assert m1.heartbeat.beat() is False      # blackholed
        age_lease(m1)
        assert mgr.check_members() == ["member-1"]
        assert mgr.summary()["down"] == ["member-1"]
        assert mgr.swap_fleet("stub://v1")["ok"] is True
        mgr.check_members()
        assert "member-1" in mgr.summary()["down"]  # still partitioned
        chaos.reset_for_tests()
        assert m1.heartbeat.beat() is True        # healed
        mgr.check_members()
        summary = mgr.summary()
        assert "member-1" in summary["standbys"]
        assert "member-1" not in summary["active"] + summary["down"]
        assert m1.generation == 1
        for i in range(6):
            got = mgr.router.score_rows(np.ones((1, 4), np.float32),
                                        model_id=f"m{i}")
            assert abs(float(got[0, 0]) - 2.0) < 0.05
        evs = fleet_events(tmp_path / "tele" / "journal.jsonl")
        rj = [e for e in evs if e["kind"] == "fleet_rejoin"]
        assert [(e["member"], e["caught_up"], e["generation"])
                for e in rj] == [("member-1", True, 1)]
        assert [e["via"] for e in evs if e["kind"] == "fleet_member_swap"
                and e["member"] == "member-1"] == ["rejoin"]
    finally:
        mgr.stop()
    assert verify_both(capsys, tmp_path / "tele")[0] == 0


def test_corrupt_sync_quarantines_then_the_retried_pull_lands(tmp_path):
    obs.configure(str(tmp_path / "tele"))
    v0 = make_tag_artifact(tmp_path, "v0", 0.0)
    v1 = make_tag_artifact(tmp_path, "v1", 1.0)
    # sync calls: gen 0 on local-0 (1) and local-1 (2); the swap's first
    # pull (3) is member-0's host
    chaos.configure(plan_mod.parse_plan({"faults": [
        {"site": fleet.SYNC_SITE, "at_call": 3, "max_times": 1,
         "action": "corrupt"}]}))
    mgr = make_manager(fleet, tmp_path / "fleet", export=v0,
                       loader=file_tag_loader, n_daemons=2, hosts="local:2")
    mgr.start()
    try:
        out = mgr.swap_fleet(v1)
        assert [f["member"] for f in out["failed"]] == ["member-0"]
        assert "sync" in out["failed"][0]["error"]
        assert mgr.summary()["stale"] == ["member-0"]
        for i in range(6):
            got = mgr.router.score_rows(np.ones((1, 4), np.float32),
                                        model_id=f"m{i}")
            assert abs(float(got[0, 0]) - 2.0) < 0.05
        assert mgr._retry_stale() == ["member-0"]
        assert mgr.summary()["stale"] == []
        evs = fleet_events(tmp_path / "tele" / "journal.jsonl")
        assert [e["member"] for e in evs
                if e["kind"] == "fleet_swap_degraded"] == ["member-0"]
        assert fleet.fleet_verify_events(evs)["verdict"] == "PASS"
    finally:
        mgr.stop()


def test_a_swap_is_pulled_once_per_host_and_applied_once_per_member(
        tmp_path):
    obs.configure(str(tmp_path / "tele"))
    v0 = make_tag_artifact(tmp_path, "v0", 0.0)
    v1 = make_tag_artifact(tmp_path, "v1", 1.0)
    mgr = make_manager(fleet, tmp_path / "fleet", export=v0,
                       loader=file_tag_loader, n_daemons=3, standbys=1,
                       hosts="local:2")
    mgr.start()
    try:
        assert mgr.swap_fleet(v1)["ok"] is True
        evs = fleet_events(tmp_path / "tele" / "journal.jsonl")
        syncs = [e["host"] for e in evs
                 if e["kind"] == "fleet_sync" and e["generation"] == 1]
        assert sorted(syncs) == ["local-0", "local-1"]
        applies = [e["member"] for e in evs
                   if e["kind"] == "fleet_member_swap"]
        assert sorted(applies) == [f"member-{i}" for i in range(4)]
        # every member loads its own host's verified copy
        for m in list(mgr.members.values()) + mgr.standbys:
            assert mgr._sync_cache[(m.host_id, 1, v1)].startswith(
                os.path.join(str(tmp_path / "fleet"), "sync", m.host_id))
    finally:
        mgr.stop()


def test_a_zombie_listener_never_resets_the_ladder():
    """A listener that accepts and closes: every request fails, and the
    successful connects never reset the reconnect ladder."""
    srv = socket.create_server(("127.0.0.1", 0))
    host, port = srv.getsockname()[:2]
    stop = threading.Event()

    def _zombie():
        srv.settimeout(0.2)
        while not stop.is_set():
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.close()

    threading.Thread(target=_zombie, daemon=True).start()
    r = FleetRouter(FleetConfig(n_daemons=1, standbys=0, backoff_base_ms=5,
                                backoff_cap_ms=200, route_timeout_ms=300,
                                connect_timeout_ms=300))
    try:
        r.add("zombie", host, port)
        m = r._members["zombie"]
        sleeps = []
        for _ in range(4):
            with pytest.raises(ConnectionError):
                r.score_rows(np.ones((1, 4), np.float32))
            sleeps.append(m.backoff._sleep)
            m.backoff._until = 0.0
        assert all(s > 0 for s in sleeps), sleeps
        assert r.router_stats()["errors"] == 4
    finally:
        stop.set()
        r.close()
        srv.close()


def test_kill_host_drops_its_standbys_at_once(tmp_path):
    obs.configure(str(tmp_path / "tele"))
    mgr = make_manager(fleet, tmp_path / "fleet", n_daemons=2, standbys=2,
                       hosts="local:2", heartbeat_every_s=60.0)
    mgr.start()
    try:
        on_1 = sorted(m.member_id for m in list(mgr.members.values())
                      + mgr.standbys if m.host_id == "local-1")
        assert sorted(mgr.kill_host("local-1")) == on_1
        assert all(s.host_id == "local-0" for s in mgr.standbys)
        evs = fleet_events(tmp_path / "tele" / "journal.jsonl")
        assert [e["host"] for e in evs
                if e["kind"] == "fleet_standby_down"] == ["local-1"]
        # the dead active keeps its slot until its lease verdict
        victim = [m for m in mgr.members.values()
                  if m.host_id == "local-1"][0]
        age_lease(victim)
        assert mgr.check_members() == [victim.member_id]
        assert mgr.summary()["failovers"] == 1
    finally:
        mgr.stop()
        shutil.rmtree(tmp_path / "fleet", ignore_errors=True)
