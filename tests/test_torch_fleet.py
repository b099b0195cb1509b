"""The port's serving fleet (shifu_tpu_torch/runtime/fleet.py, router.py)
against the JAX package's, on the CPU: leases, the heartbeat, the scale
policy, the config and its XML keys, the router's ring, barrier, shedding
and backoff ladder, a scripted manager sequence driven identically in
both packages, and the in-process drills on a stub engine.

Determinism: no test waits through heartbeat windows to decide anything.
A lease is aged by rewriting it with a past `ts`; the manager's monitor
thread is left out (`make_manager`) or the heartbeat is long, and
`check_members()` / `_retry_stale()` / `scale_tick(burns=...)` are called
directly.  The stub engine (`_TagScorer`, a copy of the JAX tests' pure
numpy one) encodes the artifact version in its score.
"""

import json
import os
import random
import threading
import time

import numpy as np
import pytest

from shifu_tpu import chaos as jax_chaos
from shifu_tpu import obs as jax_obs
from shifu_tpu.chaos import plan as jax_plan
from shifu_tpu.config import schema as jax_schema
from shifu_tpu.launcher import cli as jax_cli
from shifu_tpu.runtime import fleet as jax_fleet
from shifu_tpu.runtime import router as jax_router
from shifu_tpu.utils import xmlconfig as jax_xml
from shifu_tpu_torch import chaos, obs
from shifu_tpu_torch.chaos import plan as plan_mod
from shifu_tpu_torch.config.schema import (ConfigError, FleetConfig,
                                           ServingConfig)
from shifu_tpu_torch.launcher import cli
from shifu_tpu_torch.runtime import fleet
from shifu_tpu_torch.runtime import loadtest, router, serve_wire
from shifu_tpu_torch.runtime.fleet import FleetManager
from shifu_tpu_torch.runtime.router import FleetRouter, RouterServer
from shifu_tpu_torch.utils import xmlconfig

# journal values that differ between two runs by nature (times, process
# ids, ports, paths) or by timing (how long a promotion took)
VOLATILE = {"ts", "pid", "port", "path", "dest", "promoted_in_s",
            "lease_age_s"}


def _reset_all():
    for m in (obs, jax_obs, chaos, jax_chaos):
        m.reset_for_tests()


@pytest.fixture(autouse=True)
def _clean():
    _reset_all()
    yield
    _reset_all()


class _TagScorer:
    """Stub engine whose score encodes the artifact version: scoring a
    `...vN` artifact returns `row[0] + N` (a copy of the JAX tests')."""

    engine = "stub"
    static_shapes = False
    num_features = 4

    def __init__(self, tag: float):
        self.tag = tag

    def compute_batch(self, rows, n_valid=None):
        x = np.asarray(rows, np.float32)
        return np.ascontiguousarray(x[:, :1] + self.tag)

    def close(self):
        pass


def tag_loader(path, _engine):
    tag = 0.0
    if "v" in path:
        try:
            tag = float(path.rsplit("v", 1)[-1])
        except ValueError:
            pass
    return _TagScorer(tag)


def file_tag_loader(path, _engine):
    """For real artifact dirs (the sync drills): the tag is `tag.txt` of
    the host's verified copy."""
    with open(os.path.join(path, "tag.txt")) as f:
        return _TagScorer(float(f.read().strip()))


def make_tag_artifact(root, name: str, tag: float) -> str:
    """A syncable artifact dir: a tag file, an opaque payload and the
    exporter's manifest."""
    d = os.path.join(str(root), name)
    os.makedirs(d)
    with open(os.path.join(d, "tag.txt"), "w") as f:
        f.write(str(tag))
    with open(os.path.join(d, "weights.bin"), "wb") as f:
        f.write(bytes(range(256)) * 8)
    fleet.write_sync_manifest(d)
    return d


def fleet_kw(**kw) -> dict:
    base = dict(n_daemons=3, standbys=1, heartbeat_every_s=0.1,
                heartbeat_misses=3)
    base.update(kw)
    return base


def make_manager(pkg, root, export="stub://v0", loader=tag_loader,
                 **kw) -> object:
    """A manager of `pkg` (the port's fleet module or the JAX one) on the
    stub engine, its monitor thread left out."""
    schema = jax_schema if pkg is jax_fleet else None
    fcfg = (schema.FleetConfig if schema else FleetConfig)(**fleet_kw(**kw))
    scfg = (schema.ServingConfig(engine="numpy", report_every_s=0.0)
            if schema else ServingConfig(engine="numpy", report_every_s=0.0))
    extra = {} if pkg is jax_fleet else {"device": "cpu"}
    mgr = pkg.FleetManager(export, fleet=fcfg, serving=scfg,
                           root_dir=str(root), loader=loader, **extra)
    mgr._monitor_loop = lambda: None
    return mgr


def age_lease(member, by_s: float = 1000.0, journal: bool = False) -> None:
    """Rewrite the member's lease (and with `journal`, its own journal)
    `by_s` seconds into the past: a member silent that long."""
    rec = fleet.read_lease(member.tele_dir)
    rec["ts"] = rec["ts"] - by_s
    with open(os.path.join(member.tele_dir, fleet.LEASE_FILE), "w") as f:
        json.dump(rec, f)
    if journal:
        path = os.path.join(member.tele_dir, "journal.jsonl")
        recs = obs.read_journal(path)
        with open(path, "w") as f:
            for r in recs:
                f.write(json.dumps({**r, "ts": r["ts"] - by_s}) + "\n")


def fleet_events(path) -> list:
    """The fleet's journal events (fleet_* and route_trace) of the journal
    at `path`, the volatile values blanked."""
    out = []
    for e in obs.read_journal(str(path)):
        kind = e.get("kind", "")
        if kind.startswith("fleet_") or kind == "route_trace":
            out.append({k: ("*" if k in VOLATILE else v)
                        for k, v in e.items()})
    return out


def verify_both(capsys, path) -> tuple:
    """`fleet-verify` of both packages on `path`, text and --json: (exit
    code, text, json) of the port's, after checking them equal to JAX's."""
    capsys.readouterr()
    out = []
    for main in (cli.main, jax_cli.main):
        rc_text = main(["fleet-verify", str(path)])
        text = capsys.readouterr()
        rc_json = main(["fleet-verify", str(path), "--json"])
        js = capsys.readouterr()
        out.append((rc_text, rc_json, text.out, text.err, js.out))
    assert out[0] == out[1]
    rc, rc_json, text, _err, js = out[0]
    assert rc == rc_json
    return rc, text, json.loads(js) if js else None


def wait_for(pred, timeout=5.0, tick=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(tick)
    return pred()


# -- leases ------------------------------------------------------------------


def test_leases_read_across_packages(tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    fleet.write_lease(a, "member-0", seq=7, ttl_s=0.3, host="local-1")
    jax_fleet.write_lease(b, "member-0", seq=7, ttl_s=0.3, host="local-1")
    got, want = jax_fleet.read_lease(a), fleet.read_lease(b)
    assert set(got) == set(want) == {"member", "ts", "seq", "ttl_s", "pid",
                                     "host"}
    for k in ("member", "seq", "ttl_s", "pid", "host"):
        assert got[k] == want[k], k
    assert fleet.read_lease(a) == got and jax_fleet.read_lease(b) == want
    now = got["ts"] + 1.25
    assert fleet.lease_age_s(got, now=now) == jax_fleet.lease_age_s(
        got, now=now) == pytest.approx(1.25)
    # the host from SHIFU_TPU_FLEET_HOST where none is given
    os.environ[fleet.ENV_FLEET_HOST] = "h9"
    try:
        fleet.write_lease(a, "m", seq=1, ttl_s=1.0)
        assert jax_fleet.read_lease(a)["host"] == "h9"
    finally:
        del os.environ[fleet.ENV_FLEET_HOST]


@pytest.mark.parametrize("content", [None, '{"member": "m", "ts": 1.',
                                     "[1, 2]", "garbage", ""])
def test_lease_reads_are_tolerant_like_jax(tmp_path, content):
    d = str(tmp_path)
    if content is not None:
        with open(os.path.join(d, fleet.LEASE_FILE), "w") as f:
            f.write(content)
    assert fleet.read_lease(d) is None and jax_fleet.read_lease(d) is None


@pytest.mark.parametrize("lease", [None, {}, {"member": "m"},
                                   {"ts": "1"}, {"ts": 5.0}, {"ts": 50}])
def test_lease_age_like_jax(lease):
    for now in (0.0, 10.0, 100.0):
        assert fleet.lease_age_s(lease, now=now) == jax_fleet.lease_age_s(
            lease, now=now)


def test_heartbeat_beat_and_chaos_skip(tmp_path):
    """Beats driven by hand (the thread's interval is long): a fault at
    `fleet.heartbeat` skips the beat and leaves the lease as it was."""
    d = str(tmp_path)
    hb = fleet.Heartbeat(d, "member-0", every_s=60.0, ttl_s=180.0).start()
    try:
        first = fleet.read_lease(d)
        assert first["seq"] == 1 and first["ttl_s"] == 180.0
        assert hb.beat() is True
        assert fleet.read_lease(d)["seq"] == 2
        chaos.configure(plan_mod.parse_plan({"faults": [
            {"site": fleet.HEARTBEAT_SITE, "every": 1, "action": "raise"}]}))
        before = fleet.read_lease(d)
        assert hb.beat() is False
        assert fleet.read_lease(d) == before
        chaos.reset_for_tests()
        assert hb.beat() is True
        assert fleet.read_lease(d)["seq"] == before["seq"] + 1
    finally:
        hb.stop()


def test_lease_site_targets_one_member(tmp_path):
    chaos.configure(plan_mod.parse_plan({"faults": [
        {"site": fleet.LEASE_SITE, "member": "member-1", "every": 1,
         "action": "raise"}]}))
    fleet.write_lease(str(tmp_path / "a"), "member-0", 1, 1.0)
    with pytest.raises(chaos.ChaosError):
        fleet.write_lease(str(tmp_path / "b"), "member-1", 1, 1.0)
    assert fleet.read_lease(str(tmp_path / "b")) is None


# -- the scale policy and the config -------------------------------------


def test_decide_scale_equals_jax_over_a_grid():
    levels = (0.0, 0.1, 0.25, 0.3, 1.0, 1.99, 2.0, 2.5, 5.0)
    rng = random.Random(5)
    for lo, hi in ((1, 4), (2, 8), (1, 1)):
        cfg = FleetConfig(scale_up_burn=2.0, scale_down_burn=0.25,
                          n_daemons=lo, min_daemons=lo, max_daemons=hi)
        jcfg = jax_schema.FleetConfig(**{
            k: getattr(cfg, k) for k in cfg.__dataclass_fields__})
        for n in range(0, hi + 2):
            for size in range(0, 4):
                for _ in range(12):
                    burns = [(rng.choice(levels), rng.choice(levels))
                             for _ in range(size)]
                    assert fleet.decide_scale(burns, n, cfg) == \
                        jax_fleet.decide_scale(burns, n, jcfg), (burns, n)


BAD_FLEET = [dict(n_daemons=0), dict(standbys=-1),
             dict(heartbeat_every_s=0.0), dict(heartbeat_misses=0),
             dict(route_timeout_ms=0.0), dict(connect_timeout_ms=-1.0),
             dict(shed_burn=0.0), dict(backoff_base_ms=0.0),
             dict(backoff_cap_ms=1.0, backoff_base_ms=50.0),
             dict(scale_every_s=-1.0), dict(scale_cooldown_s=-1.0),
             dict(scale_down_burn=-0.1), dict(scale_up_burn=0.2),
             dict(min_daemons=0), dict(min_daemons=5, max_daemons=4),
             dict(n_daemons=9), dict(vnodes=0), dict(member_mode="threads"),
             dict(member_port_base=0), dict(member_port_base=70000),
             dict(timeline_max_offset_s=0.0), dict(hosts="local:0"),
             dict(hosts="local:x"), dict(hosts=" , ")]


@pytest.mark.parametrize("kw", BAD_FLEET)
def test_fleet_config_refuses_like_jax(kw):
    with pytest.raises(jax_schema.ConfigError) as want:
        jax_schema.FleetConfig(**kw).validate()
    with pytest.raises(ConfigError) as got:
        FleetConfig(**kw).validate()
    assert str(got.value) == str(want.value)


def test_fleet_config_is_jax_field_for_field():
    import dataclasses
    ours = {f.name: f.default for f in dataclasses.fields(FleetConfig)}
    theirs = {f.name: f.default
              for f in dataclasses.fields(jax_schema.FleetConfig)}
    assert ours == theirs
    FleetConfig(hosts="local:2").validate()
    FleetConfig(hosts="@hosts.txt").validate()
    assert FleetConfig(heartbeat_every_s=0.5, heartbeat_misses=3
                       ).heartbeat_ttl_s == pytest.approx(1.5)


FLEET_XML = {
    "shifu.fleet.n-daemons": "3", "shifu.fleet.standbys": "2",
    "shifu.fleet.heartbeat-every-s": "0.25",
    "shifu.fleet.heartbeat-misses": "4",
    "shifu.fleet.route-timeout-ms": "500",
    "shifu.fleet.connect-timeout-ms": "100", "shifu.fleet.shed-burn": "1.5",
    "shifu.fleet.backoff-base-ms": "10", "shifu.fleet.backoff-cap-ms": "900",
    "shifu.fleet.scale-every-s": "2", "shifu.fleet.scale-up-burn": "3",
    "shifu.fleet.scale-down-burn": "0.5",
    "shifu.fleet.scale-cooldown-s": "5", "shifu.fleet.min-daemons": "2",
    "shifu.fleet.max-daemons": "6", "shifu.fleet.vnodes": "16",
    "shifu.fleet.hosts": " local:3 ", "shifu.fleet.member-mode": "process",
    "shifu.fleet.member-port-base": "9100",
    "shifu.fleet.sync-artifacts": "false",
    "shifu.fleet.rejoin-standby": "no",
    "shifu.fleet.timeline-skew-correct": "0",
    "shifu.fleet.timeline-max-offset-s": "30",
}


def test_fleet_config_from_conf_equals_jax(tmp_path):
    path = str(tmp_path / "fleet.xml")
    xmlconfig.write_configuration_xml(FLEET_XML, path)
    conf = xmlconfig.parse_configuration_xml(path)
    got = xmlconfig.fleet_config_from_conf(conf)
    want = jax_xml.fleet_config_from_conf(
        jax_xml.parse_configuration_xml(path))
    assert got == FleetConfig(**want.__dict__)
    got.validate()
    # over a base, as the `fleet` command layers it
    base = FleetConfig(n_daemons=5, max_daemons=8)
    assert xmlconfig.fleet_config_from_conf(
        {"shifu.fleet.standbys": "0"}, base).n_daemons == 5
    assert xmlconfig.fleet_config_from_conf({}) == FleetConfig()


def test_fleet_keys_apply_like_jax():
    """A `shifu.fleet.*` key leaves a job and a serving config alone in
    both packages (it is the fleet's), where the port used to raise."""
    from shifu_tpu.config import JobConfig as JaxJob
    from shifu_tpu.config.schema import ServingConfig as JaxServing
    from shifu_tpu_torch.config import JobConfig
    from shifu_tpu_torch.data import synthetic
    from shifu_tpu.data import synthetic as jax_synthetic

    conf = {xmlconfig.KEY_EPOCHS: "3", **FLEET_XML}
    pjob = JobConfig(schema=synthetic.make_schema(num_features=4))
    jjob = JaxJob(schema=jax_synthetic.make_schema(num_features=4))
    got, want = xmlconfig.apply_to_job(pjob, conf), jax_xml.apply_to_job(
        jjob, conf)
    assert got.train.epochs == want.train.epochs == 3
    assert got == xmlconfig.apply_to_job(pjob, {xmlconfig.KEY_EPOCHS: "3"})
    sc = xmlconfig.serving_config_from_conf(conf)
    assert sc == ServingConfig()
    assert jax_xml.serving_config_from_conf(conf) == JaxServing()


# -- the router ----------------------------------------------------------


def _routers(cfg_kw=None, members=("member-0", "member-1", "member-2")):
    cfg_kw = cfg_kw or {}
    ours = FleetRouter(FleetConfig(**cfg_kw))
    theirs = jax_router.FleetRouter(jax_schema.FleetConfig(**cfg_kw))
    for i, mid in enumerate(members):
        ours.add(mid, "127.0.0.1", 9000 + i, host_id=f"local-{i % 2}")
        theirs.add(mid, "127.0.0.1", 9000 + i, host_id=f"local-{i % 2}")
    return ours, theirs


def _orders(r, keys):
    return [[m.member_id for m in r.candidates(k)] for k in keys]


KEYS = [f"k{i}" for i in range(1200)] + ["default", "model-x", ""]


@pytest.mark.parametrize("vnodes", [1, 8, 32])
def test_ring_order_equals_jax(vnodes):
    ours, theirs = _routers({"vnodes": vnodes},
                            members=[f"member-{i}" for i in range(5)])
    try:
        assert _orders(ours, KEYS) == _orders(theirs, KEYS)
        # membership changes: remove, add, a barrier, burns
        for r in (ours, theirs):
            r.remove("member-2")
            r.add("member-7", "127.0.0.1", 9107, generation=1)
        assert _orders(ours, KEYS) == _orders(theirs, KEYS)
        for r in (ours, theirs):
            r.set_barrier(1)
            r.set_generation("member-0", 1)
        assert _orders(ours, KEYS) == _orders(theirs, KEYS)
        for r in (ours, theirs):
            r.set_barrier(0)
            r.set_burn("member-1", 2.0)
            r.set_burn("member-3", 1.2)
            r.set_burn("member-4", 0.1)
        assert _orders(ours, KEYS[:300]) == _orders(theirs, KEYS[:300])
        got, want = ours.router_stats(), theirs.router_stats()
        assert got == want and got["sheds"] > 0
    finally:
        ours.close()
        theirs.close()


def test_barrier_refuses_stale_members():
    r = FleetRouter(FleetConfig())
    r.add("a", "127.0.0.1", 1, generation=0)
    r.add("b", "127.0.0.1", 2, generation=1)
    r.set_barrier(1)
    assert [m.member_id for m in r.candidates("m")] == ["b"]
    r.set_generation("a", 1)
    assert sorted(m.member_id for m in r.candidates("m")) == ["a", "b"]
    r.set_barrier(2)
    assert r.candidates("m") == []
    with pytest.raises(router.NoHealthyMember):
        r.score_rows(np.zeros((1, 4), np.float32))
    assert r.member_ids() == ["a", "b"]
    r.close()


@pytest.mark.parametrize("base_ms,cap_ms", [(50.0, 2000.0), (20.0, 100.0),
                                            (5.0, 5.0)])
def test_backoff_ladder_equals_jax_under_one_seed(base_ms, cap_ms):
    ours = router._Backoff(base_ms / 1e3, cap_ms / 1e3)
    theirs = jax_router._Backoff(base_ms / 1e3, cap_ms / 1e3)
    for seed in (0, 7):
        ladders = []
        for b in (ours, theirs):
            random.seed(seed)
            steps = [b.fail(now=100.0) for _ in range(6)]
            blocked = [b.blocked(now=100.0 + t)
                       for t in (0.0, steps[-1] * 0.5, cap_ms / 1e3 + 1e-3)]
            b.ok()
            steps.append(b.fail(now=0.0))
            ladders.append((steps, blocked, b.blocked(now=1e9)))
            b.ok()
        assert ladders[0] == ladders[1]
        assert all(base_ms / 1e3 <= s <= cap_ms / 1e3
                   for s in ladders[0][0])


def test_loadtest_reconnects_on_the_routers_ladder():
    assert loadtest._Backoff is router._Backoff
    assert not hasattr(loadtest, "random")


def test_route_chaos_site_fires_and_journals(tmp_path):
    obs.configure(str(tmp_path / "tele"))
    chaos.configure(plan_mod.parse_plan({"faults": [
        {"site": router.ROUTE_SITE, "at_call": 1, "max_times": 1,
         "action": "raise"}]}))
    r = FleetRouter(FleetConfig())
    r.add("a", "127.0.0.1", 1)
    with pytest.raises(chaos.ChaosError):
        r.score_rows(np.zeros((1, 4), np.float32))
    obs.flush()
    evs = obs.read_journal(str(tmp_path / "tele" / "journal.jsonl"))
    assert [e["site"] for e in evs if e["kind"] == "chaos_inject"] == [
        router.ROUTE_SITE]
    r.close()


# -- the kill analogues ----------------------------------------------------


def test_serve_server_kill_severs_live_connections(tmp_path):
    from shifu_tpu_torch.runtime.serve import ScoringDaemon
    d = ScoringDaemon("stub://v2", config=ServingConfig(
        engine="numpy", report_every_s=0.0), loader=tag_loader).start()
    srv = serve_wire.ServeServer(d, port=0).start()
    c = serve_wire.ServeClient(srv.host, srv.port, timeout=5)
    try:
        out = c.score_rows(np.ones((1, 4), np.float32),
                           dtype=serve_wire.DTYPE_F32)
        assert float(out[0, 0]) == 3.0
        assert wait_for(lambda: len(srv._conns) == 1)
        srv.kill()
        assert srv._conns == set()
        with pytest.raises((ConnectionError, OSError)):
            c.score_rows(np.ones((1, 4), np.float32))
        with pytest.raises(OSError):
            serve_wire.ServeClient(srv.host, srv.port, timeout=1)
    finally:
        c.close()
        d.stop()


def test_daemon_kill_fails_queued_requests_and_shuts_admission():
    from shifu_tpu_torch.runtime.serve import ScoringDaemon
    d = ScoringDaemon("stub://v0", config=ServingConfig(
        engine="numpy", report_every_s=0.0), loader=tag_loader)
    # not started: requests queue, no worker takes them
    d._running = d._accepting = True
    futs = [d.submit(np.ones(4, np.float32)) for _ in range(3)]
    d.kill()
    for f in futs:
        with pytest.raises(RuntimeError, match="killed"):
            f.result(timeout=1)
    with pytest.raises(Exception):
        d.submit(np.ones(4, np.float32))
    assert d._registry.current(d.model_id) is not None  # left open


# -- the manager: one scripted sequence in both packages ----------------


def _script(pkg, root, tele, a1, a2):
    """start on a1 with a forged-stale lease, check_members, a swap to a2
    with one straggler, _retry_stale, scale up and down, and a rejoin
    once the downed member's lease returns; summary() after each step."""
    (obs if pkg is fleet else jax_obs).configure(str(tele))
    ch, pm = ((chaos, plan_mod) if pkg is fleet else (jax_chaos, jax_plan))
    mgr = make_manager(pkg, root, export=a1, loader=file_tag_loader,
                       hosts="local:2", heartbeat_every_s=60.0,
                       timeline_skew_correct=False, max_daemons=5)
    summaries = []
    mgr.start()
    try:
        summaries.append(mgr.summary())
        victim = mgr.members["member-1"]
        assert mgr.check_members() == []
        age_lease(victim)
        assert mgr.check_members() == ["member-1"]
        summaries.append(mgr.summary())
        ch.configure(pm.parse_plan({"faults": [
            {"site": "runtime.serve", "at_call": 2, "max_times": 1,
             "action": "raise"}]}))
        out = mgr.swap_fleet(a2)
        assert [f["member"] for f in out["failed"]] == ["member-2"]
        summaries.append(mgr.summary())
        assert mgr._retry_stale() == ["member-2"]
        summaries.append(mgr.summary())
        assert mgr.scale_tick(burns=[(3.0, 3.0), (0.5, 0.4)]) == "up"
        summaries.append(mgr.summary())
        assert mgr.scale_tick(burns=[(0.1, 0.1)] * 4) == "down"
        summaries.append(mgr.summary())
        fleet.write_lease(victim.tele_dir, "member-1", 99, 180.0,
                          host=victim.host_id)
        assert mgr.check_members() == []
        summaries.append(mgr.summary())
        answers = [float(mgr.router.score_rows(
            np.ones((1, 4), np.float32), model_id=f"m{i}")[0, 0])
            for i in range(6)]
    finally:
        mgr.stop()
        ch.reset_for_tests()
    (obs if pkg is fleet else jax_obs).flush()
    return summaries, fleet_events(tele / "journal.jsonl"), answers


def test_scripted_manager_sequence_equals_jax(tmp_path, capsys):
    a1 = make_tag_artifact(tmp_path, "art_v1", 1.0)
    a2 = make_tag_artifact(tmp_path, "art_v2", 2.0)
    got = _script(fleet, tmp_path / "port", tmp_path / "port_tele", a1, a2)
    want = _script(jax_fleet, tmp_path / "jax", tmp_path / "jax_tele", a1,
                   a2)
    assert got[0] == want[0]
    assert [e["kind"] for e in got[1]] == [e["kind"] for e in want[1]]
    assert got[1] == want[1]
    kinds = {e["kind"] for e in got[1]}
    assert {"fleet_start", "fleet_sync", "fleet_failover",
            "fleet_member_swap", "fleet_swap_degraded", "fleet_swap",
            "fleet_readmit", "fleet_scale", "fleet_rejoin"} <= kinds
    # after the barrier every answer is generation 1's: 1 + tag 2 (int8)
    assert got[2] == want[2]
    assert all(abs(a - 3.0) < 0.05 for a in got[2])
    # `fleet-verify` of both packages on each package's journal
    for tele in ("port_tele", "jax_tele"):
        rc, text, report = verify_both(capsys, tmp_path / tele)
        assert rc == 0 and report["counts"]["rejoins"] == 1, text


def test_clock_skew_estimate_equals_jax(tmp_path):
    out = []
    for pkg, o in ((fleet, obs), (jax_fleet, jax_obs)):
        o.configure(str(tmp_path / pkg.__name__))
        mgr = make_manager(pkg, tmp_path / (pkg.__name__ + "_root"),
                           n_daemons=1, standbys=0)
        now = 1000.0
        for host, age in (("h0", 0.5), ("h0", 0.3), ("h0", 0.298),
                          ("h1", -2.0), ("h1", 900.0), ("", 1.0)):
            mgr._observe_skew({"ts": now - age, "host": host}, now)
        mgr._observe_skew(None, now)
        o.flush()
        out.append([{k: v for k, v in e.items() if k != "ts"}
                    for e in o.read_journal(str(
                        tmp_path / pkg.__name__ / "journal.jsonl"))
                    if e["kind"] == "fleet_clock_skew"])
    assert out[0] == out[1]
    assert [e["offset_s"] for e in out[0]] == [0.5, 0.3, -2.0]


# -- the in-process drills on the stub engine ----------------------------


def test_lease_expiry_failover_promotes_standby(tmp_path):
    obs.configure(str(tmp_path / "tele"))
    mgr = make_manager(fleet, tmp_path / "fleet", n_daemons=2, standbys=1,
                       heartbeat_every_s=30.0)
    mgr.start()
    try:
        victim_id = sorted(mgr.members)[0]
        standby_id = mgr.standbys[0].member_id
        assert mgr.check_members() == []
        age_lease(mgr.members[victim_id])
        assert mgr.check_members() == [victim_id]
        summary = mgr.summary()
        assert victim_id not in summary["active"]
        assert standby_id in summary["active"]
        assert summary["failovers"] == 1 and len(summary["standbys"]) == 1
        assert victim_id not in mgr.router.member_ids()
        assert mgr.failover(mgr._downed[victim_id][0]) is None  # handled
        obs.flush()
        evs = [e for e in fleet_events(tmp_path / "tele" / "journal.jsonl")
               if e["kind"] == "fleet_failover"]
        assert len(evs) == 1
        assert (evs[0]["member"], evs[0]["standby"]) == (victim_id,
                                                        standby_id)
    finally:
        mgr.stop()


def test_kill_drill_through_the_router_zero_errors_one_failover(tmp_path):
    """A member killed mid-loadtest behind RouterServer: 0 errors, one
    fleet_failover, the standby serving.  The monitor runs (0.5 s x 3: a
    beat late on a CPU shared with other test workers fails no one)."""
    obs.configure(str(tmp_path / "tele"))
    mgr = FleetManager("stub://v0", fleet=FleetConfig(
                           **fleet_kw(heartbeat_every_s=0.5)),
                       serving=ServingConfig(engine="numpy",
                                             report_every_s=0.0),
                       root_dir=str(tmp_path / "fleet"), loader=tag_loader,
                       device="cpu")
    mgr.start()
    front = RouterServer(mgr.router, manager=mgr).start()
    try:
        victim = mgr.members[mgr.router.candidates("default")[0].member_id]
        killer = threading.Timer(0.6, victim.kill)
        killer.start()
        rep = loadtest.run_loadtest(connect=f"{front.host}:{front.port}",
                                    rate=400.0, duration=1.5, senders=2,
                                    seed=7)
        killer.join()
        assert rep["errors"] == 0, rep
        assert rep["completed"] == rep["submitted"]
        assert wait_for(lambda: mgr.summary()["failovers"] == 1, 5.0)
        summary = mgr.summary()
        assert victim.member_id not in summary["active"]
        assert len(summary["active"]) == 3
        out = mgr.router.score_rows(np.ones((1, 4), np.float32))
        assert np.asarray(out).shape == (1, 1)
        obs.flush()
        evs = fleet_events(tmp_path / "tele" / "journal.jsonl")
        fo = [e for e in evs if e["kind"] == "fleet_failover"]
        assert [e["member"] for e in fo] == [victim.member_id]
        assert fleet.fleet_verify_events(evs)["verdict"] == "PASS"
    finally:
        front.close()
        mgr.stop()


def test_swap_drill_straggler_quarantined_then_readmitted(tmp_path):
    obs.configure(str(tmp_path / "tele"))
    mgr = make_manager(fleet, tmp_path / "fleet")
    mgr.start()
    try:
        members = sorted(mgr.members)
        chaos.configure(plan_mod.parse_plan({"faults": [
            {"site": "runtime.serve", "at_call": 2, "max_times": 1,
             "action": "raise"}]}))
        out = mgr.swap_fleet("stub://v1")
        straggler = out["failed"][0]["member"]
        assert out["ok"] is False and straggler == members[1]
        assert len(out["swapped"]) == 3
        assert straggler in mgr.summary()["stale"]
        assert straggler not in mgr.router.member_ids()
        for i in range(12):
            got = mgr.router.score_rows(np.ones((1, 4), np.float32),
                                        model_id=f"m{i}")
            assert abs(float(got[0, 0]) - 2.0) < 0.05
        assert mgr._retry_stale() == [straggler]
        assert straggler in mgr.summary()["active"]
        assert all(m.generation == 1
                   for m in list(mgr.members.values()) + mgr.standbys)
        obs.flush()
        evs = fleet_events(tmp_path / "tele" / "journal.jsonl")
        assert [e["member"] for e in evs
                if e["kind"] == "fleet_swap_degraded"] == [straggler]
        assert [e["member"] for e in evs
                if e["kind"] == "fleet_readmit"] == [straggler]
    finally:
        mgr.stop()


def test_scale_tick_up_then_down(tmp_path):
    obs.configure(str(tmp_path / "tele"))
    mgr = make_manager(fleet, tmp_path / "fleet", n_daemons=2, standbys=1,
                       max_daemons=4)
    mgr.start()
    try:
        standby_id = mgr.standbys[0].member_id
        assert mgr.scale_tick(burns=[(3.0, 3.0), (0.5, 0.4)]) == "up"
        assert standby_id in mgr.summary()["active"]
        assert mgr.scale_tick(burns=[(0.1, 0.1)] * 3) == "down"
        assert len(mgr.summary()["active"]) == 2
        assert mgr.scale_tick(burns=[(3.0, 0.1), (0.1, 0.1)]) == "hold"
        # no SLO engine on the members: no burns, hold
        assert mgr.scale_tick() == "hold"
        mgr.push_burns()
        obs.flush()
        evs = [e for e in fleet_events(tmp_path / "tele" / "journal.jsonl")
               if e["kind"] == "fleet_scale"]
        assert [(e["action"], e["n_before"], e["n_after"]) for e in evs] \
            == [("up", 2, 3), ("down", 3, 2)]
    finally:
        mgr.stop()


def test_router_server_scores_swaps_and_reports_the_fleet(tmp_path):
    obs.configure(str(tmp_path / "tele"))
    mgr = make_manager(fleet, tmp_path / "fleet", n_daemons=2, standbys=0)
    mgr.start()
    front = RouterServer(mgr.router, manager=mgr).start()
    try:
        with serve_wire.ServeClient(front.host, front.port) as c:
            assert c.ping()
            x = np.array([[0.123456, 1, 2, 3]] * 3, np.float32)
            # the frame's dtype goes to the member: f32 stays exact
            out = c.score_rows(x, dtype=serve_wire.DTYPE_F32)
            assert out.shape == (3, 1)
            np.testing.assert_array_equal(out[:, 0], x[:, 0])
            out = c.score_rows(x)   # int8 on the static grid
            assert np.abs(out[:, 0] - x[:, 0]).max() < 8.0 / 127
            stats = c.stats()
            # the STATS frame is itself routed to a member
            assert stats["fleet"]["routed"] == 3
            assert stats["fleet"]["generation"] == 0
            assert len(stats["fleet"]["active"]) == 2
            assert stats["num_features"] == 4
            swap = c.swap("stub://v3")
            assert swap["ok"] is True and swap["generation"] == 1
            out = c.score_rows(np.ones((1, 4), np.float32),
                               dtype=serve_wire.DTYPE_F32)
            assert float(out[0, 0]) == 4.0
        assert mgr.summary()["generation"] == 1
        no_mgr = RouterServer(mgr.router).start()
        try:
            with serve_wire.ServeClient(no_mgr.host, no_mgr.port) as c:
                with pytest.raises(serve_wire.WireError, match="no manager"):
                    c.swap("stub://v4")
        finally:
            no_mgr.close()
    finally:
        front.close()
        mgr.stop()


def test_route_traces_decompose_end_to_end(tmp_path):
    obs.configure(str(tmp_path / "tele"))
    mgr = make_manager(fleet, tmp_path / "fleet", n_daemons=2, standbys=0)
    mgr.router.trace_sample = 2
    mgr.start()
    try:
        for i in range(4):
            mgr.router.score_rows(np.ones((2, 4), np.float32))
        obs.flush()
        tr = [e for e in obs.read_journal(str(tmp_path / "tele" /
                                              "journal.jsonl"))
              if e["kind"] == "route_trace"]
        assert len(tr) == 2
        for e in tr:
            assert e["outcome"] == "ok" and e["rows"] == 2
            assert len(e["hops"]) == 1 and e["hedged"] is False
            assert e["e2e_ms"] == pytest.approx(
                e["hops"][0]["ms"] + e["queue_ms"], abs=1e-3)
    finally:
        mgr.stop()


def test_member_dirs_feed_the_fleet_rollup(tmp_path):
    from shifu_tpu.obs.aggregate import serving_rollup as jax_rollup
    from shifu_tpu_torch.obs.aggregate import serving_rollup

    obs.configure(str(tmp_path / "tele"))
    mgr = make_manager(fleet, tmp_path / "fleet", n_daemons=2, standbys=1,
                       heartbeat_every_s=30.0)
    mgr.start()
    try:
        dirs = mgr.member_dirs()
        assert len(dirs) == 3
        roll = serving_rollup(dirs)
        assert roll["fleet"]["daemons"] == 3 and roll["fleet"]["down"] == 0
        assert [d.get("mode") for d in roll["daemons"]] == ["serving"] * 3
        age_lease(mgr.members["member-0"], journal=True)
        mgr.check_members()
        dirs = mgr.member_dirs()
        roll = serving_rollup(dirs)
        assert roll["fleet"]["down"] == 1
        assert roll["fleet"] == jax_rollup(dirs)["fleet"]
    finally:
        mgr.stop()


def test_the_monitor_judges_no_lease_across_its_own_stall(tmp_path,
                                                         monkeypatch):
    """A monitor tick that overslept by more than a heartbeat (the fleet's
    process starved on a loaded host, its in-process heartbeats held up
    alike) checks no lease; the next, on time, does."""
    import shifu_tpu_torch.runtime.fleet as fleet_mod

    mgr = FleetManager("stub://v0", fleet=FleetConfig(
                           **fleet_kw(heartbeat_every_s=0.5)),
                       serving=ServingConfig(engine="numpy",
                                             report_every_s=0.0),
                       root_dir=str(tmp_path / "fleet"), loader=tag_loader,
                       device="cpu")
    clock = [100.0]
    naps = iter([0.2 + 0.5 + 0.1, 0.2, 0.2 + 0.5 + 0.1, 0.2])
    checked = []

    def sleep(_s):
        try:
            clock[0] += next(naps)
        except StopIteration:
            mgr._running = False

    monkeypatch.setattr(fleet_mod.time, "sleep", sleep)
    monkeypatch.setattr(fleet_mod.time, "monotonic", lambda: clock[0])
    monkeypatch.setattr(mgr, "check_members",
                        lambda: checked.append(clock[0]) or [])
    monkeypatch.setattr(mgr, "_retry_stale", lambda: [])
    mgr._running = True
    mgr._monitor_loop()
    assert checked == [pytest.approx(101.0), pytest.approx(102.0)]


def test_a_monitor_starved_every_tick_still_fails_over_a_dead_member(
        tmp_path, monkeypatch):
    """Every tick oversleeps by more than a heartbeat: the monitor holds
    back one tick at most in a row, so it judges every second tick and a
    member whose lease stopped is failed over all the same."""
    import shifu_tpu_torch.runtime.fleet as fleet_mod

    obs.configure(str(tmp_path / "tele"))
    mgr = make_manager(fleet, tmp_path / "fleet", n_daemons=2, standbys=1,
                       heartbeat_every_s=30.0)
    mgr.start()
    try:
        victim = sorted(mgr.members)[0]
        age_lease(mgr.members[victim])
        me, real_sleep, clock, judged = (threading.current_thread(),
                                         time.sleep, [100.0], [])

        def sleep(s):
            if threading.current_thread() is not me:
                return real_sleep(s)
            clock[0] += s + 30.0 + 1.0   # late by more than a beat
            mgr._running = clock[0] < 100.0 + 4 * (s + 31.0) + 1.0

        judge = mgr.check_members
        monkeypatch.setattr(fleet_mod.time, "sleep", sleep)
        monkeypatch.setattr(fleet_mod.time, "monotonic", lambda: clock[0])
        monkeypatch.setattr(mgr, "check_members",
                            lambda: judged.append(judge()) or judged[-1])
        monkeypatch.setattr(mgr, "_retry_stale", lambda: [])
        fleet.FleetManager._monitor_loop(mgr)
        monkeypatch.undo()
        assert judged == [[victim], []]
        summary = mgr.summary()
        assert summary["failovers"] == 1 and victim not in summary["active"]
    finally:
        mgr.stop()
