"""The port's fleet on a real model, on the CPU: 3 members and 1 standby
on `local:2` serve a small FT-Transformer artifact the port exported
(fused blocks), behind `RouterServer`.

- The kill drill: a member killed under a socket loadtest through the
  router; 0 errors and exactly one `fleet_failover`.
- The swap drill: `swap_fleet` to the unfused artifact of other weights;
  past the barrier every answer is the new artifact's.  Scores through the
  router equal the in-process `TorchScorer`'s and stay within the serving
  tolerance of the JAX package's `JaxScorer` on the same artifact.
- The views on the fleet-written leases: `top --once` over the member dirs
  renders the killed member DOWN and `timeline --incident` shows the
  failover; their `--json` equals the JAX renderers' on the same dirs.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from shifu_tpu.launcher import cli as jax_cli
from shifu_tpu_torch import obs
from shifu_tpu_torch.config.schema import (ColumnSpec, DataSchema,
                                           FleetConfig, ModelSpec,
                                           ServingConfig)
from shifu_tpu_torch.export.artifact import save_artifact
from shifu_tpu_torch.export.scorer import TorchScorer
from shifu_tpu_torch.launcher import cli
from shifu_tpu_torch.models.registry import build_model
from shifu_tpu_torch.runtime import fleet, loadtest, serve_wire
from shifu_tpu_torch.runtime.router import RouterServer

from test_torch_fleet import _reset_all, fleet_events, wait_for

N_FEAT, N_CAT, VOCAB = 7, 2, 11
# the repo's serving tolerance between two engines of one artifact
SERVE_ATOL = 2e-2
# the same engine on the same rows, batched otherwise: roundoff only
SAME_ENGINE_TOL = 1e-5


@pytest.fixture(autouse=True)
def _clean():
    _reset_all()
    yield
    _reset_all()


def schema() -> DataSchema:
    cols = [ColumnSpec(0, "target", is_target=True)] + [
        ColumnSpec(i, f"f{i}", is_selected=True,
                   is_categorical=i > N_FEAT - N_CAT,
                   vocab_size=VOCAB if i > N_FEAT - N_CAT else 0)
        for i in range(1, N_FEAT + 1)]
    return DataSchema(columns=tuple(cols), target_index=0,
                      selected_indices=tuple(range(1, N_FEAT + 1)))


def ft_artifact(path, seed: int, fused_block: str) -> str:
    spec = ModelSpec(model_type="ft_transformer", token_dim=16, num_layers=2,
                     num_attention_heads=2, mlp_ratio=2,
                     compute_dtype="float32", fused_block=fused_block)
    model = build_model(spec, schema(), device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    return save_artifact(model, spec, schema(), str(path))


def rows(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, N_FEAT)).astype(np.float32)
    x[:, N_FEAT - N_CAT:] = rng.integers(-1, VOCAB + 2, size=(n, N_CAT))
    return x


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    root = tmp_path_factory.mktemp("fleet_ft")
    return (ft_artifact(root / "fused", 0, "on"),
            ft_artifact(root / "unfused", 1, "off"))


@pytest.fixture(scope="module")
def drill(artifacts, tmp_path_factory):
    """The kill drill then the swap drill on one fleet; returns what the
    tests read."""
    _reset_all()
    fused, unfused = artifacts
    root = tmp_path_factory.mktemp("fleet_drill")
    tele = root / "tele"
    obs.configure(str(tele))
    mgr = fleet.FleetManager(
        fused, fleet=FleetConfig(n_daemons=3, standbys=1, hosts="local:2",
                                 heartbeat_every_s=0.5,
                                 heartbeat_misses=3),
        serving=ServingConfig(engine="torch", max_batch=256,
                              report_every_s=0.0),
        root_dir=str(root / "fleet"), device="cpu")
    mgr.start()
    front = RouterServer(mgr.router, manager=mgr).start()
    out = {"root": root, "tele": tele}
    try:
        victim = mgr.members[mgr.router.candidates("default")[0].member_id]
        out["victim"] = victim.member_id
        out["victim_host"] = victim.host_id
        timer = threading.Timer(0.6, victim.kill)
        timer.start()
        out["load"] = loadtest.run_loadtest(
            connect=f"{front.host}:{front.port}", rate=200.0, duration=2.0,
            senders=2, seed=3)
        timer.join()
        assert wait_for(lambda: mgr.summary()["failovers"] == 1, 5.0)
        out["after_kill"] = mgr.summary()
        out["member_dirs"] = mgr.member_dirs()
        probe = rows(64, seed=9)
        with serve_wire.ServeClient(front.host, front.port,
                                    timeout=30) as c:
            out["before"] = c.score_rows(probe, dtype=serve_wire.DTYPE_F32)
            out["swap"] = c.swap(unfused)
            out["after"] = [c.score_rows(probe[i:i + 8],
                                         dtype=serve_wire.DTYPE_F32)
                            for i in range(0, 64, 8)]
        out["summary"] = mgr.summary()
        out["probe"] = probe
    finally:
        front.close()
        mgr.stop()
        obs.flush()
    out["events"] = fleet_events(tele / "journal.jsonl")
    _reset_all()
    return out


def test_kill_drill_zero_errors_one_failover(drill):
    rep = drill["load"]
    assert rep["errors"] == 0, rep
    assert rep["completed"] == rep["submitted"] > 0
    # the traffic's primary killed (its requests hedge); the one standby,
    # member-3, shares its host, so it is promoted all the same
    fo = [(e["member"], e["standby"]) for e in drill["events"]
          if e["kind"] == "fleet_failover"]
    assert fo == [(drill["victim"], "member-3")]
    summary = drill["after_kill"]
    assert drill["victim"] in summary["down"]
    assert len(summary["active"]) == 3 and len(summary["standbys"]) == 1
    assert fleet.fleet_verify_events(drill["events"])["verdict"] == "PASS"


def test_router_scores_equal_the_torch_scorer_and_jax(drill, artifacts):
    from shifu_tpu.export.scorer import JaxScorer

    fused, unfused = artifacts
    probe = drill["probe"]
    want = TorchScorer(fused, device="cpu").compute_batch(probe)
    np.testing.assert_allclose(drill["before"], want, rtol=SAME_ENGINE_TOL,
                               atol=SAME_ENGINE_TOL)
    np.testing.assert_allclose(drill["before"],
                               JaxScorer(fused).compute_batch(probe),
                               rtol=0, atol=SERVE_ATOL)


def test_swap_drill_every_answer_past_the_barrier_is_the_new_one(
        drill, artifacts):
    from shifu_tpu.export.scorer import JaxScorer

    fused, unfused = artifacts
    assert drill["swap"]["ok"] is True and drill["swap"]["generation"] == 1
    assert drill["summary"]["generation"] == 1
    probe = drill["probe"]
    got = np.concatenate(drill["after"])
    new = TorchScorer(unfused, device="cpu").compute_batch(probe)
    old = TorchScorer(fused, device="cpu").compute_batch(probe)
    np.testing.assert_allclose(got, new, rtol=SAME_ENGINE_TOL,
                               atol=SAME_ENGINE_TOL)
    assert np.abs(got - old).max() > 10 * SAME_ENGINE_TOL
    np.testing.assert_allclose(got, JaxScorer(unfused).compute_batch(probe),
                               rtol=0, atol=SERVE_ATOL)
    applied = sorted(e["member"] for e in drill["events"]
                     if e["kind"] == "fleet_member_swap")
    assert applied == sorted(drill["swap"]["swapped"])
    syncs = [e["host"] for e in drill["events"]
             if e["kind"] == "fleet_sync" and e["generation"] == 1]
    assert sorted(syncs) == ["local-0", "local-1"]


def _view(main, argv, capsys):
    capsys.readouterr()
    rc = main(argv)
    return rc, capsys.readouterr().out


def test_top_renders_the_killed_member_down_like_jax(drill, capsys,
                                                      monkeypatch):
    dirs = drill["member_dirs"]
    victim_dir = [d for d in dirs if d.endswith(drill["victim"])][0]
    lease = fleet.read_lease(victim_dir)
    assert lease["host"] == drill["victim_host"]
    # read at a fixed instant after the drill: the live members' leases
    # as they stood when it ended, the victim's long silent
    newest = max(fleet.read_lease(d)["ts"] for d in dirs)
    monkeypatch.setattr(time, "time", lambda: newest + 0.1)
    for extra in ([], ["--json"]):
        argv = ["top", *dirs, "--once", *extra]
        rc, got = _view(cli.main, argv, capsys)
        jrc, want = _view(jax_cli.main, argv, capsys)
        assert rc == jrc == 0 and got == want
    roll = json.loads(got)["fleet"]
    assert roll["daemons"] == len(dirs) == 5 and roll["down"] == 1
    assert roll["hosts"][drill["victim_host"]]["down"] == 1
    assert "DOWN" in _view(cli.main, ["top", victim_dir, "--once"],
                           capsys)[1]


def test_timeline_shows_the_failover_incident_like_jax(drill, capsys):
    tele = str(drill["tele"])
    for extra in ([], ["--json"]):
        argv = ["timeline", tele, "--incident", *extra]
        rc, got = _view(cli.main, argv, capsys)
        jrc, want = _view(jax_cli.main, argv, capsys)
        assert rc == jrc == 0 and got == want
    incidents = json.loads(got)["incidents"]
    fo = [i for i in incidents if i["kind"] == "fleet_failover"]
    assert len(fo) == 1 and fo[0]["resolved"]
    assert fo[0]["root"]["member"] == drill["victim"]
