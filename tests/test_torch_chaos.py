"""The port's chaos plane (shifu_tpu_torch/chaos) against the JAX
package's: the plan grammar, its errors and the legacy env hooks; the same
injections for the same probe calls, job-scoped counters included; and
each probe site firing where its JAX twin does."""

import json
import os

import numpy as np
import pytest

from shifu_tpu import chaos as jax_chaos
from shifu_tpu import obs as jax_obs
from shifu_tpu_torch import chaos, obs

PLANS = [
    {"seed": 7, "faults": [
        {"site": "train.epoch", "at_epoch": 1, "action": "exit",
         "exit_code": 17, "scope": "job", "max_times": 1},
        {"site": "checkpoint.restore", "at_call": 1, "scope": "job"},
        {"site": "fsio.*", "every": 3, "action": "raise"}]},
    [{"site": "data.cache", "prob": 0.3, "action": "delay", "delay_s": 0}],
    {"faults": [{"site": "x", "before_epoch": "2", "rank": "1",
                 "member": "m-*", "message": "boom {site} {epoch}"}]},
]

BAD_PLANS = [
    "not json",
    {"faults": [{"site": "x", "every": 1, "trigger": 3}]},
    {"faults": [{"site": "x", "every": 1, "action": "explode"}]},
    {"faults": [{"site": "x", "every": 1, "scope": "world"}]},
    {"faults": [{"site": "x"}]},
    {"faults": [{"site": "x", "every": "often"}]},
    {"faults": [{"site": "x", "prob": 2.0}]},
    {"faults": [{"site": "", "every": 1}]},
    {"faults": "x"},
    {"faults": [], "seed": "s"},
    3,
]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("SHIFU_TPU_CHAOS_PLAN", "SHIFU_TPU_CHAOS_STATE",
                "SHIFU_TPU_PROCESS_ID", "SHIFU_TPU_FAULT_EPOCH",
                "SHIFU_TPU_FAULT_EVERY_EPOCH", "SHIFU_TPU_FAULT_PROCESS",
                "SHIFU_TPU_FAULT_HOST_DOWN", "SHIFU_TPU_HANG_EPOCH"):
        monkeypatch.delenv(var, raising=False)
    for m in (chaos, jax_chaos):
        m.reset_for_tests()
    for m in (obs, jax_obs):
        m.reset_for_tests()
    yield
    for m in (chaos, jax_chaos):
        m.reset_for_tests()
    for m in (obs, jax_obs):
        m.reset_for_tests()


@pytest.mark.parametrize("plan", PLANS)
def test_plans_parse_alike(plan):
    text = json.dumps(plan)
    got, want = chaos.load_plan(text), jax_chaos.load_plan(text)
    assert got.to_json() == want.to_json()
    assert chaos.parse_plan(plan).to_json() == want.to_json()


@pytest.mark.parametrize("plan", BAD_PLANS, ids=range(len(BAD_PLANS)))
def test_bad_plans_fail_alike(plan):
    text = plan if isinstance(plan, str) else json.dumps(plan)
    with pytest.raises(jax_chaos.ChaosPlanError) as want:
        jax_chaos.load_plan(text)
    with pytest.raises(chaos.ChaosPlanError) as got:
        chaos.load_plan(text)
    assert str(got.value) == str(want.value)


def test_a_plan_file_and_the_env_load_alike(tmp_path, monkeypatch):
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(PLANS[0]))
    assert chaos.load_plan(str(path)).to_json() \
        == jax_chaos.load_plan(str(path)).to_json()
    monkeypatch.setenv("SHIFU_TPU_CHAOS_PLAN", str(path))
    monkeypatch.setenv("SHIFU_TPU_FAULT_EPOCH", "2")
    monkeypatch.setenv("SHIFU_TPU_HANG_EPOCH", "4")
    monkeypatch.setenv("SHIFU_TPU_FAULT_HOST_DOWN", "1")
    assert chaos.load_plan_env().to_json() \
        == jax_chaos.load_plan_env().to_json()
    assert chaos.reload_from_env().to_json() \
        == jax_chaos.reload_from_env().to_json()


def _fire_sequence(mod, plan, calls, state=None):
    """Which of `calls` ((site, ctx) pairs) raise under `plan`."""
    mod.configure(mod.parse_plan(plan))
    out = []
    for site, ctx in calls:
        try:
            mod.maybe_fail(site, echo=lambda m: None, **ctx)
            out.append(None)
        except mod.ChaosError as e:
            out.append((str(e), e.exit_code))
    return out


CALLS = ([("train.chunk", {"epoch": e}) for e in range(4) for _ in range(5)]
         + [("data.cache", {"op": "read", "path": "p"})] * 20
         + [("fleet.heartbeat", {"member": m}) for m in ("m-1", "x-2")] * 3)


@pytest.mark.parametrize("fault", [
    {"site": "train.chunk", "at_call": 7},
    {"site": "train.*", "every": 4, "max_times": 3, "exit_code": 5},
    {"site": "train.chunk", "at_epoch": 2, "every": 2},
    {"site": "train.chunk", "before_epoch": 2, "message": "e{epoch}#{call}"},
    {"site": "data.cache", "prob": 0.35},
    {"site": "*", "prob": 0.5, "max_times": 9},
    {"site": "fleet.heartbeat", "every": 1, "member": "m-*"},
    {"site": "train.chunk", "every": 1, "rank": 1},
])
@pytest.mark.parametrize("rank", ["0", "1"])
def test_the_same_calls_fire(fault, rank, monkeypatch):
    monkeypatch.setenv("SHIFU_TPU_PROCESS_ID", rank)
    plan = {"seed": 13, "faults": [dict(fault, action="raise")]}
    got = _fire_sequence(chaos, plan, CALLS)
    want = _fire_sequence(jax_chaos, plan, CALLS)
    assert got == want
    if "rank" not in fault or fault["rank"] == int(rank):
        assert any(g is not None for g in got)


def test_job_scoped_counters_persist_alike(tmp_path, monkeypatch):
    plan = {"faults": [{"site": "checkpoint.restore", "at_call": 2,
                        "scope": "job"},
                       {"site": "train.epoch", "every": 1, "scope": "job",
                        "max_times": 2}]}
    calls = [("checkpoint.restore", {}), ("train.epoch", {"epoch": 0})] * 3
    results = {}
    for name, mod in (("port", chaos), ("jax", jax_chaos)):
        state = tmp_path / f"{name}.json"
        monkeypatch.setenv("SHIFU_TPU_CHAOS_STATE", str(state))
        # two "attempts" of one job: the counters survive the restart
        first = _fire_sequence(mod, plan, calls)
        second = _fire_sequence(mod, plan, calls)
        results[name] = (first, second, json.loads(state.read_text()))
    assert results["port"] == results["jax"]


def test_no_plan_costs_nothing_and_an_injection_is_journaled(tmp_path):
    chaos.configure(None)
    chaos.maybe_fail("train.chunk", epoch=0)  # no plan: a no-op
    obs.configure(str(tmp_path))
    chaos.configure(chaos.parse_plan(
        {"faults": [{"site": "board.flush", "every": 1, "action": "delay",
                     "delay_s": 0}]}))
    chaos.maybe_fail("board.flush", echo=lambda m: None, path="/b")
    ev = [e for e in obs.read_journal(str(tmp_path / "journal.jsonl"))
          if e["kind"] == "chaos_inject"]
    assert [(e["site"], e["action"], e["call"], e["path"]) for e in ev] \
        == [("board.flush", "delay", 1, "/b")]
    assert obs.counter("chaos_injected_total").value(
        site="board.flush", action="delay") == 1


def test_corrupt_flips_the_largest_file_alike(tmp_path):
    for name, mod in (("p", chaos), ("j", jax_chaos)):
        d = tmp_path / name
        d.mkdir()
        (d / "a").write_bytes(bytes(range(10)))
        (d / "b").write_bytes(bytes(range(40)))
        mod.configure(mod.parse_plan({"faults": [
            {"site": "checkpoint.post_save", "every": 1,
             "action": "corrupt"}]}))
        mod.maybe_fail("checkpoint.post_save", echo=lambda m: None,
                       path=str(d))
    assert (tmp_path / "p" / "b").read_bytes() \
        == (tmp_path / "j" / "b").read_bytes() != bytes(range(40))
    assert (tmp_path / "p" / "a").read_bytes() == bytes(range(10))


# -- the probe sites, where their JAX twins fire -------------------------------

_LOOP_SITES = ("train.epoch_start", "train.chunk", "checkpoint.save",
               "checkpoint.post_save", "checkpoint.restore", "data.feeder")


def _record_sites(mod, obs_mod, tele, sites):
    """Journal every probe call of `sites` (a delay of 0: the call goes
    on).  Not "*": an injection flushes the journal, whose own site would
    then recurse."""
    obs_mod.configure(str(tele))
    mod.configure(mod.parse_plan({"faults": [
        {"site": s, "every": 1, "action": "delay", "delay_s": 0,
         "message": " "} for s in sites]}))


def _sites(obs_mod, tele, keep):
    obs_mod.flush()
    ev = obs_mod.read_journal(str(tele / "journal.jsonl"))
    return [(e["site"], e.get("epoch"), e.get("step")) for e in ev
            if e["kind"] == "chaos_inject" and e["site"] in keep]


@pytest.mark.parametrize("data_kw", [
    {"device_resident_bytes": 0},   # staged, the feeder on
    {},                             # resident
], ids=["staged", "resident"])
def test_train_and_checkpoint_sites_fire_where_jax_fires(tmp_path, data_kw,
                                                         capsys):
    """The same job (2 epochs, a checkpoint every epoch, then a resumed run
    of 3) in both packages under a plan that records every probe call: the
    sequence of loop and checkpoint sites, with their epoch and step."""
    from shifu_tpu.config import schema as jax_schema
    from shifu_tpu.data import pipeline as jax_pipe
    from shifu_tpu.data import reader as jax_reader
    from shifu_tpu.data import synthetic as jax_synth
    from shifu_tpu.train import loop as jax_loop
    from shifu_tpu_torch.config import schema as port_schema
    from shifu_tpu_torch.data import pipeline as pipe
    from shifu_tpu_torch.train import loop

    schema = jax_synth.make_schema(num_features=6)

    def jjob(d, epochs):
        return jax_schema.JobConfig(
            schema=schema,
            data=jax_schema.DataConfig(batch_size=64, block_batches=4,
                                       **data_kw),
            model=jax_schema.ModelSpec(hidden_nodes=(8,),
                                       activations=("relu",),
                                       compute_dtype="float32"),
            train=jax_schema.TrainConfig(epochs=epochs),
            runtime=jax_schema.RuntimeConfig(
                checkpoint=jax_schema.CheckpointConfig(directory=d))
        ).validate()

    rows = jax_synth.make_rows(1200, schema, seed=2)
    cols = jax_reader.project_columns(rows, schema)

    def parts(mod):
        full = mod.TabularDataset(cols["features"], cols["target"],
                                  cols["weight"])
        return full.take(np.arange(1000)), full.take(np.arange(1000, 1200))

    seqs = {}
    for name in ("jax", "port"):
        tele = tmp_path / f"t_{name}"
        ck = str(tmp_path / f"ck_{name}")
        for epochs in (2, 3):
            if name == "jax":
                _record_sites(jax_chaos, jax_obs, tele, _LOOP_SITES)
                jax_loop.train(jjob(ck, epochs), *parts(jax_pipe),
                               console=lambda s: None)
            else:
                _record_sites(chaos, obs, tele, _LOOP_SITES)
                pjob = port_schema.JobConfig.from_dict(
                    json.loads(jjob(ck, epochs).to_json()))
                loop.train(pjob, *parts(pipe), console=lambda s: None,
                           device="cpu")
        seqs[name] = _sites(jax_obs if name == "jax" else obs, tele,
                            _LOOP_SITES)
        for m in (chaos, jax_chaos):
            m.reset_for_tests()
        for m in (obs, jax_obs):
            m.reset_for_tests()
    capsys.readouterr()
    assert seqs["port"] == seqs["jax"]
    kinds = {s for s, _e, _st in seqs["port"]}
    assert {"train.epoch_start", "train.chunk", "checkpoint.save",
            "checkpoint.post_save", "checkpoint.restore"} <= kinds
    if data_kw:
        assert "data.feeder" in kinds


def test_board_journal_and_fsio_sites(tmp_path, monkeypatch):
    """board.flush fires per board line in both packages; journal.flush on
    a local journal's flush in both.  The fsio sites fire on the remote
    branch only, in both packages: the same calls on pyarrow's mock://
    filesystem probe the same sequence, and the local calls probe none."""
    from pyarrow import fs as pafs

    from shifu_tpu.data import fsio as jax_fsio
    from shifu_tpu.launcher.console import ConsoleBoard as JaxBoard
    from shifu_tpu_torch.data import fsio
    from shifu_tpu_torch.launcher.console import ConsoleBoard

    counts = {}
    for name, mod, board_cls, obs_mod in (
            ("port", chaos, ConsoleBoard, obs),
            ("jax", jax_chaos, JaxBoard, jax_obs)):
        tele = tmp_path / f"t_{name}"
        _record_sites(mod, obs_mod, tele, ("board.flush",))
        board = board_cls(str(tmp_path / f"{name}.board"), echo=False)
        for i in range(3):
            board(f"line {i}")
        board.close()
        obs_mod.flush()
        counts[name] = _sites(obs_mod, tele, ("board.flush",))
        mod.reset_for_tests()
    assert counts["port"] == counts["jax"] == [("board.flush", None,
                                               None)] * 3
    sites = ("fsio.write_bytes", "fsio.read_bytes", "fsio.list_files")
    fired = {}
    for name, mod, fs_mod, obs_mod in (("port", chaos, fsio, obs),
                                       ("jax", jax_chaos, jax_fsio, jax_obs)):
        mock, _ = pafs.FileSystem.from_uri("mock://seed")
        monkeypatch.setitem(fs_mod._fs_cache, ("mock", ""), mock)
        tele = tmp_path / f"fs_{name}"
        _record_sites(mod, obs_mod, tele, sites)
        local = str(tmp_path / f"{name}.f")
        with open(local, "wb") as f:
            f.write(b"x")
        assert fs_mod.read_bytes(local) == b"x"   # no probe: local
        fs_mod.write_bytes("mock://b/d/f", b"x")
        assert fs_mod.read_bytes("mock://b/d/f") == b"x"
        assert fs_mod.list_files("mock://b/d") == ["mock://b/d/f"]
        fired[name] = [s for s, _e, _st in _sites(obs_mod, tele, sites)]
        mod.reset_for_tests()
    assert fired["port"] == fired["jax"] == list(sites)
    chaos.configure(chaos.parse_plan({"faults": [
        {"site": "journal.flush", "every": 1, "action": "raise"}]}))
    obs.flush()  # the fault is absorbed: the journal is observability


def test_a_feeder_fault_fails_the_epoch_in_the_consumer():
    from shifu_tpu_torch.data import pipeline as pipe
    chaos.configure(chaos.parse_plan({"faults": [
        {"site": "data.feeder", "at_epoch": 1, "action": "raise"}]}))
    feeder = pipe.EpochFeeder(lambda ep: iter([ep, ep]), lambda b: b,
                              range(3))
    try:
        assert list(feeder.epoch(0)) == [0, 0]
        with pytest.raises(chaos.ChaosError):
            list(feeder.epoch(1))
    finally:
        feeder.close()


def test_isolation_of_the_state_lock(tmp_path, monkeypatch):
    state = tmp_path / "s.json"
    monkeypatch.setenv("SHIFU_TPU_CHAOS_STATE", str(state))
    plan = {"faults": [{"site": "s", "every": 2, "scope": "job"}]}
    got = _fire_sequence(chaos, plan, [("s", {})] * 4)
    assert [g is not None for g in got] == [False, True, False, True]
    assert json.loads(state.read_text())["calls"] == {"s": 4}
    assert os.path.exists(str(state) + ".lock")


def test_a_probe_inside_an_injection_does_not_recurse(tmp_path):
    """An injection journals itself and flushes the scrape file through
    the port's fsio, whose `fsio.write_bytes` site would fire again: the
    port skips probes reached from an injection's own journaling (the JAX
    package's local fsio has no probe there)."""
    obs.configure(str(tmp_path))
    chaos.configure(chaos.parse_plan({"faults": [
        {"site": "fsio.write_bytes", "every": 1, "action": "delay",
         "delay_s": 0, "message": " "},
        {"site": "journal.flush", "every": 1, "action": "delay",
         "delay_s": 0, "message": " "}]}))
    chaos.maybe_fail("fsio.write_bytes", echo=lambda m: None, path="x")
    chaos.configure(None)
    ev = [e for e in obs.read_journal(str(tmp_path / "journal.jsonl"))
          if e["kind"] == "chaos_inject"]
    assert [e["site"] for e in ev] == ["fsio.write_bytes"]
