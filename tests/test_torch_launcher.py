"""The port's `train` and `cache` commands (shifu_tpu_torch/launcher) against
the JAX package's: the same JobConfig and job-dir files from the same Shifu
files and XML; a CPU run's outputs; the hot-cache decision; the restart
supervisor on a fake child; the `cache` command's output."""

import json
import os
import sys
import textwrap

import numpy as np
import pytest

from shifu_tpu import obs as jax_obs
from shifu_tpu.launcher import cli as jax_cli
from shifu_tpu_torch import chaos, obs
from shifu_tpu_torch.data import synthetic
from shifu_tpu_torch.launcher import cli, supervisor
from shifu_tpu_torch.utils import xmlconfig

XML = {"shifu.data.device-resident-bytes": "0",
       "shifu.application.batch-size": "64",
       "shifu.data.wire-dtype": "int8",
       "shifu.checkpoint.save-seconds": "0",
       "shifu.application.max-restarts": "4",
       "shifu.liveness.seconds": "0"}


# what a `train` command exports into os.environ (a chaos plan and its
# state file, among others): cleared before each test and after it, so no
# later test file in the same worker inherits a plan
_CLI_ENV = ("SHIFU_TPU_CHAOS_PLAN", "SHIFU_TPU_CHAOS_STATE",
            "SHIFU_TPU_METRICS_DIR", "SHIFU_TPU_DATA_CACHE",
            "SHIFU_TPU_PDEATHSIG")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in _CLI_ENV:
        monkeypatch.delenv(var, raising=False)
    for m in (obs, jax_obs):
        m.reset_for_tests()
    chaos.reset_for_tests()
    yield
    for var in _CLI_ENV:
        os.environ.pop(var, None)
    for m in (obs, jax_obs):
        m.reset_for_tests()
    chaos.reset_for_tests()


def _shifu_files(tmp_path, rows=900, epochs=2, xml=None, num_files=3):
    schema = synthetic.make_schema(num_features=8)
    synthetic.write_files(synthetic.make_rows(rows, schema, seed=7),
                          str(tmp_path / "data"), num_files=num_files)
    mc = {"basic": {"name": "launch"},
          "dataSet": {"targetColumnName": "target", "dataDelimiter": "|"},
          "train": {"validSetRate": 0.1, "numTrainEpochs": epochs,
                    "algorithm": "NN",
                    "params": {"NumHiddenLayers": 1, "NumHiddenNodes": [8],
                               "ActivationFunc": ["relu"],
                               "LearningRate": 0.01, "Propagation": "Q",
                               "Loss": "squared"}}}
    cc = [{"columnNum": c.index, "columnName": c.name,
           "columnFlag": "Target" if c.is_target else None,
           "columnType": "N", "finalSelect": c.is_selected}
          for c in schema.columns]
    (tmp_path / "ModelConfig.json").write_text(json.dumps(mc))
    (tmp_path / "ColumnConfig.json").write_text(json.dumps(cc))
    conf = dict(XML, **(xml or {}))
    xmlconfig.write_configuration_xml(conf, str(tmp_path / "global.xml"))
    return ["train", "--modelconfig", str(tmp_path / "ModelConfig.json"),
            "--columnconfig", str(tmp_path / "ColumnConfig.json"),
            "--data", str(tmp_path / "data"),
            "--globalconfig", str(tmp_path / "global.xml")]


@pytest.mark.parametrize("extra", [
    [],
    ["--epochs", "5", "--batch-size", "32", "--timeout", "60"],
    ["--cache-dir", "CACHE"],
])
def test_assemble_job_matches_jax(tmp_path, extra):
    argv = _shifu_files(tmp_path, xml={"shifu.data.cache-dir": "/c",
                                       "shifu.application.name": "app"})
    extra = [str(tmp_path / e) if e == "CACHE" else e for e in extra]
    argv += ["--output", str(tmp_path / "job")] + extra
    jargs = jax_cli.build_parser().parse_args(argv)
    jjob, jdir = jax_cli._assemble_job(jargs)
    jfiles = {n: (tmp_path / "job" / n).read_bytes()
              for n in ("global-final.xml", "job-config.json",
                        "ModelConfig.json", "ColumnConfig.json")}
    pargs = cli.build_parser().parse_args(argv + ["--device", "cpu"])
    pjob, pdir = cli._assemble_job(pargs)
    assert pdir == jdir
    assert pjob.to_dict() == json.loads(jjob.to_json()) or \
        json.loads(pjob.to_json()) == json.loads(jjob.to_json())
    for n, b in jfiles.items():
        assert (tmp_path / "job" / n).read_bytes() == b, n
    assert cli._child_train_args(pargs, pdir) \
        == jax_cli._child_train_args(jargs, jdir) + ["--device", "cpu"]


def test_train_on_the_cpu_writes_the_job_outputs(tmp_path, capsys):
    from shifu_tpu_torch.export.scorer import TorchScorer
    argv = _shifu_files(tmp_path, xml={
        "shifu.data.cache-dir": str(tmp_path / "cache")})
    out = tmp_path / "job"
    assert cli.main(argv + ["--output", str(out), "--device", "cpu"]) == 0
    for name in ("final_model", "metrics.jsonl", "console.board",
                 "telemetry", "global-final.xml", "job-config.json",
                 "tmp_model"):
        assert (out / name).exists(), name
    metrics = [json.loads(ln) for ln in
               (out / "metrics.jsonl").read_text().splitlines()]
    assert [m["epoch"] for m in metrics] == [0, 1]
    board = (out / "console.board").read_text()
    assert "Streaming first epoch" in board and "model exported to" in board
    journal = [json.loads(ln) for ln in
               (out / "telemetry" / "journal.jsonl").read_text().splitlines()]
    kinds = [e["kind"] for e in journal]
    assert kinds[0] == "run_start" and kinds[-1] == "run_end"
    report = [e for e in journal if e["kind"] == "ingest_report"]
    assert report and report[0]["mode"] == "stream"
    assert report[0]["tiers"] == {"parse": 3}
    from shifu_tpu_torch.data import native_parser
    tier = "native" if native_parser.available() else "numpy"
    assert {r["parser"] for r in report[0]["per_file"]} == {tier}
    assert (out / "telemetry" / "metrics.prom").exists()
    scorer = TorchScorer(str(out / "final_model"), device="cpu")
    rows = np.random.default_rng(0).normal(size=(5, 8)).astype(np.float32)
    assert np.all(np.isfinite(scorer.compute_batch(rows)))
    capsys.readouterr()


def test_a_hot_second_run_loads_as_jax_decides(tmp_path, capsys):
    """Run 1 (cold) streams its first epoch and writes the v2 entries;
    run 2 in a fresh job dir finds the cache hot and loads; the JAX loop
    takes the same decision on the port's cache, and the hot run's losses
    equal a cache-off run's with the streamed epoch off."""
    import dataclasses

    from shifu_tpu import config as jax_config
    from shifu_tpu.data import pipeline as jax_pipe
    from shifu_tpu_torch.config import job_config_from_shifu
    from shifu_tpu_torch.data import pipeline as pipe
    from shifu_tpu_torch.train.loop import train

    cache_dir = str(tmp_path / "cache")
    argv = _shifu_files(tmp_path, xml={"shifu.data.cache-dir": cache_dir})
    assert cli.main(argv + ["--output", str(tmp_path / "a"),
                            "--device", "cpu"]) == 0
    assert cli.main(argv + ["--output", str(tmp_path / "b"),
                            "--device", "cpu"]) == 0
    a = (tmp_path / "a" / "console.board").read_text()
    b = (tmp_path / "b" / "console.board").read_text()
    assert "Streaming first epoch" in a and "cache is hot" not in a
    assert ("Projected cache is hot for every input file: skipping the "
            "streamed first epoch") in b and "Streaming" not in b
    hits = [e for e in map(json.loads, (tmp_path / "b" / "telemetry" /
                                        "journal.jsonl").read_text()
                           .splitlines()) if e["kind"] == "ingest_report"]
    assert hits[0]["mode"] == "load" and hits[0]["tiers"] == {"cache": 3}
    # the JAX package's decision on the port's cache
    mc, cc = str(tmp_path / "ModelConfig.json"), str(
        tmp_path / "ColumnConfig.json")
    jjob = jax_config.job_config_from_shifu(
        mc, cc, data_paths=(str(tmp_path / "data"),))
    from shifu_tpu.utils import xmlconfig as jax_xml
    conf = jax_xml.parse_configuration_xml(str(tmp_path / "global.xml"))
    jjob = jax_xml.apply_to_job(jjob, conf)
    assert jax_pipe.projected_cache_complete(jjob.schema, jjob.data, 0, 1,
                                             "int8c8")
    pjob = xmlconfig.apply_to_job(job_config_from_shifu(
        mc, cc, data_paths=(str(tmp_path / "data"),)), conf)
    assert pipe.projected_cache_complete(pjob.schema, pjob.data, "int8c8")
    # hot losses == a cache-off run with stream_first_epoch off
    ref = train(pjob.replace(data=dataclasses.replace(
        pjob.data, cache_dir=None, stream_first_epoch=False)),
        console=lambda s: None, device="cpu")
    got = [json.loads(ln)["train_error"] for ln in
           (tmp_path / "b" / "metrics.jsonl").read_text().splitlines()]
    assert got == [m.train_error for m in ref.history]
    capsys.readouterr()


def test_the_cold_cache_run_equals_a_cache_off_run(tmp_path, capsys):
    argv = _shifu_files(tmp_path)
    assert cli.main(argv + ["--output", str(tmp_path / "off"),
                            "--device", "cpu"]) == 0
    assert cli.main(argv + ["--output", str(tmp_path / "on"),
                            "--device", "cpu", "--cache-dir",
                            str(tmp_path / "c")]) == 0
    def losses(out):
        return [{k: v for k, v in json.loads(x).items() if "time" not in k}
                for x in (out / "metrics.jsonl").read_text().splitlines()]

    assert losses(tmp_path / "on") == losses(tmp_path / "off") != []
    assert len(os.listdir(tmp_path / "c")) == 3
    capsys.readouterr()


def test_the_default_device_is_the_card(tmp_path):
    argv = _shifu_files(tmp_path)
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default trains on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(argv + ["--output", str(tmp_path / "job")])


@pytest.mark.parametrize("flags,item", [
    (["--hosts", "local:2"], r"\(f\)"),
    (["--num-processes", "2"], r"\(f\)"),
    (["--detach", "--num-processes", "2"], r"\(f\)"),
    (["--detach", "--hosts", "local:2"], r"\(f\)"),
])
def test_unported_flags_raise(tmp_path, flags, item):
    argv = _shifu_files(tmp_path)
    with pytest.raises(NotImplementedError, match="not ported yet.*" + item):
        cli.main(argv + ["--device", "cpu"] + flags)


@pytest.mark.parametrize("xml,item", [
    ({"shifu.mesh.seq": "2"}, r"\(f\)"),
])
def test_unported_config_raises(tmp_path, xml, item, monkeypatch):
    """A `shifu.mesh.seq` axis that once raised naming (f) now trains:
    the dispatcher spawns its two ranks on the CPU (an MLP has no
    attention to split, so the seq ranks compute alike) and the run ends
    with no mention of (f)."""
    import re
    argv = _shifu_files(tmp_path, xml=xml)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
         os.environ.get("PYTHONPATH", "")]))
    mesh_env = ("SHIFU_TPU_COORDINATOR", "SHIFU_TPU_NUM_PROCESSES",
                "SHIFU_TPU_PROCESS_ID")
    try:
        assert cli.main(argv + ["--device", "cpu", "--output",
                                str(tmp_path / "j")]) == 0
    finally:
        for var in mesh_env:
            os.environ.pop(var, None)
    journal = [json.loads(ln) for ln in (tmp_path / "j" / "telemetry" /
               "journal.jsonl").read_text().splitlines()]
    starts = [e for e in journal if e["kind"] == "run_start"]
    assert starts[0]["mesh"] == {"data": 1, "seq": 2, "pipe": 1, "model": 1}
    board = (tmp_path / "j" / "console.board").read_text()
    assert not re.search(item, board)
    assert board.count("model exported to") == 1


def test_a_fleet_key_leaves_the_train_command_alone(tmp_path):
    """A `shifu.fleet.*` key is the fleet's (utils/xmlconfig.
    fleet_config_from_conf): the train command trains past it, as the JAX
    overlay does, and keeps it in global-final.xml."""
    argv = _shifu_files(tmp_path, xml={"shifu.fleet.n-daemons": "3"})
    out = tmp_path / "j"
    assert cli.main(argv + ["--device", "cpu", "--output", str(out)]) == 0
    assert (out / "final_model" / "scoring.pt2").exists()
    assert "shifu.fleet.n-daemons" in (out / "global-final.xml").read_text()


def test_the_aot_pack_key_packs_the_final_model(tmp_path):
    """`shifu.serving.aot-pack` applies as in JAX: the train command's
    export sequence packs the serving ladder of the same XML into
    final_model/aot (here on the CPU), beside scoring.pt2 and model.bin
    (JAX `_export_and_pack`)."""
    xml = {"shifu.serving.aot-pack": "true",
           "shifu.serving.min-batch-bucket": "16",
           "shifu.serving.max-batch": "64"}
    argv = _shifu_files(tmp_path, xml=xml)
    out = tmp_path / "j"
    assert cli.main(argv + ["--device", "cpu", "--output", str(out)]) == 0
    final = out / "final_model"
    for name in ("scoring.pt2", "model.bin", "aot/manifest.json"):
        assert (final / name).exists(), name
    man = json.loads((final / "aot" / "manifest.json").read_text())
    assert man["buckets"] == [16, 32, 64] and man["platform"] == "cpu"
    jargs = jax_cli.build_parser().parse_args(argv)
    pargs = cli.build_parser().parse_args(argv)
    assert cli._export_aot_opts(pargs) == jax_cli._export_aot_opts(jargs)
    assert cli._export_aot_opts(pargs) == (True, (16, 32, 64))


@pytest.mark.parametrize("site,want", [("launcher.start", 1),
                                       ("train.epoch", 1)])
def test_cli_chaos_sites(tmp_path, site, want, capsys):
    argv = _shifu_files(tmp_path)
    plan = json.dumps({"faults": [{"site": site, "every": 1}]})
    out = tmp_path / "job"
    assert cli.main(argv + ["--device", "cpu", "--output", str(out),
                            "--chaos-plan", plan]) == want
    assert json.loads((out / "chaos_plan.json").read_text())["faults"][0][
        "site"] == site
    if site == "train.epoch":
        assert "training failed: ChaosError" in (
            out / "console.board").read_text()
    assert "chaos injection" in capsys.readouterr().out + (
        (out / "console.board").read_text()
        if (out / "console.board").exists() else "")


def test_a_bad_chaos_plan_fails_the_launch(tmp_path, capsys):
    argv = _shifu_files(tmp_path)
    assert cli.main(argv + ["--device", "cpu", "--chaos-plan",
                            '{"faults": [{"site": "x"}]}']) == 1
    assert "no trigger" in capsys.readouterr().err


# -- the supervisor, on a fake child ------------------------------------------

FAKE_CHILD = textwrap.dedent('''
    """A stand-in train child: attempt n plays script[n]."""
    import json, os, sys, time
    d = sys.argv[1]
    n_path = os.path.join(d, "attempts")
    n = int(open(n_path).read()) if os.path.exists(n_path) else 0
    open(n_path, "w").write(str(n + 1))
    step = json.load(open(os.path.join(d, "script.json")))[n]
    assert os.environ.get("SHIFU_TPU_PDEATHSIG") == str(os.getppid())
    for i in range(step.get("board", 0)):
        with open(os.path.join(d, "console.board"), "a") as f:
            f.write("line\\n")
    if "progress" in step:
        os.makedirs(os.path.join(d, "ckpt"), exist_ok=True)
        with open(os.path.join(d, "ckpt", "PROGRESS"), "w") as f:
            json.dump({"epoch": step["progress"], "step": 1}, f)
    time.sleep(step.get("sleep", 0))
    sys.exit(step["rc"])
''')


def _supervise(tmp_path, monkeypatch, script, **kw):
    (tmp_path / "fake_train_child.py").write_text(FAKE_CHILD)
    (tmp_path / "script.json").write_text(json.dumps(script))
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(tmp_path), os.environ.get("PYTHONPATH", "")]))
    monkeypatch.setenv("SHIFU_TPU_METRICS_DIR", str(tmp_path / "tele"))
    rc = supervisor.supervise(
        [str(tmp_path)], board_path=str(tmp_path / "console.board"),
        checkpoint_dir=str(tmp_path / "ckpt"), poll_seconds=0.05,
        module="fake_train_child", **kw)
    attempts = int((tmp_path / "attempts").read_text())
    events = [json.loads(ln) for ln in
              (tmp_path / "tele" / "journal.jsonl").read_text().splitlines()]
    obs.reset_for_tests()
    return rc, attempts, events


@pytest.mark.parametrize("first_rc", [75, 1])
def test_supervisor_restarts_a_failed_child(tmp_path, monkeypatch, first_rc):
    rc, attempts, events = _supervise(
        tmp_path, monkeypatch,
        [{"rc": first_rc, "progress": 1}, {"rc": 0, "progress": 2}])
    assert (rc, attempts) == (0, 2)
    kinds = [e["kind"] for e in events]
    assert kinds == ["supervisor_start", "supervisor_restart",
                     "supervisor_done"]
    assert events[1]["rc"] == first_rc and events[1]["progressed"] is True


def test_supervisor_timeout_exit_is_terminal(tmp_path, monkeypatch):
    rc, attempts, _ = _supervise(tmp_path, monkeypatch,
                                 [{"rc": 3}, {"rc": 0}])
    assert (rc, attempts) == (3, 1)


def test_the_budget_counts_failures_without_progress(tmp_path, monkeypatch):
    rc, attempts, events = _supervise(
        tmp_path, monkeypatch, [{"rc": 1}] * 3 + [{"rc": 0}],
        max_restarts=2)
    assert (rc, attempts) == (1, 3)
    assert events[-1]["kind"] == "supervisor_exhausted"
    # progress (the PROGRESS marker moving) resets the budget
    for f in ("attempts", "console.board"):
        if (tmp_path / f).exists():
            os.remove(tmp_path / f)
    os.remove(tmp_path / "tele" / "journal.jsonl")
    rc, attempts, _ = _supervise(
        tmp_path, monkeypatch,
        [{"rc": 1, "progress": 3}, {"rc": 1}, {"rc": 1, "progress": 4},
         {"rc": 1}, {"rc": 0}], max_restarts=2)
    assert (rc, attempts) == (0, 5)


def test_the_liveness_window_kills_a_silent_child(tmp_path, monkeypatch):
    rc, attempts, events = _supervise(
        tmp_path, monkeypatch,
        [{"rc": 0, "board": 1, "sleep": 60}, {"rc": 0, "board": 1}],
        liveness_seconds=2.0)
    assert (rc, attempts) == (0, 2)
    kinds = [e["kind"] for e in events]
    assert "supervisor_liveness_kill" in kinds
    restart = [e for e in events if e["kind"] == "supervisor_restart"][0]
    assert restart["liveness_kill"] is True and restart["rc"] == -9


def test_a_spawn_fault_is_a_failed_attempt(tmp_path, monkeypatch):
    chaos.configure(chaos.parse_plan({"faults": [
        {"site": "supervisor.spawn", "at_call": 1, "exit_code": 9}]}))
    rc, attempts, events = _supervise(tmp_path, monkeypatch, [{"rc": 0}])
    assert rc == 0 and attempts == 1  # the stub was attempt 1
    restart = [e for e in events if e["kind"] == "supervisor_restart"][0]
    assert restart["rc"] == 9


def test_checkpoint_progress_reads_the_marker_and_the_steps(tmp_path):
    d = tmp_path / "ck"
    assert supervisor.checkpoint_progress(str(d)) == -1
    (d / "12").mkdir(parents=True)
    (d / "12" / "extra.json").write_text(json.dumps({"epoch": 3}))
    assert supervisor.checkpoint_progress(str(d)) == 3
    (d / "PROGRESS").write_text(json.dumps({"epoch": 5, "step": 20}))
    assert supervisor.checkpoint_progress(str(d)) == 5


def test_pdeathsig_env_is_popped(monkeypatch):
    monkeypatch.setenv("SHIFU_TPU_PDEATHSIG", str(os.getppid()))
    cli._arm_pdeathsig()
    assert "SHIFU_TPU_PDEATHSIG" not in os.environ


def test_a_supervised_cpu_job_resumes_after_a_kill(tmp_path):
    """The real child under the supervisor: chaos kills attempt 1 at the
    start of epoch 2; the restart resumes there and ends like an unbroken
    supervised run, bitwise (the cache is hot for both)."""
    import subprocess
    argv = _shifu_files(tmp_path, epochs=3, xml={
        "shifu.data.cache-dir": str(tmp_path / "cache")})
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
         os.environ.get("PYTHONPATH", "")]))

    def run(out, plan=None):
        e = dict(env)
        if plan:
            e["SHIFU_TPU_CHAOS_PLAN"] = json.dumps(plan)
        return subprocess.run(
            [sys.executable, "-m", "shifu_tpu_torch.launcher.cli", *argv,
             "--output", str(out), "--device", "cpu", "--supervise"],
            env=e, capture_output=True, text=True, timeout=300)

    assert cli.main(argv + ["--output", str(tmp_path / "warm"),
                            "--device", "cpu"]) == 0  # the cache, hot
    plan = {"faults": [{"site": "train.epoch_start", "at_epoch": 2,
                        "action": "exit", "scope": "job", "max_times": 1}]}
    killed = run(tmp_path / "killed", plan)
    unbroken = run(tmp_path / "unbroken")
    assert killed.returncode == 0, killed.stdout + killed.stderr
    assert unbroken.returncode == 0, unbroken.stdout + unbroken.stderr
    assert "succeeded after 2 attempts" in killed.stdout

    def epochs(out):
        ev = [json.loads(ln) for ln in
              (out / "telemetry" / "journal.jsonl").read_text().splitlines()]
        return ev, {e["epoch"]: e["train_error"] for e in ev
                    if e["kind"] == "epoch"}

    kev, klosses = epochs(tmp_path / "killed")
    _uev, ulosses = epochs(tmp_path / "unbroken")
    assert klosses == ulosses and sorted(klosses) == [0, 1, 2]
    assert [e["kind"] for e in kev].count("supervisor_restart") == 1
    resumed = [e for e in kev if e["kind"] == "train_resume"]
    assert [e["epoch"] for e in resumed] == [2]
    kw = np.load(tmp_path / "killed" / "final_model" / "weights.npz")
    uw = np.load(tmp_path / "unbroken" / "final_model" / "weights.npz")
    assert sorted(kw.files) == sorted(uw.files)
    for k in kw.files:
        assert np.array_equal(kw[k], uw[k]), k


# -- the cache command --------------------------------------------------------

def _cache_fixture(tmp_path):
    from shifu_tpu_torch.config.schema import DataConfig
    from shifu_tpu_torch.data import pipeline as pipe
    schema = synthetic.make_schema(num_features=4)
    synthetic.write_files(synthetic.make_rows(200, schema, seed=1),
                          str(tmp_path / "d"), num_files=2)
    c = str(tmp_path / "c")
    pipe.load_datasets(schema, DataConfig(paths=(str(tmp_path / "d"),),
                                          cache_dir=c))
    os.remove(sorted((tmp_path / "d").iterdir())[0])
    return c


@pytest.mark.parametrize("flags", [[], ["--json"], ["--prune"],
                                   ["--prune", "--json"]])
def test_cache_command_prints_what_jax_prints(tmp_path, capsys, flags):
    import shutil
    c = _cache_fixture(tmp_path)
    c2 = str(tmp_path / "c2")
    shutil.copytree(c, c2)
    assert cli.main(["cache", c] + flags) == 0
    got = capsys.readouterr().out.replace(c, "<dir>")
    assert jax_cli.run_cache(jax_cli.build_parser().parse_args(
        ["cache", c2] + flags)) == 0
    want = capsys.readouterr().out.replace(c2, "<dir>")
    assert got == want
    assert "orphaned" in got


def test_cache_command_on_a_missing_dir(tmp_path, capsys):
    assert cli.main(["cache", str(tmp_path / "none")]) == 1
    assert "no such directory" in capsys.readouterr().err
