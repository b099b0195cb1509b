"""The operator's views in the port (shifu_tpu_torch/obs/render.py,
obs/timeline.py, obs/aggregate.py and their commands in launcher/cli.py)
against the JAX package's renderers, on the CPU.

Three journals: one the port's `train` command wrote (its first epoch
traced by the flight recorder, under a chaos plan), one the JAX package's
`train` command wrote from the same Shifu files, and one a port scoring
daemon wrote with a drift alert and a firing p99 SLO objective.  Every
view (`metrics`, `profile`, `trace`, `top`, `drift`, `timeline`,
`chaos-verify`) prints the same `--json` and the same text from both
packages' commands on each file, and exits with the same code.  Each
view is read in process through `main([...])`; one subprocess checks that
the views import no torch.
"""

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from shifu_tpu import obs as jax_obs
from shifu_tpu.launcher import cli as jax_cli
from shifu_tpu_torch import chaos, obs
from shifu_tpu_torch.data import synthetic
from shifu_tpu_torch.launcher import cli
from shifu_tpu_torch.utils import xmlconfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# what a `train` command exports into os.environ
_CLI_ENV = ("SHIFU_TPU_CHAOS_PLAN", "SHIFU_TPU_CHAOS_STATE",
            "SHIFU_TPU_METRICS_DIR", "SHIFU_TPU_DATA_CACHE",
            "SHIFU_TPU_PDEATHSIG")

# a drill that fires without failing the run: a short delay at epoch 1's
# start
PLAN = {"faults": [{"site": "train.epoch_start", "at_epoch": 1,
                    "action": "delay", "delay_s": 0.01, "scope": "job",
                    "max_times": 1}]}


def _reset_all():
    from shifu_tpu import chaos as jax_chaos
    for var in _CLI_ENV:
        os.environ.pop(var, None)
    for m in (obs, jax_obs, chaos, jax_chaos):
        m.reset_for_tests()


@pytest.fixture(autouse=True)
def _clean():
    _reset_all()
    yield
    _reset_all()


def _shifu_files(root):
    schema = synthetic.make_schema(num_features=8)
    synthetic.write_files(synthetic.make_rows(900, schema, seed=5),
                          str(root / "data"), num_files=2)
    mc = {"basic": {"name": "views"},
          "dataSet": {"targetColumnName": "target", "dataDelimiter": "|"},
          "train": {"validSetRate": 0.2, "numTrainEpochs": 2,
                    "algorithm": "NN",
                    "params": {"NumHiddenLayers": 1, "NumHiddenNodes": [8],
                               "ActivationFunc": ["relu"],
                               "LearningRate": 0.01, "Propagation": "Q",
                               "Loss": "squared"}}}
    cc = [{"columnNum": c.index, "columnName": c.name,
           "columnFlag": "Target" if c.is_target else None,
           "columnType": "N", "finalSelect": c.is_selected}
          for c in schema.columns]
    (root / "ModelConfig.json").write_text(json.dumps(mc))
    (root / "ColumnConfig.json").write_text(json.dumps(cc))
    xmlconfig.write_configuration_xml(
        {"shifu.application.batch-size": "64",
         "shifu.obs.trace-epochs": "first",
         "shifu.checkpoint.save-seconds": "0",
         "shifu.liveness.seconds": "0"}, str(root / "global.xml"))
    return ["train", "--modelconfig", str(root / "ModelConfig.json"),
            "--columnconfig", str(root / "ColumnConfig.json"),
            "--data", str(root / "data"),
            "--globalconfig", str(root / "global.xml"),
            "--chaos-plan", json.dumps(PLAN)]


def _serving_journal(root):
    """A port daemon's journal: healthy traffic, then feature 3 shifted
    (one drift alert), labelled feedback, and a slowed dispatch under a
    5 ms p99 objective (one firing slo_alert with its one-shot trace)."""
    import torch  # noqa: F401 — the daemon's engine

    from shifu_tpu_torch.config import schema as ps
    from shifu_tpu_torch.data import pipeline as pipe
    from shifu_tpu_torch.data import reader
    from shifu_tpu_torch.export.artifact import save_artifact
    from shifu_tpu_torch.runtime import serve
    from shifu_tpu_torch.train import loop

    schema = synthetic.make_schema(8)
    job = ps.JobConfig(
        schema=schema, data=ps.DataConfig(batch_size=128),
        model=ps.ModelSpec(hidden_nodes=(8,), activations=("relu",),
                           compute_dtype="float32"),
        train=ps.TrainConfig(epochs=1, optimizer=ps.OptimizerConfig(
            name="adam", learning_rate=0.02))).validate()
    cols = reader.project_columns(synthetic.make_rows(2000, schema, seed=3),
                                  schema)
    full = pipe.TabularDataset(cols["features"], cols["target"],
                               cols["weight"])
    tr, va = full.take(np.arange(1500)), full.take(np.arange(1500, 2000))
    res = loop.train(job, tr, va, console=lambda s: None, device="cpu")
    art = save_artifact(res.state.model, job.model, job.schema,
                        str(root / "art"),
                        baseline_profile=res.baseline_profile)
    tele = root / "serve"
    obs.configure(str(tele), flush_every=1)
    cfg = ps.ServingConfig(
        report_every_s=0.0, max_batch=64, min_batch_bucket=4,
        latency_budget_ms=1.0, slo_p99_ms=5.0, slo_fast_window_s=0.5,
        slo_slow_window_s=1.0, slo_burn_threshold=2.0,
        drift=ps.DriftConfig(fast_window_s=0.5, slow_window_s=1.0,
                             min_rows=100, psi_threshold=0.25,
                             score_kl_threshold=0.0))
    daemon = serve.ScoringDaemon(art, config=cfg, device="cpu").start()
    rng = np.random.default_rng(9)

    def journaled(kind):
        return any(r["kind"] == kind for r in
                   obs.read_journal(str(tele / "journal.jsonl")))

    def until(kind, send, least_s, most_s):
        """`send()` for at least `least_s` and until `kind` is journaled
        (at most `most_s`: a loaded host is slow)."""
        t0 = time.monotonic()
        while time.monotonic() - t0 < least_s or (
                not journaled(kind) and time.monotonic() - t0 < most_s):
            send()

    def frame(shift):
        x = tr.features[rng.integers(0, 1500, 300)].copy()
        x[:, 3] += shift
        daemon.score_batch(x)
        time.sleep(0.05)

    try:
        until("drift_report", lambda: frame(0.0), 1.5, 10.0)
        until("drift_alert", lambda: frame(3.0), 1.5, 10.0)
        scores = daemon.score_batch(va.features)[:, 0]
        daemon.feedback(scores, va.target[:, 0], va.weight[:, 0])
        daemon.drift_flush()
        chaos.configure(chaos.parse_plan({"faults": [
            {"site": "runtime.serve.dispatch", "every": 1,
             "action": "delay", "delay_s": 0.012}]}))
        until("device_profile",
              lambda: daemon.score(tr.features[0], timeout=30), 0.0, 20.0)
        chaos.reset_for_tests()
        time.sleep(0.3)
    finally:
        daemon.stop()
    obs.flush()
    return tele


@pytest.fixture(scope="module")
def journals(tmp_path_factory):
    """{name: dir}: the port's train job, the JAX package's, the port's
    serving telemetry."""
    root = tmp_path_factory.mktemp("views")
    _reset_all()
    argv = _shifu_files(root)
    assert cli.main(argv + ["--output", str(root / "port"),
                            "--device", "cpu"]) == 0
    _reset_all()
    assert jax_cli.main(argv + ["--output", str(root / "jax")]) == 0
    _reset_all()
    serve_dir = _serving_journal(root)
    _reset_all()
    return {"port": root / "port", "jax": root / "jax", "serve": serve_dir}


def _run(main, argv, capsys):
    capsys.readouterr()
    rc = main(argv)
    return rc, capsys.readouterr().out


VIEWS = {
    "metrics": [],
    "profile": [],
    "trace": [],
    "top": ["--once"],
    "drift": [],
    "timeline": [],
    "timeline-incident": ["--incident"],
    "chaos-verify": [],
}


@pytest.mark.parametrize("fmt", ["json", "text"])
@pytest.mark.parametrize("name", ["port", "jax", "serve"])
@pytest.mark.parametrize("view", sorted(VIEWS))
def test_view_equals_jax_renderer(journals, capsys, view, name, fmt):
    command = view.split("-incident")[0]
    argv = [command, str(journals[name]), *VIEWS[view]]
    if fmt == "json":
        argv.append("--json")
    rc, got = _run(cli.main, argv, capsys)
    jrc, want = _run(jax_cli.main, argv, capsys)
    assert rc == jrc
    assert got == want
    if fmt == "json":
        data = json.loads(got)
        if command in ("metrics", "profile", "trace", "top", "drift",
                       "chaos-verify"):
            assert data["journal"].startswith(str(journals[name]))
    # a serving journal holds no drill: chaos-verify finds it INCOMPLETE
    assert rc == (1 if command == "chaos-verify" and name == "serve" else 0)


def test_port_journal_renders_the_flight_recorder_and_no_compiles(
        journals, capsys):
    rc, out = _run(cli.main, ["trace", str(journals["port"]), "--json"],
                   capsys)
    trace = json.loads(out)
    assert rc == 0 and trace["profiles"], trace
    assert trace["profiles"][0]["epoch"] == 0
    assert trace["profiles"][0]["kernels"]
    assert len(trace["watermarks"]) == 2
    _, out = _run(cli.main, ["profile", str(journals["port"]), "--json"],
                  capsys)
    prof = json.loads(out)
    assert prof["compiled_functions"] == {}
    assert [e["epoch"] for e in prof["epochs"]] == [0, 1]
    assert prof["device"]["profiles"] == 1
    _, text = _run(cli.main, ["profile", str(journals["port"])], capsys)
    assert "compiled functions" not in text and "device:" in text
    _, out = _run(cli.main, ["chaos-verify", str(journals["port"]),
                             "--json"], capsys)
    rep = json.loads(out)
    assert rep["verdict"] == "PASS"
    assert rep["injected"] == {"train.epoch_start": 1}


def test_serving_journal_shows_drift_slo_and_the_incident(journals,
                                                          capsys):
    d = str(journals["serve"])
    _, out = _run(cli.main, ["top", d, "--once", "--json"], capsys)
    top = json.loads(out)
    assert top["mode"] == "serving"
    assert top["slo"]["alerts_total"] == 1
    # the drift alert fired on the shifted rows; the unshifted rows of the
    # SLO drill resolved it
    assert top["drift"]["alerts_total"] == 1
    assert top["incidents"]["total"] == 1
    _, out = _run(cli.main, ["drift", d, "--json"], capsys)
    assert json.loads(out)
    _, out = _run(cli.main, ["drift", d, "--json", "--feature", "f3"],
                  capsys)
    _, want = _run(jax_cli.main, ["drift", d, "--json", "--feature", "f3"],
                   capsys)
    assert out == want
    _, out = _run(cli.main, ["timeline", d, "--incident", "--json"], capsys)
    tl = json.loads(out)
    assert [i["kind"] for i in tl["incidents"]] == ["slo_alert"]


def test_no_journal_fails_every_view(tmp_path, capsys):
    for view in ("metrics", "profile", "trace", "top", "drift", "timeline",
                 "chaos-verify"):
        rc, _ = _run(cli.main, [view, str(tmp_path)], capsys)
        jrc, _ = _run(jax_cli.main, [view, str(tmp_path)], capsys)
        assert rc == jrc == 1, view


# -- chaos-verify's verdicts ------------------------------------------------------

def _drill(tmp_path, events, plan):
    d = tmp_path / "drill"
    (d / "telemetry").mkdir(parents=True)
    with open(d / "telemetry" / "journal.jsonl", "w") as f:
        for i, e in enumerate(events):
            f.write(json.dumps({"ts": 1000.0 + i, "seq": i, **e}) + "\n")
    (d / "chaos_plan.json").write_text(json.dumps(plan))
    return str(d)


def _fault(site):
    return {"site": site, "at_call": 1}


@pytest.mark.parametrize("case,verdict", [
    ("pass", "PASS"), ("glob", "PASS"), ("silent", "SILENT_SITES"),
    ("incomplete", "INCOMPLETE"), ("supervised", "PASS")])
def test_chaos_verify_verdicts_and_exit_codes(tmp_path, capsys, case,
                                              verdict):
    inject = {"kind": "chaos_inject", "site": "checkpoint.save"}
    done = {"kind": "run_end", "exit": 0}
    events, sites = {
        "pass": ([inject, done], ["checkpoint.save"]),
        "glob": ([{"kind": "chaos_inject", "site": "fsio.read"}, done],
                 ["fsio.*"]),
        "silent": ([inject, done], ["checkpoint.save", "train.epoch"]),
        "incomplete": ([inject, {"kind": "run_end", "exit": 1}],
                       ["checkpoint.save"]),
        "supervised": ([inject, {"kind": "run_end", "exit": 17},
                        {"kind": "supervisor_restart", "rc": 17},
                        {"kind": "train_resume", "epoch": 1},
                        {"kind": "supervisor_done"}],
                       ["checkpoint.save"]),
    }[case]
    d = _drill(tmp_path, events, {"faults": [_fault(s) for s in sites]})
    rc, out = _run(cli.main, ["chaos-verify", d, "--json"], capsys)
    jrc, want = _run(jax_cli.main, ["chaos-verify", d, "--json"], capsys)
    assert out == want and rc == jrc == (0 if verdict == "PASS" else 1)
    assert json.loads(out)["verdict"] == verdict
    rc, text = _run(cli.main, ["chaos-verify", d], capsys)
    _, jtext = _run(jax_cli.main, ["chaos-verify", d], capsys)
    assert text == jtext and text.startswith(f"chaos-verify: {verdict}")


# -- top over two dirs, one with a stale lease ----------------------------------

def test_top_over_two_dirs_marks_the_stale_member_down(journals, tmp_path,
                                                       capsys, monkeypatch):
    live, dead = tmp_path / "member-0", tmp_path / "member-1"
    for d in (live, dead):
        shutil.copytree(journals["serve"], d)
    journal = obs.read_journal(str(live / "journal.jsonl"))
    now = journal[-1]["ts"] + 30.0
    # a hand-written lease: member-1 beat last 30 s ago, ttl 5 s; member-0
    # beat just now
    (live / "lease.json").write_text(json.dumps(
        {"member": "member-0", "ts": now - 0.5, "ttl_s": 5.0,
         "host": "h0"}))
    (dead / "lease.json").write_text(json.dumps(
        {"member": "member-1", "ts": now - 30.0, "ttl_s": 5.0,
         "host": "h1"}))
    monkeypatch.setattr(time, "time", lambda: now)
    for extra in ([], ["--json"]):
        argv = ["top", str(live), str(dead), "--once", *extra]
        rc, got = _run(cli.main, argv, capsys)
        jrc, want = _run(jax_cli.main, argv, capsys)
        assert rc == jrc == 0 and got == want
    fleet = json.loads(got)["fleet"]
    assert fleet["daemons"] == 2 and fleet["down"] == 1
    assert fleet["hosts"] == {"h0": {"members": 1, "down": 0},
                              "h1": {"members": 1, "down": 1}}
    assert "DOWN" in _run(cli.main, ["top", str(dead), "--once"],
                          capsys)[1]
    # --stale-after overrides the lease's ttl: 60 s keeps member-1 up
    argv = ["top", str(live), str(dead), "--once", "--json",
            "--stale-after", "60"]
    _, got = _run(cli.main, argv, capsys)
    _, want = _run(jax_cli.main, argv, capsys)
    assert got == want and json.loads(got)["fleet"]["down"] == 0


def test_aggregate_helpers_equal_jax():
    from shifu_tpu.obs import aggregate as jax_agg
    from shifu_tpu_torch.obs import aggregate

    rows = [{"host": "a", "rank": 0, "input_s": 1.5, "epoch_s": 3.0,
             "valid_s": 0.2, "order_digest": "x"},
            {"host": "b", "rank": 1, "input_s": 2.25, "epoch_s": 3.0,
             "valid_s": 0.25, "order_digest": "x", "ingest_bytes": 2e6,
             "ingest_s": 1.0}]
    assert aggregate.skew_line(3, rows) == jax_agg.skew_line(3, rows)
    for key in ("order_digest", "shard_digest"):
        assert aggregate.digest_agreement(rows, key) == \
            jax_agg.digest_agreement(rows, key)
    rows[1]["order_digest"] = "y"
    assert aggregate.digest_agreement(rows, "order_digest") is False
    row = aggregate.host_summary(1.23456, 2.0, 0.5, extra=1)
    assert row == {"host": os.uname().nodename, "rank": 0, "input_s": 1.2346,
                   "epoch_s": 2.0, "valid_s": 0.5, "extra": 1}


def test_timeline_of_a_single_host_journal_has_no_offsets(journals):
    from shifu_tpu.obs import timeline as jax_tl
    from shifu_tpu_torch.obs import timeline

    d = str(journals["serve"])
    assert timeline.discover_journals(d) == jax_tl.discover_journals(d)
    got = timeline.timeline_summary(d)
    assert got == jax_tl.timeline_summary(d)
    assert got["offsets"] == {}
    assert timeline.render_timeline_text(got) == \
        jax_tl.render_timeline_text(got)


# -- the views import no torch ----------------------------------------------------

def test_views_import_no_torch(journals):
    """Every view and job command in a fresh interpreter: torch stays
    unimported (each reads files only, safe against a live job)."""
    script = (
        "import sys, io, contextlib\n"
        "from shifu_tpu_torch.launcher import cli\n"
        "port, serve = sys.argv[1], sys.argv[2]\n"
        "runs = [['metrics', port], ['profile', port], ['trace', port],\n"
        "        ['top', serve, '--once'], ['top', port, serve, '--once'],\n"
        "        ['drift', serve], ['timeline', serve, '--incident'],\n"
        "        ['chaos-verify', port], ['status', port]]\n"
        "for argv in runs:\n"
        "    with contextlib.redirect_stdout(io.StringIO()):\n"
        "        cli.main(argv)\n"
        "bad = [m for m in sys.modules if m == 'torch'\n"
        "       or m.startswith('torch.')]\n"
        "print('torch modules:', len(bad))\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", script, str(journals["port"]),
         str(journals["serve"])], capture_output=True, text=True, env=env,
        cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "torch modules: 0" in proc.stdout
