"""Detached jobs in the port (shifu_tpu_torch/launcher/detach.py and the
`train --detach`, `status`, `attach`, `kill` commands) on the CPU.

A detached `train --device cpu` submits and returns; `status` reads
RUNNING, `attach` follows the board to the job's exit 0, `status` then
reads FINISHED, as the JAX package's `job_state` reads the same dir.
`kill` drains a second detached job (SIGTERM, the supervisor's drain,
exit 143) and leaves no process of its tree.  `_is_our_job` accepts only
the port's command lines, and `kill --force` (the provision marker) is
not ported.  Two subprocess tests, each with a timeout.
"""

import json
import os
import subprocess
import sys
import time

import pytest

from shifu_tpu.launcher import detach as jax_detach
from shifu_tpu_torch import chaos, obs
from shifu_tpu_torch.data import synthetic
from shifu_tpu_torch.launcher import cli, detach
from shifu_tpu_torch.utils import xmlconfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CLI_ENV = ("SHIFU_TPU_CHAOS_PLAN", "SHIFU_TPU_CHAOS_STATE",
            "SHIFU_TPU_METRICS_DIR", "SHIFU_TPU_DATA_CACHE",
            "SHIFU_TPU_PDEATHSIG", detach.ENV_DETACHED)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in _CLI_ENV:
        monkeypatch.delenv(var, raising=False)
    obs.reset_for_tests()
    chaos.reset_for_tests()
    yield
    obs.reset_for_tests()
    chaos.reset_for_tests()


def _train_argv(root, epochs=2):
    schema = synthetic.make_schema(num_features=8)
    synthetic.write_files(synthetic.make_rows(900, schema, seed=5),
                          str(root / "data"), num_files=2)
    mc = {"basic": {"name": "detach"},
          "dataSet": {"targetColumnName": "target", "dataDelimiter": "|"},
          "train": {"validSetRate": 0.2, "numTrainEpochs": epochs,
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
         "shifu.liveness.seconds": "0"}, str(root / "global.xml"))
    return ["train", "--modelconfig", str(root / "ModelConfig.json"),
            "--columnconfig", str(root / "ColumnConfig.json"),
            "--data", str(root / "data"),
            "--globalconfig", str(root / "global.xml"),
            "--device", "cpu", "--timeout", "120"]


def _submit(argv, job):
    """`python -m shifu_tpu_torch.launcher.cli train ... --detach` in a
    subprocess, as an operator submits; returns its output."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "shifu_tpu_torch.launcher.cli", *argv,
         "--output", str(job), "--detach"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=60)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def _status(job, capsys):
    capsys.readouterr()
    rc = cli.main(["status", str(job)])
    return rc, json.loads(capsys.readouterr().out)


def _tree(pid):
    """pid and its descendants (Linux /proc)."""
    out, todo = [], [pid]
    while todo:
        p = todo.pop()
        out.append(p)
        try:
            with open(f"/proc/{p}/task/{p}/children") as f:
                todo += [int(k) for k in f.read().split()]
        except OSError:
            pass
    return out


def _wait_for(pred, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"no {what} within {timeout_s} s")
        time.sleep(0.05)


def test_detached_train_runs_to_exit_0(tmp_path, capsys):
    job = tmp_path / "job"
    out = _submit(_train_argv(tmp_path), job)
    assert "submitted: pid" in out and "shifu-tpu-torch attach" in out
    rec = json.loads((job / detach.JOB_FILE).read_text())
    assert "--supervise" in rec["argv"] and "--detach" not in rec["argv"]
    assert rec["argv"][rec["argv"].index("--device") + 1] == "cpu"
    rc, st = _status(job, capsys)
    assert rc == 0 and st["state"] == "RUNNING" and st["pid"] == rec["pid"]
    capsys.readouterr()
    assert cli.main(["attach", str(job)]) == 0
    followed = capsys.readouterr().out
    assert "Epoch 0:" in followed and "Epoch 1:" in followed
    assert followed.rstrip().endswith("job finished (exit 0)")
    rc, st = _status(job, capsys)
    assert rc == 0 and (st["state"], st["exit"]) == ("FINISHED", 0)
    assert st["telemetry"]["last_event"] == "supervisor_done"
    assert st["checkpoints"]["kept_steps"]
    # the JAX package reads the same job dir the same way
    want = jax_detach.job_state(str(job))
    assert st == json.loads(json.dumps(want))
    assert (job / "final_model" / "topology.json").exists()
    assert (job / detach.LOG_FILE).stat().st_size > 0


def test_kill_drains_the_tree_and_the_job_resumes(tmp_path, capsys):
    job = tmp_path / "job"
    # epoch 0's checkpoint save stalls 2 s: the SIGTERM lands there and the
    # child drains at the next chunk boundary
    plan = {"faults": [{"site": "checkpoint.save", "at_call": 1,
                        "action": "delay", "delay_s": 2, "scope": "job"}]}
    argv = _train_argv(tmp_path, epochs=3)
    _submit(argv + ["--chaos-plan", json.dumps(plan)], job)
    pid = json.loads((job / detach.JOB_FILE).read_text())["pid"]
    board = job / "console.board"
    _wait_for(lambda: board.exists() and "Epoch 0:" in board.read_text(),
              90, "epoch 0 on the board")
    tree = _tree(pid)
    assert len(tree) >= 2  # the supervisor and its attempt
    capsys.readouterr()
    t0 = time.monotonic()
    assert cli.main(["kill", str(job)]) == 0
    took = time.monotonic() - t0
    assert f"job pid {pid} terminated" in capsys.readouterr().out
    assert took < 10.0
    _wait_for(lambda: not any(detach._alive(p) for p in tree), 5,
              "end of every process of the tree")
    rc, st = _status(job, capsys)
    assert st["state"] == "FAILED" and st["exit"] == 143
    recs = obs.read_journal(str(job / "telemetry" / "journal.jsonl"))
    assert any(r["kind"] == "preemption_grace" for r in recs)
    # killing a job that has ended: nothing to signal
    capsys.readouterr()
    assert cli.main(["kill", str(job)]) == 0
    assert "is not running" in capsys.readouterr().out
    # a plain train on the same --output resumes from the drain's save
    os.environ.pop("SHIFU_TPU_CHAOS_PLAN", None)
    assert cli.main(argv + ["--output", str(job)]) == 0
    recs = obs.read_journal(str(job / "telemetry" / "journal.jsonl"))
    resumes = [r for r in recs if r["kind"] == "train_resume"]
    assert resumes and resumes[-1]["epoch"] == 1


def test_status_of_a_dead_daemon_and_of_no_job(tmp_path, capsys):
    rc, st = _status(tmp_path, capsys)
    assert rc == 1 and st["state"] == "UNKNOWN"
    # a pid that cannot run (past Linux's largest pid_max), with no status
    # file: DEAD
    (tmp_path / detach.JOB_FILE).write_text(json.dumps(
        {"pid": (1 << 22) + 4321, "argv": [], "submitted_at": 1.0,
         "host": os.uname().nodename}))
    (tmp_path / "console.board").write_text("Epoch 0: x\n")
    rc, st = _status(tmp_path, capsys)
    assert rc == 0 and st["state"] == "DEAD" and st["exit"] is None
    assert st["last_progress"] == "Epoch 0: x"
    assert st == jax_detach.job_state(str(tmp_path))
    capsys.readouterr()
    assert cli.main(["attach", str(tmp_path)]) == 1
    assert "job state: DEAD" in capsys.readouterr().out
    assert cli.main(["kill", str(tmp_path)]) == 0  # not running


def test_is_our_job_accepts_only_the_ports_command_lines(monkeypatch):
    me = {"host": os.uname().nodename}
    lines = {
        b"python\0-m\0shifu_tpu_torch.launcher.cli\0train\0": True,
        b"/usr/bin/shifu-tpu-torch\0train\0": True,
        b"python\0-m\0shifu_tpu.launcher.cli\0train\0": False,
        b"/usr/bin/shifu-tpu\0train\0": False,
        b"python\0-c\0pass\0": False,
    }
    for cmd, ours in lines.items():
        monkeypatch.setattr(detach, "_cmdline", lambda pid, c=cmd: c)
        assert detach._is_our_job(os.getpid(), me) is ours, cmd
    assert not detach._is_our_job(os.getpid(), {"host": "elsewhere"})


def test_kill_refuses_a_jax_dispatcher(tmp_path, monkeypatch, capsys):
    (tmp_path / detach.JOB_FILE).write_text(json.dumps(
        {"pid": os.getpid(), "argv": [], "submitted_at": 1.0,
         "host": os.uname().nodename}))
    monkeypatch.setattr(detach, "_cmdline", lambda pid: (
        b"python\0-m\0shifu_tpu.launcher.cli\0train\0"))
    capsys.readouterr()
    assert cli.main(["kill", str(tmp_path)]) == 1
    assert "refusing to signal it" in capsys.readouterr().out


def test_kill_force_is_not_ported(tmp_path):
    with pytest.raises(NotImplementedError, match=r"\(f\)"):
        cli.main(["kill", str(tmp_path), "--force"])


def test_write_status_only_from_the_recorded_pid(tmp_path):
    (tmp_path / detach.JOB_FILE).write_text(json.dumps(
        {"pid": os.getpid() + 1, "argv": []}))
    detach.write_status(str(tmp_path), 0)
    assert not (tmp_path / detach.STATUS_FILE).exists()
    (tmp_path / detach.JOB_FILE).write_text(json.dumps(
        {"pid": os.getpid(), "argv": []}))
    detach.write_status(str(tmp_path), 75)
    st = json.loads((tmp_path / detach.STATUS_FILE).read_text())
    assert st["exit"] == 75
    assert detach.job_state(str(tmp_path))["state"] == "FAILED"


def test_main_records_the_daemons_exit_also_through_systemexit(
        tmp_path, monkeypatch):
    (tmp_path / detach.JOB_FILE).write_text(json.dumps(
        {"pid": os.getpid(), "argv": []}))
    monkeypatch.setenv(detach.ENV_DETACHED, str(tmp_path))

    def drained(args):
        raise SystemExit(143)

    monkeypatch.setattr(cli, "run_train", drained)
    with pytest.raises(SystemExit):
        cli.main(["train", "--modelconfig", "m", "--columnconfig", "c"])
    st = json.loads((tmp_path / detach.STATUS_FILE).read_text())
    assert st["exit"] == 143
    monkeypatch.setattr(cli, "run_train", lambda args: 0)
    assert cli.main(["train", "--modelconfig", "m", "--columnconfig",
                     "c"]) == 0
    assert json.loads((tmp_path / detach.STATUS_FILE).read_text())[
        "exit"] == 0
