"""`train --devices N` and `shifu.mesh.*` through the port's operator
command (shifu_tpu_torch/launcher/cli.py, parallel/launch.py): the
dispatcher spawns gloo ranks on the CPU, the chief alone writes the job's
files, and the run equals a one-device run; the pod flags still raise.

Tolerances, two epochs of the 8-feature MLP on the int8 wire: the final
valid_auc within 1e-4 and the artifacts' scores within 1e-5 of the
`--devices 1` run (the same math, other reduction orders).
"""

import json
import os

import numpy as np
import pytest

from shifu_tpu.launcher import cli as jax_cli
from shifu_tpu_torch import chaos, obs
from shifu_tpu_torch.data import synthetic
from shifu_tpu_torch.launcher import cli
from shifu_tpu_torch.utils import xmlconfig

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XML = {"shifu.data.device-resident-bytes": "0",
       "shifu.application.batch-size": "64",
       "shifu.data.wire-dtype": "int8",
       "shifu.checkpoint.save-seconds": "0"}
_CLI_ENV = ("SHIFU_TPU_CHAOS_PLAN", "SHIFU_TPU_CHAOS_STATE",
            "SHIFU_TPU_METRICS_DIR", "SHIFU_TPU_DATA_CACHE",
            "SHIFU_TPU_PDEATHSIG", "SHIFU_TPU_COORDINATOR",
            "SHIFU_TPU_NUM_PROCESSES", "SHIFU_TPU_PROCESS_ID")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in _CLI_ENV:
        monkeypatch.delenv(var, raising=False)
    # the ranks run `python -m shifu_tpu_torch.launcher.cli`
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        p for p in (_ROOT, os.environ.get("PYTHONPATH")) if p))
    obs.reset_for_tests()
    chaos.reset_for_tests()
    yield
    for var in _CLI_ENV:
        os.environ.pop(var, None)
    obs.reset_for_tests()
    chaos.reset_for_tests()


def _shifu_files(tmp_path, xml=None, rows=900, epochs=2):
    schema = synthetic.make_schema(num_features=8)
    synthetic.write_files(synthetic.make_rows(rows, schema, seed=7),
                          str(tmp_path / "data"), num_files=3)
    mc = {"basic": {"name": "mesh"},
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
    xmlconfig.write_configuration_xml(dict(XML, **(xml or {})),
                                      str(tmp_path / "global.xml"))
    return ["train", "--modelconfig", str(tmp_path / "ModelConfig.json"),
            "--columnconfig", str(tmp_path / "ColumnConfig.json"),
            "--data", str(tmp_path / "data"),
            "--globalconfig", str(tmp_path / "global.xml")]


def _journal(job_dir):
    path = job_dir / "telemetry" / "journal.jsonl"
    return [json.loads(ln) for ln in path.read_text().splitlines()]


def test_devices_two_on_the_cpu_equals_devices_one(tmp_path, capsys):
    """Two gloo ranks train the job the one-device run trains: one
    journal, board, metrics file and artifact, the chief's; the same
    final valid_auc and artifact scores (module docstring)."""
    from shifu_tpu_torch.export.scorer import TorchScorer

    argv = _shifu_files(tmp_path)
    one, two = tmp_path / "one", tmp_path / "two"
    assert cli.main(argv + ["--device", "cpu", "--devices", "1",
                            "--output", str(one)]) == 0
    assert cli.main(argv + ["--device", "cpu", "--devices", "2",
                            "--output", str(two)]) == 0
    capsys.readouterr()
    for name in ("final_model", "metrics.jsonl", "console.board",
                 "global-final.xml", "job-config.json", "tmp_model"):
        assert (two / name).exists(), name
    assert sorted(os.listdir(two / "telemetry")) == sorted(
        os.listdir(one / "telemetry"))
    journal = _journal(two)
    starts = [e for e in journal if e["kind"] == "run_start"]
    assert len(starts) == 1  # the chief's alone
    assert starts[0]["devices"] == 2 and starts[0]["processes"] == 2
    assert starts[0]["mesh"] == {"data": 2, "seq": 1, "pipe": 1, "model": 1}
    train_start = [e for e in journal if e["kind"] == "train_start"]
    assert [(e["processes"], e["devices"]) for e in train_start] == [(2, 2)]
    assert sum(e["kind"] == "epoch" for e in journal) == 2
    board = (two / "console.board").read_text()
    assert board.count("model exported to") == 1
    assert "devices=2" in board.splitlines()[0]

    m1, m2 = ([json.loads(ln) for ln in (d / "metrics.jsonl").read_text()
               .splitlines()] for d in (one, two))
    assert [m["epoch"] for m in m2] == [0, 1]
    for a, b in zip(m1, m2):
        assert abs(a["valid_auc"] - b["valid_auc"]) <= 1e-4
        assert b["train_error"] == pytest.approx(a["train_error"], rel=1e-4)
    rows = np.random.default_rng(0).normal(size=(64, 8)).astype(np.float32)
    s1 = TorchScorer(str(one / "final_model"), device="cpu").compute_batch(
        rows)
    s2 = TorchScorer(str(two / "final_model"), device="cpu").compute_batch(
        rows)
    np.testing.assert_allclose(s2, s1, rtol=0, atol=1e-5)
    assert sorted(os.listdir(one / "final_model")) == sorted(
        os.listdir(two / "final_model"))


def test_a_mesh_larger_than_the_devices_exits_1_as_in_jax(tmp_path, capsys):
    argv = _shifu_files(tmp_path, xml={"shifu.mesh.data": "2"})
    assert jax_cli.main(argv + ["--devices", "1", "--output",
                                str(tmp_path / "jax")]) == 1
    assert cli.main(argv + ["--device", "cpu", "--devices", "1",
                            "--output", str(tmp_path / "port")]) == 1
    capsys.readouterr()
    want = (tmp_path / "jax" / "console.board").read_text().splitlines()[-1]
    got = (tmp_path / "port" / "console.board").read_text().splitlines()[-1]
    assert "needs 2 devices, have 1" in want
    assert got.split("]", 1)[-1] == want.split("]", 1)[-1]


def test_model_axis_and_sharding_rules_through_the_command(tmp_path,
                                                         capsys):
    """`shifu.mesh.model=2` with a `shifu.sharding.rules` entry trains on
    two ranks (the hidden kernel split over `model`, all-gathered where
    layer 0 uses it) the job a one-device run trains (module docstring's
    tolerances)."""
    from shifu_tpu_torch.export.scorer import TorchScorer

    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    one_argv = _shifu_files(tmp_path / "a")
    two_argv = _shifu_files(tmp_path / "b", xml={
        "shifu.mesh.data": "1", "shifu.mesh.model": "2",
        "shifu.sharding.rules": ".*hidden_layer0.*kernel.*=none,model"})
    one, two = tmp_path / "one", tmp_path / "two"
    assert cli.main(one_argv + ["--device", "cpu", "--output",
                                str(one)]) == 0
    assert cli.main(two_argv + ["--device", "cpu", "--output",
                                str(two)]) == 0
    capsys.readouterr()
    starts = [e for e in _journal(two) if e["kind"] == "run_start"]
    assert starts[0]["mesh"] == {"data": 1, "seq": 1, "pipe": 1, "model": 2}
    m1, m2 = ([json.loads(ln) for ln in (d / "metrics.jsonl").read_text()
               .splitlines()] for d in (one, two))
    assert [m["epoch"] for m in m2] == [0, 1]
    for a, b in zip(m1, m2):
        assert abs(a["valid_auc"] - b["valid_auc"]) <= 1e-4
        assert b["train_error"] == pytest.approx(a["train_error"], rel=1e-4)
    rows = np.random.default_rng(0).normal(size=(64, 8)).astype(np.float32)
    s1, s2 = (TorchScorer(str(d / "final_model"), device="cpu")
              .compute_batch(rows) for d in (one, two))
    np.testing.assert_allclose(s2, s1, rtol=0, atol=1e-5)


@pytest.mark.parametrize("flags", [["--num-processes", "2"],
                                   ["--hosts", "local:2"],
                                   ["--devices", "2", "--hosts", "h1,h2"]])
def test_the_pod_flags_still_raise(tmp_path, flags):
    argv = _shifu_files(tmp_path)
    with pytest.raises(NotImplementedError, match=r"not ported yet.*\(f\)"):
        cli.main(argv + ["--device", "cpu", "--output",
                         str(tmp_path / "j")] + flags)


def test_supervise_restarts_the_gang_as_one_child(tmp_path, capsys):
    """A rank that dies after epoch 0 takes its gang down; `--supervise`
    restarts the gang, which resumes from the chief's checkpoint and
    finishes the run."""
    argv = _shifu_files(tmp_path)
    plan = json.dumps({"faults": [{"site": "train.epoch", "at_epoch": 0,
                                   "action": "exit", "scope": "job",
                                   "max_times": 1}]})
    out = tmp_path / "sup"
    assert cli.main(argv + ["--device", "cpu", "--devices", "2",
                            "--supervise", "--chaos-plan", plan,
                            "--output", str(out)]) == 0
    capsys.readouterr()
    journal = _journal(out)
    kinds = [e["kind"] for e in journal]
    assert kinds.count("supervisor_restart") == 1
    # the chief journals the fault when it fired there, else the broken
    # collective that ended its attempt
    assert kinds.count("chaos_inject") + kinds.count("run_error") == 1
    resumes = [e for e in journal if e["kind"] == "train_resume"]
    assert [e["epoch"] for e in resumes] == [1]
    assert [e["devices"] for e in journal if e["kind"] == "run_start"] \
        == [2, 2]
    epochs = [json.loads(ln)["epoch"] for ln in
              (out / "metrics.jsonl").read_text().splitlines()]
    assert epochs == [1]  # this attempt's epochs, as in JAX
