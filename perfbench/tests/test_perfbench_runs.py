"""Whole runs of the harness on the CPU at small sizes (the widths are the
configurations'; rows and batches are cut): each driver's program output
agrees with the reference, a cell and a metric added as files alone are
found and run, the control and each fault the cells can have come out as
not correct, and the command refuses a machine without a card."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from perfbench import run
from perfbench.core import manifest

SMALL = {"ft-b2-d128.train": {"rows": 2048, "batch_rows": 256,
                              "warm_steps": 1, "trace_seconds": 0.2},
         "ft-b3-d192.score": {"pool_rows": 1500, "batch_rows": 256,
                              "warm_calls": 1, "trace_seconds": 0.2}}
SEED = 2**31 + 5


def _run(cell, trace=False, seed=SEED, **kw):
    return run.execute(cell, seed, 0.3, trace, "cpu",
                       overrides=SMALL[cell], **kw)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_program_agrees_with_the_reference(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    wanted = {m["name"] for m in manifest.end_to_end(manifest.load(), cell)}
    assert set(r["metrics"]) == wanted
    assert list(r)[list(r).index("checks") - 1] in ("device", "breakdown")
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_traced_run_is_judged_alike(cell):
    r = _run(cell, trace=True, seed=SEED + 1)
    assert r["correct"], r["checks"]
    # the CPU's trace holds no device work: the device metrics stay out
    assert all("idle" not in k and "roofline" not in k for k in r["metrics"])
    assert "busy_s" in r["device"] and "window_s" in r["device"]


def test_a_cell_and_a_metric_added_as_files_alone(tmp_path):
    base = tmp_path / "perfbench"
    for sub in ("configs", "traffic", "workloads", "metrics"):
        shutil.copytree(os.path.join(manifest.HERE, sub), base / sub)
    bench = manifest.load()
    bench["workloads"].append(
        {"name": "ft-b2-d128.score", "config": "ft-rtdl-b2-d128",
         "traffic": "bulk_score_4096", "chips": 1, "why": "added by files"})
    bench["per_layer"].append(
        {"name": "calls_per_s", "unit": "1/s", "better": "higher",
         "source": "host_clock", "layer": "scorer", "moves":
         "score_rows_per_s", "workloads": ["ft-b2-d128.score"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and "ft-b3-d192.score" in m["workloads"]:
            m["workloads"].append("ft-b2-d128.score")
    (base / "workloads" / "ft-b2-d128.score.json").write_text(json.dumps(
        {"config": "ft-rtdl-b2-d128", "traffic": "bulk_score_4096",
         "limits": {"score_gap": 0.05}}))
    (base / "metrics" / "calls_per_s.py").write_text(
        "def read(run):\n    return run['calls'] / run['window_s']\n")
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    ov = dict(SMALL["ft-b3-d192.score"])
    r = run.execute("ft-b2-d128.score", SEED, 0.3, True, "cpu",
                    overrides=ov, manifest_path=str(path), base=str(base))
    assert r["correct"], r["checks"]
    assert r["metrics"]["calls_per_s"]["value"] > 0


def _broken_step(kind):
    from shifu_tpu_torch.train import step as step_mod
    real = step_mod.make_train_step

    def make(job, *a, **kw):
        inner = real(job, *a, **kw)
        loss_fn = step_mod.make_loss_fn(job)

        def step(state, batch):
            if kind == "unchanged":  # the loss, and no update
                return state, {"loss": loss_fn(state.model, batch).detach()}
            half = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
            return inner(state, half)

        return step
    return make


@pytest.mark.parametrize("kind", ["unchanged", "half_batch"])
def test_training_faults_are_not_correct(kind, monkeypatch):
    from shifu_tpu_torch.train import step as step_mod
    monkeypatch.setattr(step_mod, "make_train_step", _broken_step(kind))
    r = _run("ft-b2-d128.train")
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("kind", ["altered", "half_rows"])
def test_scoring_faults_are_not_correct(kind, monkeypatch):
    from shifu_tpu_torch.export import scorer
    real = scorer.TorchScorer._score_batch

    def broken(self, x):
        out = real(self, x)
        if kind == "altered":  # one answer changed where it is produced
            out = out.copy()
            out[7, 0] = 1.0 - out[7, 0]
            return out
        return out[:out.shape[0] // 2]

    monkeypatch.setattr(scorer.TorchScorer, "_score_batch", broken)
    r = _run("ft-b3-d192.score")
    assert not r["correct"], (r["checks"], r["failed"])


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_is_not_correct(cell):
    """The reference in fp8 in the program's place fails the cell's
    limits (at this size; the card's readings at the cell's own size are
    in PERF.md and in the card test)."""
    import tempfile
    import time

    from perfbench.core.session import Session
    bench = manifest.load()
    entry = manifest.cell(bench, cell)
    s = Session(cell, SEED, 0.0, False, torch.device("cpu"),
                entry["config_file"],
                dict(entry["traffic_file"], **SMALL[cell]),
                time.perf_counter(), tempfile.mkdtemp())
    got = manifest.driver(entry["traffic_file"]["driver"]).readings(s)
    limits = entry["workload"]["limits"]
    assert any(got["control"][k] > lim for k, lim in limits.items())
    assert all(got["program"][k] <= lim for k, lim in limits.items())
    shutil.rmtree(s.tmpdir)


def test_command_refuses_a_machine_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "ft-b3-d192.score", "--seed", "1", "--seconds", "1"],
                       cwd=manifest.ROOT, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode == 3
    assert p.stdout.strip() == ""


def test_command_fails_without_the_program(tmp_path):
    shutil.copy(manifest.MANIFEST, tmp_path / "BENCHMARK.json")
    shutil.copytree(manifest.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "ft-b3-d192.score", "--seed", "1", "--seconds", "1"],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=120, env=dict(os.environ, PYTHONPATH=""))
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_same_seed_same_inputs():
    from perfbench.core import inputs
    cfg = manifest.cell(manifest.load(), "ft-b2-d128.train")["config_file"]
    a = inputs.ft_weights(cfg, SEED, "cpu")
    b = inputs.ft_weights(cfg, SEED, "cpu")
    c = inputs.ft_weights(cfg, SEED + 1, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["block_0.qkv.kernel"], c["block_0.qkv.kernel"])
    x = inputs.numeric_rows(64, 28, SEED, "cpu")
    assert torch.equal(x, inputs.numeric_rows(64, 28, SEED, "cpu"))
    y = inputs.teacher_labels(x, SEED, 64)
    assert set(np.unique(y.numpy())) <= {0.0, 1.0}
    assert np.array_equal(inputs.batch_order(SEED, 10),
                          inputs.batch_order(SEED, 10))


def test_half_of_the_batch_reads_half_the_noise():
    """`grad_noise` measures the first gradient's error in the batch's own
    sampling noise: the gradient of one half of the batch is off from the
    whole batch's by half the difference of the two halves, on every leaf."""
    from perfbench.core import compare
    g = torch.Generator().manual_seed(3)
    a = {k: torch.randn(s, generator=g) for k, s in (("w", (4, 3)),
                                                     ("b", (3,)))}
    b = {k: torch.randn(v.shape, generator=g) for k, v in a.items()}
    whole = {k: 0.5 * (a[k] + b[k]) for k in a}
    noise = {k: a[k] - b[k] for k in a}
    side = {"losses": [1.0], "grads": a, "params": whole}
    ref = {"losses": [1.0], "grads": whole, "params": whole}
    got = compare.train_gaps(side, ref, whole, noise)
    assert got["grad_noise"] == pytest.approx(0.5)
