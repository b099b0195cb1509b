"""The port's device flight recorder (shifu_tpu_torch/obs/devprof.py,
obs/tracefmt.py, train/profiler.py) against the JAX package's, on the CPU
(the counterparts of tests/test_devprof.py).

- Pure functions, the same inputs through both packages, equal outputs:
  `FlightRecorder.record` on quiet, spiking and short series,
  `roofline_join` with the peaks overridden and with a window's dispatch
  counts, `_match_stats` over every step tier's name, the
  `obs.trace_epochs` grammar.
- The rollup: one list of (lane, ts, dur, name, module) tuples rendered
  as the JAX package's device events (`args.hlo_op`) and as a
  torch.profiler trace (`kernel` events under `gpu_user_annotation`
  ranges, or launched from a `user_annotation` range) rolls up equal.
- The CPU device-event rule (a deliberate difference, ROADMAP.md section
  C): the outermost `cpu_op` events inside a step program's range.
- A CPU training job through `loop.train`: a `device_profile` and an
  `hbm_watermark` every epoch with JAX's keys; watermarks with tracing
  off (the CPU watermark rule: the state's and resident batches' bytes,
  `source: "state_bytes"`); an `obs.trace` fault degrades to
  `trace_fallback`; a stale capture dir is never merged; a
  SHIFU_TPU_PROFILE_DIR collision is journaled; an anomaly journals the
  JAX package's keys.
"""

import json
import os

import numpy as np
import pytest

from shifu_tpu import chaos as jax_chaos
from shifu_tpu import obs as jax_obs
from shifu_tpu.config import ObsConfig as JaxObsConfig
from shifu_tpu.obs import devprof as jax_devprof
from shifu_tpu.obs import tracefmt as jax_tracefmt
from shifu_tpu_torch import chaos, obs
from shifu_tpu_torch.config.schema import ObsConfig
from shifu_tpu_torch.obs import devprof, tracefmt
from shifu_tpu_torch.train import profiler


@pytest.fixture(autouse=True)
def _clean():
    for m in (obs, jax_obs, chaos, jax_chaos):
        m.reset_for_tests()
    yield
    for m in (obs, jax_obs, chaos, jax_chaos):
        m.reset_for_tests()


# -------------------------------------------------------- pure functions

def _series(kind):
    rng = np.random.default_rng(0)
    if kind == "quiet":
        return [(0.001, 0.010 + rng.normal(0, 1e-5)) for _ in range(200)]
    if kind == "spike":
        return [(0.002, 0.100 if i == 20 else 0.010 + (i % 3) * 1e-4)
                for i in range(30)]
    return [(0.0, 0.01)] * 7 + [(0.0, 10.0)]  # short: 7 prior chunks


@pytest.mark.parametrize("kind,kw", [
    ("quiet", dict(window=16, zscore=6.0, min_chunks=8)),
    ("spike", dict(window=16, zscore=6.0, min_chunks=8)),
    ("short", dict(window=8, zscore=3.0, min_chunks=8))])
def test_flight_recorder_verdicts_equal_jax(kind, kw):
    ours, theirs = devprof.FlightRecorder(**kw), \
        jax_devprof.FlightRecorder(**kw)
    got = [ours.record(0, i, s) for i, s in _series(kind)]
    want = [theirs.record(0, i, s) for i, s in _series(kind)]
    assert got == want
    assert ours.anomalies == theirs.anomalies == (1 if kind == "spike"
                                                  else 0)


def _rollup():
    return {"kernels": [
        {"name": "dot.1", "module": "train_step", "device_us": 600.0,
         "calls": 10},
        {"name": "copy.1", "module": "eval_step", "device_us": 300.0,
         "calls": 1}],
        "modules": {"train_step": 1000.0, "eval_step": 300.0}}


@pytest.mark.parametrize("dispatches", [None, {"train_step": 10},
                                        {"other": 5}])
def test_roofline_join_equals_jax(monkeypatch, dispatches):
    for mod in (devprof, jax_devprof):
        monkeypatch.setenv("SHIFU_TPU_PEAK_TFLOPS", "100.0")
        monkeypatch.setenv(mod.ENV_PEAK_HBM_GBPS, "1000.0")
    stats = {"train_step": {"flops": 1e10, "bytes_accessed": 1e9},
             "eval_step": {"flops": 1e9, "bytes_accessed": 1e9}}
    got = devprof.roofline_join(_rollup(), stats=stats,
                                dispatches=dispatches)
    want = jax_devprof.roofline_join(_rollup(), stats=stats,
                                     dispatches=dispatches)
    assert got == want
    assert got["peak_tflops"] == 100.0 and got["peak_hbm_gbps"] == 1000.0


def test_match_stats_over_every_step_tier_equals_jax():
    names = ("train_step", "epoch_scan_step", "device_epoch_step",
             "eval_step", "local_sgd_epoch_step")
    for module in (*names, "jit_epoch_step", "jit_step", "jit_score",
                   "jit__lambda_", "", None, "step"):
        for stats in ({n: {"flops": float(i)} for i, n in enumerate(names)},
                      {"epoch_scan_step": {"flops": 2.0},
                       "train_step": {"flops": 1.0}},
                      {"device_epoch_step": {}}, {"eval_step": {}}):
            assert devprof._match_stats(module, stats) \
                == jax_devprof._match_stats(module, stats), (module, stats)
    # the port's ranges carry the programs' own names
    for n in names:
        assert devprof._match_stats(n, {n: {}})[0] == n


@pytest.mark.parametrize("spec", ["off", "", "first", "on", "every:2",
                                  "0,2,5", "every:0", "bogus", "1,x"])
def test_parse_trace_epochs_equals_jax(spec):
    try:
        want = jax_devprof.parse_trace_epochs(spec)
    except ValueError as e:
        with pytest.raises(ValueError, match="obs.trace_epochs"):
            devprof.parse_trace_epochs(spec)
        assert "obs.trace_epochs" in str(e)
        return
    got = devprof.parse_trace_epochs(spec)
    for epoch in range(7):
        for start in (0, 1, 3):
            assert got(epoch, start) == want(epoch, start)


# ------------------------------------------------------------- the rollup

# (lane, ts, dur, name, module): nesting on one lane, a second lane, a
# kernel of no module, more kernels than top-K keeps
_KERNELS = [((0, 7), 0.0, 100.0, "while_k", "train_step"),
            ((0, 7), 10.0, 60.0, "gemm_k", "train_step"),
            ((0, 7), 75.0, 20.0, "elt_k", "train_step"),
            ((0, 7), 120.0, 30.0, "copy_k", "eval_step"),
            ((0, 9), 5.0, 50.0, "side_k", "train_step"),
            ((0, 9), 200.0, 5.0, "loose_k", "")]
_KERNELS += [((0, 7), 300.0 + 10 * i, 4.0, f"tail_{i}", "eval_step")
             for i in range(6)]


def _as_jax(kernels):
    return [{"ph": "X", "pid": lane[0], "tid": lane[1], "ts": ts,
             "dur": dur, "name": name,
             "args": {"hlo_op": name, "hlo_module": module}}
            for lane, ts, dur, name, module in kernels]


def _as_torch(kernels, via="gpu"):
    """A torch.profiler trace of the same kernels: `kernel` events, each
    under a range of its module on the device lane (`gpu`), or launched
    (`cuda_runtime`, by correlation id) from inside a `user_annotation`
    range on a CPU thread (`cpu`); host events the rule must skip."""
    out = [{"ph": "X", "cat": "cpu_op", "pid": 100, "tid": 1, "ts": 0.0,
            "dur": 999.0, "name": "aten::mm"},
           {"ph": "X", "cat": "python_function", "pid": 100, "tid": 1,
            "ts": 0.0, "dur": 999.0, "name": "loop.py"}]
    for i, (lane, ts, dur, name, module) in enumerate(kernels):
        out.append({"ph": "X", "cat": "kernel", "pid": lane[0],
                    "tid": lane[1], "ts": ts, "dur": dur, "name": name,
                    "args": {"correlation": i, "stream": lane[1]}})
        if not module:
            continue
        if via == "gpu":
            out.append({"ph": "X", "cat": "gpu_user_annotation",
                        "pid": lane[0], "tid": lane[1], "ts": ts,
                        "dur": dur, "name": module})
        else:
            t0 = 10_000.0 + 100.0 * i
            out.append({"ph": "X", "cat": "user_annotation", "pid": 100,
                        "tid": 1, "ts": t0, "dur": 50.0, "name": module})
            out.append({"ph": "X", "cat": "cuda_runtime", "pid": 100,
                        "tid": 1, "ts": t0 + 10.0, "dur": 5.0,
                        "name": "cudaLaunchKernel",
                        "args": {"correlation": i}})
    return out


@pytest.mark.parametrize("via", ["gpu", "cpu"])
@pytest.mark.parametrize("top_k", [3, 16])
def test_rollup_of_torch_events_equals_jax(tmp_path, via, top_k):
    want = jax_tracefmt.kernel_rollup(_as_jax(_KERNELS), top_k=top_k)
    assert tracefmt.kernel_rollup(_as_torch(_KERNELS, via), top_k=top_k) \
        == want
    assert tracefmt.kernel_rollup(_as_jax(_KERNELS), top_k=top_k) == want
    assert want["lanes"] == 2 and want["other_us"] > 0 or top_k == 16
    # a capture dir: the same through find/load/rollup_trace_dir
    d = tmp_path / f"cap-{via}-{top_k}"
    d.mkdir()
    (d / "host_1.trace.json").write_text(
        json.dumps({"traceEvents": _as_torch(_KERNELS, via)}))
    assert tracefmt.rollup_trace_dir(str(d), top_k=top_k) == want
    assert tracefmt.diff_rollups(want, want) == \
        jax_tracefmt.diff_rollups(want, want)


def test_cpu_rule_takes_the_outermost_ops_in_step_ranges():
    events = [
        {"ph": "X", "cat": "user_annotation", "pid": 1, "tid": 1,
         "ts": 0.0, "dur": 100.0, "name": "train_step"},
        {"ph": "X", "cat": "cpu_op", "pid": 1, "tid": 1, "ts": 1.0,
         "dur": 40.0, "name": "aten::linear"},
        {"ph": "X", "cat": "cpu_op", "pid": 1, "tid": 1, "ts": 2.0,
         "dur": 30.0, "name": "aten::addmm"},       # inside linear
        {"ph": "X", "cat": "cpu_op", "pid": 1, "tid": 1, "ts": 50.0,
         "dur": 20.0, "name": "aten::relu"},
        {"ph": "X", "cat": "cpu_op", "pid": 1, "tid": 1, "ts": 200.0,
         "dur": 20.0, "name": "aten::add"},         # outside any range
    ]
    r = tracefmt.kernel_rollup(events)
    assert [(k["name"], k["module"], k["calls"]) for k in r["kernels"]] \
        == [("aten::linear", "train_step", 1), ("aten::relu", "train_step",
                                                1)]
    assert r["device_us_total"] == 60.0 and r["window_us"] == 69.0
    assert tracefmt.kernel_rollup([events[-1]]) is None


def test_a_capture_of_the_card_never_takes_the_cpu_rule(tmp_path):
    """Host ops are device time only in a capture of the CPU: a capture of
    the card with no device-category event has no device events at all,
    so its rollup is None (the recorder then journals trace_fallback)."""
    events = [
        {"ph": "X", "cat": "user_annotation", "pid": 1, "tid": 1,
         "ts": 0.0, "dur": 100.0, "name": "serve_dispatch"},
        {"ph": "X", "cat": "cpu_op", "pid": 1, "tid": 1, "ts": 1.0,
         "dur": 40.0, "name": "aten::matmul"},
    ]
    assert [e["name"] for e in tracefmt.device_events(events)] \
        == ["aten::matmul"]
    assert tracefmt.device_events(events, on_card=True) == []
    d = tmp_path / "cap"
    d.mkdir()
    (d / "host_1.trace.json").write_text(json.dumps({"traceEvents": events}))
    assert tracefmt.rollup_trace_dir(str(d))["kernel_count"] == 1
    assert tracefmt.rollup_trace_dir(str(d), on_card=True) is None
    # a device event keeps the card's rule either way
    kernel = {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 5.0,
              "dur": 3.0, "name": "gemm", "args": {"correlation": 1}}
    assert tracefmt.device_events(events + [kernel], on_card=True) \
        == tracefmt.device_events(events + [kernel])


# --------------------------------------------------------- profiler legs

def test_step_timer_feeds_chunk_hook_as_jax():
    from shifu_tpu.train.profiler import StepTimer as JaxTimer
    for cls in (profiler.StepTimer, JaxTimer):
        seen = []
        t = cls(on_chunk=lambda i, s: seen.append((i, s)))
        t.start()
        for _ in range(2):
            t.mark_input_ready()
            t.mark_step_done()
        assert seen == list(zip(t.input_times, t.step_times))
        t2 = cls(on_chunk=lambda i, s: 1 / 0)  # a raising hook is absorbed
        t2.start()
        t2.mark_input_ready()
        t2.mark_step_done()
        assert len(t2.step_times) == 1


def _journal(tmp_path, name="journal.jsonl"):
    obs.flush()
    return obs.read_journal(str(tmp_path / name))


def test_anomaly_journals_jax_keys_and_a_oneshot_capture(tmp_path):
    """A spike through note_chunk journals one `anomaly` with the JAX
    package's keys and opens a one-shot capture that the next chunk
    closes; the CPU rule rolls up the step program's ops run inside it."""
    import torch

    from shifu_tpu_torch.obs import flops

    step = flops.instrument(lambda x: (x @ x).relu().sum(), "train_step")
    keys = {}
    for name, mod, obs_mod, cfg_cls in (
            ("port", devprof, obs, ObsConfig),
            ("jax", jax_devprof, jax_obs, JaxObsConfig)):
        obs_mod.configure(str(tmp_path / name))
        cfg = cfg_cls(trace_epochs="first",
                      trace_dir=str(tmp_path / name / "tr"),
                      anomaly_window=8, anomaly_min_chunks=4)
        dp = mod.DeviceProfiler(cfg)
        for _ in range(6):
            dp.note_chunk(0, 0.001, 0.010)
        dp.note_chunk(0, 0.001, 0.500)
        if name == "port":
            step(torch.ones(32, 32))
        dp.note_chunk(0, 0.001, 0.010)
        dp.end_epoch(0)
        dp.close()
        obs_mod.flush()
        recs = obs_mod.read_journal(str(tmp_path / name / "journal.jsonl"))
        anomalies = [r for r in recs if r["kind"] == "anomaly"]
        assert len(anomalies) == 1 and anomalies[0]["ring"]
        keys[name] = set(anomalies[0])
        if name == "port":
            shots = [r for r in recs if r["kind"] == "device_profile"]
            assert len(shots) == 1 and shots[0]["trigger"] == "anomaly"
            assert {k["module"] for k in shots[0]["kernels"]} \
                == {"train_step"}
    assert keys["port"] == keys["jax"]
    assert not profiler.trace_active()


def test_a_card_window_without_device_events_journals_trace_fallback(
        tmp_path, monkeypatch):
    """Where the JAX rollup drops an empty window without a word, a
    capture of the card that recorded no device event journals
    `trace_fallback` (stage "parse") and no `device_profile`: the
    one-shot anomaly capture, with the card's capture stood in for by a
    CPU capture that reports itself as one."""
    import torch

    from shifu_tpu_torch.obs import flops

    real = profiler.start_trace
    monkeypatch.setattr(profiler, "start_trace",
                        lambda log_dir: real(log_dir) or True)
    step = flops.instrument(lambda x: (x @ x).relu().sum(), "train_step")
    obs.configure(str(tmp_path))
    dp = devprof.DeviceProfiler(ObsConfig(
        trace_epochs="first", trace_dir=str(tmp_path / "tr"),
        anomaly_window=8, anomaly_min_chunks=4))
    for _ in range(6):
        dp.note_chunk(0, 0.001, 0.010)
    dp.note_chunk(0, 0.001, 0.500)
    step(torch.ones(32, 32))
    dp.note_chunk(0, 0.001, 0.010)
    dp.end_epoch(0)
    dp.close()
    recs = _journal(tmp_path)
    assert not [r for r in recs if r["kind"] == "device_profile"]
    falls = [r for r in recs if r["kind"] == "trace_fallback"]
    assert [f["stage"] for f in falls] == ["parse"]
    assert "no device events in a capture of the card" in falls[0]["error"]
    assert not profiler.trace_active()


def test_fresh_capture_dir_never_merges_stale_runs(tmp_path):
    dp = devprof.DeviceProfiler(ObsConfig(trace_epochs="first",
                                          trace_dir=str(tmp_path)))
    base = os.path.join(str(tmp_path), "epoch00000")
    assert dp._fresh_capture_dir(base) == base
    os.makedirs(base)
    assert dp._fresh_capture_dir(base) == base + "-r1"
    os.makedirs(base + "-r1")
    assert dp._fresh_capture_dir(base) == base + "-r2"


def test_legacy_profile_dir_collision_is_journaled(tmp_path):
    obs.configure(str(tmp_path))
    dp = devprof.DeviceProfiler(ObsConfig(trace_epochs="first",
                                          trace_dir=str(tmp_path / "tr")))
    dp.note_superseded(0)   # scheduled: journals
    dp.note_superseded(1)   # unscheduled: silent
    devprof.DeviceProfiler(ObsConfig()).note_superseded(0)  # tracing off
    recs = [r for r in _journal(tmp_path) if r["kind"] == "trace_fallback"]
    assert [(r["epoch"], r["stage"]) for r in recs] == [(0, "superseded")]


# ------------------------------------------------- a CPU job through train

def _jobs(tmp, **obs_kw):
    from shifu_tpu.config import schema as jax_schema
    from shifu_tpu.data import synthetic as jax_synth
    from shifu_tpu_torch.config import schema as port_schema
    jjob = jax_schema.JobConfig(
        schema=jax_synth.make_schema(num_features=10),
        data=jax_schema.DataConfig(batch_size=64),
        model=jax_schema.ModelSpec(hidden_nodes=(8,), activations=("relu",),
                                   compute_dtype="float32"),
        train=jax_schema.TrainConfig(epochs=2, optimizer=(
            jax_schema.OptimizerConfig(name="adam", learning_rate=1e-2))),
        obs=jax_schema.ObsConfig(trace_dir=str(tmp / "trace"),
                                 anomaly_min_chunks=10_000,
                                 **obs_kw)).validate()
    pjob = port_schema.JobConfig.from_dict(
        json.loads(jjob.to_json())).validate()
    return jjob, pjob


def _parts(mod, n=640):
    from shifu_tpu.data import reader as jax_reader
    from shifu_tpu.data import synthetic as jax_synth
    schema = jax_synth.make_schema(num_features=10)
    cols = jax_reader.project_columns(jax_synth.make_rows(n + 128, schema,
                                                          seed=5), schema)
    full = mod.TabularDataset(cols["features"], cols["target"],
                              cols["weight"])
    return full.take(np.arange(n)), full.take(np.arange(n, n + 128))


def _port_run(tmp_path, name, **obs_kw):
    from shifu_tpu_torch.data import pipeline as pipe
    from shifu_tpu_torch.train import loop
    out = tmp_path / name
    _, pjob = _jobs(out, **obs_kw)
    obs.configure(str(out), flush_every=1)
    res = loop.train(pjob, *_parts(pipe), console=lambda s: None,
                     device="cpu")
    events = obs.read_journal(str(out / "journal.jsonl"))
    obs.reset_for_tests()
    return res, events


def _jax_capture_report(root, jevents) -> str:
    """What the JAX run's flight recorder did: its trace_fallback events
    and the files of each capture dir (printed when it falls short)."""
    falls = [e for e in jevents if e["kind"] == "trace_fallback"]
    dirs = {}
    for dirpath, _dirs, files in os.walk(root / "trace"):
        dirs[os.path.relpath(dirpath, root)] = sorted(files)
    return f"JAX trace_fallback events: {falls}; capture dirs: {dirs}"


def test_cpu_job_journals_a_profile_and_a_watermark_every_epoch(tmp_path):
    """The port traces every epoch; the JAX reference traces its first
    epoch only.  Its CPU rollup drops a capture with no device events
    without a word (no device_profile, no trace_fallback), which a loaded
    host made happen to its second window, so the reference's field sets
    come from one traced epoch and two watermarks."""
    from shifu_tpu.data import pipeline as jax_pipe
    from shifu_tpu.train import loop as jax_loop
    res, events = _port_run(tmp_path, "port", trace_epochs="every:1")
    jjob, _ = _jobs(tmp_path / "jax", trace_epochs="first")
    jax_obs.configure(str(tmp_path / "jax"), flush_every=1)
    jax_loop.train(jjob, *_parts(jax_pipe), console=lambda s: None)
    jevents = jax_obs.read_journal(str(tmp_path / "jax" / "journal.jsonl"))
    for kind, n_jax in (("device_profile", 1), ("hbm_watermark", 2)):
        mine = [e for e in events if e["kind"] == kind]
        theirs = [e for e in jevents if e["kind"] == kind]
        assert [e["epoch"] for e in mine] == [0, 1]
        assert len(theirs) == n_jax, _jax_capture_report(tmp_path / "jax",
                                                         jevents)
        assert {k for e in mine for k in e} == {k for e in theirs for k in e}
    prof = [e for e in events if e["kind"] == "device_profile"]
    for p in prof:
        assert p["kernels"] and p["trigger"] == "schedule"
        assert set(p["modules"]) <= {"device_epoch_step", "epoch_scan_step",
                                     "train_step"}
        assert sum(k["fraction"] for k in p["kernels"]) <= 1.0 + 1e-6
    marks = [e for e in events if e["kind"] == "hbm_watermark"]
    # the CPU rule: parameters, Adam's two slots and the step counters,
    # and the resident batches (10 batches of 64 rows, 10 f32 features,
    # a u8 target, the unit weights elided)
    state = res.state
    params = sum(p.numel() * 4 for p in state.model.parameters())
    assert all(m["source"] == "state_bytes" for m in marks)
    assert marks[0]["peak_bytes"] >= 3 * params + 640 * (10 * 4 + 1)
    good = [e for e in events if e["kind"] == "goodput"]
    assert len(good) == 2
    assert all(g["achieved_tflops"] > 0 and g["mfu"] is None for g in good)


def test_tracing_off_by_default_still_watermarks(tmp_path):
    _, events = _port_run(tmp_path, "off")
    kinds = [e["kind"] for e in events]
    assert kinds.count("hbm_watermark") == 2
    assert "device_profile" not in kinds and "trace_fallback" not in kinds


def test_an_obs_trace_fault_degrades_to_trace_fallback(tmp_path):
    chaos.configure(chaos.parse_plan(
        {"faults": [{"site": "obs.trace", "every": 1, "action": "raise"}]}))
    faulted, events = _port_run(tmp_path, "faulted", trace_epochs="first")
    chaos.reset_for_tests()
    falls = [e for e in events if e["kind"] == "trace_fallback"]
    assert [(f["epoch"], f["stage"]) for f in falls] == [(0, "start")]
    assert not [e for e in events if e["kind"] == "device_profile"]
    twin, _ = _port_run(tmp_path, "twin")
    assert [m.train_error for m in faulted.history] \
        == [m.train_error for m in twin.history]
    assert not profiler.trace_active()


def test_a_stale_capture_dir_is_never_merged(tmp_path):
    stale = tmp_path / "stale" / "trace" / "epoch00000"
    stale.mkdir(parents=True)
    far = [((0, 7), 1e12, 5.0, "stale_k", "train_step")]
    (stale / "old.trace.json").write_text(
        json.dumps({"traceEvents": _as_torch(far)}))
    _, events = _port_run(tmp_path, "stale", trace_epochs="first")
    (prof,) = [e for e in events if e["kind"] == "device_profile"]
    assert prof["trace_dir"].endswith("epoch00000-r1")
    assert all(k["name"] != "stale_k" for k in prof["kernels"])
    assert prof["window_us"] < 1e9


def test_a_profile_dir_collision_is_journaled_by_the_loop(tmp_path,
                                                          monkeypatch):
    monkeypatch.setenv("SHIFU_TPU_PROFILE_DIR", str(tmp_path / "raw"))
    _, events = _port_run(tmp_path, "collide", trace_epochs="first")
    falls = [e for e in events if e["kind"] == "trace_fallback"]
    assert [(f["epoch"], f["stage"]) for f in falls] == [(0, "superseded")]
    assert not [e for e in events if e["kind"] == "device_profile"]
    assert tracefmt.find_trace_files(str(tmp_path / "raw"))
