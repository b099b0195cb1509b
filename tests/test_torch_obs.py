"""The port's telemetry (shifu_tpu_torch/obs: metrics, journal, sinks,
spans, goodput, the flight recorder's events), train/profiler.py and
data/fsio.py on the CPU, against the JAX package's on the same inputs.

Held exactly: the Prometheus text of the same instrument operations, the
goodput summary of the same bucket seconds, StepTimer summaries of the
same timings, and the fsio answers on the same paths.  For one small job
run by each package with its sinks configured, the journal's event types
and each type's keys are the same sets (values are not compared), and so
are the scrape file's metric names, except what comes from JAX modules
the port has not ported yet (`_JAX_ONLY_*`, ROADMAP.md queue A); both
jobs trace their first epoch, so `device_profile` and `hbm_watermark` are
held too (`anomaly` and `trace_fallback`: tests/test_torch_devprof.py).
"""

import collections
import json
import os

import numpy as np
import pytest

from shifu_tpu import obs as jax_obs
from shifu_tpu.data import fsio as jax_fsio
from shifu_tpu.obs import goodput as jax_goodput
from shifu_tpu.obs import metrics as jax_metrics
from shifu_tpu.train import profiler as jax_profiler
from shifu_tpu_torch import obs
from shifu_tpu_torch.data import fsio
from shifu_tpu_torch.obs import goodput, metrics
from shifu_tpu_torch.train import profiler

# journal events and metric names of JAX modules the port has not ported:
# obs/introspect.py (XLA compiles; its FLOPs are obs/flops.py's) and
# obs/sketch.py (the drift baseline)
_JAX_ONLY_EVENTS = {"xla_compile": "obs/introspect.py",
                    "baseline_profile": "obs/sketch.py"}
_JAX_ONLY_METRIC_PREFIXES = ("xla_",)


@pytest.fixture(autouse=True)
def _clean():
    obs.reset_for_tests()
    jax_obs.reset_for_tests()
    yield
    obs.reset_for_tests()
    jax_obs.reset_for_tests()


def _drive(reg):
    c = reg.counter("requests_total", "requests")
    c.inc()
    c.inc(2.5, route="a")
    c.inc(1, route='b"q\n')
    g = reg.gauge("depth", "queue depth")
    g.set(3)
    g.inc(-1.5, shard="x")
    h = reg.histogram("latency_seconds", "latency")
    for v in (0.0001, 0.003, 0.2, 7.0, 400.0, float("inf"), float("nan")):
        h.observe(v, op="score")
    reg.histogram("narrow_seconds", buckets=(0.5, 0.1)).observe(0.3)
    return reg


def test_prometheus_text_equals_jax():
    port = _drive(metrics.MetricsRegistry())
    ref = _drive(jax_metrics.MetricsRegistry())
    assert port.to_prometheus_text() == ref.to_prometheus_text()
    assert port.names() == ref.names()
    for name in ("requests_total", "depth"):
        kind = ref.counter if name.endswith("total") else ref.gauge
        mine = port.counter if name.endswith("total") else port.gauge
        assert mine(name).total() == kind(name).total()
    h, jh = port.histogram("latency_seconds"), ref.histogram("latency_seconds")
    assert h.count(op="score") == jh.count(op="score") == 7


def test_registry_rules():
    reg = metrics.MetricsRegistry()
    assert reg.counter("x") is reg.counter("x")
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("x")
    with pytest.raises(ValueError, match="negative"):
        reg.counter("x").inc(-1)
    reg.clear()
    assert reg.names() == [] and reg.to_prometheus_text() == ""


def test_scrape_file_is_written_atomically(tmp_path):
    metrics.counter("a_total", "a").inc(3)
    path = str(tmp_path / "sub" / "metrics.prom")
    metrics.write_scrape_file(path)
    text = open(path).read()
    assert "# TYPE a_total counter" in text and "a_total 3" in text
    assert not [n for n in os.listdir(tmp_path / "sub") if "tmp" in n]


def test_event_is_a_noop_until_configured_and_the_registry_collects(tmp_path):
    assert obs.event("x", a=1) is None
    obs.counter("early_total").inc()
    j = obs.configure(str(tmp_path), flush_every=1)
    rec = obs.event("hello", value=float("nan"), nested={"x": float("inf")})
    assert rec["kind"] == "hello" and rec["value"] is None
    assert rec["nested"] == {"x": None}
    obs.flush()
    recs = obs.read_journal(str(tmp_path / "journal.jsonl"))
    assert [r["kind"] for r in recs] == ["hello"]
    assert recs[0]["seq"] == 1
    assert "early_total 1" in open(tmp_path / "metrics.prom").read()
    assert obs.get_journal() is j
    obs.shutdown()
    assert obs.get_journal() is None


def test_configure_from_env(tmp_path, monkeypatch):
    monkeypatch.delenv(obs.ENV_METRICS_DIR, raising=False)
    assert obs.configure_from_env() is False
    monkeypatch.setenv(obs.ENV_METRICS_DIR, str(tmp_path / "m"))
    assert obs.configure_from_env() is True
    obs.event("one")
    obs.flush()
    assert obs.read_journal(str(tmp_path / "m" / "journal.jsonl"))[0][
        "kind"] == "one"


def test_journal_memory_mode_partial_lines_and_tail(tmp_path):
    mem = obs.RunJournal(None)
    mem.event("a", x=1)
    assert [r["kind"] for r in mem.records] == ["a"]
    path = str(tmp_path / "j.jsonl")
    j = obs.RunJournal(path)
    j.event("first")
    j.event("second", n=2)
    j.close()
    with open(path, "a") as f:
        f.write('{"kind": "torn"')  # a crash mid-append
    recs = obs.read_journal(path)
    assert [r["kind"] for r in recs] == ["first", "second"]
    tail = obs.tail_journal(path)
    assert [next(tail)["kind"], next(tail)["kind"]] == ["first", "second"]


def test_remote_paths_are_refused_naming_the_roadmap(tmp_path,
                                                    monkeypatch):
    """The call sites that raised NotImplementedError before the remote
    half of fsio work on pyarrow's in-memory mock:// filesystem; without
    pyarrow a remote URI raises the JAX module's clear error and falls
    back to nothing."""
    from pyarrow import fs as pafs
    mock, _ = pafs.FileSystem.from_uri("mock://seed")
    monkeypatch.setitem(fsio._fs_cache, ("mock", ""), mock)
    j = obs.RunJournal("mock://bucket/j.jsonl", flush_every=1)
    j.event("first", n=1)
    assert [r["kind"] for r in obs.read_journal("mock://bucket/j.jsonl")] \
        == ["first"]
    obs.configure("mock://bucket/tele", flush_every=1)
    obs.event("hello")
    obs.flush()
    assert obs.read_journal("mock://bucket/tele/journal.jsonl")
    fsio.write_bytes("mock://bucket/k", b"abc")
    assert fsio.read_bytes("mock://bucket/k") == b"abc"
    assert ("mock://bucket/k", 3) in fsio.walk_files("mock://bucket/")
    assert fsio.file_info("mock://bucket/k")[0] == 3
    monkeypatch.setitem(__import__("sys").modules, "pyarrow", None)
    monkeypatch.setattr(fsio, "_fs_cache", {})
    with pytest.raises(RuntimeError, match="needs pyarrow"):
        fsio.read_bytes("mock://bucket/k")


def test_spans_nest_and_feed_the_histogram(tmp_path):
    obs.configure(str(tmp_path), flush_every=1)
    with obs.span("epoch", epoch=3):
        assert obs.current_path() == "epoch"
        with obs.span("eval"):
            assert obs.current_path() == "epoch/eval"
    assert obs.current_path() == ""
    obs.flush()
    spans = [r for r in obs.read_journal(str(tmp_path / "journal.jsonl"))
             if r["kind"] == "span"]
    assert [s["span"] for s in spans] == ["epoch/eval", "epoch"]
    assert spans[1]["epoch"] == 3
    h = obs.histogram("span_seconds")
    assert h.count(span="epoch") == h.count(span="epoch/eval") == 1


@pytest.mark.parametrize("adds,wall", [
    ({"input": 0.5, "step": 2.0, "eval": 0.25}, 3.0),
    ({"compile": 1.0, "step": 0.5, "eval": 2.0, "checkpoint": 0.1}, 4.0),
    ({"step": float("nan"), "restore": -1.0, "other": 0.2}, 1.0),
    ({}, 0.0),
])
def test_goodput_summary_equals_jax(adds, wall, monkeypatch):
    """The same bucket seconds give the JAX package's record; neither
    counts FLOPs here, so both leave `mfu` null."""
    monkeypatch.setenv("SHIFU_TPU_PEAK_TFLOPS", "100")
    port, ref = goodput.GoodputLedger(), jax_goodput.GoodputLedger()
    for led in (port, ref):
        for k, v in adds.items():
            led.add(k, v)
    assert port.summary(wall) == ref.summary(wall)


def test_goodput_peak_table_and_null_mfu(tmp_path, monkeypatch):
    monkeypatch.delenv("SHIFU_TPU_PEAK_TFLOPS", raising=False)
    assert goodput.peak_tflops("NVIDIA H100 80GB HBM3") == 989.0
    assert goodput.peak_tflops("NVIDIA A100-SXM4-40GB") is None
    assert goodput.peak_tflops("TPU v5 lite") is None  # no TPU rows
    assert goodput.BUCKETS == jax_goodput.BUCKETS
    obs.configure(str(tmp_path), flush_every=1)
    led = goodput.begin_epoch()
    goodput.note("checkpoint", 0.5)
    led.add("step", 1.0)
    rec = goodput.end_epoch(4, 2.0)
    assert goodput.current() is None
    assert rec["epoch"] == 4 and rec["mfu"] is None
    assert rec["achieved_tflops"] is None
    assert sum(rec["buckets"].values()) == pytest.approx(2.0)
    assert goodput.end_epoch(5, 1.0) is None  # no ledger open
    goodput.note("step", 1.0)  # between epochs: a no-op
    assert obs.counter("goodput_bucket_seconds_total").value(
        bucket="checkpoint") == 0.5


def _timed(cls, inputs, steps):
    t = cls()
    t.input_times = list(inputs)
    t.step_times = list(steps)
    return t


@pytest.mark.parametrize("inputs,steps", [
    ([0.001, 0.002, 0.5], [0.01, 0.02, 0.03]),
    ([0.1], [0.2]),
    ([], []),
    ([float("nan"), 0.001], [0.004, float("inf")]),
])
def test_step_timer_summary_equals_jax(inputs, steps):
    port = _timed(profiler.StepTimer, inputs, steps)
    ref = _timed(jax_profiler.StepTimer, inputs, steps)
    assert port.summary() == ref.summary()
    assert port.console_line() == ref.console_line()


def test_step_timer_marks_and_emit():
    t = profiler.StepTimer()
    t.mark_step_done()  # before start(): nothing to time
    t.start()
    for _ in range(3):
        t.mark_input_ready()
        t.mark_step_done()
    assert len(t.input_times) == len(t.step_times) == 3
    t.emit()
    assert obs.histogram("train_input_seconds").count() == 3
    assert obs.histogram("train_step_seconds").count() == 3


def test_trace_writes_a_torch_profiler_trace(tmp_path):
    import torch
    with profiler.maybe_trace(None):
        pass
    with profiler.maybe_trace(str(tmp_path / "tr")):
        torch.ones(4).sum()
    (name,) = os.listdir(tmp_path / "tr")
    assert name.endswith(".trace.json")
    trace = json.load(open(tmp_path / "tr" / name))
    assert trace["traceEvents"]
    # one capture at a time, as with jax.profiler
    profiler.start_trace(str(tmp_path / "a"))
    try:
        with pytest.raises(RuntimeError, match="one torch.profiler"):
            profiler.start_trace(str(tmp_path / "b"))
    finally:
        profiler.stop_trace()
    assert not profiler.trace_active()


def test_fsio_local_half_equals_jax(tmp_path):
    for p in ("gs://b/x", "hdfs://nn/p", "s3://b", "file:///x", "mock://m",
              "/local/path", "rel/path", "http://host/x", "c:/x"):
        assert fsio.is_remote(p) == jax_fsio.is_remote(p)
    for base, names in (("/a", ("b", "c")), ("gs://bkt/", ("x",)),
                        ("rel", ("y",))):
        assert fsio.join(base, *names) == jax_fsio.join(base, *names)
    root = tmp_path / "tree"
    fsio.write_bytes(str(root / "d" / "one.bin"), b"12345")
    fsio.write_bytes(str(root / "two.bin"), b"ab")
    fsio.write_bytes(str(root / "two.bin"), b"abc")  # replaced whole
    assert fsio.read_bytes(str(root / "two.bin")) == b"abc"
    assert not [n for n in os.listdir(root) if ".tmp" in n]
    assert fsio.walk_files(str(root)) == jax_fsio.walk_files(str(root))
    assert fsio.walk_files(str(root / "missing")) == []
    size, mtime = fsio.file_info(str(root / "two.bin"))
    assert size == 3 and mtime > 0
    with pytest.raises(FileNotFoundError):
        fsio.file_info(str(root / "missing"))


def _events_and_metrics(recs, prom_path):
    keys = collections.defaultdict(set)
    for r in recs:
        keys[r["kind"]] |= set(r)
    names = set()
    for line in open(prom_path):
        if line.startswith("#") or not line.strip():
            continue
        name = line.split("{")[0].split(" ")[0]
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix):
                name = name[: -len(suffix)]
        names.add(name)
    return keys, names


@pytest.mark.parametrize("data_kw", [
    {"device_resident_bytes": 0},                   # staged, feeder on
    {"staged": False, "overlap_epochs": False},     # per-batch, no feeder
    {},                                             # resident
])
def test_one_job_journals_the_same_events_and_keys_as_jax(tmp_path, data_kw):
    """Each package runs the same small job (2 epochs, a checkpoint every
    epoch) with its sinks configured: the event types, each type's keys,
    and the scrape file's metric names are the same sets, but for the
    unported JAX modules' (`_JAX_ONLY_*`)."""
    from shifu_tpu.config import schema as jax_schema
    from shifu_tpu.data import pipeline as jax_pipe
    from shifu_tpu.data import reader as jax_reader
    from shifu_tpu.data import synthetic as jax_synth
    from shifu_tpu.train import loop as jax_loop
    from shifu_tpu_torch.config import schema as port_schema
    from shifu_tpu_torch.data import pipeline as pipe
    from shifu_tpu_torch.train import loop

    schema = jax_synth.make_schema(num_features=10)

    def jjob(d):
        return jax_schema.JobConfig(
            schema=schema,
            data=jax_schema.DataConfig(batch_size=64, **data_kw),
            model=jax_schema.ModelSpec(hidden_nodes=(8,),
                                       activations=("relu",),
                                       compute_dtype="float32"),
            train=jax_schema.TrainConfig(
                epochs=2, optimizer=jax_schema.OptimizerConfig(
                    name="adam", learning_rate=1e-2)),
            runtime=jax_schema.RuntimeConfig(
                checkpoint=jax_schema.CheckpointConfig(
                    directory=d)),
            # trace the first epoch; no anomaly (a slow chunk on a loaded
            # host would fire one in one package and not the other)
            obs=jax_schema.ObsConfig(
                trace_epochs="first", trace_dir=f"{d}-trace",
                anomaly_min_chunks=10_000)).validate()

    rows = jax_synth.make_rows(1024, schema, seed=5)
    cols = jax_reader.project_columns(rows, schema)

    def parts(mod):
        full = mod.TabularDataset(cols["features"], cols["target"],
                                  cols["weight"])
        return full.take(np.arange(900)), full.take(np.arange(900, 1024))

    jax_obs.configure(str(tmp_path / "jt"), flush_every=1)
    jax_loop.train(jjob(str(tmp_path / "jc")), *parts(jax_pipe),
                   console=lambda s: None)
    jax_obs.flush()
    jkeys, jnames = _events_and_metrics(
        jax_obs.read_journal(str(tmp_path / "jt" / "journal.jsonl")),
        tmp_path / "jt" / "metrics.prom")
    jax_obs.reset_for_tests()

    pjob = port_schema.JobConfig.from_dict(
        json.loads(jjob(str(tmp_path / "pc")).to_json())).validate()
    obs.configure(str(tmp_path / "pt"), flush_every=1)
    loop.train(pjob, *parts(pipe), console=lambda s: None, device="cpu")
    obs.flush()
    pkeys, pnames = _events_and_metrics(
        obs.read_journal(str(tmp_path / "pt" / "journal.jsonl")),
        tmp_path / "pt" / "metrics.prom")

    for kind in _JAX_ONLY_EVENTS:
        jkeys.pop(kind, None)
    assert set(pkeys) == set(jkeys)
    for kind in jkeys:
        assert pkeys[kind] == jkeys[kind], kind
    jnames = {n for n in jnames
              if not n.startswith(_JAX_ONLY_METRIC_PREFIXES)}
    assert pnames == jnames
    assert {"epoch", "goodput", "overlap_report", "checkpoint_save",
            "train_start", "train_end", "span", "device_profile",
            "hbm_watermark"} <= set(pkeys)
