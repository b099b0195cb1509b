"""The port's serving plane (shifu_tpu_torch/obs/{metrics,tracing,sketch,
drift,slo}.py, runtime/{serve,serve_wire,loadtest}.py) against the JAX
package's, on the CPU.

- Pure functions on the same numpy inputs give the JAX package's outputs:
  histogram quantiles, the sketches, PSI, KL, mean shift, the profile,
  the drift engine's alerts and reports on one scripted tick sequence
  (exactly equal), and the SLO engine's decisions on a scripted latency
  stream (exactly equal); the stage histograms' statistics.
- Trace contexts and wire frames are the same bytes; the JAX package's
  client scores through the port's server and the port's client through
  the JAX package's (whose daemon runs its numpy engine on a port
  artifact): f32 frames within 1e-5, int8 frames equal to each other.
- The daemon's hooks on the CPU: drift fires on the shifted feature only
  and the live AUC from labelled feedback matches `evaluate` within 0.02;
  a dispatch slowed by the chaos site `runtime.serve.dispatch` fires one
  p99 `slo_alert` and one `device_profile` with trigger "slo"; sampled
  `request_trace` stages sum to e2e; a chaos fault at `runtime.serve`
  keeps the previous version serving; `serve_forever` serves and drains.
- An in-process and a socket loadtest at low rates.

Every socket binds an ephemeral localhost port and has a timeout.
"""

import json
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

from shifu_tpu import chaos as jax_chaos
from shifu_tpu import obs as jax_obs
from shifu_tpu.obs import drift as jax_drift
from shifu_tpu.obs import metrics as jax_metrics
from shifu_tpu.obs import sketch as jax_sketch
from shifu_tpu.obs import slo as jax_slo
from shifu_tpu.obs import tracing as jax_tracing
from shifu_tpu.runtime import serve_wire as jax_wire
from shifu_tpu_torch import chaos, obs
from shifu_tpu_torch.config import schema as ps
from shifu_tpu_torch.export.scorer import SCORE_LATENCY_BUCKETS
from shifu_tpu_torch.obs import drift, metrics, sketch, slo, tracing
from shifu_tpu_torch.runtime import loadtest, serve, serve_wire

F = 6
N_BUCKETS = len(SCORE_LATENCY_BUCKETS) + 1


@pytest.fixture(autouse=True)
def _clean():
    for m in (obs, jax_obs, chaos, jax_chaos):
        m.reset_for_tests()
    yield
    for m in (obs, jax_obs, chaos, jax_chaos):
        m.reset_for_tests()


# -- pure functions -----------------------------------------------------------

def test_quantiles_and_merged_counts_equal_jax():
    rng = np.random.default_rng(0)
    lat = rng.lognormal(-6, 1.2, size=5000)
    bounds = np.asarray(SCORE_LATENCY_BUCKETS)
    counts = np.bincount(np.searchsorted(bounds, lat, side="left"),
                         minlength=N_BUCKETS).tolist()
    for q in (0.0, 0.5, 0.9, 0.99, 0.999, 1.0):
        assert metrics.quantile_from_counts(SCORE_LATENCY_BUCKETS, counts,
                                            5000, q) \
            == jax_metrics.quantile_from_counts(SCORE_LATENCY_BUCKETS,
                                                counts, 5000, q)
    assert metrics.quantile_from_counts(SCORE_LATENCY_BUCKETS, counts, 0,
                                        0.5) is None
    mine = metrics.MetricsRegistry().histogram("h", "",
                                               SCORE_LATENCY_BUCKETS)
    theirs = jax_metrics.MetricsRegistry().histogram("h", "",
                                                     SCORE_LATENCY_BUCKETS)
    for h in (mine, theirs):
        h.merge_counts(counts, float(lat.sum()), 5000, engine="serve")
        h.merge_counts(counts, float(lat.sum()), 5000, engine="serve")
    assert mine.counts(engine="serve") == theirs.counts(engine="serve")
    snap = mine.counts(engine="serve")
    assert metrics.quantile_from_counts(SCORE_LATENCY_BUCKETS, snap[0],
                                        snap[2], 0.99) \
        == theirs.quantile(0.99, engine="serve")
    assert mine.counts(engine="other") is None
    with pytest.raises(ValueError, match="buckets"):
        mine.merge_counts([1, 2], 0.0, 3)


def _feature_rows(n, seed, shift_col=None, shift=0.0):
    x = np.random.default_rng(seed).normal(size=(n, F)).astype(np.float32)
    if shift_col is not None:
        x[:, shift_col] += np.float32(shift)
    return x


def test_sketches_psi_kl_and_profile_equal_jax():
    x = _feature_rows(3000, 1)
    q = np.clip(np.rint(x / (8.0 / 127)), -127, 127).astype(np.int8)
    scores = np.random.default_rng(2).random(3000)
    out = []
    for mod in (sketch, jax_sketch):
        fs = mod.FeatureSketch(F)
        fs.update(x[:1000])
        fs.update(q[1000:])
        other = mod.FeatureSketch(F)
        other.update(x[:500])
        fs.merge(other)
        ss = mod.ScoreSketch()
        ss.update(scores)
        shifted = mod.FeatureSketch(F)
        shifted.update(_feature_rows(800, 3, shift_col=2, shift=3.0))
        mean, var = fs.moments()
        prof = mod.build_profile(fs, ss, feature_names=list("abcdef"),
                                 train_auc=0.75, train_error=0.2, epoch=3)
        out.append(dict(
            hist=fs.hist, rows=fs.rows, mean=mean, var=var,
            score=ss.to_dict(), prof=json.dumps(prof, sort_keys=True),
            summary=mod.profile_summary(prof),
            psi=mod.psi(fs.hist, shifted.hist),
            kl=mod.kl_divergence(ss.hist, np.roll(ss.hist, 5)),
            shift=mod.mean_shift_sigmas(mean, var, shifted.moments()[0]),
            back=mod.profile_sketches(prof)[0].hist))
    mine, theirs = out
    for k in mine:
        if isinstance(mine[k], np.ndarray):
            np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)
        else:
            assert mine[k] == theirs[k], k
    assert int(np.argmax(mine["psi"])) == 2 and mine["psi"][2] > 0.25
    sketch.validate_profile(json.loads(mine["prof"]))
    with pytest.raises(ValueError):
        sketch.validate_profile({"kind": "x"})


def _drift_script(mod, cfg_mod):
    """One scripted drift drill: healthy traffic, one feature shifted by
    3 sigma, labelled feedback, then healthy again; every tick's alerts
    and report."""
    base = mod.sketch_mod.FeatureSketch(F)
    base.update(_feature_rows(4000, 10))
    bscore = mod.sketch_mod.ScoreSketch()
    bscore.update(np.random.default_rng(11).random(4000))
    prof = mod.sketch_mod.build_profile(
        base, bscore, feature_names=[f"c{j}" for j in range(F)],
        train_auc=0.8)
    eng = mod.DriftEngine(
        mod.DriftMonitor(prof, model_id="m", version=1, digest="d"),
        cfg_mod.DriftConfig(fast_window_s=10.0, slow_window_s=30.0,
                            min_rows=50, psi_threshold=0.2,
                            score_kl_threshold=0.1))
    rng = np.random.default_rng(12)
    log = []
    for i, t in enumerate(np.arange(0.0, 90.0, 5.0)):
        shifted = 25.0 <= t < 60.0
        x = _feature_rows(400, 100 + i, shift_col=4 if shifted else None,
                          shift=3.0)
        s = rng.random(400)
        eng.monitor.observe_batch(x, s)
        eng.monitor.observe_feedback(s, (rng.random(400) < s).astype(float))
        alerts, rep = eng.tick(float(t))
        log.append((alerts, rep))
    return log, eng.state()


def test_drift_engine_equals_jax_on_a_scripted_drill():
    from shifu_tpu.config import schema as jax_schema
    mine, mstate = _drift_script(drift, ps)
    theirs, tstate = _drift_script(jax_drift, jax_schema)
    assert mine == theirs
    assert mstate == tstate
    fired = [a for alerts, _ in mine for a in alerts
             if a["state"] == "firing"]
    assert [a["objective"] for a in fired] == ["feature_psi"]
    assert [f["feature"] for f in fired[0]["features"]] == ["c4"]
    assert any(a["state"] == "resolved" for alerts, _ in mine
               for a in alerts)


def _slo_script(mod):
    eng = mod.SloEngine(mod.SloObjectives(
        p99_ms=5.0, error_rate=0.01, availability=0.99, fast_window_s=1.0,
        slow_window_s=3.0, burn_threshold=2.0, min_requests=5),
        buckets=SCORE_LATENCY_BUCKETS)
    t, req, err, rej = 0.0, 0, 0, 0
    counts = [0] * N_BUCKETS
    log = []
    # healthy, then slow, then errors and rejections, then healthy, idle
    for phase, steps in (("ok", 8), ("slow", 10), ("err", 8), ("ok", 12),
                         ("idle", 10)):
        for _ in range(steps):
            t += 0.5
            if phase != "idle":
                req += 100
                counts[9 if phase == "slow" else 4] += 100
            if phase == "err":
                err += 5
                rej += 3
            eng.observe(t, req, rej, err, counts)
            log.append(eng.evaluate(t))
    return log, eng.state()


def test_slo_engine_decisions_equal_jax():
    mine, mstate = _slo_script(slo)
    theirs, tstate = _slo_script(jax_slo)
    assert mine == theirs and mstate == tstate
    events = [(e["objective"], e["state"]) for evs in mine for e in evs]
    assert ("p99_latency", "firing") in events
    assert ("error_rate", "firing") in events
    assert ("p99_latency", "resolved") in events


def test_stage_statistics_equal_jax():
    rng = np.random.default_rng(4)
    vals = {"admission": rng.random(64) * 1e-4, "queue": rng.random(64) * 1e-3,
            "coalesce": rng.random(64) * 2e-3, "dispatch": 3e-4,
            "device": 2.5e-3, "reply": 1e-5}
    out = []
    for mod, m_metrics in ((slo, metrics), (jax_slo, jax_metrics)):
        m_metrics.default_registry().clear()
        mod.observe_stage_seconds(vals, 64)
        mod.observe_stage_seconds(vals, 64)
        hist = m_metrics.histogram(mod.STAGE_HISTOGRAM,
                                   buckets=SCORE_LATENCY_BUCKETS)
        per = {s: (SCORE_LATENCY_BUCKETS, *hist.counts(stage=s))
               for s in mod.STAGES}
        out.append(mod.stage_stats(per))
    assert out[0] == out[1]
    assert set(out[0]) == set(slo.STAGES)
    assert sum(s["share"] for s in out[0].values()) == pytest.approx(1.0,
                                                                     abs=1e-3)


def test_trace_context_bytes_equal_jax():
    ctx = tracing.TraceContext(trace_id="0123456789abcdef", attempt=1,
                               sampled=True)
    jctx = jax_tracing.TraceContext(trace_id="0123456789abcdef", attempt=1,
                                    sampled=True)
    assert ctx.pack() == jctx.pack() and len(ctx.pack()) == 20
    assert tracing.unpack(jctx.pack()) == ctx
    assert jax_tracing.unpack(ctx.pack()) == jctx
    assert tracing.unpack(b"short") is None
    assert tracing.unpack(b"ZZZZZZZZZZZZZZZZ" + bytes(4)) is None
    m = tracing.mint()
    assert len(m.trace_id) == 16 and m.sampled and m.attempt == 0


# -- wire frames ----------------------------------------------------------------

def test_row_encoding_equals_jax():
    x = _feature_rows(7, 5) * 3
    for dtype in (serve_wire.DTYPE_F32, serve_wire.DTYPE_INT8):
        mine = serve_wire.encode_rows(x, dtype=dtype)
        theirs = jax_wire.encode_rows(x, dtype=dtype)
        assert mine == theirs
        np.testing.assert_array_equal(
            serve_wire.decode_rows(mine[0], dtype, 7, F, *mine[1:]),
            jax_wire.decode_rows(mine[0], dtype, 7, F, *mine[1:]))
    with pytest.raises(serve_wire.WireError):
        serve_wire.decode_rows(b"abc", serve_wire.DTYPE_F32, 1, 1, 1.0, 0.0)


def _capture_frames(client_cls, calls):
    """The bytes a client writes for `calls`, read by a socket that answers
    every frame with an empty ok response."""
    a, b = socket.socketpair()
    a.settimeout(10)
    b.settimeout(10)
    frames = []

    def server():
        try:
            while True:
                frame = serve_wire.read_request(b, with_trace=True)
                frames.append(frame)
                op = frame[0]
                body = b"{}" if op in (serve_wire.OP_STATS,
                                       serve_wire.OP_SWAP,
                                       serve_wire.OP_FEEDBACK) else b""
                serve_wire.write_response(b, 0, body)
        except (ConnectionError, OSError):
            pass

    th = threading.Thread(target=server, daemon=True)
    th.start()
    client = client_cls.__new__(client_cls)
    client._sock = a
    client._lock = threading.Lock()
    raw = []
    real_sendall = a.sendall
    a_send = lambda data: (raw.append(bytes(data)), real_sendall(data))[1]
    client._sock = type("S", (), {"sendall": staticmethod(a_send),
                                  "recv_into": a.recv_into,
                                  "close": a.close})()
    for name, args, kw in calls:
        try:
            getattr(client, name)(*args, **kw)
        except Exception:
            pass  # the canned empty responses need not parse
    a.close()
    th.join(timeout=10)
    b.close()
    return raw, frames


def test_client_frames_are_jax_byte_for_byte():
    x = _feature_rows(3, 6)
    ctx = tracing.TraceContext(trace_id="00000000deadbeef", attempt=2)
    jctx = jax_tracing.TraceContext(trace_id="00000000deadbeef", attempt=2)
    calls = lambda c: [
        ("ping", (), {}),
        ("score_rows", (x,), {}),
        ("score_rows", (x,), {"dtype": serve_wire.DTYPE_F32}),
        ("score_rows", (x[:1],), {"trace": c}),
        ("stats", (), {}),
        ("swap", ("/a/b",), {"engine": "numpy"}),
        ("feedback", ([0.2, 0.9], [0, 1]), {"weights": [1.0, 2.0]})]
    mine, frames = _capture_frames(serve_wire.ServeClient, calls(ctx))
    theirs, _ = _capture_frames(jax_wire.ServeClient, calls(jctx))
    assert mine == theirs and len(mine) == 7
    assert frames[3][-1] == ctx  # the traced frame's context decoded
    # the response frame is JAX's too
    a, b = socket.socketpair()
    a2, b2 = socket.socketpair()
    try:
        serve_wire.write_response(a, 0, b"xyz", n_rows=1, n_cols=3)
        jax_wire.write_response(a2, 0, b"xyz", n_rows=1, n_cols=3)
        assert b.recv(64) == b2.recv(64)
    finally:
        for s in (a, b, a2, b2):
            s.close()


# -- artifacts for the daemon ---------------------------------------------------

def _train_artifact(tmp, model_type="mlp", seed=0, epochs=2):
    from shifu_tpu_torch.data import pipeline as pipe
    from shifu_tpu_torch.data import reader, synthetic
    from shifu_tpu_torch.export.artifact import save_artifact
    from shifu_tpu_torch.train import loop
    schema = synthetic.make_schema(F)
    job = ps.JobConfig(
        schema=schema, data=ps.DataConfig(batch_size=128),
        model=ps.ModelSpec(model_type=model_type, hidden_nodes=(16,),
                           activations=("relu",), compute_dtype="float32"),
        train=ps.TrainConfig(epochs=epochs, seed=seed,
                             optimizer=ps.OptimizerConfig(
                                 name="adam", learning_rate=0.02))
    ).validate()
    cols = reader.project_columns(synthetic.make_rows(3000, schema, seed=3),
                                  schema)
    full = pipe.TabularDataset(cols["features"], cols["target"],
                               cols["weight"])
    tr, va = full.take(np.arange(2000)), full.take(np.arange(2000, 3000))
    res = loop.train(job, tr, va, console=lambda s: None, device="cpu")
    out = save_artifact(res.state.model, job.model, job.schema,
                        str(tmp / f"{model_type}-{seed}"),
                        baseline_profile=res.baseline_profile)
    return out, res, job, tr, va


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    obs.reset_for_tests()
    out = _train_artifact(tmp_path_factory.mktemp("serving"))
    obs.reset_for_tests()
    return out


def _cfg(**kw):
    base = dict(report_every_s=0.0, max_batch=64, min_batch_bucket=4,
                latency_budget_ms=1.0)
    base.update(kw)
    return ps.ServingConfig(**base)


def test_load_engine_tiers(trained):
    out = trained[0]
    assert serve.load_engine(out, "numpy").engine == "numpy"
    assert serve.load_engine(out, "torch", device="cpu").engine == "torch"
    for name in ("native", "aot", "jax"):
        with pytest.raises(NotImplementedError, match=r"\(e\)4"):
            serve.load_engine(out, name)
    with pytest.raises(ValueError, match="unknown"):
        serve.load_engine(out, "bogus")


# -- interop: clients and servers of both packages -------------------------------

def test_jax_client_scores_through_the_port_server(trained):
    out = trained[0]
    x = trained[3].features[:5]
    want = serve.load_engine(out, "torch", device="cpu").compute_batch(x)
    daemon = serve.ScoringDaemon(out, config=_cfg(), device="cpu").start()
    server = serve_wire.ServeServer(daemon, port=0).start()
    try:
        with jax_wire.ServeClient("127.0.0.1", server.port,
                                  timeout=30) as c:
            assert c.ping()
            one = c.score_rows(x[:1], dtype=jax_wire.DTYPE_F32)
            many = c.score_rows(x, dtype=jax_wire.DTYPE_F32)
            q = c.score_rows(x)
            traced = c.score_rows(x[:1], trace=jax_tracing.mint())
            stats = c.stats()
            fb = c.feedback([0.1, 0.8], [0, 1])
        with serve_wire.ServeClient("127.0.0.1", server.port,
                                    timeout=30) as pc:
            q_port = pc.score_rows(x)
    finally:
        server.close()
        daemon.stop()
    np.testing.assert_allclose(one, want[:1], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(many, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(q, q_port)
    np.testing.assert_allclose(q, want, atol=0.02)
    assert traced.shape == (1, 1)
    assert stats["engine"] == "torch" and stats["requests"] == 2
    assert fb == {"ok": True, "rows": 2}


def test_port_client_scores_through_the_jax_server(trained):
    from shifu_tpu.config.schema import ServingConfig as JaxServing
    from shifu_tpu.runtime.serve import ScoringDaemon as JaxDaemon
    out = trained[0]
    x = trained[3].features[:5]
    want = serve.load_engine(out, "numpy").compute_batch(x)
    daemon = JaxDaemon(out, config=JaxServing(
        engine="numpy", report_every_s=0.0, max_batch=64)).start()
    server = jax_wire.ServeServer(daemon, port=0).start()
    try:
        with serve_wire.ServeClient("127.0.0.1", server.port,
                                    timeout=30) as c:
            assert c.ping()
            one = c.score_rows(x[:1], dtype=serve_wire.DTYPE_F32)
            many = c.score_rows(x, dtype=serve_wire.DTYPE_F32)
            traced = c.score_rows(x[:1], trace=tracing.mint(),
                                  dtype=serve_wire.DTYPE_F32)
            stats = c.stats()
            bad = c.swap(str(out) + "-missing")
    finally:
        server.close()
        daemon.stop()
    np.testing.assert_allclose(one, want[:1], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(many, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(traced, want[:1], rtol=1e-5, atol=1e-5)
    assert stats["engine"] == "numpy"
    assert not bad["ok"] and bad["kept_version"] == 1


# -- the daemon's hooks ---------------------------------------------------------

def _journal(tmp):
    return obs.read_journal(str(tmp / "journal.jsonl"))


def test_drift_fires_on_the_shifted_feature_and_feedback_gives_the_auc(
        trained, tmp_path):
    from shifu_tpu_torch.train import loop, step
    out, res, job, tr, va = trained
    obs.configure(str(tmp_path), flush_every=1)
    cfg = _cfg(drift=ps.DriftConfig(fast_window_s=0.5, slow_window_s=1.0,
                                    min_rows=100, psi_threshold=0.25,
                                    score_kl_threshold=0.0))
    daemon = serve.ScoringDaemon(out, config=cfg, device="cpu").start()
    try:
        assert daemon.drift_baseline_digest() == \
            drift.baseline_digest(os.path.join(out, "baseline_profile.json"))
        rng = np.random.default_rng(9)
        t_end = time.monotonic() + 1.5
        while time.monotonic() < t_end:
            daemon.score_batch(tr.features[rng.integers(0, 2000, 300)])
            time.sleep(0.05)
        healthy = [e for e in _journal(tmp_path) if e["kind"] == "drift_alert"]
        t_end = time.monotonic() + 2.5
        while time.monotonic() < t_end:
            x = tr.features[rng.integers(0, 2000, 300)].copy()
            x[:, 3] += 3.0
            daemon.score_batch(x)
            time.sleep(0.05)
        scores = daemon.score_batch(va.features)[:, 0]
        daemon.feedback(scores, va.target[:, 0], va.weight[:, 0])
        daemon.drift_flush()
        stats = daemon.stats()
    finally:
        daemon.stop()
    events = _journal(tmp_path)
    assert not healthy
    fired = [e for e in events if e["kind"] == "drift_alert"
             and e["state"] == "firing"]
    assert [e["objective"] for e in fired] == ["feature_psi"]
    assert [f["feature"] for f in fired[0]["features"]] == ["f3"]
    want = loop.evaluate(res.state, va, job, step.make_eval_step(job),
                         torch.device("cpu"))[1]
    reports = [e for e in events if e["kind"] == "drift_report"]
    assert abs(reports[-1]["auc_live"] - want) <= 0.02
    assert stats["drift"]["alerts_fired"] == 1


def test_a_slow_dispatch_fires_one_p99_alert_and_one_slo_profile(
        trained, tmp_path):
    out = trained[0]
    obs.configure(str(tmp_path), flush_every=1)
    cfg = _cfg(slo_p99_ms=5.0, slo_fast_window_s=0.5, slo_slow_window_s=1.0,
               slo_burn_threshold=2.0)
    daemon = serve.ScoringDaemon(out, config=cfg, device="cpu").start()
    x = trained[3].features[:1][0]
    try:
        for _ in range(30):
            daemon.score(x, timeout=30)
        chaos.configure(chaos.parse_plan({"faults": [
            {"site": "runtime.serve.dispatch", "every": 1,
             "action": "delay", "delay_s": 0.012}]}))
        t_end = time.monotonic() + 4.0
        while time.monotonic() < t_end:
            daemon.score(x, timeout=30)
            if [e for e in _journal(tmp_path)
                    if e["kind"] == "device_profile"]:
                break
        chaos.reset_for_tests()
        time.sleep(0.3)
    finally:
        daemon.stop()
    events = _journal(tmp_path)
    alerts = [e for e in events if e["kind"] == "slo_alert"
              and e["state"] == "firing"]
    assert [a["objective"] for a in alerts] == ["p99_latency"]
    assert alerts[0]["observed_p99_ms"] > 5.0
    profs = [e for e in events if e["kind"] == "device_profile"]
    assert len(profs) == 1 and profs[0]["trigger"] == "slo"
    assert profs[0]["engine"] == "torch"
    assert profs[0]["kernels"], profs[0]
    assert set(profs[0]["modules"]) == {"serve_dispatch"}


def test_a_card_capture_without_device_events_journals_a_fallback(
        tmp_path, monkeypatch):
    """The one-shot slo capture of the card never rolls host ops up as
    device time: with no device event it journals `trace_fallback` (stage
    "parse", trigger "slo", its attempt) and re-arms for the next
    dispatch, up to MAX_CAPTURES captures, with no `device_profile`.  A
    CPU capture that reports itself as one of the card stands in for it;
    a plain CPU capture still journals the CPU rule's profile."""
    from shifu_tpu_torch.train import profiler

    obs.configure(str(tmp_path), flush_every=1)
    real = profiler.start_trace

    def run():
        return torch.ones(8, 8) @ torch.ones(8, 8)

    def dispatch(trig):
        assert torch.equal(trig.capture(run), run())
        deadline = time.monotonic() + 30
        while trig._finishing and time.monotonic() < deadline:
            time.sleep(0.01)

    monkeypatch.setattr(profiler, "start_trace",
                        lambda d: real(d) or True)
    trig = slo.ServeTraceTrigger(trace_dir=str(tmp_path / "card"))
    assert trig.arm(engine="torch")
    for _ in range(slo.ServeTraceTrigger.MAX_CAPTURES):
        assert trig.armed
        dispatch(trig)
    assert not trig.armed
    falls = [e for e in _journal(tmp_path) if e["kind"] == "trace_fallback"]
    assert [(f["stage"], f["trigger"], f["attempt"]) for f in falls] == [
        ("parse", "slo", n + 1)
        for n in range(slo.ServeTraceTrigger.MAX_CAPTURES)]
    assert all("no device events in a capture of the card" in f["error"]
               for f in falls)
    assert not [e for e in _journal(tmp_path)
                if e["kind"] == "device_profile"]

    monkeypatch.setattr(profiler, "start_trace", real)
    trig = slo.ServeTraceTrigger(trace_dir=str(tmp_path / "cpu"))
    assert trig.arm(engine="torch")
    dispatch(trig)
    assert not trig.armed
    profs = [e for e in _journal(tmp_path) if e["kind"] == "device_profile"]
    assert len(profs) == 1 and profs[0]["kernels"]
    assert profs[0]["attempt"] == 1
    assert profs[0]["trace_dir"].startswith(str(tmp_path / "cpu"))


def test_sampled_request_traces_sum_to_e2e(trained, tmp_path):
    out = trained[0]
    obs.configure(str(tmp_path), flush_every=1)
    daemon = serve.ScoringDaemon(out, config=_cfg(trace_sample=4),
                                 device="cpu").start()
    x = trained[3].features[:16]
    try:
        futs = [daemon.submit(r) for r in x]
        for f in futs:
            f.result(timeout=30)
        ctx = tracing.TraceContext(trace_id="feedfacefeedface", attempt=1)
        daemon.score(x[0], timeout=30, trace=ctx)
        stats = daemon.stats()
    finally:
        daemon.stop()
    traces = [e for e in _journal(tmp_path) if e["kind"] == "request_trace"]
    assert [t["seq"] for t in traces] == [4, 8, 12, 16, 17]
    for t in traces:
        parts = sum(t[f"{s}_ms"] for s in slo.STAGES)
        assert parts == pytest.approx(t["e2e_ms"], abs=1e-3)
    assert traces[-1]["trace_id"] == "feedfacefeedface"
    assert traces[-1]["hop"] == 1
    assert set(stats["stages"]) == set(slo.STAGES)
    assert stats["p50_ms"] <= stats["p99_ms"]
    assert stats["trace_sample"] == 4


def test_a_chaos_fault_at_load_keeps_the_previous_version(trained, tmp_path):
    out = trained[0]
    obs.configure(str(tmp_path), flush_every=1)
    daemon = serve.ScoringDaemon(out, config=_cfg(), device="cpu").start()
    x = trained[3].features[:1][0]
    try:
        before = daemon.score(x, timeout=30)
        chaos.configure(chaos.parse_plan({"faults": [
            {"site": "runtime.serve", "at_call": 1, "action": "raise"}]}))
        res = daemon.swap(out)
        chaos.reset_for_tests()
        after = daemon.score(x, timeout=30)
        ok = daemon.swap(out)
    finally:
        daemon.stop()
    assert not res["ok"] and res["kept_version"] == 1
    np.testing.assert_array_equal(before, after)
    assert ok["ok"] and ok["version"] == 2
    assert ok["baseline_digest"] == daemon.drift_baseline_digest()
    kinds = [e["kind"] for e in _journal(tmp_path)]
    assert "model_swap_failed" in kinds and "chaos_inject" in kinds
    assert kinds.count("model_swap") == 2


def test_serve_forever_serves_and_drains(trained, tmp_path):
    out = trained[0]
    obs.configure(str(tmp_path), flush_every=1)
    lines = []
    stop = threading.Event()
    rc = []
    th = threading.Thread(target=lambda: rc.append(serve.serve_forever(
        out, _cfg(port=0, report_every_s=0.2), echo=lines.append,
        device="cpu", stop_event=stop)), daemon=True)
    th.start()
    t_end = time.monotonic() + 30
    while not lines and time.monotonic() < t_end:
        time.sleep(0.02)
    port = int(lines[0].split(" on ")[1].split()[0].rsplit(":", 1)[1])
    with serve_wire.ServeClient("127.0.0.1", port, timeout=30) as c:
        got = c.score_rows(trained[3].features[:3],
                           dtype=serve_wire.DTYPE_F32)
    time.sleep(0.3)
    stop.set()
    th.join(timeout=30)
    assert rc == [0] and got.shape == (3, 1)
    assert lines[-1].startswith("serve: stopped")
    kinds = [e["kind"] for e in _journal(tmp_path)]
    assert "serve_start" in kinds and "serving_report" in kinds


def test_the_default_device_is_the_card(trained, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.ScoringDaemon(trained[0])


# -- the loadtest -----------------------------------------------------------------

def test_loadtests_in_process_and_over_the_socket(trained, tmp_path):
    out = trained[0]
    obs.configure(str(tmp_path), flush_every=1)
    daemon = serve.ScoringDaemon(out, config=_cfg(), device="cpu").start()
    server = serve_wire.ServeServer(daemon, port=0).start()
    try:
        inproc = loadtest.run_loadtest(daemon=daemon, rate=400.0,
                                       duration=0.5, senders=2, seed=1,
                                       trace_sample=10)
        sock = loadtest.run_loadtest(connect=f"127.0.0.1:{server.port}",
                                     rate=200.0, duration=0.5, senders=2)
    finally:
        server.close()
        daemon.stop()
    for rep in (inproc, sock):
        assert rep["errors"] == 0 and rep["rejected"] == 0
        assert rep["completed"] == rep["submitted"] > 0
        assert 0 < rep["p50_ms"] <= rep["p99_ms"] <= rep["max_ms"]
        assert set(rep["stages"]) == set(slo.STAGES)
    assert inproc["mode"] == "inproc" and sock["mode"] == "socket"
    assert inproc["engine"] == "torch" and inproc["trace_exemplars"]
    kinds = [e["kind"] for e in _journal(tmp_path)]
    assert kinds.count("loadtest_report") == 2


def test_find_capacity_ramps_until_it_saturates(trained):
    cap = loadtest.find_capacity(trained[0], engine="numpy",
                                 p99_target_ms=1e-6, start_rate=200.0,
                                 max_steps=2, step_duration=0.3)
    assert cap["capacity_scores_per_sec"] is None
    assert [s["ok"] for s in cap["ramp"]] == [False]
    assert cap["p99_target_ms"] == 1e-6


def test_backoff_ladder_is_the_routers():
    from shifu_tpu.runtime.router import _Backoff as JaxBackoff
    import random
    random.seed(5)
    mine = loadtest._Backoff(base_s=0.02, cap_s=0.5)
    got = [mine.fail(now=0.0) for _ in range(6)]
    random.seed(5)
    theirs = JaxBackoff(base_s=0.02, cap_s=0.5)
    assert got == [theirs.fail(now=0.0) for _ in range(6)]
    mine.ok()
    theirs.ok()
    random.seed(6)
    first = mine.fail(now=0.0)
    random.seed(6)
    assert first == theirs.fail(now=0.0)
