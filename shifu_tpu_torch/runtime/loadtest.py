"""Open-loop load harness for the scoring plane (port of
shifu_tpu/runtime/loadtest.py).

Open loop, not closed loop: request arrival times are drawn up front from
a Poisson process at the offered rate and each request is charged from its
scheduled arrival, so a server (or sender) falling behind cannot slow the
arrival process down and hide queueing delay (coordinated omission).

Two modes:

- in-process (`export_dir=` / `daemon=`): drives a ScoringDaemon directly
  through `submit(need_future=False)`; completions flow back through the
  daemon's `on_batch` hook (scores, scheduled arrivals and done-stamp per
  dispatched batch), so the measured path is admission -> micro-batch ->
  score -> completion with no per-request Future.
- socket (`connect=`): each sender owns a ServeClient connection and
  round-trips single-row frames against a live wire server
  (runtime/serve_wire.py); rates are bounded by the per-connection round
  trip, so raise `senders` for parallelism.  A sender whose connection
  dies reconnects with the fleet router's decorrelated-jitter backoff
  (runtime/router.py `_Backoff`).

Percentiles are exact (numpy over the recorded per-request latencies),
not histogram estimates.  Each run reports its lifecycle stage breakdown
(obs/slo.py).  `find_capacity` ramps the offered rate to the highest one
that still meets a p99 target.  An own daemon's torch engine scores on
`device` (default `cuda:0`).
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np

from ..config.schema import ServingConfig
from ..device import DeviceLike
from .router import _Backoff
from .serve import ScoringDaemon, ServeOverload


def _poisson_schedule(rate: float, duration: float,
                      rng: np.random.Generator) -> np.ndarray:
    """Cumulative arrival offsets (seconds) of a Poisson process at
    `rate` over `duration` — drawn ONCE, before any request is sent."""
    n = max(1, int(rate * duration))
    return np.cumsum(rng.exponential(1.0 / rate, size=n))


def _make_rows(num_features: int, rng: np.random.Generator,
               n_unique: int = 2048) -> np.ndarray:
    return rng.standard_normal((n_unique, num_features)).astype(np.float32)


def _shift_rows(rows: np.ndarray, features, shift: float) -> np.ndarray:
    """The drift-drill traffic shaper: a copy of the request pool with
    the selected feature columns translated by `shift` (in raw feature
    units — the pool is standard normal, so `shift` reads as sigmas).
    Un-listed columns are untouched, which is the drill's whole point:
    the PSI engine must name exactly these columns."""
    shifted = np.array(rows, copy=True)
    for j in features:
        shifted[:, int(j)] += np.float32(shift)
    return shifted


def _resolve_drift_features(features, num_features: int) -> list[int]:
    feats = [int(j) for j in (features if features is not None else (0, 1))]
    bad = [j for j in feats if not (0 <= j < num_features)]
    if bad:
        raise ValueError(f"drift feature index {bad} out of range for "
                         f"{num_features} features")
    return feats


def _percentiles(latencies: np.ndarray) -> dict:
    if latencies.size == 0:
        return {"p50_ms": None, "p99_ms": None, "max_ms": None}
    p50, p99 = np.percentile(latencies, [50, 99])
    return {"p50_ms": round(float(p50) * 1e3, 3),
            "p99_ms": round(float(p99) * 1e3, 3),
            "max_ms": round(float(latencies.max()) * 1e3, 3)}


def run_loadtest(export_dir: Optional[str] = None, *,
                 daemon: Optional[ScoringDaemon] = None,
                 connect: Optional[str] = None,
                 engine: str = "torch",
                 device: DeviceLike = None,
                 rate: float = 50_000.0,
                 duration: float = 5.0,
                 senders: int = 2,
                 seed: int = 0,
                 config: Optional[ServingConfig] = None,
                 drain_timeout: float = 30.0,
                 trace_sample: int = 0,
                 trace_exemplars: int = 5,
                 drift_after: float = 0.0,
                 drift_shift: float = 2.0,
                 drift_features=None,
                 feedback: bool = False) -> dict:
    """One open-loop run at a fixed offered rate; returns the report dict
    (offered/achieved scores/s, exact p50/p99/max latency, reject/error
    counts, the stage breakdown).  Exactly one of `export_dir` / `daemon`
    / `connect`; an own daemon (`export_dir`) scores on `device`.

    `trace_sample` > 0 mints a TraceContext (obs/tracing.py) for every
    Nth request and the report carries `trace_exemplars`: the trace ids
    of the slowest sampled requests.  0 = off.

    `drift_after` > 0 turns the run into a drift drill: requests
    scheduled after that many seconds draw from a pool whose
    `drift_features` columns (default the first two) are shifted by
    `drift_shift`.  `feedback=True` additionally ships synthetic labelled
    feedback after the run: score-calibrated labels for pre-drift
    traffic, coin-flip labels for post-drift traffic."""
    if connect is not None:
        return _run_socket(connect, rate=rate, duration=duration,
                           senders=senders, seed=seed,
                           trace_sample=trace_sample,
                           trace_exemplars=trace_exemplars,
                           drift_after=drift_after,
                           drift_shift=drift_shift,
                           drift_features=drift_features,
                           feedback=feedback)
    own_daemon = daemon is None
    if own_daemon:
        if export_dir is None:
            raise ValueError("need export_dir, daemon=, or connect=")
        cfg = config or ServingConfig(engine=engine, report_every_s=0.0)
        daemon = ScoringDaemon(export_dir, config=cfg, device=device).start()
    try:
        return _run_inproc(daemon, rate=rate, duration=duration,
                           senders=senders, seed=seed,
                           drain_timeout=drain_timeout,
                           trace_sample=trace_sample,
                           trace_exemplars=trace_exemplars,
                           drift_after=drift_after,
                           drift_shift=drift_shift,
                           drift_features=drift_features,
                           feedback=feedback)
    finally:
        if own_daemon:
            daemon.stop()


def _top_exemplars(arrivals: np.ndarray, latencies: np.ndarray,
                   trace_map: dict, limit: int) -> list:
    """The `limit` slowest sampled requests as [{trace_id, ms}], joined
    by exact arrival stamp (senders key `trace_map` with the float they
    submit as t_arrival)."""
    out: list = []
    if not trace_map or limit <= 0 or latencies.size == 0:
        return out
    for i in np.argsort(latencies)[::-1]:
        tid = trace_map.get(float(arrivals[i]))
        if tid is not None:
            out.append({"trace_id": tid,
                        "ms": round(float(latencies[i]) * 1e3, 3)})
            if len(out) >= limit:
                break
    return out


def _run_inproc(daemon: ScoringDaemon, *, rate: float, duration: float,
                senders: int, seed: int, drain_timeout: float,
                trace_sample: int = 0, trace_exemplars: int = 5,
                drift_after: float = 0.0, drift_shift: float = 2.0,
                drift_features=None, feedback: bool = False) -> dict:
    rng = np.random.default_rng(seed)
    rows = _make_rows(daemon.num_features, rng)
    n_unique = len(rows)
    schedule = _poisson_schedule(rate, duration, rng)
    n = len(schedule)
    drift_feats: list[int] = []
    if drift_after > 0:
        drift_feats = _resolve_drift_features(drift_features,
                                              daemon.num_features)
        shifted_rows = _shift_rows(rows, drift_feats, drift_shift)

    completed_batches: list = []   # [(arrivals_array, t_done)]; append is
    #                                atomic under the GIL, no lock

    if feedback:
        # the feedback path needs the scores back: keep the head-0 score
        # per batch alongside the arrivals (still one append per batch)
        def on_batch(scores, arrivals, t_done):
            completed_batches.append((arrivals, t_done,
                                      np.asarray(scores)[:, 0]))
    else:
        def on_batch(_scores, arrivals, t_done):
            completed_batches.append((arrivals, t_done))

    prev_hook = daemon._on_batch
    daemon._on_batch = on_batch
    errors_at_start = daemon._snapshot()["errors"]  # the daemon counter
    # is lifetime-cumulative; this run must only count its own
    stages_at_start = daemon.stage_counts()  # likewise the stage
    # histograms: window them to THIS run so the decomposition shows
    # where latency goes at THIS offered rate, not a ramp's mixture
    submitted = [0] * senders
    rejected = [0] * senders
    # pre-resolve each sender's (scheduled time, row) sequence OUTSIDE the
    # timed region: the sender loop is harness overhead that shares the
    # host with the daemon, so it must be as close to submit-only as
    # Python allows (plain floats, no per-request numpy indexing)
    row_views = list(rows)  # slice once; senders share the 1-D views
    if drift_feats:
        # drift drill: requests scheduled past the cut draw from the
        # shifted pool — resolved here, OUTSIDE the timed region, so the
        # sender loop stays submit-only
        shifted_views = list(shifted_rows)
        def _pick(k: int, off: float):
            return (shifted_views if off >= drift_after
                    else row_views)[k % n_unique]
    else:
        def _pick(k: int, _off: float):
            return row_views[k % n_unique]
    offsets = schedule.tolist()
    # trace contexts are pre-minted OUTSIDE the timed region too: the
    # sampled sender path adds one tuple element, not an os.urandom call
    if trace_sample > 0:
        from ..obs import tracing
        ctx_for = [tracing.mint() if k % trace_sample == 0 else None
                   for k in range(n)]
    else:
        ctx_for = [None] * n
    trace_map: dict = {}  # exact t_sched float -> trace_id (exemplars)
    per_sender = []
    for s in range(senders):
        idx = range(s, n, senders)  # thinned Poisson is still Poisson
        per_sender.append([(offsets[k], _pick(k, offsets[k]),
                            ctx_for[k]) for k in idx])
    # stamp the epoch AFTER the (slow) precompute: a t_start taken before
    # it would put every sender behind schedule from the first request
    t_start = time.perf_counter() + 0.02  # lead so senders start on time

    def sender(s: int) -> None:
        submit = daemon.submit
        clock = time.perf_counter
        sleep = time.sleep
        epoch = t_start
        n_sub = n_rej = 0
        for off, row, ctx in per_sender[s]:
            t_sched = epoch + off
            dt = t_sched - clock()
            if dt > 0:
                # plain sleep, never a spin: a spinning sender burns the
                # GIL the dispatch thread needs, which shows up as fake
                # server latency.  Sub-ms oversleep lands the request a
                # hair late and is charged to it honestly (latency runs
                # from t_sched); behind schedule -> fire immediately,
                # the open-loop contract.
                sleep(dt)
            try:
                submit(row, t_arrival=t_sched, need_future=False,
                       trace=ctx)
                n_sub += 1
                if ctx is not None:
                    trace_map[t_sched] = ctx.trace_id
            except ServeOverload:
                n_rej += 1
            except RuntimeError:
                break  # daemon stopped under us
        submitted[s] = n_sub
        rejected[s] = n_rej

    threads = [threading.Thread(target=sender, args=(s,), daemon=True)
               for s in range(senders)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=duration + drain_timeout)
    n_submitted = sum(submitted)
    # drain: every admitted request resolves (errors land in daemon stats)
    t_deadline = time.perf_counter() + drain_timeout
    while time.perf_counter() < t_deadline:
        done = sum(len(b[0]) for b in completed_batches)
        errors = daemon._snapshot()["errors"] - errors_at_start
        if done + errors >= n_submitted:
            break
        time.sleep(0.005)
    daemon._on_batch = prev_hook

    feedback_rows = 0
    if feedback and completed_batches:
        # synthetic labelled feedback, shipped after the run: pre-drift
        # traffic gets score-calibrated Bernoulli labels, post-drift
        # traffic coin-flip labels, so auc_decay opens up
        t_cut = t_start + drift_after if drift_after > 0 else float("inf")
        fb_rng = np.random.default_rng(seed + 1)
        for b in completed_batches:
            arrivals, scores = b[0], b[2]
            s = np.clip(np.asarray(scores, dtype=np.float64), 0.0, 1.0)
            u = fb_rng.random(s.shape)
            labels = np.where(np.asarray(arrivals) < t_cut,
                              u < s, u < 0.5)
            try:
                feedback_rows += daemon.feedback(s, labels)
            except ValueError:
                break  # feedback path disabled on the daemon
        if feedback_rows:
            # the labels landed after the last scheduled drift tick:
            # flush one forced evaluation so auc_decay reaches the
            # journal
            try:
                daemon.drift_flush()
            except Exception:
                pass

    done_counts = [len(b[0]) for b in completed_batches]
    n_completed = sum(done_counts)
    latencies = (np.concatenate(
        [b[1] - b[0] for b in completed_batches])
        if completed_batches else np.empty(0))
    # achieved rate over the span requests actually completed in
    if completed_batches:
        t_first = min(float(b[0].min()) for b in completed_batches)
        t_last = max(b[1] for b in completed_batches)
        span = max(t_last - t_first, 1e-9)
    else:
        span = duration
    snap = daemon._snapshot()
    report = {
        "mode": "inproc",
        "offered_rate": round(rate, 1),
        "duration_s": round(duration, 3),
        "submitted": n_submitted,
        "completed": n_completed,
        "rejected": sum(rejected),
        "errors": snap["errors"] - errors_at_start,
        "achieved_scores_per_sec": round(n_completed / span, 1),
        "batch_mean": round(n_completed / max(len(done_counts), 1), 1),
        "senders": senders,
        **_percentiles(latencies),
    }
    if drift_after > 0:
        report["drift_after_s"] = round(drift_after, 3)
        report["drift_shift"] = round(drift_shift, 3)
        report["drift_features"] = drift_feats
    if feedback:
        report["feedback_rows"] = int(feedback_rows)
    # per-stage latency decomposition of THIS run (queue / coalesce /
    # dispatch / device / reply): where the end-to-end percentile's time
    # went — the capacity-ramp readout that says WHAT saturates first
    stages = daemon.stage_window(stages_at_start, daemon.stage_counts())
    if stages:
        report["stages"] = stages
    if trace_sample > 0 and completed_batches:
        all_arr = np.concatenate([b[0] for b in completed_batches])
        report["trace_exemplars"] = _top_exemplars(
            all_arr, latencies, trace_map, trace_exemplars)
    handle = daemon._registry.current(daemon.model_id)
    if handle is not None:
        report["engine"] = handle.engine_name
    _journal(report)
    return report


def _run_socket(connect: str, *, rate: float, duration: float,
                senders: int, seed: int, trace_sample: int = 0,
                trace_exemplars: int = 5, drift_after: float = 0.0,
                drift_shift: float = 2.0, drift_features=None,
                feedback: bool = False) -> dict:
    from . import serve_wire

    host, _, port_s = connect.rpartition(":")
    host, port = host or "127.0.0.1", int(port_s)
    rng = np.random.default_rng(seed)
    probe = serve_wire.ServeClient(host, port)
    num_features = int(probe.stats()["num_features"])
    probe.close()
    rows = _make_rows(num_features, rng)
    n_unique = len(rows)
    schedule = _poisson_schedule(rate, duration, rng)
    n = len(schedule)
    drift_feats: list[int] = []
    if drift_after > 0:
        drift_feats = _resolve_drift_features(drift_features, num_features)
        shifted_rows = _shift_rows(rows, drift_feats, drift_shift)
    # feedback mode: each sender records (score, is_post_drift) pairs so
    # the harness ships labelled feedback over the wire after the run
    fb_lists: list[list] = [[] for _ in range(senders)]
    lat_lists: list[list] = [[] for _ in range(senders)]
    err_counts = [0] * senders
    rej_counts = [0] * senders
    reconnects = [0] * senders
    # sampled requests carry a wire trace (v2 frames); each sender
    # records (latency, trace_id) pairs for the exemplar join
    sampled_lists: list[list] = [[] for _ in range(senders)]
    if trace_sample > 0:
        from ..obs import tracing
    else:
        tracing = None
    t_start = time.perf_counter() + 0.05
    # a sender may reconnect until the schedule has fully played out
    # (plus grace for the last round-trips): failover drills measure
    # real drops, not a client that gave up on the first RST
    t_give_up = t_start + (float(schedule[-1]) if n else 0.0) + 5.0

    def _reconnect(deadline: float, ladder) -> object:
        """Reconnect with the sender's persistent backoff ladder, retrying
        until the deadline; None when the transport never came back.  A
        successful connect does not reset the ladder (a server that
        accepts and then dies on every request would otherwise flap at
        full tightness); only a completed request does."""
        while time.perf_counter() < deadline:
            try:
                return serve_wire.ServeClient(host, port)
            except (ConnectionError, OSError):
                sleep_s = ladder.fail()
                time.sleep(min(sleep_s,
                               max(0.0, deadline - time.perf_counter())))
        return None

    def sender(s: int) -> None:
        lats = lat_lists[s]
        # one decorrelated-jitter ladder per sender, shared by every
        # reconnect this sender does
        ladder = _Backoff(base_s=0.02, cap_s=0.5)
        # connect inside the accounting scope: a server that is never
        # reachable within the whole schedule charges this sender's
        # every request as an error, not a silent thread exit
        client = _reconnect(t_give_up, ladder)
        if client is None:
            err_counts[s] += len(range(s, n, senders))
            return
        try:
            for k in range(s, n, senders):
                t_sched = t_start + schedule[k]
                dt = t_sched - time.perf_counter()
                if dt > 0:
                    time.sleep(dt)  # see _run_inproc: never spin
                ctx = (tracing.mint() if tracing is not None
                       and k % trace_sample == 0 else None)
                post = bool(drift_feats) and schedule[k] >= drift_after
                pool = shifted_rows if post else rows
                sent = False
                while not sent:
                    try:
                        out = client.score_rows(pool[k % n_unique][None, :],
                                                trace=ctx)
                        lat = time.perf_counter() - t_sched
                        lats.append(lat)
                        if feedback:
                            fb_lists[s].append((float(out[0, 0]), post))
                        if ctx is not None:
                            sampled_lists[s].append((lat, ctx.trace_id))
                        ladder.ok()  # a COMPLETED round-trip — the only
                        #              reset (never a bare connect)
                        sent = True
                    except serve_wire.WireOverload:
                        rej_counts[s] += 1  # backpressure, like inproc
                        sent = True
                    except serve_wire.WireError:
                        err_counts[s] += 1  # per-request error: carry on
                        sent = True
                    except (ConnectionError, OSError):
                        # transport died (daemon killed, socket reset):
                        # reconnect with backoff and retry this request;
                        # scoring is idempotent
                        client.close()
                        reconnects[s] += 1
                        # pace BEFORE reconnecting: against a zombie the
                        # connect below succeeds instantly, so this
                        # sleep is the only thing breaking the flap loop
                        time.sleep(min(
                            ladder.fail(),
                            max(0.0,
                                t_give_up - time.perf_counter())))
                        client = _reconnect(t_give_up, ladder)
                        if client is None:
                            err_counts[s] += 1 + len(
                                range(k + senders, n, senders))
                            return
        finally:
            client.close()

    threads = [threading.Thread(target=sender, args=(s,), daemon=True)
               for s in range(senders)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    span = max(time.perf_counter() - t0, 1e-9)
    latencies = np.asarray([v for lats in lat_lists for v in lats])
    feedback_rows = 0
    if feedback:
        pairs = [p for lst in fb_lists for p in lst]
        if pairs:
            scores = np.clip(np.asarray([p[0] for p in pairs],
                                        dtype=np.float64), 0.0, 1.0)
            post = np.asarray([p[1] for p in pairs], dtype=bool)
            u = np.random.default_rng(seed + 1).random(scores.shape)
            # same synthesis as inproc: calibrated labels pre-drift,
            # coin-flips post-drift (see _run_inproc)
            labels = np.where(post, u < 0.5, u < scores)
            try:
                fb_client = serve_wire.ServeClient(host, port)
                resp = fb_client.feedback(scores, labels)
                fb_client.close()
                feedback_rows = int(resp.get("rows", 0))
            except (ConnectionError, OSError, serve_wire.WireError):
                pass  # feedback disabled / daemon gone: report 0 rows
    report = {
        "mode": "socket",
        "target": f"{host}:{port}",
        "offered_rate": round(rate, 1),
        "duration_s": round(duration, 3),
        "submitted": n,
        "completed": int(latencies.size),
        "rejected": sum(rej_counts),
        "errors": sum(err_counts),
        "reconnects": sum(reconnects),
        "achieved_scores_per_sec": round(latencies.size / span, 1),
        "senders": senders,
        **_percentiles(latencies),
    }
    if drift_after > 0:
        report["drift_after_s"] = round(drift_after, 3)
        report["drift_shift"] = round(drift_shift, 3)
        report["drift_features"] = drift_feats
    if feedback:
        report["feedback_rows"] = feedback_rows
    if trace_sample > 0:
        sampled = sorted((p for lst in sampled_lists for p in lst),
                         reverse=True)[:max(trace_exemplars, 0)]
        report["trace_exemplars"] = [
            {"trace_id": tid, "ms": round(lat * 1e3, 3)}
            for lat, tid in sampled]
    # the daemon's lifetime stage decomposition over the wire (STATS):
    # not windowed to this run (the daemon may serve other traffic), but
    # still names the stage a remote p99 excursion lives in
    try:
        probe = serve_wire.ServeClient(host, port)
        stats = probe.stats()
        probe.close()
        if stats.get("stages"):
            report["stages"] = stats["stages"]
        if stats.get("slo"):
            report["slo"] = stats["slo"]
    except (ConnectionError, OSError, serve_wire.WireError):
        pass
    _journal(report)
    return report


def find_capacity(export_dir: Optional[str] = None, *,
                  daemon: Optional[ScoringDaemon] = None,
                  engine: str = "torch",
                  device: DeviceLike = None,
                  p99_target_ms: float = 10.0,
                  start_rate: float = 25_000.0,
                  max_steps: int = 7,
                  step_duration: float = 1.0,
                  senders: int = 2,
                  config: Optional[ServingConfig] = None,
                  seed: int = 0) -> dict:
    """Ramp the offered rate (x2 per step) to the highest one that still
    meets the p99 target AND keeps up with the offered load (achieved >=
    85% of offered — an open-loop run that falls behind is saturated no
    matter what its percentiles say).  Returns the best passing report
    with the ramp attached."""
    own_daemon = daemon is None
    if own_daemon:
        if export_dir is None:
            raise ValueError("need export_dir or daemon=")
        cfg = config or ServingConfig(engine=engine, report_every_s=0.0)
        daemon = ScoringDaemon(export_dir, config=cfg, device=device).start()
    best = None
    ramp = []
    try:
        rate = start_rate
        for _step in range(max_steps):
            r = _run_inproc(daemon, rate=rate, duration=step_duration,
                            senders=senders, seed=seed,
                            drain_timeout=30.0)
            ok = (r["p99_ms"] is not None
                  and r["p99_ms"] <= p99_target_ms
                  and r["achieved_scores_per_sec"] >= 0.85 * rate
                  and r["rejected"] == 0)
            ramp.append({"rate": round(rate, 1), "ok": ok,
                         "achieved": r["achieved_scores_per_sec"],
                         "p99_ms": r["p99_ms"]})
            if ok:
                best = r
                rate *= 2
            else:
                break
    finally:
        if own_daemon:
            daemon.stop()
    out = dict(best) if best else {"p99_target_ms": p99_target_ms,
                                   "capacity_scores_per_sec": None}
    out["ramp"] = ramp
    out["p99_target_ms"] = p99_target_ms
    if best:
        out["capacity_scores_per_sec"] = best["achieved_scores_per_sec"]
    return out


def render_report(report: dict) -> str:
    """Human text for a loadtest / capacity report, as the `loadtest`
    command prints it (the JAX package's renderer)."""
    lines = []
    if "ramp" in report:
        for step in report["ramp"]:
            lines.append(f"  ramp {step['rate']:>12,.0f}/s -> achieved "
                         f"{step['achieved']:>12,.1f}/s  "
                         f"p99 {step['p99_ms']} ms  "
                         f"{'ok' if step['ok'] else 'SATURATED'}")
        cap = report.get("capacity_scores_per_sec")
        lines.append(f"capacity: {cap:,.0f} scores/s at p99 <= "
                     f"{report['p99_target_ms']} ms" if cap
                     else "capacity: below the starting rate")
    else:
        lines.append(
            f"loadtest [{report['mode']}]: offered "
            f"{report['offered_rate']:,.0f}/s achieved "
            f"{report['achieved_scores_per_sec']:,.0f} scores/s  "
            f"p50 {report['p50_ms']} ms  p99 {report['p99_ms']} ms  "
            f"(completed {report['completed']:,}, rejected "
            f"{report.get('rejected', 0):,}, errors "
            f"{report['errors']:,})")
    stages = report.get("stages")
    if stages:
        from ..obs.slo import STAGES
        parts = [f"{s} {stages[s]['mean_ms']}/{stages[s]['p99_ms']}ms"
                 for s in STAGES if s in stages]
        lines.append("  stages (mean/p99): " + "  ".join(parts))
    exemplars = report.get("trace_exemplars")
    if exemplars:
        lines.append("  slowest traces: " + "  ".join(
            f"{e['trace_id']}={e['ms']}ms" for e in exemplars))
    if report.get("drift_after_s"):
        fb = report.get("feedback_rows")
        lines.append(
            f"  drift drill: features {report.get('drift_features')} "
            f"shifted +{report.get('drift_shift')} after "
            f"{report['drift_after_s']}s"
            + (f", {fb:,} labeled feedback rows shipped"
               if fb is not None else "")
            + "  (the daemon journals drift_report)")
    return "\n".join(lines)


def _journal(report: dict) -> None:
    try:
        from .. import obs
        obs.event("loadtest_report", **report)
        obs.flush()
    except Exception:
        pass


def run_command(export_dir: Optional[str] = None, *,
                connect: Optional[str] = None,
                capacity: bool = False,
                engine: str = "auto",
                device: DeviceLike = None,
                rate: float = 50_000.0,
                duration: float = 5.0,
                senders: int = 2,
                budget_ms: float = 0.0,
                p99_target_ms: float = 10.0,
                seed: int = 0,
                as_json: bool = False,
                **run_kwargs) -> int:
    """The `loadtest` command's body, shared by `shifu-tpu-torch loadtest`
    and `python -m shifu_tpu_torch.tools.loadtest` (each keeps its own
    parser and usage checks): one fixed-rate run or a capacity ramp,
    printed as JSON or as `render_report`'s text.  Exit 0 when anything
    completed, 1 otherwise or on a refused run (a JAX engine name, a
    missing artifact, no CUDA without `device="cpu"`), which is reported
    on one stderr line."""
    import json
    import sys

    from .. import obs

    obs.configure_from_env()
    config = None
    if budget_ms:
        config = ServingConfig(engine=engine, latency_budget_ms=budget_ms,
                               report_every_s=0.0)
    try:
        if capacity:
            report = find_capacity(export_dir, engine=engine, device=device,
                                   p99_target_ms=p99_target_ms,
                                   senders=senders, config=config, seed=seed)
        else:
            report = run_loadtest(export_dir, connect=connect, engine=engine,
                                  device=device, rate=rate,
                                  duration=duration, senders=senders,
                                  config=config, seed=seed, **run_kwargs)
    except (ValueError, OSError, KeyError, RuntimeError) as e:
        print(f"loadtest: {e}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps(report) if as_json else render_report(report))
    obs.flush()
    return 0 if (report.get("capacity_scores_per_sec")
                 or report.get("completed")) else 1
