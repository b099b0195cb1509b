"""Serving SLO engine: rolling-window burn-rate evaluation, per-request
lifecycle stage accounting, and the one-shot device trace of the scoring
daemon (port of shifu_tpu/obs/slo.py).

- Lifecycle stages: every request through runtime/serve.py is decomposed
  into the span chain admission -> queue -> coalesce -> dispatch ->
  device -> reply, whose durations sum exactly to the end-to-end latency
  (the stamps are shared batch boundaries).  `observe_stage_seconds` bins
  a whole batch's per-stage values into the always-on
  `serve_stage_seconds{stage=...}` histogram in one vectorized pass per
  stage.
- SloEngine: objectives from `ServingConfig` (`shifu.serving.slo.*`): p99
  latency, error rate, availability.  The daemon feeds cumulative counters
  and latency-histogram snapshots on a fixed tick; each objective is
  evaluated over a fast and a slow window, and fires one `slo_alert` when
  both burn past `slo_burn_threshold`, latched until the fast window is
  healthy again (burn < 1), which emits state="resolved".
- ServeTraceTrigger: a p99 alert arms it, the daemon's next dispatch runs
  under a torch.profiler window (train/profiler.py), and the rollup
  (obs/tracefmt.py) journals a `device_profile` event with
  trigger="slo".  Chaos-probed at the `obs.trace` site; every failure
  degrades to a journaled `trace_fallback`, and the dispatch itself always
  runs.

The engine is pure given injected timestamps, so drills replay
deterministically.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import threading
from typing import Callable, Optional

# The span chain, in request order.  `admission` is the submit-side cost
# (validation + enqueue), `queue` the wait until a dispatch worker opened
# the coalesce window, `coalesce` the time inside that window, `dispatch`
# host-side batch assembly (stack + pad bucket), `device` the engine's
# compute_batch, `reply` future resolution back to the caller.
STAGES = ("admission", "queue", "coalesce", "dispatch", "device", "reply")

STAGE_HISTOGRAM = "serve_stage_seconds"

# objective keys, as journaled in slo_alert events
OBJ_P99 = "p99_latency"
OBJ_ERRORS = "error_rate"
OBJ_AVAILABILITY = "availability"

# engines with no device plane: the one-shot slo trace skips the
# profiler window for them and journals the empty attribution directly
HOST_ENGINES = ("numpy", "native")


def _latency_buckets() -> tuple:
    # the one serving latency bucket table (export/scorer.py); lazy, so
    # importing obs.slo never pulls in the artifact machinery
    from ..export.scorer import SCORE_LATENCY_BUCKETS
    return SCORE_LATENCY_BUCKETS


def observe_stage_seconds(stage_values: dict, n: int) -> None:
    """Record one dispatched batch's per-stage durations into the
    `serve_stage_seconds{stage=...}` histogram.  `stage_values` maps a
    stage name to either a scalar (the whole batch shared it: dispatch /
    device / reply) or a length-n array (per-request: admission / queue /
    coalesce).  One vectorized bin + one lock acquisition per stage —
    the always-on cost the quiet-traffic budget test pins."""
    import numpy as np

    from . import metrics as metrics_mod

    if n <= 0:
        return
    buckets = _latency_buckets()
    bounds = np.asarray(buckets, np.float64)
    hist = metrics_mod.histogram(
        STAGE_HISTOGRAM,
        "per-request serving lifecycle stage durations "
        "(admission/queue/coalesce/dispatch/device/reply)",
        buckets=buckets)
    for stage, v in stage_values.items():
        arr = np.asarray(v, np.float64)
        if arr.ndim == 0:
            # scalar stage: all n requests saw the same duration — one
            # bucket gets the whole count, no per-request loop
            counts = [0] * (len(buckets) + 1)
            counts[int(np.searchsorted(bounds, float(arr), side="left"))] = n
            hist.merge_counts(counts, float(arr) * n, n, stage=stage)
        else:
            idx = np.searchsorted(bounds, arr, side="left")
            counts = np.bincount(idx, minlength=len(buckets) + 1)
            hist.merge_counts(counts.tolist(), float(arr.sum()), int(arr.size),
                              stage=stage)


def stage_stats(per_stage: dict) -> dict:
    """{stage: (bounds, counts, sum_seconds, n)} -> {stage: {mean_ms,
    p99_ms, count, share}} — the ONE stage-decomposition shape every
    renderer shows (a scrape file's histograms, loadtest /
    stats() from differenced histogram snapshots): share is the stage's
    summed seconds over all stages' (where the e2e wall went)."""
    from .metrics import quantile_from_counts

    out: dict = {}
    sums: dict = {}
    for stage, (bounds, counts, total, n) in per_stage.items():
        if n <= 0:
            continue
        p99 = quantile_from_counts(bounds, counts, n, 0.99)
        out[stage] = {
            "mean_ms": round(total / n * 1e3, 4),
            "p99_ms": round(p99 * 1e3, 4) if p99 is not None else None,
            "count": int(n),
        }
        sums[stage] = total
    total_s = sum(sums.values())
    if total_s > 0:
        for stage, s in out.items():
            s["share"] = round(sums[stage] / total_s, 4)
    return out


# ------------------------------------------------------------- objectives


@dataclasses.dataclass(frozen=True)
class SloObjectives:
    """The serving objectives + burn-rate windows (ServingConfig's
    `slo_*` fields / `shifu.serving.slo.*` XML keys).  An objective at 0
    is disabled; `enabled()` is False when all three are."""

    p99_ms: float = 0.0          # p99 latency target; budget = 1% over it
    error_rate: float = 0.0      # allowed error fraction (e.g. 0.001)
    availability: float = 0.0    # target admitted-and-scored fraction
    fast_window_s: float = 60.0
    slow_window_s: float = 300.0
    burn_threshold: float = 2.0  # both windows must burn past this
    min_requests: int = 20       # don't judge near-empty windows

    def enabled(self) -> bool:
        return (self.p99_ms > 0 or self.error_rate > 0
                or self.availability > 0)

    @classmethod
    def from_serving_config(cls, cfg) -> "SloObjectives":
        return cls(p99_ms=cfg.slo_p99_ms,
                   error_rate=cfg.slo_error_rate,
                   availability=cfg.slo_availability,
                   fast_window_s=cfg.slo_fast_window_s,
                   slow_window_s=cfg.slo_slow_window_s,
                   burn_threshold=cfg.slo_burn_threshold)


class SloEngine:
    """Rolling-window burn-rate evaluation over cumulative daemon
    counters.  Pure given injected timestamps: `observe(now, ...)` feeds
    one sample, `evaluate(now)` returns the alert events (firing AND
    resolved) that transitioned at that instant — the caller journals
    them.  Thread-compat: the daemon's SLO loop is the only caller, but
    state mutation is lock-guarded so stats() can read burn rates."""

    def __init__(self, objectives: SloObjectives,
                 buckets: Optional[tuple] = None):
        self.obj = objectives
        self.buckets = tuple(buckets if buckets is not None
                             else _latency_buckets())
        self._lock = threading.Lock()
        # ring of (t, requests, rejected, errors, latency_counts tuple);
        # pruned to the slow window plus one base sample
        self._samples: collections.deque = collections.deque()
        self._firing: dict[str, dict] = {}
        self._burns: dict[str, dict] = {}  # objective -> last burn pair
        self.alerts_fired = 0

    # -- sampling ------------------------------------------------------

    def observe(self, now: float, requests: int, rejected: int,
                errors: int, latency_counts: Optional[list] = None) -> None:
        """Feed one cumulative snapshot.  `latency_counts` is the
        per-bucket counts list (len(buckets)+1, +Inf last) of THIS
        daemon's `score_latency_seconds` series (already baselined to
        the daemon's lifetime by the caller); None when no request has
        been scored yet."""
        counts = (tuple(int(c) for c in latency_counts)
                  if latency_counts is not None else None)
        with self._lock:
            self._samples.append((float(now), int(requests), int(rejected),
                                  int(errors), counts))
            horizon = float(now) - self.obj.slow_window_s
            # keep ONE sample at/older than the horizon as the window base
            while (len(self._samples) >= 2
                   and self._samples[1][0] <= horizon):
                self._samples.popleft()

    def _window(self, now: float, seconds: float) -> Optional[dict]:
        """Counter deltas over the trailing `seconds` (newest sample vs
        the newest sample at/older than now - seconds; the oldest held
        sample when none is old enough — early life uses what exists)."""
        if len(self._samples) < 2:
            return None
        cur = self._samples[-1]
        cut = now - seconds
        base = self._samples[0]
        for s in self._samples:
            if s[0] <= cut:
                base = s
            else:
                break
        span = cur[0] - base[0]
        if span <= 0:
            return None
        counts = None
        if cur[4] is not None:
            base_counts = base[4] or (0,) * len(cur[4])
            counts = [c - b for c, b in zip(cur[4], base_counts)]
        return {"span_s": span,
                "requests": cur[1] - base[1],
                "rejected": cur[2] - base[2],
                "errors": cur[3] - base[3],
                "latency_counts": counts}

    # -- burn computation ----------------------------------------------

    def _burn_p99(self, w: dict) -> Optional[tuple]:
        """(burn, observed_p99_s) for the latency objective: the burn is
        the fraction of requests slower than the target divided by the 1%
        budget.  Counting is bucket-conservative: requests in buckets
        whose upper bound is <= the target count as meeting it — pick the
        target from the bucket table (1/2.5/5/10/25ms...) for exactness."""
        n = w["requests"]
        counts = w["latency_counts"]
        if counts is None or n < self.obj.min_requests:
            return None
        threshold = self.obj.p99_ms / 1000.0
        ok = 0
        for bound, c in zip(self.buckets, counts):
            if bound <= threshold + 1e-12:
                ok += c
        total = sum(counts)
        if total <= 0:
            return None
        violations = max(total - ok, 0)
        burn = (violations / total) / 0.01
        from .metrics import quantile_from_counts
        p99 = quantile_from_counts(self.buckets, counts, total, 0.99)
        return burn, p99

    def _burn_errors(self, w: dict) -> Optional[tuple]:
        total = w["requests"] + w["errors"]
        if total < self.obj.min_requests:
            return None
        rate = w["errors"] / total
        return rate / self.obj.error_rate, rate

    def _burn_availability(self, w: dict) -> Optional[tuple]:
        total = w["requests"] + w["errors"] + w["rejected"]
        if total < self.obj.min_requests:
            return None
        ok_frac = w["requests"] / total
        budget = max(1.0 - self.obj.availability, 1e-9)
        return (1.0 - ok_frac) / budget, ok_frac

    # -- evaluation ----------------------------------------------------

    def evaluate(self, now: float) -> list[dict]:
        """Evaluate every enabled objective at `now`; returns the
        `slo_alert` event payloads that TRANSITIONED (fired or resolved)
        this call, most severe first.  Idempotent between transitions —
        a latched alert never re-emits."""
        out: list[dict] = []
        with self._lock:
            fast = self._window(now, self.obj.fast_window_s)
            slow = self._window(now, self.obj.slow_window_s)
            if fast is None or slow is None:
                return out
            specs = []
            if self.obj.p99_ms > 0:
                specs.append((OBJ_P99, self._burn_p99,
                              {"target_p99_ms": self.obj.p99_ms}))
            if self.obj.error_rate > 0:
                specs.append((OBJ_ERRORS, self._burn_errors,
                              {"target_error_rate": self.obj.error_rate}))
            if self.obj.availability > 0:
                specs.append((OBJ_AVAILABILITY, self._burn_availability,
                              {"target_availability":
                               self.obj.availability}))
            for name, fn, target in specs:
                bf = fn(fast)
                bs = fn(slow)
                if bf is None:
                    # window below min_requests: no judgment — but a
                    # LATCHED alert must not survive the traffic that
                    # caused it going away (an idle daemon showing a
                    # stale FIRING alert forever helps no one)
                    if name in self._firing:
                        del self._firing[name]
                        self._burns.pop(name, None)
                        out.append({
                            "objective": name, "state": "resolved",
                            "burn_fast": 0.0, "burn_slow": 0.0,
                            "burn_threshold": self.obj.burn_threshold,
                            "fast_window_s": round(fast["span_s"], 3),
                            "slow_window_s": round(slow["span_s"], 3),
                            "requests_window": fast["requests"],
                            "note": "window below min_requests — "
                                    "traffic stopped", **target})
                    continue
                burn_fast, observed = bf
                burn_slow = bs[0] if bs is not None else burn_fast
                self._burns[name] = {"burn_fast": round(burn_fast, 4),
                                     "burn_slow": round(burn_slow, 4)}
                firing = name in self._firing
                ev = {
                    "objective": name,
                    "burn_fast": round(burn_fast, 4),
                    "burn_slow": round(burn_slow, 4),
                    "burn_threshold": self.obj.burn_threshold,
                    "fast_window_s": round(fast["span_s"], 3),
                    "slow_window_s": round(slow["span_s"], 3),
                    "requests_window": fast["requests"],
                    **target,
                }
                if name == OBJ_P99 and observed is not None:
                    ev["observed_p99_ms"] = round(observed * 1e3, 3)
                elif name == OBJ_ERRORS:
                    ev["observed_error_rate"] = round(observed, 6)
                elif name == OBJ_AVAILABILITY:
                    ev["observed_availability"] = round(observed, 6)
                if (not firing and burn_fast >= self.obj.burn_threshold
                        and burn_slow >= self.obj.burn_threshold):
                    ev["state"] = "firing"
                    self._firing[name] = ev
                    self.alerts_fired += 1
                    out.append(ev)
                elif firing and burn_fast < 1.0:
                    ev["state"] = "resolved"
                    del self._firing[name]
                    out.append(ev)
        return out

    def state(self) -> dict:
        """Operator snapshot: per-objective last burn pair + firing set
        (`stats()["slo"]`)."""
        with self._lock:
            return {
                "objectives": {
                    k: v for k, v in (
                        (OBJ_P99, self.obj.p99_ms),
                        (OBJ_ERRORS, self.obj.error_rate),
                        (OBJ_AVAILABILITY, self.obj.availability)) if v > 0},
                "burns": {k: dict(v) for k, v in self._burns.items()},
                "firing": sorted(self._firing),
                "alerts_fired": self.alerts_fired,
            }


# ------------------------------------------------- one-shot device trace


class ServeTraceTrigger:
    """One-shot torch.profiler capture of the next dispatched batch, armed
    by a p99 `slo_alert`; journals a `device_profile` event with
    trigger="slo", the serving counterpart of the flight recorder's
    anomaly trace (obs/devprof.py).

    `armed` is a plain attribute the dispatch hot path reads for free;
    `capture(fn)` is only entered when it is set.  The dispatch runs under
    a `record_function("serve_dispatch")` range, the module its device
    events are attributed to.  The profiler starts and stops on the
    dispatch thread; parsing the trace and journaling run on a background
    thread.  Chaos site `obs.trace` probes every capture; any failure
    journals `trace_fallback`, and `fn` runs regardless.

    A capture of the card that recorded no device event (on the H100 the
    profiler now and then delivers none for a whole window, late in a
    long-lived process) journals `trace_fallback` with its `attempt` and
    re-arms for the next dispatch, up to `MAX_CAPTURES` captures; the
    profile that lands carries `attempt`."""

    MODULE = "serve_dispatch"
    MAX_CAPTURES = 8

    def __init__(self, trace_dir: str = "", top_k: int = 16):
        self._explicit_dir = trace_dir
        self.top_k = int(top_k)
        self._lock = threading.Lock()
        self.armed = False
        self._context: Optional[dict] = None
        self._attempt = 1
        self._seq = 0
        self.captures = 0
        # a capture whose parse and journal still run on their thread
        self._finishing = False

    def arm(self, _attempt: int = 1, **context) -> bool:
        """Arm for the next dispatch; no-op (False) while already armed."""
        with self._lock:
            if self.armed:
                return False
            self._context = dict(context)
            self._attempt = _attempt
            self.armed = True
            return True

    def _resolve_dir(self) -> Optional[str]:
        if self._explicit_dir:
            return self._explicit_dir
        from . import devprof
        return devprof.resolve_trace_dir()

    def capture(self, fn: Callable):
        """Run `fn` under a one-shot profiler window and journal the
        rollup; falls through to a plain `fn()` on any trace failure."""
        with self._lock:
            if not self.armed:
                return fn()
            context, self._context = self._context or {}, None
            attempt = self._attempt
            self.armed = False
            self._seq += 1
            seq = self._seq
        from . import _sinks, devprof, metrics as metrics_mod

        if context.get("engine") in HOST_ENGINES:
            # a host-side engine has no device plane: "not device time"
            # is the attribution
            self._journal_empty(context, "host-side engine "
                                f"({context.get('engine')}) - no device "
                                "plane to trace")
            return fn()
        with self._lock:
            if self._finishing:
                self._journal_empty(context, "previous slo capture still "
                                             "finalizing - skipped")
                return fn()
            self._finishing = True
        base = self._resolve_dir()
        log_dir = (os.path.join(base, f"slo-{seq:04d}")
                   if base else None)
        started = on_card = False
        if log_dir is not None:
            try:
                from .. import chaos
                from ..train import profiler as prof_lib
                chaos.maybe_fail(devprof.CHAOS_SITE, trigger="slo",
                                 path=log_dir)
                on_card = prof_lib.start_trace(log_dir)
                started = True
            except Exception as e:
                _sinks.event("trace_fallback", stage="start", trigger="slo",
                             error=str(e)[:200])
                metrics_mod.counter(
                    "trace_fallback_total",
                    "trace captures degraded to untraced epochs").inc(
                        stage="start")
        else:
            _sinks.event("trace_fallback", stage="start", trigger="slo",
                         error="no trace dir (telemetry sinks not "
                               "configured or remote)")
        if not started:
            with self._lock:
                self._finishing = False
            return fn()
        stopped = False
        try:
            import torch
            with torch.profiler.record_function(self.MODULE):
                out = fn()
        finally:
            stopped = self._stop(context)
            if stopped:
                threading.Thread(target=self._finish_and_clear,
                                 args=(log_dir, context, on_card, attempt),
                                 daemon=True,
                                 name="serve-slo-trace-finish").start()
            else:
                with self._lock:
                    self._finishing = False
        return out

    def _stop(self, context: dict) -> bool:
        from ..train import profiler as prof_lib
        from . import _sinks, metrics as metrics_mod
        try:
            prof_lib.stop_trace()
            return True
        except Exception as e:
            _sinks.event("trace_fallback", stage="stop", trigger="slo",
                         error=str(e)[:200])
            metrics_mod.counter("trace_fallback_total", "").inc(stage="stop")
            return False

    def _finish_and_clear(self, log_dir: str, context: dict,
                          on_card: bool, attempt: int) -> None:
        retake = False
        try:
            retake = self._finish(log_dir, context, on_card, attempt)
        finally:
            with self._lock:
                self._finishing = False
        if retake:
            self.arm(_attempt=attempt + 1, **context)

    def _journal_empty(self, context: dict, note: str) -> None:
        """A device_profile event with no kernels: the excursion's
        attribution when there is nothing on the device side to trace."""
        from . import _sinks, metrics as metrics_mod
        _sinks.event("device_profile", trigger="slo", window_us=0,
                     device_us_total=0, device_fraction=None, lanes=0,
                     kernel_count=0, kernels=[], other_us=0, note=note,
                     **context)
        metrics_mod.counter(
            "device_profiles_total",
            "device trace captures rolled up and journaled").inc(
                trigger="slo")
        self.captures += 1

    def _finish(self, log_dir: str, context: dict, on_card: bool,
                attempt: int) -> bool:
        """Journal the capture's rollup; True when the capture is to be
        retaken on the next dispatch."""
        from . import _sinks, devprof, metrics as metrics_mod, tracefmt
        empty = False
        try:
            rollup = tracefmt.rollup_trace_dir(log_dir, top_k=self.top_k,
                                               on_card=on_card)
            # host ops are not the card's time: no profile from them
            empty = rollup is None and on_card
            if empty:
                raise RuntimeError("no device events in a capture of the "
                                   "card")
        except Exception as e:
            _sinks.event("trace_fallback", stage="parse", trigger="slo",
                         error=str(e)[:200], attempt=attempt)
            metrics_mod.counter("trace_fallback_total", "").inc(stage="parse")
            return empty and attempt < self.MAX_CAPTURES
        if rollup is None:
            rollup = {"window_us": 0, "device_us_total": 0,
                      "device_fraction": None, "lanes": 0,
                      "kernel_count": 0, "kernels": [], "other_us": 0,
                      "note": "no device events in the traced dispatch"}
        else:
            try:
                devprof.roofline_join(rollup)
            except Exception:
                pass
        rollup.update(trigger="slo", trace_dir=log_dir, attempt=attempt,
                      **context)
        _sinks.event("device_profile", **rollup)
        metrics_mod.counter(
            "device_profiles_total",
            "device trace captures rolled up and journaled").inc(
                trigger="slo")
        self.captures += 1
        return False
