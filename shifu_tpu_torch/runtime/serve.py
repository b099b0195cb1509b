"""Serving plane: persistent scorer daemon with adaptive micro-batching, a
hot-swappable model registry, and its hooks (port of
shifu_tpu/runtime/serve.py).

- ScoringDaemon: admission queue + adaptive micro-batcher.  A request is
  one feature row; the dispatch loop takes everything queued (up to
  `max_batch`) when either the oldest request's latency budget expires or
  the queue reaches `max_batch`, so batch size tracks queue depth under
  load and a lone request never waits past the budget.  Static-shape
  engines (torch) get batches padded up a power-of-two bucket ladder.
- ModelRegistry: versioned load and atomic swap of export artifacts.  A
  load builds and warms the new scorer before it becomes visible; a failed
  or chaos-injected load (chaos site `runtime.serve`) keeps the previous
  version serving and journals `model_swap_failed`.
- The hooks: per-request latencies into the shared
  `score_latency_seconds` schema and the lifecycle stages into
  `serve_stage_seconds` (obs/slo.py); the SLO engine with its one-shot
  device trace (trigger "slo"); the drift engine over the artifact's
  `baseline_profile.json` with labelled feedback (obs/drift.py); sampled
  `request_trace` events; `serving_report` events and the metrics
  publisher; the dispatch chaos site `runtime.serve.dispatch`.
- serve_forever: the daemon behind the wire server (runtime/serve_wire.py)
  until SIGINT or SIGTERM.

Engines: "torch" (`export.scorer.TorchScorer`, on `device`, the card by
default) and "numpy" (`export.scorer.Scorer`, the op-list interpreter on
the host).  The native C++ engine and a compiled tier are ROADMAP.md
queue A item (e)4; the fleet's heartbeat lease is (e)7.
"""

from __future__ import annotations

import functools
import json
import os
import threading
import time
from concurrent.futures import Future
from typing import Callable, Optional

import numpy as np

from ..config.schema import ServingConfig
from ..device import DeviceLike
from ..obs import drift as drift_mod
from ..obs import slo as slo_mod

CHAOS_SITE = "runtime.serve"
# the dispatch-path probe (distinct from the load/swap site above, so a
# swap drill never perturbs live scoring): fired once per coalesced batch
# between dequeue and engine compute; a `delay` here lands in the
# `dispatch` lifecycle stage
CHAOS_DISPATCH_SITE = "runtime.serve.dispatch"

# engines of the JAX package that later slices port (ROADMAP.md queue A)
_NOT_PORTED_ENGINES = ("native", "aot", "stablehlo", "jax", "auto")


class ServeOverload(RuntimeError):
    """Admission queue at `serving.queue_limit`: backpressure to the
    caller (retry or shed upstream), never an unbounded-latency queue."""


def load_engine(export_dir: str, engine: str = "torch",
                device: DeviceLike = None):
    """Build one scoring engine for an artifact: "torch"
    (`TorchScorer` on `device`, default `cuda:0`) or "numpy" (the op-list
    interpreter on the host, `Scorer`)."""
    if engine == "torch":
        from ..export.scorer import TorchScorer
        return TorchScorer(export_dir, device=device)
    if engine == "numpy":
        from ..export.scorer import Scorer
        return Scorer(export_dir)
    if engine in _NOT_PORTED_ENGINES:
        raise NotImplementedError(
            f"scoring engine {engine!r} is not ported yet (ROADMAP.md, "
            "queue A item (e)4); the port's engines are 'torch' and "
            "'numpy'")
    raise ValueError(f"unknown scoring engine {engine!r}")


def bucket_ladder(min_bucket: int, max_batch: int) -> tuple[int, ...]:
    """The padded-shape ladder: min_bucket, 2x, 4x, ..., capped at
    max_batch (always included)."""
    sizes = []
    b = max(1, int(min_bucket))
    while b < max_batch:
        sizes.append(b)
        b *= 2
    sizes.append(int(max_batch))
    return tuple(sizes)


def bucket_for(n: int, ladder: tuple[int, ...]) -> int:
    for b in ladder:
        if n <= b:
            return b
    return ladder[-1]


class _ModelHandle:
    """One loaded scorer version.  Refcounted: the dispatch loop holds an
    acquire() across each batch, so a retired (swapped-out) version is
    closed only after its last in-flight batch drains."""

    __slots__ = ("scorer", "version", "export_dir", "engine_name",
                 "model_id", "num_heads", "_refs", "_retired")

    def __init__(self, scorer, version: int, export_dir: str,
                 model_id: str, num_heads: Optional[int] = None):
        self.scorer = scorer
        self.version = version
        self.export_dir = export_dir
        self.engine_name = getattr(scorer, "engine",
                                   type(scorer).__name__.lower())
        self.model_id = model_id
        self.num_heads = num_heads  # from the warm score; None unwarmed
        self._refs = 0
        self._retired = False


class ModelRegistry:
    """Versioned multi-model registry with atomic hot-swap.

    `load()` is both initial load and swap: the new scorer is built and
    warmed before the pointer flips; the old version keeps serving until
    that instant and is closed after its in-flight batches release.  With
    `warm_ladder` set (the daemon's padded bucket grid), a static-shape
    engine is warmed at every rung, largest first, on a small thread pool,
    so no live request meets a cold shape; other engines keep a 1-row
    warm.  Every load attempt passes the `runtime.serve` chaos probe: an
    injected (or real) failure leaves the previous version installed and
    is journaled as `model_swap_failed`."""

    def __init__(self, loader: Optional[Callable] = None,
                 warm_ladder: Optional[tuple] = None):
        self._loader = loader or load_engine
        self._warm_ladder = tuple(warm_ladder) if warm_ladder else None
        self._lock = threading.RLock()
        # serializes load(): two concurrent swaps of one model_id would
        # otherwise both snapshot the same predecessor and the
        # intermediate version would never retire.  A separate lock, so a
        # slow load never blocks the hot acquire/release path.
        self._load_lock = threading.Lock()
        self._models: dict[str, _ModelHandle] = {}
        self._next_version = 1
        self._closed = False

    def load(self, export_dir: str, engine: str = "torch",
             model_id: str = "default", warm: bool = True) -> _ModelHandle:
        """Load (or hot-swap) `model_id` from an export artifact; returns
        the installed handle.  Raises on failure — the caller decides
        whether that is fatal (initial load) or degraded (swap; the
        previous version is still installed and serving).  Loads are
        serialized per registry; the dispatch path is never blocked."""
        from .. import chaos, obs

        with self._load_lock:
            return self._load_locked(export_dir, engine, model_id, warm,
                                     chaos, obs)

    def _load_locked(self, export_dir: str, engine: str, model_id: str,
                     warm: bool, chaos, obs) -> _ModelHandle:
        with self._lock:
            if self._closed:
                raise RuntimeError("model registry is closed (daemon "
                                   "stopped) — swap refused")
            old = self._models.get(model_id)
        scorer = None
        try:
            chaos.maybe_fail(CHAOS_SITE, op="load", model=model_id,
                             path=export_dir)
            scorer = self._loader(export_dir, engine)
            n_feat = int(getattr(scorer, "num_features", 0))
            if old is not None and n_feat != getattr(
                    old.scorer, "num_features", n_feat):
                raise ValueError(
                    f"hot-swap feature-width mismatch: current model has "
                    f"{old.scorer.num_features} features, replacement has "
                    f"{n_feat} — a swapped model must keep the wire schema")
            n_heads = None
            if warm and n_feat:
                n_heads = self._warm_scorer(scorer, n_feat, model_id, obs)
                if old is not None and old.num_heads is not None \
                        and n_heads != old.num_heads:
                    raise ValueError(
                        f"hot-swap head-count mismatch: current model "
                        f"scores {old.num_heads} heads, replacement "
                        f"scores {n_heads} — a swapped model must keep "
                        "the response schema")
        except Exception as e:
            # the scorer may already be built (the warm or a check failed
            # after it): free it
            close = getattr(scorer, "close", None)
            if callable(close):
                try:
                    close()
                except Exception:
                    pass
            obs.counter("serve_swap_failed_total",
                        "failed model hot-load attempts").inc(
                model=model_id)
            obs.event("model_swap_failed", model=model_id,
                      path=export_dir, engine=engine,
                      error=f"{type(e).__name__}: {e}"[:300],
                      kept_version=old.version if old else None)
            raise
        with self._lock:
            version = self._next_version
            self._next_version += 1
            handle = _ModelHandle(scorer, version, export_dir, model_id,
                                  num_heads=n_heads)
            self._models[model_id] = handle
            if old is not None:
                old._retired = True
                self._maybe_close(old)
        obs.counter("serve_swap_total", "model hot-loads installed").inc(
            model=model_id)
        obs.event("model_swap", model=model_id, version=version,
                  old_version=old.version if old else None,
                  path=export_dir, engine=handle.engine_name)
        return handle

    def _warm_scorer(self, scorer, n_feat: int, model_id: str,
                     obs) -> int:
        """Warm the not-yet-installed scorer and return its head count.
        Static-shape engines with a ladder are warmed at every padded
        bucket, largest first, before the caller flips the registry
        pointer; warm rows are reported with `n_valid=0`, so they never
        count as scored traffic.  Any warm failure propagates: the load
        fails and the previous version keeps serving."""
        ladder = self._warm_ladder
        if not (ladder and getattr(scorer, "static_shapes", False)):
            out = scorer.compute_batch(np.zeros((1, n_feat), np.float32))
            return int(out.shape[1])
        sizes = sorted({int(b) for b in ladder}, reverse=True)
        bucket_ms: dict[str, float] = {}
        ms_lock = threading.Lock()

        def warm_one(b: int) -> int:
            t_b = time.perf_counter()
            out = scorer.compute_batch(np.zeros((b, n_feat), np.float32),
                                       n_valid=0)
            with ms_lock:
                bucket_ms[str(b)] = round(
                    (time.perf_counter() - t_b) * 1e3, 3)
            return int(out.shape[1])

        from concurrent.futures import ThreadPoolExecutor
        t0 = time.perf_counter()
        workers = min(4, len(sizes))
        if workers > 1:
            with ThreadPoolExecutor(
                    max_workers=workers,
                    thread_name_prefix="serve-prewarm") as pool:
                heads = list(pool.map(warm_one, sizes))
        else:
            heads = [warm_one(sizes[0])]
        obs.event("model_prewarm", model=model_id,
                  engine=getattr(scorer, "engine",
                                 type(scorer).__name__.lower()),
                  buckets=sizes[::-1], bucket_ms=bucket_ms,
                  wall_ms=round((time.perf_counter() - t0) * 1e3, 3))
        return heads[0]

    def acquire(self, model_id: str = "default") -> _ModelHandle:
        with self._lock:
            handle = self._models.get(model_id)
            if handle is None:
                raise KeyError(f"no model {model_id!r} loaded")
            handle._refs += 1
            return handle

    def release(self, handle: _ModelHandle) -> None:
        with self._lock:
            handle._refs -= 1
            self._maybe_close(handle)

    def current(self, model_id: str = "default") -> Optional[_ModelHandle]:
        with self._lock:
            return self._models.get(model_id)

    def close(self) -> None:
        # _load_lock first: a hot-swap racing close() either installs
        # before the sweep (and is retired by it) or is refused
        with self._load_lock:
            with self._lock:
                self._closed = True
                for handle in self._models.values():
                    handle._retired = True
                    self._maybe_close(handle)
                self._models.clear()

    def _maybe_close(self, handle: _ModelHandle) -> None:
        # caller holds self._lock
        if handle._retired and handle._refs <= 0:
            close = getattr(handle.scorer, "close", None)
            if callable(close):
                try:
                    close()
                except Exception:
                    pass
            from .. import obs
            obs.event("model_retired", model=handle.model_id,
                      version=handle.version)


class ScoringDaemon:
    """The persistent scorer: admission queue, micro-batch dispatch,
    hot-swappable model registry, lifecycle, telemetry.

    In-process API (the wire server and runtime/loadtest.py sit on top):

    - `submit(row)` -> Future resolving to that row's (H,) score vector
      (`need_future=False` skips the Future for callers that consume
      results through `on_batch`, the loadtest's fast path).
    - `score(row)` -> scores, synchronous single-request convenience.
    - `score_batch(rows)` -> direct pass-through for already-batched
      requests (still metered and versioned).
    - `swap(export_dir)` -> degrade-safe hot-swap.
    - `feedback(scores, labels)` -> labelled rows for the live AUC.
    - `stats()` -> counters, p50/p99 off the shared latency histogram
      (admission to reply), the lifecycle stages, the SLO and drift
      state.

    The torch engine scores on `device` (default `cuda:0`; pass "cpu" to
    serve on the CPU)."""

    def __init__(self, export_dir: Optional[str] = None, *,
                 config: Optional[ServingConfig] = None,
                 engine: Optional[str] = None,
                 device: DeviceLike = None,
                 registry: Optional[ModelRegistry] = None,
                 loader: Optional[Callable] = None,
                 model_id: str = "default",
                 on_batch: Optional[Callable] = None):
        self.config = config or ServingConfig()
        if engine is not None:
            self.config = self.config.replace(engine=engine)
        self.config.validate()
        self.model_id = model_id
        # the padded-bucket grid, computed BEFORE the registry so an
        # owned registry pre-warms every rung of it on load/swap
        # (prewarm_ladder=False restores the single 1-row warm)
        self._ladder = bucket_ladder(self.config.min_batch_bucket,
                                     self.config.max_batch)
        # an injected registry is the caller's; only a registry built
        # here is closed by stop()
        self._owns_registry = registry is None
        self._registry = registry or ModelRegistry(
            loader=loader or functools.partial(load_engine, device=device),
            warm_ladder=(self._ladder if self.config.prewarm_ladder
                         else None))
        if export_dir is not None:
            self._registry.load(export_dir, engine=self.config.engine,
                                model_id=model_id)
        current = self._registry.current(model_id)
        if current is None:
            raise ValueError("ScoringDaemon needs an export_dir or a "
                             "pre-loaded registry")
        self.num_features = int(current.scorer.num_features)
        self._row_shape = (self.num_features,)
        self._on_batch = on_batch
        self._budget_s = self.config.latency_budget_ms / 1000.0
        # a plain Lock, not the Condition default RLock: submit() takes it
        # once per request on the hot path and never recursively
        self._cond = threading.Condition(threading.Lock())
        # [(row, t_arrival, future|None, t_enqueued, trace_seq, trace)]:
        # t_enqueued splits admission from queue wait; trace_seq is the
        # admitted-request ordinal for the sampled request_trace journal
        # (0 = untraced); trace is the TraceContext a wire frame carried
        self._queue: list = []
        self._running = False
        self._accepting = False
        self._threads: list[threading.Thread] = []
        self._t_start = 0.0
        # counters mutated under self._cond (cheap ints on the hot path;
        # published to the obs registry by the reporter/stop)
        self._requests = 0
        self._rejected = 0
        self._errors = 0
        self._batches = 0
        self._batch_rows = 0
        self._padded_rows = 0
        self._direct_rows = 0
        self._direct_batches = 0
        self._swaps_failed = 0
        self._admitted = 0              # drives request_trace sampling
        # SLO engine + the one-shot device-trace bridge (armed by a p99
        # alert, captured around the next dispatch — trigger="slo")
        objectives = slo_mod.SloObjectives.from_serving_config(self.config)
        self._slo = (slo_mod.SloEngine(objectives)
                     if objectives.enabled() else None)
        self._trace_trigger = slo_mod.ServeTraceTrigger()
        # drift observatory (obs/drift.py): one DriftEngine per model,
        # built from the artifact's frozen baseline_profile.json.  The
        # dict stays EMPTY when the kill switch is off or the artifact
        # carries no profile — the dispatch path then pays one dict.get.
        self._drift: dict[str, drift_mod.DriftEngine] = {}
        self._drift_lock = threading.Lock()
        if self.config.drift.enabled and export_dir is not None:
            self._init_drift(model_id, current, export_dir)
        # per-daemon publish baselines: the obs counters are
        # process-global and cumulative, so a second daemon in one
        # process adds its own deltas
        self._published: dict[str, int] = {}
        self._lat_baseline = None  # set at start(); see stats()

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "ScoringDaemon":
        with self._cond:
            if self._running:
                return self
            self._running = True
            self._accepting = True
            self._t_start = time.monotonic()
        # baseline the (process-global, cumulative) latency histogram so
        # stats()/serving_report percentiles cover THIS daemon's
        # requests, not a predecessor's in the same process
        self._lat_baseline = self._latency_counts()
        self._stage_baseline = self.stage_counts()
        for i in range(self.config.workers):
            t = threading.Thread(target=self._worker, daemon=True,
                                 name=f"serve-worker-{i}")
            t.start()
            self._threads.append(t)
        if self.config.report_every_s > 0:
            t = threading.Thread(target=self._reporter, daemon=True,
                                 name="serve-reporter")
            t.start()
            self._threads.append(t)
        if self._slo is not None:
            t = threading.Thread(target=self._slo_loop, daemon=True,
                                 name="serve-slo")
            t.start()
            self._threads.append(t)
        if self.config.drift.enabled:
            # the tick thread runs even with no baseline yet: a swap to
            # a profile-carrying artifact engages drift without restart
            t = threading.Thread(target=self._drift_loop, daemon=True,
                                 name="serve-drift")
            t.start()
            self._threads.append(t)
        return self

    def stop(self, timeout: float = 30.0) -> None:
        """Drain-and-stop: admission closes immediately, queued requests
        are still dispatched, workers exit once the queue is empty."""
        with self._cond:
            self._accepting = False
            self._running = False
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout=timeout)
        self._threads.clear()
        # anything a timed-out worker left behind fails loudly
        with self._cond:
            leftovers, self._queue = self._queue, []
        for _row, _t, fut, _te, _ts, _tc in leftovers:
            if fut is not None:
                fut.set_exception(RuntimeError("serving daemon stopped"))
        self._publish_metrics()
        self._report(final=True)
        if self._owns_registry:
            self._registry.close()

    def __enter__(self) -> "ScoringDaemon":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- request admission ---------------------------------------------

    def submit(self, row, t_arrival: Optional[float] = None,
               need_future: bool = True, trace=None) -> Optional[Future]:
        """Admit one feature row; returns a Future of its (H,) scores.

        `t_arrival` (a time.perf_counter() timestamp) lets an open-loop
        caller charge latency from the SCHEDULED arrival, so a sender
        running behind cannot hide queueing delay (coordinated omission).

        `trace` is the distributed TraceContext the wire server decoded
        from a version-2 frame (obs/tracing.py).  A sampled trace FORCES
        this request into the request_trace journal regardless of the
        local `trace_sample` cadence — the ingress sampling decision
        owns the trace; its member-side hops must not go dark.
        """
        if getattr(row, "shape", None) != self._row_shape:
            # coerce odd inputs up front: a malformed row must be rejected
            # HERE, not poison a whole coalesced batch at dispatch
            row = np.asarray(row, dtype=np.float32).ravel()
            if row.shape != self._row_shape:
                raise ValueError(f"expected {self.num_features} features, "
                                 f"got {row.shape[0]}")
        t = time.perf_counter() if t_arrival is None else t_arrival
        fut = Future() if need_future else None
        cond = self._cond
        with cond:
            if not self._accepting:
                raise RuntimeError("serving daemon is not accepting "
                                   "requests (not started or stopping)")
            q = self._queue
            if len(q) >= self.config.queue_limit:
                self._rejected += 1
                raise ServeOverload(
                    f"admission queue at limit ({self.config.queue_limit} "
                    "requests) — shed or retry")
            self._admitted += 1
            sample = self.config.trace_sample
            trace_seq = (self._admitted
                         if sample > 0 and self._admitted % sample == 0
                         else 0)
            if trace is not None and trace.sampled and not trace_seq:
                trace_seq = self._admitted
            # the enqueue stamp closes the `admission` stage (validation +
            # lock + append) and opens `queue`; one clock read per request
            q.append((row, t, fut, time.perf_counter(), trace_seq, trace))
            n = len(q)
            # wake the dispatcher only on the transitions that matter: an
            # idle worker (empty -> 1) or a full batch; every other submit
            # rides silently on the pending deadline
            if n == 1 or n >= self.config.max_batch:
                cond.notify()
        return fut

    def score(self, row, timeout: Optional[float] = None,
              t_arrival: Optional[float] = None, trace=None) -> np.ndarray:
        """Synchronous single-request scoring through the batcher.
        `t_arrival` extends the lifecycle chain upstream: the wire server
        passes the frame-read stamp so socket transfer/parse time rides
        the admission stage instead of vanishing; `trace` carries the
        frame's distributed trace context into the batcher."""
        fut = self.submit(row, t_arrival=t_arrival, trace=trace)
        return fut.result(timeout=timeout)

    def score_batch(self, rows: np.ndarray) -> np.ndarray:
        """Already-batched requests bypass the coalescer (nothing to
        gain) but still ride the versioned registry + telemetry seam."""
        handle = self._registry.acquire(self.model_id)
        try:
            out = handle.scorer.compute_batch(rows)
        except Exception:
            # a failed batch frame is a scoring error like any other —
            # serve_errors_total must not be micro-batch-path-only
            r = np.asarray(rows)
            with self._cond:
                self._errors += int(r.shape[0]) if r.ndim > 1 else 1
            raise
        finally:
            self._registry.release(handle)
        with self._cond:
            self._direct_rows += out.shape[0]
            self._direct_batches += 1
        drift_eng = self._drift.get(self.model_id)
        if (drift_eng is not None
                and drift_eng.monitor.version == handle.version):
            # the direct path is live traffic too (multi-row wire frames)
            drift_eng.monitor.observe_batch(np.asarray(rows), out)
        return out

    # -- hot swap ------------------------------------------------------

    def swap(self, export_dir: str, engine: Optional[str] = None) -> dict:
        """Degrade-safe hot-swap: on ANY load failure the previous
        version keeps serving and the error is reported, not raised —
        in-flight and future requests are never dropped."""
        try:
            handle = self._registry.load(
                export_dir, engine=engine or self.config.engine,
                model_id=self.model_id)
            result = {"ok": True, "version": handle.version,
                      "engine": handle.engine_name, "path": export_dir}
            if self.config.drift.enabled:
                # the new artifact's baseline replaces the old one (live
                # sketches reset: traffic scored by the old version must
                # not count against the new baseline); no profile drops
                # the model back to drift-dormant.  The digest rides the
                # swap result.
                eng_obj = self._init_drift(self.model_id, handle,
                                           export_dir)
                result["baseline_digest"] = (
                    eng_obj.monitor.digest if eng_obj is not None
                    else None)
            return result
        except Exception as e:
            with self._cond:
                self._swaps_failed += 1
            kept = self._registry.current(self.model_id)
            return {"ok": False,
                    "error": f"{type(e).__name__}: {e}"[:300],
                    "kept_version": kept.version if kept else None}

    # -- drift observatory ---------------------------------------------

    def _init_drift(self, model_id: str, handle, export_dir: str):
        """(Re)build the model's DriftEngine from the artifact's frozen
        baseline, or drop it when the artifact ships none.  Returns the
        engine or None."""
        loaded = drift_mod.load_baseline(export_dir)
        if loaded is None:
            with self._drift_lock:
                self._drift.pop(model_id, None)
            return None
        profile, digest = loaded
        return self.set_drift_baseline(
            profile, model_id=model_id,
            version=handle.version if handle else 1, digest=digest)

    def set_drift_baseline(self, profile: dict, model_id: str = "default",
                           version: int = 1, digest: str = ""):
        """Install (or replace) the drift baseline for a model — swap()
        and __init__ call this with the artifact's profile; tests inject
        synthetic baselines directly.  Returns the DriftEngine, or None
        when drift is off or the profile doesn't match the scorer."""
        if not self.config.drift.enabled:
            return None
        if int(profile.get("num_features", -1)) != self.num_features:
            from .. import obs
            obs.event("drift_baseline_invalid", model=model_id,
                      error=f"profile has {profile.get('num_features')} "
                            f"features, scorer has {self.num_features}")
            with self._drift_lock:
                self._drift.pop(model_id, None)
            return None
        mon = drift_mod.DriftMonitor(
            profile, model_id=model_id, version=version, digest=digest,
            feedback_bins=self.config.drift.feedback_bins)
        eng = drift_mod.DriftEngine(mon, self.config.drift)
        with self._drift_lock:
            self._drift[model_id] = eng
        return eng

    def drift_baseline_digest(self, model_id: str = "default"):
        """The served baseline's digest (None when drift is dormant)."""
        eng = self._drift.get(model_id)
        return eng.monitor.digest if eng is not None else None

    def feedback(self, scores, labels, weights=None,
                 model_id: str = "default") -> int:
        """Labelled-feedback ingestion (the wire FEEDBACK frame,
        `ServeClient.feedback`): (score, label[, weight]) rows feed the
        trailing-window live-AUC accumulator.  Returns rows accepted (0
        when the model has no baseline); raises ValueError when the
        feedback path is disabled."""
        if not (self.config.drift.enabled and self.config.drift.feedback):
            raise ValueError(
                "feedback path disabled (shifu.drift.feedback)")
        eng = self._drift.get(model_id)
        if eng is None:
            return 0
        return eng.monitor.observe_feedback(scores, labels, weights)

    def _drift_tick_once(self, now: float,
                         force_report: bool = False) -> None:
        """One evaluation pass over every model's drift engine: journal
        `drift_alert` transitions + `drift_report`s, export gauges."""
        from .. import obs

        wrote = False
        for _model_id, eng in list(self._drift.items()):
            try:
                alerts, report = eng.tick(now, force_report=force_report)
                eng.export_gauges()
            except Exception:
                continue  # the drift plane must never kill serving
            for ev in alerts:
                obs.counter("drift_alerts_total",
                            "drift alert transitions journaled").inc(
                    objective=ev["objective"], state=ev["state"])
                obs.event("drift_alert", **ev)
                wrote = True
            if report is not None:
                obs.event("drift_report", **report)
                wrote = True
        if wrote:
            try:
                obs.flush()
            except Exception:
                pass

    def drift_flush(self) -> None:
        """Force one drift evaluation and journaled report now: the
        end-of-run flush for drills whose labelled feedback lands after
        the last scheduled tick."""
        self._drift_tick_once(time.monotonic(), force_report=True)

    def _drift_loop(self) -> None:
        """The drift evaluation tick (cadence of the SLO loop): snapshot
        live sketches, diff both trailing windows against the baseline,
        journal `drift_alert` transitions + periodic `drift_report`s,
        export the drift gauges."""
        cfg = self.config.drift
        tick = max(0.05, min(1.0, cfg.fast_window_s / 5.0))
        while True:
            t_next = time.monotonic() + tick
            while time.monotonic() < t_next:
                if not self._running:
                    return
                time.sleep(min(0.05, tick))
            self._drift_tick_once(time.monotonic())

    # -- dispatch loop -------------------------------------------------

    def _worker(self) -> None:
        cond = self._cond
        cfg = self.config
        while True:
            with cond:
                while not self._queue and self._running:
                    cond.wait(0.05)
                if not self._queue:
                    return  # stopped and drained
                # the coalesce window opens HERE: requests enqueued before
                # this stamp were queue-waiting, later arrivals ride the
                # window — the queue/coalesce split of the lifecycle chain
                t_window = time.perf_counter()
                # adaptive window: dispatch when the OLDEST request's
                # budget expires or the queue reaches max_batch —
                # queue-depth-driven batch sizing with a deadline floor
                deadline = self._queue[0][1] + self._budget_s
                while (self._running
                       and len(self._queue) < cfg.max_batch):
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    cond.wait(remaining)
                q = self._queue
                if len(q) <= cfg.max_batch:
                    batch = q          # swap, not slice: O(1), and a
                    self._queue = []   # backlogged list never pays O(n)
                else:                  # front-deletes per dispatch
                    batch = q[:cfg.max_batch]
                    del q[:cfg.max_batch]
                t_take = time.perf_counter()
                if self._queue and self._running:
                    cond.notify()  # another worker can start on the rest
            if batch:
                self._process(batch, t_window, t_take)

    def _process(self, batch: list, t_window: float, t_take: float) -> None:
        n = len(batch)
        rows, arrival_ts, futures, enq_ts, trace_seqs, trace_ctxs = \
            zip(*batch)
        x = np.stack(rows) if n > 1 else rows[0][None, :]
        handle = self._registry.acquire(self.model_id)
        err: Optional[Exception] = None
        scores = None
        padded = n
        t_exec = t_take
        try:
            from .. import chaos
            if getattr(handle.scorer, "static_shapes", False):
                padded = bucket_for(n, self._ladder)
                if padded != n:
                    xp = np.zeros((padded, self.num_features), np.float32)
                    xp[:n] = x
                    x = xp
            # the dispatch probe sits between dequeue and compute, so an
            # injected `delay` inflates exactly the `dispatch` stage
            chaos.maybe_fail(CHAOS_DISPATCH_SITE, rows=n)
            t_exec = time.perf_counter()
            if getattr(handle.scorer, "static_shapes", False):
                def run(xx=x, nn=n):
                    # n_valid: pad rows must not count as scored traffic
                    return handle.scorer.compute_batch(xx, n_valid=nn)[:nn]
            else:
                def run(xx=x):
                    return handle.scorer.compute_batch(xx)
            if self._trace_trigger.armed:
                # a p99 slo_alert armed the one-shot: this dispatch runs
                # under a profiler window, journaled as device_profile
                # trigger="slo" (obs/slo.ServeTraceTrigger)
                scores = self._trace_trigger.capture(run)
            else:
                scores = run()
        except Exception as e:  # noqa: BLE001 — must resolve every future
            err = e
        finally:
            self._registry.release(handle)
        t_done = time.perf_counter()
        arrivals = np.asarray(arrival_ts, np.float64)
        if err is not None:
            for fut in futures:
                if fut is not None:
                    fut.set_exception(err)
            with self._cond:
                self._errors += n
            self._journal_traces(trace_seqs, trace_ctxs, arrivals,
                                 np.asarray(enq_ts, np.float64), t_window,
                                 t_take, t_exec, t_done, t_done, n,
                                 padded, handle,
                                 error=f"{type(err).__name__}: {err}"[:200])
            return
        # counted before the futures resolve: a caller that holds its
        # answer finds its batch in stats()
        with self._cond:
            self._requests += n
            self._batches += 1
            self._batch_rows += n
            self._padded_rows += padded
        if any(f is not None for f in futures):
            for fut, s in zip(futures, scores):
                if fut is not None:
                    fut.set_result(s)
        # e2e is charged through the reply (futures resolved), so the
        # lifecycle stages sum exactly to the latency recorded
        t_reply = time.perf_counter()
        enqs = np.asarray(enq_ts, np.float64)
        latencies = t_reply - arrivals
        from ..export.scorer import observe_request_latencies
        observe_request_latencies("serve", latencies)
        # per-stage histograms (always-on): admission/queue/coalesce vary
        # per request, dispatch/device/reply are batch-shared scalars
        admission = np.clip(enqs - arrivals, 0.0, None)
        queue = np.clip(t_window - enqs, 0.0, None)
        coalesce = np.clip(t_take - np.maximum(enqs, t_window), 0.0, None)
        dispatch_s = max(t_exec - t_take, 0.0)
        device_s = max(t_done - t_exec, 0.0)
        reply_s = max(t_reply - t_done, 0.0)
        try:
            slo_mod.observe_stage_seconds(
                {"admission": admission, "queue": queue,
                 "coalesce": coalesce, "dispatch": dispatch_s,
                 "device": device_s, "reply": reply_s}, n)
        except Exception:
            pass  # telemetry must never fail the dispatch it measures
        drift_eng = self._drift.get(self.model_id)
        if (drift_eng is not None
                and drift_eng.monitor.version == handle.version):
            # live sketch accumulation: un-padded rows and head-0 scores,
            # skipped across a version mismatch
            drift_eng.monitor.observe_batch(x[:n], scores)
        if any(trace_seqs):
            self._journal_traces(trace_seqs, trace_ctxs, arrivals, enqs,
                                 t_window, t_take, t_exec, t_done,
                                 t_reply, n, padded, handle)
        if self._on_batch is not None:
            try:
                self._on_batch(scores, arrivals, t_done)
            except Exception:
                pass  # a caller's bookkeeping bug must not kill dispatch

    def _journal_traces(self, trace_seqs, trace_ctxs, arrivals, enqs,
                        t_window, t_take, t_exec, t_done, t_reply, n: int,
                        padded: int, handle,
                        error: Optional[str] = None) -> None:
        """Journal one `request_trace` event per sampled request of this
        batch: the stage decomposition in ms, summing exactly to e2e_ms
        (shared stamps).  A request that arrived with a TraceContext
        carries its `trace_id` and `hop` (the attempt index)."""
        from .. import obs

        for i, seq in enumerate(trace_seqs):
            if not seq:
                continue
            t_arr = float(arrivals[i])
            t_enq = float(enqs[i])
            fields = {
                "seq": int(seq),
                "admission_ms": round(max(t_enq - t_arr, 0.0) * 1e3, 4),
                "queue_ms": round(max(t_window - t_enq, 0.0) * 1e3, 4),
                "coalesce_ms": round(
                    max(t_take - max(t_enq, t_window), 0.0) * 1e3, 4),
                "dispatch_ms": round(max(t_exec - t_take, 0.0) * 1e3, 4),
                "device_ms": round(max(t_done - t_exec, 0.0) * 1e3, 4),
                "reply_ms": round(max(t_reply - t_done, 0.0) * 1e3, 4),
                "e2e_ms": round(max(t_reply - t_arr, 0.0) * 1e3, 4),
                "batch": n,
                "padded": padded,
                "engine": handle.engine_name,
                "model_version": handle.version,
            }
            ctx = trace_ctxs[i]
            if ctx is not None:
                fields["trace_id"] = ctx.trace_id
                fields["hop"] = int(ctx.attempt)
            if error is not None:
                fields["error"] = error
            obs.event("request_trace", **fields)

    # -- telemetry -----------------------------------------------------

    def _snapshot(self) -> dict:
        with self._cond:
            return {"requests": self._requests,
                    "rejected": self._rejected,
                    "errors": self._errors,
                    "batches": self._batches,
                    "batch_rows": self._batch_rows,
                    "padded_rows": self._padded_rows,
                    "direct_rows": self._direct_rows,
                    "direct_batches": self._direct_batches,
                    "swaps_failed": self._swaps_failed,
                    "queue_depth": len(self._queue)}

    def _latency_counts(self):
        from .. import obs
        from ..export.scorer import SCORE_LATENCY_BUCKETS

        hist = obs.histogram("score_latency_seconds",
                             buckets=SCORE_LATENCY_BUCKETS)
        return hist.counts(engine="serve")

    def stage_counts(self) -> dict:
        """Per-stage snapshots of the process-global `serve_stage_seconds`
        histogram: {stage: (counts, sum, n) | None}; callers window a run
        (runtime/loadtest.py) or the daemon's lifetime (stats()) by
        differencing two snapshots."""
        from .. import obs
        from ..export.scorer import SCORE_LATENCY_BUCKETS

        hist = obs.histogram(slo_mod.STAGE_HISTOGRAM,
                             buckets=SCORE_LATENCY_BUCKETS)
        return {s: hist.counts(stage=s) for s in slo_mod.STAGES}

    @staticmethod
    def stage_window(baseline: dict, current: dict) -> dict:
        """{stage: {"mean_ms", "p99_ms", "count", "share"}} between two
        stage_counts() snapshots (slo.stage_stats)."""
        from ..export.scorer import SCORE_LATENCY_BUCKETS

        per_stage: dict = {}
        for stage in slo_mod.STAGES:
            cur = current.get(stage)
            if cur is None:
                continue
            counts, total, n = cur
            base = (baseline or {}).get(stage)
            if base is not None:
                counts = [c - b for c, b in zip(counts, base[0])]
                total -= base[1]
                n -= base[2]
            per_stage[stage] = (SCORE_LATENCY_BUCKETS, counts, total, n)
        return slo_mod.stage_stats(per_stage)

    def _latency_quantiles(self) -> tuple:
        """(p50, p99) over THIS daemon's requests: the shared
        `score_latency_seconds` schema is process-global and cumulative,
        so difference against the start-time baseline."""
        from ..export.scorer import SCORE_LATENCY_BUCKETS
        from ..obs.metrics import quantile_from_counts

        cur = self._latency_counts()
        if cur is None:
            return None, None
        counts, _total, n = cur
        base = self._lat_baseline
        if base is not None:
            counts = [c - b for c, b in zip(counts, base[0])]
            n -= base[2]
        return (quantile_from_counts(SCORE_LATENCY_BUCKETS, counts, n,
                                     0.50),
                quantile_from_counts(SCORE_LATENCY_BUCKETS, counts, n,
                                     0.99))

    def stats(self) -> dict:
        """Operator view: cumulative counters and histogram-estimated
        latency percentiles (the shared `score_latency_seconds` schema,
        admission to reply, windowed to this daemon's lifetime): the
        series the SLO engine reads."""
        snap = self._snapshot()
        handle = self._registry.current(self.model_id)
        p50, p99 = self._latency_quantiles()
        uptime = (time.monotonic() - self._t_start) if self._t_start else 0
        snap.update({
            "model": self.model_id,
            "version": handle.version if handle else None,
            "engine": handle.engine_name if handle else None,
            "export_dir": handle.export_dir if handle else None,
            "num_features": self.num_features,
            "batch_mean": (snap["batch_rows"] / snap["batches"]
                           if snap["batches"] else None),
            "p50_ms": round(p50 * 1e3, 3) if p50 is not None else None,
            "p99_ms": round(p99 * 1e3, 3) if p99 is not None else None,
            "uptime_s": round(uptime, 2),
            "latency_budget_ms": self.config.latency_budget_ms,
            "max_batch": self.config.max_batch,
        })
        # lifecycle stage decomposition over this daemon's lifetime
        # (histogram-windowed p99, exact means): what a socket loadtest
        # reads
        try:
            stages = self.stage_window(
                getattr(self, "_stage_baseline", None) or {},
                self.stage_counts())
            if stages:
                snap["stages"] = stages
        except Exception:
            pass
        if self._slo is not None:
            snap["slo"] = self._slo.state()
        drift_eng = self._drift.get(self.model_id)
        if drift_eng is not None:
            snap["drift"] = drift_eng.state()
        if self.config.trace_sample:
            snap["trace_sample"] = self.config.trace_sample
        return snap

    def _publish_metrics(self) -> None:
        """Hot-path counters (plain ints under the queue lock) into the
        obs registry; called by the reporter cadence and stop()."""
        from .. import obs

        snap = self._snapshot()
        obs.gauge("serve_queue_depth",
                  "admission-queue depth after dispatch").set(
            snap["queue_depth"])
        for name, key, help_ in (
                ("serve_requests_total", "requests",
                 "single-row requests scored by the daemon"),
                ("serve_rejected_total", "rejected",
                 "requests rejected at the admission limit"),
                ("serve_errors_total", "errors",
                 "requests failed by a scoring error"),
                ("serve_batches_total", "batches",
                 "coalesced batches dispatched"),
                ("serve_direct_rows_total", "direct_rows",
                 "rows scored through the already-batched path")):
            delta = snap[key] - self._published.get(key, 0)
            if delta > 0:
                obs.counter(name, help_).inc(delta)
                self._published[key] = snap[key]

    def _windowed_latency_counts(self) -> Optional[list]:
        """This daemon's per-bucket latency counts (process-global series
        minus the start() baseline): the SLO engine's p99 feed."""
        cur = self._latency_counts()
        if cur is None:
            return None
        counts = list(cur[0])
        base = getattr(self, "_lat_baseline", None)
        if base is not None:
            counts = [c - b for c, b in zip(counts, base[0])]
        return counts

    def _slo_loop(self) -> None:
        """The SLO evaluation tick: feed cumulative counters into the
        engine and journal every alert transition.  Tick = fast_window/5
        (50ms floor, 1s cap) so a violation fires within ~one fast
        window; a firing p99 alert arms the one-shot device trace."""
        from .. import obs

        eng = self._slo
        tick = max(0.05, min(1.0, eng.obj.fast_window_s / 5.0))
        while True:
            t_next = time.monotonic() + tick
            while time.monotonic() < t_next:
                if not self._running:
                    return
                time.sleep(min(0.05, tick))
            now = time.monotonic()
            snap = self._snapshot()
            try:
                eng.observe(now, requests=snap["requests"],
                            rejected=snap["rejected"],
                            errors=snap["errors"],
                            latency_counts=self._windowed_latency_counts())
                events = eng.evaluate(now)
            except Exception:
                continue  # the SLO plane must never kill serving
            for burn_obj, b in eng.state().get("burns", {}).items():
                obs.gauge("slo_burn_rate",
                          "burn rate of each serving SLO objective over "
                          "the fast window").set(b["burn_fast"],
                                                 objective=burn_obj)
            for ev in events:
                obs.counter(
                    "slo_alerts_total",
                    "serving SLO alert transitions journaled").inc(
                        objective=ev["objective"], state=ev["state"])
                obs.event("slo_alert", model=self.model_id, **ev)
                if (ev["state"] == "firing"
                        and ev["objective"] == slo_mod.OBJ_P99):
                    # latency excursion -> kernel-level attribution: the
                    # next dispatch runs under a one-shot trace window
                    # (host-side engines journal the empty attribution,
                    # slo.HOST_ENGINES)
                    handle = self._registry.current(self.model_id)
                    self._trace_trigger.arm(
                        objective=ev["objective"],
                        observed_p99_ms=ev.get("observed_p99_ms"),
                        engine=handle.engine_name if handle else None)
            if events:
                try:
                    obs.flush()
                except Exception:
                    pass

    def _reporter(self) -> None:
        last = self._snapshot()
        last_t = time.monotonic()
        while True:
            t_next = last_t + self.config.report_every_s
            while time.monotonic() < t_next:
                if not self._running:
                    return
                time.sleep(0.1)
            now = time.monotonic()
            self._publish_metrics()
            self._report(window=(last, now - last_t))
            last = self._snapshot()
            last_t = now

    def _report(self, window=None, final: bool = False) -> None:
        from .. import obs

        snap = self.stats()
        fields = dict(snap)
        if window is not None:
            prev, dt = window
            fields["window_s"] = round(dt, 2)
            fields["scores_per_sec"] = round(
                (snap["requests"] - prev["requests"]) / max(dt, 1e-9), 1)
        if final:
            fields["final"] = True
        obs.event("serving_report", **fields)
        try:
            obs.flush()
        except Exception:
            pass


def serve_forever(export_dir: str, config: ServingConfig,
                  echo=print, allow_swap: Optional[bool] = None,
                  device: DeviceLike = None,
                  stop_event: Optional[threading.Event] = None) -> int:
    """The daemon behind the wire server (runtime/serve_wire.py) on
    `config.host`:`config.port` until SIGINT or SIGTERM, or until
    `stop_event` is set; returns a process exit code.  The torch engine
    scores on `device` (default `cuda:0`).  The fleet's heartbeat lease
    is ROADMAP.md queue A item (e)7."""
    import signal

    from .. import obs
    from . import serve_wire

    daemon = ScoringDaemon(export_dir, config=config, device=device)
    daemon.start()
    try:
        server = serve_wire.ServeServer(daemon, host=config.host,
                                        port=config.port,
                                        allow_swap=allow_swap)
        server.start()
    except OSError:
        # bind failure (port in use): drain the running daemon so the
        # final report lands
        daemon.stop()
        raise
    stop_evt = stop_event or threading.Event()

    def _stop(signum, _frame):
        echo(f"serve: signal {signum} - draining")
        stop_evt.set()

    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            signal.signal(sig, _stop)
        except ValueError:
            pass  # not the main thread
    handle = daemon._registry.current(daemon.model_id)
    echo(f"serve: model={export_dir} engine={handle.engine_name} "
         f"features={daemon.num_features} on {server.host}:{server.port} "
         f"(budget={config.latency_budget_ms}ms "
         f"max_batch={config.max_batch})")
    obs.event("serve_start", path=export_dir, engine=handle.engine_name,
              port=server.port, pid=os.getpid())
    try:
        stop_evt.wait()
    except KeyboardInterrupt:
        pass
    server.close()
    daemon.stop()
    stats = daemon.stats()
    echo("serve: stopped - " + json.dumps(
        {k: stats[k] for k in ("requests", "rejected", "errors",
                               "p50_ms", "p99_ms") if k in stats}))
    return 0
