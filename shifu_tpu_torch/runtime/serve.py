"""Serving plane: persistent scorer daemon with adaptive micro-batching and a
hot-swappable model registry (port of shifu_tpu/runtime/serve.py).

- **ScoringDaemon** — admission queue + adaptive micro-batcher.  A request
  is one feature row; the dispatch loop takes everything queued (up to
  `max_batch`) when either the OLDEST request's latency budget expires or
  the queue reaches `max_batch`, so batch size tracks queue depth under load
  and a lone request never waits past the budget.  Static-shape engines get
  batches padded up a power-of-two bucket ladder.
- **ModelRegistry** — versioned load/atomic swap of export artifacts.  A
  load builds AND warms the new scorer (every rung of the ladder) before it
  becomes visible; a failed load keeps the previous version serving.

Not ported yet (ROADMAP.md): the drift, SLO, chaos, journal and
request-trace hooks, the wire server, and engines other than "torch".
A scoring error resolves the batch's futures with the exception and counts
in `stats()["errors"]`; nothing is swallowed.
"""

from __future__ import annotations

import functools
import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np

from ..config.schema import ServingConfig
from ..device import DeviceLike

# per-request latencies kept for stats() percentiles (newest first out)
_LATENCY_WINDOW = 1_000_000


class ServeOverload(RuntimeError):
    """Admission queue at `queue_limit` — backpressure to the caller."""


def load_engine(export_dir: str, engine: str = "torch",
                device: DeviceLike = None):
    """Build one scoring engine for an artifact.  The port has one engine,
    "torch" (`export.scorer.TorchScorer`)."""
    if engine == "torch":
        from ..export.scorer import TorchScorer
        return TorchScorer(export_dir, device=device)
    raise NotImplementedError(
        f"scoring engine {engine!r} is not ported yet (ROADMAP.md, queue A "
        "item (e)); the port's engine is 'torch'")


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
    """One loaded scorer version, refcounted by in-flight batches."""

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
        self.num_heads = num_heads
        self._refs = 0
        self._retired = False


class ModelRegistry:
    """Versioned multi-model registry with atomic hot-swap.

    `load()` is both initial load and swap: the new scorer is built and
    warmed before the pointer flips.  With `warm_ladder` set, a static-shape
    engine is warmed at every rung, largest first, on a small thread pool,
    so no live request meets a cold shape."""

    def __init__(self, loader: Optional[Callable] = None,
                 warm_ladder: Optional[tuple] = None):
        self._loader = loader or load_engine
        self._warm_ladder = tuple(warm_ladder) if warm_ladder else None
        self._lock = threading.RLock()
        # serializes load(); a slow load never blocks acquire/release
        self._load_lock = threading.Lock()
        self._models: dict[str, _ModelHandle] = {}
        self._next_version = 1
        self._closed = False

    def load(self, export_dir: str, engine: str = "torch",
             model_id: str = "default", warm: bool = True) -> _ModelHandle:
        """Load (or hot-swap) `model_id`; returns the installed handle.
        Raises on failure, with the previous version still installed."""
        with self._load_lock:
            with self._lock:
                if self._closed:
                    raise RuntimeError("model registry is closed (daemon "
                                       "stopped) — swap refused")
                old = self._models.get(model_id)
            scorer = self._loader(export_dir, engine)
            n_feat = int(getattr(scorer, "num_features", 0))
            if old is not None and n_feat != old.scorer.num_features:
                raise ValueError(
                    f"hot-swap feature-width mismatch: current model has "
                    f"{old.scorer.num_features} features, replacement has "
                    f"{n_feat}")
            n_heads = None
            if warm and n_feat:
                n_heads = self._warm_scorer(scorer, n_feat)
                if (old is not None and old.num_heads is not None
                        and n_heads != old.num_heads):
                    raise ValueError(
                        f"hot-swap head-count mismatch: current model "
                        f"scores {old.num_heads} heads, replacement scores "
                        f"{n_heads}")
            with self._lock:
                version = self._next_version
                self._next_version += 1
                handle = _ModelHandle(scorer, version, export_dir, model_id,
                                      num_heads=n_heads)
                self._models[model_id] = handle
                if old is not None:
                    old._retired = True
                    self._maybe_close(old)
            return handle

    def _warm_scorer(self, scorer, n_feat: int) -> int:
        """Warm the not-yet-installed scorer; returns its head count."""
        ladder = self._warm_ladder
        if not (ladder and getattr(scorer, "static_shapes", False)):
            out = scorer.compute_batch(np.zeros((1, n_feat), np.float32))
            return int(out.shape[1])
        sizes = sorted({int(b) for b in ladder}, reverse=True)

        def warm_one(b: int) -> int:
            out = scorer.compute_batch(np.zeros((b, n_feat), np.float32),
                                       n_valid=0)
            return int(out.shape[1])

        with ThreadPoolExecutor(max_workers=min(4, len(sizes)),
                                thread_name_prefix="serve-prewarm") as pool:
            heads = list(pool.map(warm_one, sizes))
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
                close()


class ScoringDaemon:
    """The persistent scorer: admission queue, micro-batch dispatch,
    hot-swappable model registry.

    - `submit(row)` -> Future resolving to that row's (H,) score vector.
    - `score(row)` -> scores, synchronous single-request convenience.
    - `score_batch(rows)` -> direct pass-through for already-batched rows.
    - `swap(export_dir)` -> degrade-safe hot-swap.
    - `stats()` -> requests, batches, batch mean, p50/p99 latency, errors.
    """

    def __init__(self, export_dir: Optional[str] = None, *,
                 config: Optional[ServingConfig] = None,
                 engine: Optional[str] = None,
                 device: DeviceLike = None,
                 registry: Optional[ModelRegistry] = None,
                 model_id: str = "default"):
        self.config = config or ServingConfig()
        if engine is not None:
            self.config = self.config.replace(engine=engine)
        self.config.validate()
        self.model_id = model_id
        self._ladder = bucket_ladder(self.config.min_batch_bucket,
                                     self.config.max_batch)
        self._owns_registry = registry is None
        self._registry = registry or ModelRegistry(
            loader=functools.partial(load_engine, device=device),
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
        self._budget_s = self.config.latency_budget_ms / 1000.0
        self._cond = threading.Condition(threading.Lock())
        # [(row, t_arrival, future)]
        self._queue: list = []
        self._running = False
        self._accepting = False
        self._threads: list[threading.Thread] = []
        self._t_start = 0.0
        # counters mutated under self._cond
        self._requests = 0
        self._rejected = 0
        self._errors = 0
        self._batches = 0
        self._batch_rows = 0
        self._padded_rows = 0
        self._direct_rows = 0
        self._direct_batches = 0
        self._swaps_failed = 0
        self._latencies: deque = deque()
        self._n_latencies = 0

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "ScoringDaemon":
        with self._cond:
            if self._running:
                return self
            self._running = True
            self._accepting = True
            self._t_start = time.monotonic()
        for i in range(self.config.workers):
            t = threading.Thread(target=self._worker, daemon=True,
                                 name=f"serve-worker-{i}")
            t.start()
            self._threads.append(t)
        return self

    def stop(self, timeout: float = 30.0) -> None:
        """Drain-and-stop: admission closes at once, queued requests are
        still dispatched, workers exit once the queue is empty."""
        with self._cond:
            self._accepting = False
            self._running = False
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout=timeout)
        self._threads.clear()
        with self._cond:
            leftovers, self._queue = self._queue, []
        for _row, _t, fut in leftovers:
            fut.set_exception(RuntimeError("serving daemon stopped"))
        if self._owns_registry:
            self._registry.close()

    def __enter__(self) -> "ScoringDaemon":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- request admission ---------------------------------------------

    def submit(self, row, t_arrival: Optional[float] = None) -> Future:
        """Admit one feature row; returns a Future of its (H,) scores.
        `t_arrival` (a time.perf_counter() stamp) charges latency from a
        scheduled arrival rather than from this call."""
        if getattr(row, "shape", None) != self._row_shape:
            row = np.asarray(row, dtype=np.float32).ravel()
            if row.shape != self._row_shape:
                raise ValueError(f"expected {self.num_features} features, "
                                 f"got {row.shape[0]}")
        t = time.perf_counter() if t_arrival is None else t_arrival
        fut: Future = Future()
        with self._cond:
            if not self._accepting:
                raise RuntimeError("serving daemon is not accepting "
                                   "requests (not started or stopping)")
            if len(self._queue) >= self.config.queue_limit:
                self._rejected += 1
                raise ServeOverload(
                    f"admission queue at limit ({self.config.queue_limit} "
                    "requests) — shed or retry")
            self._queue.append((row, t, fut))
            n = len(self._queue)
            if n == 1 or n >= self.config.max_batch:
                self._cond.notify()
        return fut

    def score(self, row, timeout: Optional[float] = None) -> np.ndarray:
        """Synchronous single-request scoring through the batcher."""
        return self.submit(row).result(timeout=timeout)

    def score_batch(self, rows) -> np.ndarray:
        """Already-batched rows bypass the coalescer but still ride the
        versioned registry and the counters."""
        handle = self._registry.acquire(self.model_id)
        try:
            out = handle.scorer.compute_batch(rows)
        except Exception:
            r = np.asarray(rows)
            with self._cond:
                self._errors += int(r.shape[0]) if r.ndim > 1 else 1
            raise
        finally:
            self._registry.release(handle)
        with self._cond:
            self._direct_rows += out.shape[0]
            self._direct_batches += 1
        return out

    # -- hot swap ------------------------------------------------------

    def swap(self, export_dir: str, engine: Optional[str] = None) -> dict:
        """Degrade-safe hot-swap: on any load failure the previous version
        keeps serving and the error is reported, not raised."""
        try:
            handle = self._registry.load(
                export_dir, engine=engine or self.config.engine,
                model_id=self.model_id)
            return {"ok": True, "version": handle.version,
                    "engine": handle.engine_name, "path": export_dir}
        except Exception as e:  # noqa: BLE001 — reported to the caller
            with self._cond:
                self._swaps_failed += 1
            kept = self._registry.current(self.model_id)
            return {"ok": False,
                    "error": f"{type(e).__name__}: {e}"[:300],
                    "kept_version": kept.version if kept else None}

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
                # dispatch when the OLDEST request's budget expires or the
                # queue reaches max_batch
                deadline = self._queue[0][1] + self._budget_s
                while self._running and len(self._queue) < cfg.max_batch:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    cond.wait(remaining)
                q = self._queue
                if len(q) <= cfg.max_batch:
                    batch, self._queue = q, []
                else:
                    batch = q[:cfg.max_batch]
                    del q[:cfg.max_batch]
                if self._queue and self._running:
                    cond.notify()  # another worker can start on the rest
            if batch:
                self._process(batch)

    def _process(self, batch: list) -> None:
        n = len(batch)
        rows, arrival_ts, futures = zip(*batch)
        x = np.stack(rows)
        padded = n
        handle = self._registry.acquire(self.model_id)
        try:
            if handle.scorer.static_shapes:
                padded = bucket_for(n, self._ladder)
                if padded != n:
                    xp = np.zeros((padded, self.num_features), np.float32)
                    xp[:n] = x
                    x = xp
            scores = handle.scorer.compute_batch(x, n_valid=n)[:n]
        except Exception as err:  # noqa: BLE001 — every future must resolve
            for fut in futures:
                fut.set_exception(err)
            with self._cond:
                self._errors += n
            return
        finally:
            self._registry.release(handle)
        for fut, s in zip(futures, scores):
            fut.set_result(s)
        lat = time.perf_counter() - np.asarray(arrival_ts, np.float64)
        with self._cond:
            self._requests += n
            self._batches += 1
            self._batch_rows += n
            self._padded_rows += padded
            self._latencies.append(lat)
            self._n_latencies += n
            while self._n_latencies - len(self._latencies[0]) \
                    >= _LATENCY_WINDOW:
                self._n_latencies -= len(self._latencies.popleft())

    # -- telemetry -----------------------------------------------------

    def stats(self) -> dict:
        """Counters since start, and per-request latency percentiles (from
        admission to the resolved future) over the newest requests."""
        with self._cond:
            snap = {"requests": self._requests,
                    "rejected": self._rejected,
                    "errors": self._errors,
                    "batches": self._batches,
                    "batch_rows": self._batch_rows,
                    "padded_rows": self._padded_rows,
                    "direct_rows": self._direct_rows,
                    "direct_batches": self._direct_batches,
                    "swaps_failed": self._swaps_failed,
                    "queue_depth": len(self._queue)}
            lat = (np.concatenate(list(self._latencies))
                   if self._latencies else None)
        handle = self._registry.current(self.model_id)
        if lat is not None:
            p50, p99 = (float(v) for v in np.percentile(lat, [50, 99]))
        else:
            p50 = p99 = None
        uptime = (time.monotonic() - self._t_start) if self._t_start else 0.0
        snap.update({
            "model": self.model_id,
            "version": handle.version if handle else None,
            "engine": handle.engine_name if handle else None,
            "export_dir": handle.export_dir if handle else None,
            "num_features": self.num_features,
            "batch_mean": (snap["batch_rows"] / snap["batches"]
                           if snap["batches"] else None),
            "p50_ms": p50 * 1e3 if p50 is not None else None,
            "p99_ms": p99 * 1e3 if p99 is not None else None,
            "uptime_s": uptime,
            "latency_budget_ms": self.config.latency_budget_ms,
            "max_batch": self.config.max_batch,
        })
        return snap
