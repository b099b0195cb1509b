"""Metrics registry: counters, gauges, histograms with label sets (port of
shifu_tpu/obs/metrics.py, the same instruments, names and text format).

Every subsystem writes into one process-local registry, which exports a
Prometheus text-format scrape file (`metrics.prom`, written atomically
beside the journal).  The serving plane bins its per-request latencies in
bulk (`Histogram.merge_counts`), windows the cumulative histograms by
differencing `counts()` snapshots and reads quantiles off them
(`quantile_from_counts`).  `MetricsRegistry.snapshot` gives the
registry as one JSON-safe dict.

Dependency-free by design: stdlib + nothing.  Instruments are cheap enough
for per-batch call sites (one dict update under a lock); per-row call sites
should aggregate first (`counter.inc(n)`), never loop.
"""

from __future__ import annotations

import threading
from typing import Iterable, Optional

# Latency-shaped default buckets (seconds): sub-ms host work through
# multi-minute epochs; fixed bounds, the JAX package's, so that scrape
# files of both packages compare bucket for bucket.
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0)


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(key: tuple) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in key)
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if v != v:
        return "NaN"
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class Counter:
    """Monotonic counter; one value per label set."""

    kind = "counter"

    def __init__(self, name: str, help: str, lock: threading.RLock):
        self.name = name
        self.help = help
        self._lock = lock
        self._values: dict[tuple, float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative inc {amount}")
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def total(self) -> float:
        with self._lock:
            return sum(self._values.values())

    def _render(self, out: list[str]) -> None:
        for key in sorted(self._values):
            out.append(f"{self.name}{_fmt_labels(key)} "
                       f"{_fmt_value(self._values[key])}")

    def _snapshot(self) -> dict:
        return {"type": self.kind,
                "values": {";".join("=".join(kv) for kv in k): v
                           for k, v in self._values.items()}}


class Gauge(Counter):
    """Last-write-wins value; `inc` may go either direction."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[_label_key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics) per label set."""

    kind = "histogram"

    def __init__(self, name: str, help: str, lock: threading.RLock,
                 buckets: Iterable[float] = DEFAULT_BUCKETS):
        self.name = name
        self.help = help
        self.buckets = tuple(sorted(buckets))
        self._lock = lock
        # key -> [counts per bucket + inf, sum, count]
        self._series: dict[tuple, list] = {}

    def observe(self, value: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = [[0] * (len(self.buckets) + 1),
                                         0.0, 0]
            counts, _sum, _n = s
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            s[1] = _sum + float(value)
            s[2] = _n + 1

    def observe_many(self, values, **labels) -> None:
        """Observe every value of `values` in one lock acquisition: each
        binned by bisect into the bucket `observe` would pick, then
        merged.  Callers holding numpy arrays bin with searchsorted and
        call merge_counts instead."""
        import bisect

        counts = [0] * (len(self.buckets) + 1)
        total = 0.0
        n = 0
        for v in values:
            v = float(v)
            # the first bound >= v; len(buckets) is +Inf
            counts[bisect.bisect_left(self.buckets, v)] += 1
            total += v
            n += 1
        self.merge_counts(counts, total, n, **labels)

    def count(self, **labels) -> int:
        with self._lock:
            s = self._series.get(_label_key(labels))
            return 0 if s is None else int(s[2])

    def sum(self, **labels) -> float:
        with self._lock:
            s = self._series.get(_label_key(labels))
            return 0.0 if s is None else float(s[1])

    def merge_counts(self, counts, total: float, n: int, **labels) -> None:
        """Merge a pre-bucketed batch (len(buckets)+1 counts in bound
        order, +Inf last) in one lock acquisition: the bulk path for the
        serving daemon's per-request latencies, binned with numpy by the
        caller."""
        counts = list(counts)
        if len(counts) != len(self.buckets) + 1:
            raise ValueError(
                f"merge_counts: got {len(counts)} buckets, histogram "
                f"{self.name} has {len(self.buckets) + 1}")
        key = _label_key(labels)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = [[0] * (len(self.buckets) + 1),
                                         0.0, 0]
            for i, c in enumerate(counts):
                if c:
                    s[0][i] += int(c)
            s[1] += float(total)
            s[2] += int(n)

    def counts(self, **labels) -> Optional[tuple[list, float, int]]:
        """Snapshot of one series: (per-bucket counts incl. +Inf, sum,
        n), or None when empty; two snapshots difference into a window."""
        key = _label_key(labels)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                return None
            return list(s[0]), float(s[1]), int(s[2])

    def quantile(self, q: float, **labels) -> Optional[float]:
        """Histogram-estimated quantile (linear interpolation inside the
        owning bucket); None for an empty series."""
        snap = self.counts(**labels)
        if snap is None or snap[2] == 0:
            return None
        return quantile_from_counts(self.buckets, snap[0], snap[2], q)

    def _render(self, out: list[str]) -> None:
        for key in sorted(self._series):
            counts, total, n = self._series[key]
            cum = 0
            for i, bound in enumerate(self.buckets):
                cum += counts[i]
                le = dict(key)
                le["le"] = _fmt_value(bound)
                out.append(f"{self.name}_bucket{_fmt_labels(_label_key(le))}"
                           f" {cum}")
            le = dict(key)
            le["le"] = "+Inf"
            out.append(f"{self.name}_bucket{_fmt_labels(_label_key(le))} {n}")
            out.append(f"{self.name}_sum{_fmt_labels(key)} "
                       f"{_fmt_value(total)}")
            out.append(f"{self.name}_count{_fmt_labels(key)} {n}")

    def _snapshot(self) -> dict:
        return {"type": self.kind,
                "values": {";".join("=".join(kv) for kv in k):
                           {"sum": s[1], "count": s[2]}
                           for k, s in self._series.items()}}


def quantile_from_counts(buckets, counts, n: int, q: float
                         ) -> Optional[float]:
    """The quantile of an explicit (buckets, counts, n) triple, linearly
    interpolated inside the owning bucket (Prometheus histogram_quantile
    semantics; values past the last finite bound clamp to it)."""
    if n <= 0:
        return None
    rank = q * n
    cum = 0.0
    lo = 0.0
    for i, bound in enumerate(buckets):
        prev = cum
        cum += counts[i]
        if cum >= rank and counts[i] > 0:
            frac = (rank - prev) / counts[i]
            return lo + (bound - lo) * min(max(frac, 0.0), 1.0)
        lo = bound
    return buckets[-1] if buckets else None


class MetricsRegistry:
    """Named instruments, one registry per process (default_registry()).

    Re-registering a name returns the SAME instrument (call sites stay
    declaration-free: `registry.counter("x").inc()` anywhere); a name
    re-registered as a different type raises — silently splitting a metric
    across types would corrupt every consumer.
    """

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._metrics: dict[str, object] = {}

    def _get(self, name: str, cls, help: str, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, self._lock, **kw)
            elif not isinstance(m, cls) or type(m) is not cls:
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, Counter, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, Gauge, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(name, Histogram, help, buckets=buckets)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._metrics)

    def to_prometheus_text(self) -> str:
        """The registry in Prometheus exposition text format (scrape-file
        contract: point a node-exporter textfile collector, or any tool
        that reads the format, at `metrics.prom`)."""
        out: list[str] = []
        with self._lock:
            for name in sorted(self._metrics):
                m = self._metrics[name]
                if m.help:
                    out.append(f"# HELP {name} {m.help}")
                out.append(f"# TYPE {name} {m.kind}")
                m._render(out)
        return "\n".join(out) + ("\n" if out else "")

    def snapshot(self) -> dict:
        """{name: {"type", "values"}}, JSON-safe: a counter's or gauge's
        value per label set ("k=v;k=v"), a histogram's sum and count."""
        with self._lock:
            return {name: m._snapshot()
                    for name, m in sorted(self._metrics.items())}

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _DEFAULT


def counter(name: str, help: str = "") -> Counter:
    return _DEFAULT.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return _DEFAULT.gauge(name, help)


def histogram(name: str, help: str = "",
              buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
    return _DEFAULT.histogram(name, help, buckets)


def write_scrape_file(path: str,
                      registry: Optional[MetricsRegistry] = None) -> None:
    """Write the registry as a Prometheus text file at `path` (a temporary
    file, then a rename: scrapers never see a half-written file).
    Best-effort: telemetry must never fail the job."""
    text = (registry or _DEFAULT).to_prometheus_text()
    try:
        from ..data import fsio
        fsio.write_bytes(path, text.encode())
    except Exception:
        pass
