"""The traced segment of a `--trace 1` run and its reduction.

`capture(fn, path, sync)` runs `fn` under `torch.profiler` (CPU and CUDA
activities) inside one `record_function` range, `WINDOW`, that ends after
`sync()` has waited for the device, writes the Chrome trace to `path`
and reduces it.

`reduce_events` works on the trace's events alone:

- the traced window is the host range `WINDOW` (its `dur`);
- a device event is a complete event of a device category (`kernel`,
  `gpu_memcpy`, `gpu_memset`), clipped to the window;
- `busy_s` is the length of the union of the device events' intervals,
  so overlapping streams count once; the idle share is 1 - busy/window;
- `kernels` sums each device event name's count and seconds, and the
  breakdown's `device_ops` are the ten largest, their names shortened;
- each idle gap (the window less the union) is put down to the innermost
  host event (`cpu_op`, `cuda_runtime`, `cuda_driver` or a
  `user_annotation` range) open at its midpoint, `host` where none is.
"""

from __future__ import annotations

import heapq
import json
from typing import Callable, Iterable

WINDOW = "perfbench.traced"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
TOP = 10


def idle_pct(reduced: dict | None):
    """The device's idle share of a reduced trace, in %: 100 x (1 - busy /
    window); None where the trace holds no device work."""
    if not reduced or reduced["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - reduced["busy_s"] / reduced["window_s"])


def capture(fn: Callable[[], object], path: str,
            sync: Callable[[], None]) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            fn()
            sync()
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return reduce_events(events)


def short_name(name: str, limit: int = 160) -> str:
    """A device op's name without its argument list and leading `void`:
    the text before the first "(" outside template brackets, with
    `(anonymous namespace)::` left out."""
    name = name.replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name.removeprefix("void ").strip()[:limit]


def _union(intervals: list) -> list:
    out: list = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            if hi > out[-1][1]:
                out[-1][1] = hi
        else:
            out.append([lo, hi])
    return out


def _label_points(points: list, host: list) -> list:
    """For each time in `points` (sorted), the name of the innermost host
    event open at it: of those open, the one that began last."""
    host = sorted(host)
    labels, heap, i = [], [], 0
    for t in points:
        while i < len(host) and host[i][0] <= t:
            lo, hi, name = host[i]
            heapq.heappush(heap, (-lo, hi, name))
            i += 1
        while heap and heap[0][1] < t:
            heapq.heappop(heap)
        labels.append(heap[0][2] if heap else "host")
    return labels


def reduce_events(events: Iterable[dict]) -> dict:
    events = [e for e in events if e.get("ph") == "X"]
    windows = [e for e in events if e.get("name") == WINDOW
               and e.get("cat") == "user_annotation"]
    if not windows:
        raise ValueError(f"trace has no {WINDOW!r} range")
    lo = float(windows[0]["ts"])
    hi = lo + float(windows[0]["dur"])
    spans, kernels = [], {}
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        if b <= lo or a >= hi:
            continue
        spans.append((max(a, lo), min(b, hi)))
        k = kernels.setdefault(e["name"], [0, 0.0])
        k[0] += 1
        k[1] += (b - a) * 1e-6
    busy = _union(spans)
    busy_us = sum(b - a for a, b in busy)
    gaps, prev = [], lo
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = b
    if hi > prev:
        gaps.append((prev, hi))
    host = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
             e["name"]) for e in events
            if e.get("cat") in HOST_CATS and e.get("name") != WINDOW]
    mids = [0.5 * (a + b) for a, b in gaps]
    order = sorted(range(len(gaps)), key=mids.__getitem__)
    labels = _label_points([mids[j] for j in order], host)
    idle: dict = {}
    for j, name in zip(order, labels):
        a, b = gaps[j]
        idle[name] = idle.get(name, 0.0) + (b - a) * 1e-6
    top_ops = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:TOP]
    top_gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return {"window_s": (hi - lo) * 1e-6, "busy_s": busy_us * 1e-6,
            "kernels": {k: tuple(v) for k, v in kernels.items()},
            "breakdown": {"device_ops": [[short_name(k), v[1]]
                                         for k, v in top_ops],
                          "idle_gaps": [[k, v] for k, v in top_gaps]}}
