"""Trace-event parsing: torch.profiler captures -> per-kernel device
rollups (port of shifu_tpu/obs/tracefmt.py).

`train/profiler.start_trace(dir)` writes one Chrome trace-event JSON
(`*.trace.json`) per capture; this module parses it with the stdlib only.
The functions and the rollup's keys are the JAX package's; what counts as
a device event is not, since a torch.profiler trace carries no
`args.hlo_op` tag:

- **On the card**, a device event is a complete ("X") event of a device
  category (`DEVICE_CATS`: `kernel`, `gpu_memcpy`, `gpu_memset`), on its
  (device, stream) lane.  Its `module` is the innermost
  `gpu_user_annotation` range on the same device that encloses it (the
  step program's `record_function` range, obs/flops.instrument, mirrored
  onto the device lane); when the trace has none, the innermost
  `user_annotation` range enclosing the CPU launch its `correlation` id
  names.
- **On the CPU**, where torch.profiler records no kernels, the device
  events are the outermost `cpu_op` events inside a `user_annotation`
  range (a step program's dispatch), on their (pid, tid) lane, with that
  range's name as their module; so a CPU run still journals a
  `device_profile`, as the JAX package's CPU run does.  The rule applies
  only to a trace with no device-category event.

Device events are normalized to the JAX shape (`ph`, `pid`, `tid`, `ts`,
`dur`, `name`, `args.hlo_op`, `args.hlo_module`) so `kernel_rollup`
computes exactly what the JAX one does: per-kernel self time (nesting on a
lane subtracted), fractions of the traced window divided across lanes,
top-K by device time with the tail folded into `other_us`, and per-module
totals taken before the cut.
"""

from __future__ import annotations

import bisect
import gzip
import json
import os
from typing import Iterable, Optional

TRACE_SUFFIXES = (".trace.json.gz", ".trace.json")
DEFAULT_TOP_K = 16

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def find_trace_files(log_dir: str) -> list[str]:
    """Every Chrome-trace file under a capture dir (any nesting), sorted."""
    out: list[str] = []
    for root, _dirs, files in os.walk(log_dir):
        for name in files:
            if name.endswith(TRACE_SUFFIXES):
                out.append(os.path.join(root, name))
    return sorted(out)


def load_trace_events(path: str) -> list[dict]:
    """The `traceEvents` list of one Chrome-trace file (gzip or plain)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:  # type: ignore[operator]
        doc = json.loads(f.read().decode("utf-8", "replace"))
    events = doc.get("traceEvents", []) if isinstance(doc, dict) else []
    return events if isinstance(events, list) else []


def _span(e: dict) -> Optional[tuple[float, float]]:
    try:
        ts = float(e.get("ts", 0.0))
        dur = float(e.get("dur", 0.0))
    except (TypeError, ValueError):
        return None
    if not (dur >= 0.0) or dur == float("inf"):
        return None
    return ts, ts + dur


class _Ranges:
    """Named ranges of one lane; `innermost(lo, hi)` is the name of the
    shortest range that encloses [lo, hi].  A range starting more than the
    longest range's length before `lo` cannot enclose it, so a query scans
    only the ranges that start within that distance."""

    def __init__(self, ranges: list[tuple[float, float, str]]) -> None:
        self._r = sorted(ranges)
        self._starts = [r[0] for r in self._r]
        self._longest = max((r[1] - r[0] for r in self._r), default=0.0)

    def innermost(self, lo: float, hi: float) -> Optional[str]:
        best = None
        i = bisect.bisect_right(self._starts, lo + 1e-6)
        while i > 0:
            i -= 1
            start, end, name = self._r[i]
            if start < lo - self._longest - 1e-6:
                break
            if end >= hi - 1e-6 and (best is None
                                     or end - start < best[1] - best[0]):
                best = (start, end, name)
        return best[2] if best else None


def _ranges_by(events: list[dict], cat: str, key) -> dict:
    out: dict = {}
    for e in events:
        if e.get("cat") != cat:
            continue
        span = _span(e)
        if span is None:
            continue
        out.setdefault(key(e), []).append((span[0], span[1],
                                           str(e.get("name") or "")))
    return {k: _Ranges(v) for k, v in out.items()}


def _normalized(e: dict, span: tuple[float, float], name: str,
                module: Optional[str]) -> dict:
    return {"ph": "X", "pid": e.get("pid"), "tid": e.get("tid"),
            "ts": span[0], "dur": span[1] - span[0], "name": name,
            "args": {"hlo_op": name, "hlo_module": module or ""}}


def _card_events(events: list[dict], devs: list[dict]) -> list[dict]:
    gpu_ranges = _ranges_by(events, "gpu_user_annotation",
                            lambda e: e.get("pid"))
    cpu_ranges = _ranges_by(events, "user_annotation",
                            lambda e: (e.get("pid"), e.get("tid")))
    launches: dict = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            span = _span(e)
            if corr is not None and span is not None:
                launches[corr] = ((e.get("pid"), e.get("tid")), span)
    out = []
    for e in devs:
        span = _span(e)
        if span is None:
            continue
        ranges = gpu_ranges.get(e.get("pid"))
        module = ranges.innermost(*span) if ranges else None
        if module is None:
            launch = launches.get((e.get("args") or {}).get("correlation"))
            if launch is not None and launch[0] in cpu_ranges:
                module = cpu_ranges[launch[0]].innermost(*launch[1])
        out.append(_normalized(e, span, str(e.get("name") or "?"), module))
    return out


def _cpu_events(events: list[dict]) -> list[dict]:
    """The CPU rule (module docstring): outermost cpu_op events inside a
    user_annotation range, per (pid, tid) lane."""
    ranges = _ranges_by(events, "user_annotation",
                        lambda e: (e.get("pid"), e.get("tid")))
    ops: dict = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "cpu_op":
            span = _span(e)
            if span is not None:
                ops.setdefault((e.get("pid"), e.get("tid")), []).append(
                    (span, e))
    out = []
    for lane, lane_ops in ops.items():
        lane_ranges = ranges.get(lane)
        if lane_ranges is None:
            continue
        lane_ops.sort(key=lambda r: (r[0][0], -r[0][1]))
        outer_end = float("-inf")
        for span, e in lane_ops:
            if span[0] < outer_end - 1e-6:
                continue  # nested inside an op already taken
            module = lane_ranges.innermost(*span)
            if module is None:
                continue
            outer_end = span[1]
            out.append(_normalized(e, span, str(e.get("name") or "?"),
                                   module))
    return out


def device_events(events: Iterable[dict]) -> list[dict]:
    """The device events of one capture, normalized to the JAX shape (see
    the module docstring for the card's rule and the CPU's)."""
    events = [e for e in events if isinstance(e, dict)]
    devs = [e for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    if devs:
        return _card_events(events, devs)
    # an already-normalized (or JAX-tagged) list passes through
    tagged = [e for e in events if e.get("ph") == "X"
              and isinstance(e.get("args"), dict) and e["args"].get("hlo_op")]
    if tagged:
        return tagged
    return _cpu_events(events)


def _self_times(lane_events: list[tuple]) -> list[tuple]:
    """(ts, dur, self_us, name, module) per event of ONE lane: an event
    starting before the stack top ends is its child and subtracts from
    the parent's self time, so per-kernel times sum to the lane's busy
    time exactly."""
    ordered = sorted(lane_events, key=lambda e: (e[0], -e[1]))
    out = [[ts, dur, dur, name, module] for ts, dur, name, module in ordered]
    stack: list[list] = []
    for rec in out:
        ts, dur = rec[0], rec[1]
        while stack and ts >= stack[-1][0] + stack[-1][1] - 1e-9:
            stack.pop()
        if stack:
            stack[-1][2] -= dur  # child time is not the parent's self time
        stack.append(rec)
    return [(ts, dur, max(self_us, 0.0), name, module)
            for ts, dur, self_us, name, module in out]


def kernel_rollup(events: Iterable[dict],
                  top_k: int = DEFAULT_TOP_K) -> Optional[dict]:
    """Per-kernel device-time rollup of one capture's events.

    None when the capture holds no device events.  Per-kernel `device_us`
    is self time, so kernels sum to the device-busy time, never above it.
    Fractions are of the traced window (first device-event start to last
    end) divided across `lanes`, so they sum to <= 1 even when lanes
    overlap in wall time."""
    devs = device_events(events)
    if not devs:
        return None
    by_lane: dict[tuple, list[tuple]] = {}
    for e in devs:
        try:
            ts = float(e.get("ts", 0.0))
            dur = float(e.get("dur", 0.0))
        except (TypeError, ValueError):
            continue
        if not (dur >= 0.0) or dur == float("inf"):
            continue
        args = e.get("args") or {}
        name = str(e.get("name") or args.get("hlo_op") or "?")
        module = str(args.get("hlo_module") or "")
        by_lane.setdefault((e.get("pid"), e.get("tid")), []).append(
            (ts, dur, name, module))
    per: dict[tuple, dict] = {}  # (name, module) -> {calls, us}
    mod_totals: dict[str, float] = {}  # module -> us over ALL its kernels
    lanes = set(by_lane)
    t_lo = float("inf")
    t_hi = float("-inf")
    total_us = 0.0
    for lane, lane_events in by_lane.items():
        for ts, dur, self_us, name, module in _self_times(lane_events):
            k = per.setdefault((name, module), {"calls": 0, "us": 0.0})
            k["calls"] += 1
            k["us"] += self_us
            total_us += self_us
            if module:
                mod_totals[module] = mod_totals.get(module, 0.0) + self_us
            t_lo = min(t_lo, ts)
            t_hi = max(t_hi, ts + dur)
    if not per:
        return None
    window_us = max(t_hi - t_lo, 0.0)
    denom = window_us * max(len(lanes), 1)
    ranked = sorted(per.items(), key=lambda kv: -kv[1]["us"])
    kernels = [{
        "name": name,
        "module": module or None,
        "calls": v["calls"],
        "device_us": round(v["us"], 3),
        "fraction": round(v["us"] / denom, 6) if denom > 0 else None,
    } for (name, module), v in ranked[:max(top_k, 1)]]
    other_us = sum(v["us"] for _k, v in ranked[max(top_k, 1):])
    return {
        "window_us": round(window_us, 3),
        "device_us_total": round(total_us, 3),
        "device_fraction": (round(total_us / denom, 6) if denom > 0
                            else None),
        "lanes": len(lanes),
        "kernel_count": len(per),
        "kernels": kernels,
        "other_us": round(other_us, 3),
        # per-module device time over all its kernels, before the top-K
        # cut: the roofline denominators (devprof.roofline_join)
        "modules": {m: round(us, 3)
                    for m, us in sorted(mod_totals.items(),
                                        key=lambda kv: -kv[1])},
    }


def rollup_trace_dir(log_dir: str,
                     top_k: int = DEFAULT_TOP_K) -> Optional[dict]:
    """Rollup over every trace file under `log_dir`; each file is filtered
    to its device events as it is read.  None when no file yields device
    events; a torn file is skipped."""
    merged: list[dict] = []
    for path in find_trace_files(log_dir):
        try:
            merged.extend(device_events(load_trace_events(path)))
        except (OSError, ValueError):
            continue  # a torn capture must not hide the readable ones
    return kernel_rollup(merged, top_k=top_k)


def diff_rollups(a: dict, b: dict) -> list[dict]:
    """Per-kernel device-time deltas between two rollups (A = before,
    B = after), matched by (name, module); one-sided kernels show with the
    missing side at 0."""
    def index(r: dict) -> dict[tuple, dict]:
        return {(k["name"], k.get("module")): k
                for k in r.get("kernels") or []}

    ia, ib = index(a), index(b)
    out = []
    for key in sorted(set(ia) | set(ib), key=lambda k: (k[0], k[1] or "")):
        ka, kb = ia.get(key), ib.get(key)
        ua = float(ka["device_us"]) if ka else 0.0
        ub = float(kb["device_us"]) if kb else 0.0
        out.append({
            "name": key[0],
            "module": key[1],
            "a_us": round(ua, 3),
            "b_us": round(ub, 3),
            "delta_us": round(ub - ua, 3),
            "ratio": round(ub / ua, 4) if ua > 0 else None,
            "a_calls": ka["calls"] if ka else 0,
            "b_calls": kb["calls"] if kb else 0,
        })
    out.sort(key=lambda d: -abs(d["delta_us"]))
    return out
