"""Step timing and tracing (port of shifu_tpu/train/profiler.py).

- `StepTimer`: cheap per-chunk wall timing with percentile summaries: the
  host-side input wait against the step's dispatch-to-done time; its
  `on_chunk` hook feeds the flight recorder (obs/devprof.py).
- `start_trace` / `stop_trace`: the capture seam the flight recorder
  opens and closes: one `torch.profiler` capture of the CPU and, where
  present, the card, written on stop as a Chrome trace
  (`<host>_<pid>.trace.json`) into the capture's directory.  One capture
  may be active at a time, as with `jax.profiler`.
- `trace` / `maybe_trace`: the same as a context (the legacy
  SHIFU_TPU_PROFILE_DIR dump).

The JAX package's `straggler_line` reads `obs/aggregate` across hosts; it
waits for multi-GPU training (ROADMAP.md queue A item (f)).
"""

from __future__ import annotations

import contextlib
import os
import socket
import threading
import time
from typing import Callable, Iterator, Optional

import numpy as np


class StepTimer:
    """Accumulates per-chunk host/device timings for one epoch.

    `on_chunk(input_s, step_s)`, when given, is called at every
    mark_step_done with the chunk's input wait and dispatch-to-done time
    (the flight recorder's feed, obs/devprof.py).  It must be cheap;
    its exceptions are swallowed (timing must not fail the chunk it
    times)."""

    def __init__(self, on_chunk: Optional[Callable[[float, float],
                                                   None]] = None) -> None:
        self.input_times: list[float] = []
        self.step_times: list[float] = []
        self._t: Optional[float] = None
        self._on_chunk = on_chunk

    def start(self) -> None:
        self._t = time.perf_counter()

    def mark_input_ready(self) -> None:
        now = time.perf_counter()
        if self._t is not None:
            self.input_times.append(now - self._t)
        self._t = now

    def mark_step_done(self) -> None:
        now = time.perf_counter()
        if self._t is not None:
            self.step_times.append(now - self._t)
        self._t = now
        if self._on_chunk is not None and self.step_times:
            try:
                self._on_chunk(
                    self.input_times[-1] if self.input_times else 0.0,
                    self.step_times[-1])
            except Exception:
                pass

    def emit(self, prefix: str = "train", **labels) -> None:
        """Feed this epoch's timings into the registry:
        `<prefix>_input_seconds` / `<prefix>_step_seconds` histograms.
        Call once per epoch; an empty epoch is a no-op."""
        from .. import obs

        hin = obs.histogram(f"{prefix}_input_seconds",
                            "host input wait per step/chunk")
        hstep = obs.histogram(f"{prefix}_step_seconds",
                              "device step/chunk dispatch-to-done time")
        for v in self.input_times:
            if v == v and v != float("inf"):  # finite only, like summary()
                hin.observe(v, **labels)
        for v in self.step_times:
            if v == v and v != float("inf"):
                hstep.observe(v, **labels)

    def summary(self) -> dict[str, float]:
        def stats(xs: list[float], prefix: str) -> dict[str, float]:
            # finite samples only: one NaN timing would otherwise reach
            # every field; a single-chunk epoch still gives a record
            arr = np.asarray([x for x in xs if x == x and x != float("inf")],
                             dtype=np.float64)
            if arr.size == 0:
                return {}
            if arr.size == 1:
                v_ms = float(arr[0]) * 1e3
                return {f"{prefix}_mean_ms": v_ms,
                        f"{prefix}_p50_ms": v_ms,
                        f"{prefix}_p99_ms": v_ms,
                        f"{prefix}_total_s": float(arr[0])}
            return {
                f"{prefix}_mean_ms": float(arr.mean() * 1e3),
                f"{prefix}_p50_ms": float(np.percentile(arr, 50) * 1e3),
                f"{prefix}_p99_ms": float(np.percentile(arr, 99) * 1e3),
                f"{prefix}_total_s": float(arr.sum()),
            }
        out = {}
        out.update(stats(self.input_times, "input"))
        out.update(stats(self.step_times, "step"))
        if "input_total_s" in out and "step_total_s" in out:
            total = out["input_total_s"] + out["step_total_s"]
            out["input_fraction"] = float(out["input_total_s"]
                                          / max(total, 1e-9))
        return out

    def console_line(self) -> str:
        s = self.summary()
        if not s:
            return "timing: no steps"
        return (f"timing: input p50 {s.get('input_p50_ms', 0):.2f}ms "
                f"step p50 {s.get('step_p50_ms', 0):.2f}ms "
                f"input fraction {s.get('input_fraction', 0):.1%}")


_trace_lock = threading.Lock()
# (profile, log_dir) of the one active capture
_active: Optional[tuple] = None


def trace_active() -> bool:
    return _active is not None


def start_trace(log_dir: str) -> None:
    """Start a torch.profiler capture of the CPU and, where CUDA is
    initialized, the card; raises RuntimeError if one is already active."""
    global _active
    import torch
    from torch.profiler import ProfilerActivity, profile

    with _trace_lock:
        if _active is not None:
            raise RuntimeError("only one torch.profiler capture may be "
                               f"active at a time ({_active[1]} is)")
        os.makedirs(log_dir, exist_ok=True)
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        _active = (prof, log_dir)


def stop_trace() -> str:
    """Stop the active capture and write its Chrome trace; returns the
    file's path.  Raises RuntimeError when no capture is active."""
    global _active
    with _trace_lock:
        if _active is None:
            raise RuntimeError("no torch.profiler capture is active")
        prof, log_dir = _active
        _active = None
    import torch
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()  # the window's kernels end inside it
    prof.stop()
    path = os.path.join(log_dir, f"{socket.gethostname()}_{os.getpid()}"
                                 ".trace.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """A capture around the block (`start_trace` / `stop_trace`)."""
    start_trace(log_dir)
    try:
        yield
    finally:
        stop_trace()


def maybe_trace(log_dir: Optional[str]):
    """trace() if a directory is given, else a no-op context."""
    if log_dir:
        return trace(log_dir)
    return contextlib.nullcontext()
