"""Step timing and tracing (port of shifu_tpu/train/profiler.py).

- `StepTimer`: cheap per-chunk wall timing with percentile summaries: the
  host-side input wait against the step's dispatch-to-done time.
- `trace` / `maybe_trace`: a `torch.profiler` capture of the CPU and the
  card, written as a Chrome trace into a directory.

The JAX package's `straggler_line` reads `obs/aggregate` across hosts; it
waits for multi-GPU training (ROADMAP.md queue A item (f)).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import numpy as np


class StepTimer:
    """Accumulates per-chunk host/device timings for one epoch.  (The JAX
    timer's `on_chunk` hook feeds its flight recorder, which the port has
    not ported yet.)"""

    def __init__(self) -> None:
        self.input_times: list[float] = []
        self.step_times: list[float] = []
        self._t: Optional[float] = None

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


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """torch.profiler capture of the CPU and, where present, the card;
    the Chrome trace lands in `log_dir/trace.json` on exit."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def maybe_trace(log_dir: Optional[str]):
    """trace() if a directory is given, else a no-op context."""
    if log_dir:
        return trace(log_dir)
    return contextlib.nullcontext()
