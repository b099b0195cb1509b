"""Span tracing: nested host-side phase timing feeding registry + journal
(port of shifu_tpu/obs/spans.py).

`with obs.span("epoch/eval"):` times the block, records the duration into
the `span_seconds` histogram (labeled with the full nested path) and
journals a `span` event.  Nesting composes paths — a span opened inside
`span("epoch")` named "eval" journals as "epoch/eval" — so one stream
reconstructs where wall time went across phases, the host-side complement
of the torch.profiler device trace (train/profiler.py).

Thread-local nesting: the prefetch producer thread's spans nest
independently of the main thread's — each thread reads as its own
coherent phase stack.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Iterator

from . import metrics as metrics_mod

_state = threading.local()


def current_path() -> str:
    """The active nested span path ("" at top level)."""
    return "/".join(getattr(_state, "stack", ()))


def emit(path: str, dur_s: float, journal: bool = True, **fields) -> None:
    """Record one completed span: `span_seconds` histogram observation +
    (optionally) a `span` journal event.  The one emission contract, so
    that a phase tracker outside `span()` cannot split the metric.  Never
    raises."""
    try:
        metrics_mod.histogram(
            "span_seconds",
            "host-side phase durations by nested span path",
        ).observe(dur_s, span=path)
        if journal:
            from . import _sinks
            _sinks.event("span", span=path, dur_s=round(dur_s, 6), **fields)
    except Exception:
        pass  # telemetry must never fail the phase it measures


@contextlib.contextmanager
def span(name: str, journal: bool = True, **fields) -> Iterator[None]:
    """Time a phase.  `fields` ride into the journal event (e.g.
    `span("epoch/train", epoch=3)`); set `journal=False` for hot spans that
    should only feed the histogram."""
    stack = getattr(_state, "stack", None)
    if stack is None:
        stack = _state.stack = []
    stack.append(name)
    path = "/".join(stack)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dur = time.perf_counter() - t0
        stack.pop()
        emit(path, dur, journal=journal, **fields)
