"""The device's idle share of the traced segment of a training run:
100 x (1 - the union of its device events' intervals / the segment),
from the profiler's trace (perfbench/core/trace.py)."""

from perfbench.core import trace


def read(run: dict):
    return trace.idle_pct(run.get("trace"))
