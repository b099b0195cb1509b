"""FLOP and byte counts of the step programs (the cost-capture half of the
JAX package's obs/introspect.py, which gets no port of its own).

XLA hands the JAX package a cost analysis of every compiled program; eager
PyTorch has none.  Here a counting `TorchDispatchMode` watches one
dispatch of a step program and counts, for each aten op:

- FLOPs by `torch.utils.flop_counter`'s formulas (its op set: the matrix
  products, convolutions and attention; elementwise work counts 0);
- bytes as the operands' plus the results' bytes (an eager op is unfused,
  so it really reads and writes them).  View ops and `empty*` move
  nothing, fills (`zeros`, `new_zeros`, `full_like`, ...) write their
  result only; a result that is one of the operands (in place, `out=`)
  counts once; a gather (`index`, `index_select`, `gather`, `embedding`)
  reads the rows it returns, not its whole source, and a scatter
  (`index_add`, `index_put`, `scatter*`, `index_copy`) reads and writes
  the rows it touches.

A hand-written kernel's wrapper enters `kernel(cost)` around its body: the
kernel's own `cost(...)` formula (its module's, the figures chip_smoke.py's
bounds read) is added, and the aten ops inside (the plain version on the
CPU, the allocations on the card) are not counted.  So a step counts the
same on the CPU as on the card: the count is a function of the model, the
shapes and the dtypes, never of which implementation ran.

`instrument(fn, name)` wraps a step builder's function (train/step.py):
every dispatch runs inside a `torch.profiler.record_function(name)` range
(the module obs/tracefmt.py attributes device time to), bumps the name's
dispatch tally, and credits `goodput.note_flops` with the count of its
signature (the program, the shapes and dtypes of its tensors).  The count
is taken on the first dispatch of each signature, as the JAX package takes
its cost analysis at the first compile.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Optional

Cost = tuple  # (flops, bytes, exponentials)

_lock = threading.Lock()
# one count at a time: `_active` is process-global
_count_lock = threading.Lock()
# name -> {"flops", "bytes_accessed", "exponentials", "dispatches",
#          "counts"}: the last counted signature's per-dispatch figures
_stats: dict[str, dict] = {}
# the counting mode in force (module-global: backward ops may run on the
# autograd engine's threads, which must find it too)
_active: Optional[Any] = None
# per-thread depth of kernel() regions: their aten ops are not counted
_tls = threading.local()

_FREE_OPS = frozenset(("empty", "empty_like", "empty_strided", "new_empty",
                       "new_empty_strided", "lift_fresh", "_local_scalar_dense",
                       "record_stream", "resize_"))
# factories that read no operand: their results are written once
_FILL_OPS = frozenset(("new_zeros", "new_ones", "new_full", "zeros_like",
                       "ones_like", "full_like", "zeros", "ones", "full",
                       "scalar_tensor", "arange"))
_GATHER_OPS = frozenset(("index", "index_select", "gather", "embedding"))
_SCATTER_OPS = frozenset(("index_add", "index_put", "_index_put_impl",
                          "scatter", "scatter_add", "scatter_reduce",
                          "index_copy"))


def _tensors(tree) -> list:
    import torch
    out: list = []

    def walk(x) -> None:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)

    walk(tree)
    return out


def _nbytes(t) -> int:
    return int(t.numel()) * int(t.element_size())


def op_bytes(func, args, kwargs, out) -> int:
    """Bytes one aten op moves, by the rule of the module docstring."""
    name = func.overloadpacket.__name__.rstrip("_")
    if name in _FREE_OPS or getattr(func, "is_view", False):
        return 0
    ins = _tensors((args, kwargs))
    outs = _tensors(out)
    if name in _FILL_OPS:
        return sum(_nbytes(t) for t in outs)
    if name in _GATHER_OPS:
        idx = sum(_nbytes(t) for t in ins[1:]
                  if not t.is_floating_point())
        return 2 * sum(_nbytes(t) for t in outs) + idx
    if name in _SCATTER_OPS:
        # (self, ..., index, source): the source rows are read, the rows
        # they land on read and written
        src = [t for t in ins[1:] if t.is_floating_point()]
        idx = sum(_nbytes(t) for t in ins[1:] if not t.is_floating_point())
        return 3 * sum(_nbytes(t) for t in src) + idx
    seen = {(t.data_ptr(), _nbytes(t)) for t in ins
            if t.device.type != "meta"}
    n = sum(_nbytes(t) for t in ins)
    for t in outs:
        if t.device.type == "meta" or (t.data_ptr(), _nbytes(t)) not in seen:
            n += _nbytes(t)
    return n


def _flop_formula(func, args, kwargs, out) -> float:
    from torch.utils.flop_counter import flop_registry
    formula = flop_registry.get(func.overloadpacket)
    if formula is None:
        return 0.0
    return float(formula(*args, **kwargs, out_val=out))


def _make_counter():
    from torch.utils._python_dispatch import TorchDispatchMode

    class Counter(TorchDispatchMode):
        """Counts the FLOPs and bytes of the aten ops it sees, and takes
        the kernels' costs from `kernel()`."""

        def __init__(self) -> None:
            super().__init__()
            self.flops = 0.0
            self.bytes = 0.0
            self.exponentials = 0.0
            self._lock = threading.Lock()

        def add(self, flops: float, n_bytes: float, exps: float) -> None:
            with self._lock:
                self.flops += float(flops)
                self.bytes += float(n_bytes)
                self.exponentials += float(exps)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if not getattr(_tls, "depth", 0):
                self.add(_flop_formula(func, args, kwargs, out),
                         op_bytes(func, args, kwargs, out), 0.0)
            return out

    return Counter()


class kernel:
    """`with kernel(cost):` around a hand-written kernel's wrapper body.
    `cost()` returns its (flops, bytes, exponentials); it is called only
    while a count is being taken.  Cheap when nothing counts: one global
    read and a thread-local bump."""

    __slots__ = ("cost",)

    def __init__(self, cost: Callable[[], Cost]) -> None:
        self.cost = cost

    def __enter__(self) -> None:
        _tls.depth = getattr(_tls, "depth", 0) + 1
        counter = _active
        if counter is not None:
            counter.add(*self.cost())

    def __exit__(self, *exc) -> None:
        _tls.depth -= 1


def add_costs(*costs: Cost) -> Cost:
    return tuple(float(sum(c[i] for c in costs)) for i in range(3))


def count(fn: Callable, *args, **kwargs) -> tuple[Any, dict]:
    """Run `fn(*args, **kwargs)` once under the counting mode; returns
    (its result, {"flops", "bytes_accessed", "exponentials"})."""
    global _active
    counter = _make_counter()
    with _count_lock:
        _active = counter
        try:
            with counter:
                out = fn(*args, **kwargs)
        finally:
            _active = None
    return out, {"flops": counter.flops, "bytes_accessed": counter.bytes,
                 "exponentials": counter.exponentials}


def _signature(args) -> tuple:
    """Shapes and dtypes of the tensors (and arrays) in a call's
    arguments; other objects by type."""
    import numpy as np
    import torch
    sig: list = []

    def walk(x) -> None:
        if isinstance(x, torch.Tensor):
            sig.append((tuple(x.shape), str(x.dtype)))
        elif isinstance(x, np.ndarray):
            sig.append(("nd", x.shape, str(x.dtype)))
        elif isinstance(x, dict):
            for k in sorted(x):
                sig.append(k)
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            sig.append(len(x))
            for v in x:
                walk(v)
        elif isinstance(x, range):
            sig.append(("range", len(x)))
        else:
            sig.append(type(x).__name__)

    walk(args)
    return tuple(sig)


class Instrumented:
    """A step program with its dispatches named, counted and credited
    (module docstring)."""

    def __init__(self, fn: Callable, name: str) -> None:
        self._fn = fn
        self.name = name
        self._by_sig: dict[tuple, dict] = {}

    def __call__(self, *args, **kwargs):
        import torch
        from . import goodput

        sig = _signature((args, kwargs))
        cost = self._by_sig.get(sig)
        with torch.profiler.record_function(self.name):
            if cost is None:
                out, cost = count(self._fn, *args, **kwargs)
                self._by_sig[sig] = cost
                with _lock:
                    st = _stats.setdefault(self.name, {"dispatches": 0,
                                                       "counts": 0})
                    st.update(cost)
                    st["counts"] += 1
            else:
                out = self._fn(*args, **kwargs)
        with _lock:
            st = _stats.setdefault(self.name, {"dispatches": 0, "counts": 0})
            st["dispatches"] += 1
        if cost["flops"] > 0:
            goodput.note_flops(cost["flops"])
        return out


def instrument(fn: Callable, name: str) -> Instrumented:
    return Instrumented(fn, name)


def stats() -> dict[str, dict]:
    """Per-program counts so far this process (the last counted
    signature's per-dispatch flops and bytes, and the dispatch tally)."""
    with _lock:
        return {k: dict(v) for k, v in _stats.items()}


def dispatch_counts() -> dict[str, int]:
    """Per-program dispatch tallies: the flight recorder snapshots them
    around a trace window to scale per-dispatch counts to the window's
    work (obs/devprof.roofline_join)."""
    with _lock:
        return {k: int(v.get("dispatches", 0)) for k, v in _stats.items()}


def reset_for_tests() -> None:
    with _lock:
        _stats.clear()
