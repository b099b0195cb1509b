"""Device flight recorder: per-kernel device-time attribution, HBM
watermarks and anomaly-triggered trace capture (port of
shifu_tpu/obs/devprof.py, on torch.profiler).

The goodput ledger (obs/goodput.py) says how much of an epoch's wall was
`step`; this module opens that bucket.  Four legs, as in the JAX package:

- **Windowed trace capture**: `DeviceProfiler.epoch_capture(epoch)` opens
  the train loop's torch.profiler seam (train/profiler.start_trace) on the
  `obs.trace_epochs` schedule (default off; "first" = the first trained
  epoch only), into a fresh directory per window.  The Chrome trace parses
  into a per-kernel rollup (obs/tracefmt.py) journaled as a
  `device_profile` event.  The capture is chaos-probed (site `obs.trace`):
  a failing profiler degrades to a journaled `trace_fallback` and the
  epoch trains on untraced.  One capture is active at a time.
- **Roofline attribution**: the rollup joins obs/flops.py's per-dispatch
  FLOPs and bytes (matched per module, the step program's name) against
  the card's peaks (`goodput.PEAK_BF16_TFLOPS`, `PEAK_HBM_GBPS` below):
  each matched kernel carries its program's achieved-vs-peak FLOP/s and
  bandwidth fractions and a `bound` verdict (compute vs hbm).
- **HBM watermarks** (on by default): `hbm_snapshot()` reads
  `torch.cuda.memory_stats` (`allocated_bytes.all.current` and `.peak`)
  and `torch.cuda.mem_get_info` (the limit) at epoch boundaries into the
  `hbm_bytes_in_use` / `hbm_peak_bytes` gauges and an `hbm_watermark`
  event (`source: "memory_stats"`).  On the CPU, where the JAX package
  reports XLA's memory-analysis estimate, the port reports the bytes of
  the training state's tensors (parameters, optimizer slots, table slots)
  plus the resident batches, which the train loop registers
  (`source: "state_bytes"`), with the same keys.
- **Flight recorder + anomaly trigger**: `FlightRecorder` keeps a ring of
  the last K per-chunk (input_s, step_s) timings (fed by
  train/profiler.StepTimer's chunk hook) and runs a rolling robust z-score
  (median/MAD, one-sided) on the step time.  An anomalous chunk journals
  an `anomaly` event carrying the ring and, when tracing is enabled, a
  one-shot capture of the next chunk, journaled as a `device_profile`
  with `trigger: "anomaly"`.

Always-on cost: an O(K) deque touched once per chunk; the profiler,
parse and journal run only on scheduled or triggered windows.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Callable, Iterator, Optional

from . import tracefmt

# peak HBM GB/s by device-name substring; first match wins.  H100 SXM:
# 3350 GB/s (NVIDIA H100 data sheet), the figure chip_smoke.py's bounds
# read through `peak_hbm_gbps`.
PEAK_HBM_GBPS: tuple[tuple[str, float], ...] = (
    ("h100", 3350.0),
)

ENV_PEAK_HBM_GBPS = "SHIFU_TPU_PEAK_HBM_GBPS"

# module -> step-program aliases the suffix match can't reach (kept from
# the JAX package, whose jit modules are named after inner functions; the
# port's record_function ranges carry the programs' own names)
_MODULE_ALIASES = {
    "score": ("eval_step", "jax_scorer"),
    "step": ("train_step",),
    "epoch_step": ("epoch_scan_step", "device_epoch_step",
                   "local_sgd_epoch_step"),
}

CHAOS_SITE = "obs.trace"


def peak_hbm_gbps(device_kind: Optional[str] = None) -> Optional[float]:
    """Peak HBM GB/s for a device name (card 0's when omitted and CUDA is
    present); SHIFU_TPU_PEAK_HBM_GBPS overrides; None when unknown (the
    CPU, other cards): roofline fractions are then null, never guessed."""
    env = os.environ.get(ENV_PEAK_HBM_GBPS)
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    if device_kind is None:
        try:
            import torch
            if not torch.cuda.is_available():
                return None
            device_kind = torch.cuda.get_device_name(0)
        except Exception:
            return None
    kind = str(device_kind).lower()
    for sub, peak in PEAK_HBM_GBPS:
        if sub in kind:
            return peak
    return None


# the one definition of "tracing off" — parse_trace_epochs and
# DeviceProfiler.tracing_enabled must never disagree on it
_OFF_TOKENS = ("", "off", "0", "false", "none")


def trace_spec_off(spec: str) -> bool:
    return (spec or "").strip().lower() in _OFF_TOKENS


def parse_trace_epochs(spec: str) -> Callable[[int, int], bool]:
    """`obs.trace_epochs` -> predicate(epoch, start_epoch).

    Forms: "off"/"" (never), "first"/"on" (the first trained epoch only),
    "every:N" (every Nth epoch), or a comma list of epoch numbers
    ("0,2,5").  Malformed specs raise ValueError at config time
    (JobConfig.validate), never mid-run.
    """
    s = (spec or "").strip().lower()
    if trace_spec_off(s):
        return lambda epoch, start: False
    if s in ("first", "on", "true"):
        return lambda epoch, start: epoch == start
    if s.startswith("every:"):
        n = int(s.split(":", 1)[1])
        if n <= 0:
            raise ValueError(f"obs.trace_epochs every:N needs N > 0: {spec!r}")
        return lambda epoch, start, n=n: epoch % n == 0
    try:
        epochs = frozenset(int(tok) for tok in s.split(",") if tok.strip())
    except ValueError:
        raise ValueError(
            f"obs.trace_epochs must be off/first/every:N/or a comma list "
            f"of epoch numbers: {spec!r}")
    return lambda epoch, start, es=epochs: epoch in es


def resolve_trace_dir(explicit: str = "") -> Optional[str]:
    """Where trace windows land: `obs.trace_dir` when set, else a
    `trace/` dir beside this process's telemetry sinks (local dirs only:
    torch.profiler writes real files), else None (capture disabled)."""
    if explicit:
        return explicit
    from ..data import fsio
    from . import _sinks
    base = _sinks.metrics_dir()
    if not base or fsio.is_remote(base):
        return None
    return os.path.join(base, "trace")


# ---------------------------------------------------------------- roofline


def _match_stats(module: Optional[str],
                 stats: dict) -> Optional[tuple[str, dict]]:
    """(stats key, entry) for one rollup module: exact name first (the
    port's ranges carry the programs' names), then the JAX package's alias
    table and a `jit_` prefix strip (its modules are named after inner
    functions), then suffix both ways; within a rank the largest-FLOPs
    candidate wins."""
    if not module:
        return None
    name = module[4:] if module.startswith("jit_") else module
    name = name.strip("_")
    if not name:
        return None
    cands = []  # (rank, -flops) minimized: exact < alias < suffix
    for key, st in stats.items():
        if key == name:
            rank = 0
        elif key in _MODULE_ALIASES.get(name, ()):
            rank = 1
        elif key.endswith(name) or name.endswith(key):
            rank = 2
        else:
            continue
        cands.append(((rank, -(st.get("flops") or 0.0)), key, st))
    if not cands:
        return None
    _prio, key, st = min(cands)
    return key, st


def roofline_join(rollup: dict, stats: Optional[dict] = None,
                  dispatches: Optional[dict] = None) -> dict:
    """Annotate a tracefmt rollup with roofline attribution (in place,
    returned for chaining).

    Per-DISPATCH FLOPs/bytes come from the instrumented programs'
    counts (obs/flops.stats()); the achieved rate scales
    them by `dispatches` — the per-fn dispatch counts executed INSIDE
    the traced window (DeviceProfiler snapshots
    flops.dispatch_counts() around each capture; a window holding
    1000 step dispatches must not read as 1000x under-utilized).  When
    `dispatches` is omitted the window is assumed to hold ONE dispatch
    per module (bench-style micro-windows).  The module's device-time
    denominator is the rollup's pre-truncation `modules` total, so
    tail kernels folded into other_us still count.

    A kernel inherits its module's achieved-vs-peak fractions (module
    cost spread over the module's device time — per-kernel FLOP counts
    don't exist outside the compiler, so this is time-proportional
    attribution, stated as such).  `bound` is the limiting resource:
    "compute" when the FLOP/s fraction >= the bandwidth fraction,
    "hbm" otherwise; null when the platform peaks, the module cost, or
    the window's dispatch count are unknown (CPU tests: bytes are
    known, peaks are not — intensity still journals).
    """
    if stats is None:
        from . import flops
        stats = flops.stats()
    peak_tf = None
    try:
        from . import goodput
        peak_tf = goodput.peak_tflops()
    except Exception:
        pass
    peak_bw = peak_hbm_gbps()
    rollup["peak_tflops"] = peak_tf
    rollup["peak_hbm_gbps"] = peak_bw
    # module device time: pre-truncation totals when the rollup carries
    # them (tracefmt >= this PR), else the kept kernels as the fallback
    mod_us: dict[str, float] = dict(rollup.get("modules") or {})
    if not mod_us:
        for k in rollup.get("kernels") or []:
            if k.get("module"):
                mod_us[k["module"]] = mod_us.get(k["module"], 0.0) \
                    + float(k["device_us"])
    mod_info: dict[str, dict] = {}
    for module, us in mod_us.items():
        matched = _match_stats(module, stats)
        if not matched or us <= 0:
            continue
        key, st = matched
        n_disp = 1 if dispatches is None else dispatches.get(key)
        flops = st.get("flops")
        bytes_acc = st.get("bytes_accessed")
        info: dict = {}
        if flops and bytes_acc:
            info["intensity_flops_per_byte"] = round(flops / bytes_acc, 4)
        sec = float(us) * 1e-6
        if n_disp and n_disp > 0:
            info["window_dispatches"] = int(n_disp)
            if flops and peak_tf:
                info["flops_frac"] = round(
                    flops * n_disp / sec / 1e12 / peak_tf, 6)
            if bytes_acc and peak_bw:
                info["hbm_frac"] = round(
                    bytes_acc * n_disp / sec / 1e9 / peak_bw, 6)
        if "flops_frac" in info and "hbm_frac" in info:
            info["bound"] = ("compute"
                             if info["flops_frac"] >= info["hbm_frac"]
                             else "hbm")
        if info:
            mod_info[module] = info
    for k in rollup.get("kernels") or []:
        info = mod_info.get(k.get("module") or "")
        if info:
            k.update(info)
        k.setdefault("bound", None)  # explicit null: "not classified"
    return rollup


# -------------------------------------------------------------- watermarks


def hbm_snapshot(state_bytes: Optional[int] = None) -> dict:
    """Device-memory occupancy right now.

    {"source": "memory_stats", "devices": [...], "bytes_in_use",
    "peak_bytes", "bytes_limit"} from `torch.cuda.memory_stats` on every
    card this process has initialized; else (the CPU) the CPU rule of the
    module docstring: `state_bytes` as both the bytes in use and the peak,
    under `source: "state_bytes"`.  Never raises."""
    devices = []
    try:
        import torch
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            for i in range(torch.cuda.device_count()):
                st = torch.cuda.memory_stats(i)
                if not st:
                    continue
                _free, total = torch.cuda.mem_get_info(i)
                cur = int(st.get("allocated_bytes.all.current", 0))
                devices.append({
                    "id": i,
                    "kind": torch.cuda.get_device_name(i),
                    "bytes_in_use": cur,
                    "peak_bytes_in_use": int(st.get(
                        "allocated_bytes.all.peak", cur)),
                    "bytes_limit": int(total),
                })
    except Exception:
        devices = []
    if devices:
        return {
            "source": "memory_stats",
            "devices": devices[:16],
            "device_count": len(devices),
            "bytes_in_use": sum(d["bytes_in_use"] for d in devices),
            "peak_bytes": max(d["peak_bytes_in_use"] for d in devices),
            "bytes_limit": sum(d["bytes_limit"] for d in devices),
        }
    est = int(state_bytes or 0)
    return {"source": "state_bytes", "devices": [], "device_count": 0,
            "bytes_in_use": est, "peak_bytes": est, "bytes_limit": 0}


def journal_watermark(epoch: int,
                      state_bytes: Optional[int] = None) -> Optional[dict]:
    """One `hbm_watermark` event + the gauges, at an epoch boundary.
    Never raises (telemetry must not fail the epoch it measures)."""
    try:
        from . import _sinks, metrics as metrics_mod
        snap = hbm_snapshot(state_bytes)
        snap["epoch"] = int(epoch)
        in_use = metrics_mod.gauge(
            "hbm_bytes_in_use", "device memory in use at the last epoch "
            "boundary (memory_stats; state_bytes on the CPU)")
        peak = metrics_mod.gauge(
            "hbm_peak_bytes", "device-memory high water observed so far")
        if snap["devices"]:
            for d in snap["devices"]:
                in_use.set(d["bytes_in_use"], device=str(d["id"]))
                peak.set(d["peak_bytes_in_use"], device=str(d["id"]))
        else:
            in_use.set(snap["bytes_in_use"], device="est")
            peak.set(snap["peak_bytes"], device="est")
        _sinks.event("hbm_watermark", **snap)
        return snap
    except Exception:
        return None


# --------------------------------------------------------- flight recorder


class FlightRecorder:
    """Ring buffer of the last K per-chunk timings + a rolling robust
    z-score anomaly detector on the device step time.

    A chunk is anomalous when, against the ring of PRIOR chunks (at least
    `min_chunks` of them), its step time is BOTH a `zscore`-sigma outlier
    under the median/MAD robust scale AND at least `min_ratio` slower
    than the median — the second guard keeps near-constant (MAD ~ 0)
    quiet series from flagging scheduler jitter.  One-sided on purpose:
    a suspiciously FAST chunk is a bug for a correctness tool, not a
    stall for this one.
    """

    def __init__(self, window: int = 32, zscore: float = 6.0,
                 min_chunks: int = 8, min_ratio: float = 0.5) -> None:
        self.window = max(int(window), 4)
        self.zscore = float(zscore)
        self.min_chunks = max(int(min_chunks), 2)
        self.min_ratio = float(min_ratio)
        self.ring: collections.deque = collections.deque(maxlen=self.window)
        self.anomalies = 0
        self._chunk = 0

    def record(self, epoch: int, input_s: float, step_s: float
               ) -> Optional[dict]:
        """Feed one chunk; returns the anomaly record (also journaled by
        the caller) when this chunk trips the detector, else None."""
        self._chunk += 1
        verdict = None
        if (step_s == step_s and step_s != float("inf")
                and len(self.ring) >= self.min_chunks):
            steps = sorted(r["step_s"] for r in self.ring)
            n = len(steps)
            med = (steps[n // 2] if n % 2
                   else 0.5 * (steps[n // 2 - 1] + steps[n // 2]))
            mad = sorted(abs(s - med) for s in steps)[n // 2]
            scale = 1.4826 * mad + 1e-12
            z = (step_s - med) / scale
            if z > self.zscore and step_s > med * (1.0 + self.min_ratio):
                self.anomalies += 1
                verdict = {
                    "epoch": int(epoch),
                    "chunk": self._chunk,
                    "step_s": round(step_s, 6),
                    "median_s": round(med, 6),
                    "mad_s": round(mad, 6),
                    "zscore": round(min(z, 1e6), 2),
                    "window": self.window,
                    "ring": [dict(r) for r in self.ring],
                }
        self.ring.append({"epoch": int(epoch), "chunk": self._chunk,
                          "input_s": round(float(input_s), 6),
                          "step_s": round(float(step_s), 6)})
        return verdict


# ---------------------------------------------------------- the profiler


class DeviceProfiler:
    """The train loop's device-profiling plane: epoch-scheduled trace
    windows, the always-on flight recorder with its one-shot anomaly
    trace, and epoch-boundary HBM watermarks.  Every leg is best-effort:
    a broken profiler (or an injected `obs.trace` fault) journals a
    `trace_fallback` and training continues.  `state_bytes`, when given,
    returns the CPU watermark's bytes (module docstring)."""

    def __init__(self, cfg, start_epoch: int = 0,
                 enabled: bool = True,
                 state_bytes: Optional[Callable[[], int]] = None) -> None:
        self.cfg = cfg
        self.start_epoch = int(start_epoch)
        self.enabled = bool(enabled)
        self.trace_dir = resolve_trace_dir(cfg.trace_dir) if enabled else None
        self._sched = parse_trace_epochs(cfg.trace_epochs)
        self.tracing_enabled = (bool(self.trace_dir)
                                and not trace_spec_off(cfg.trace_epochs))
        self.recorder = FlightRecorder(
            window=cfg.anomaly_window, zscore=cfg.anomaly_zscore,
            min_chunks=cfg.anomaly_min_chunks,
            min_ratio=cfg.anomaly_min_ratio)
        self.state_bytes = state_bytes
        self._lock = threading.Lock()
        self._trace_active = False   # one torch.profiler capture at a time
        self._oneshot: Optional[dict] = None
        # obs/flops dispatch tallies at the active capture's start: the
        # delta at stop scales per-dispatch cost to the window's work
        self._disp0: dict = {}

    # -- capture plumbing ---------------------------------------------

    def _start_trace(self, log_dir: str, epoch: int) -> bool:
        """chaos-probed train/profiler.start_trace; False (journaled
        trace_fallback) on any failure."""
        from .. import chaos
        from ..train import profiler as prof_lib
        from . import _sinks, flops, metrics as metrics_mod
        try:
            chaos.maybe_fail(CHAOS_SITE, epoch=epoch, path=log_dir)
            os.makedirs(log_dir, exist_ok=True)
            self._disp0 = flops.dispatch_counts()
            prof_lib.start_trace(log_dir)
            self._trace_active = True
            return True
        except Exception as e:
            _sinks.event("trace_fallback", epoch=int(epoch), stage="start",
                         error=str(e)[:200])
            metrics_mod.counter(
                "trace_fallback_total",
                "trace captures degraded to untraced epochs").inc(
                    stage="start")
            return False

    def _stop_and_journal(self, log_dir: str, epoch: int, trigger: str,
                          window_s: Optional[float] = None) -> Optional[dict]:
        from ..train import profiler as prof_lib
        from . import _sinks, flops, metrics as metrics_mod
        try:
            prof_lib.stop_trace()
        except Exception as e:
            _sinks.event("trace_fallback", epoch=int(epoch), stage="stop",
                         error=str(e)[:200])
            metrics_mod.counter("trace_fallback_total", "").inc(stage="stop")
            self._trace_active = False
            return None
        self._trace_active = False
        try:
            rollup = tracefmt.rollup_trace_dir(log_dir,
                                               top_k=self.cfg.trace_top_k)
        except Exception as e:
            rollup = None
            _sinks.event("trace_fallback", epoch=int(epoch), stage="parse",
                         error=str(e)[:200])
            metrics_mod.counter("trace_fallback_total", "").inc(stage="parse")
        if rollup is None:
            return None
        now = flops.dispatch_counts()
        delta = {k: n - self._disp0.get(k, 0) for k, n in now.items()
                 if n - self._disp0.get(k, 0) > 0}
        roofline_join(rollup, dispatches=delta or None)
        rollup.update(epoch=int(epoch), trigger=trigger, trace_dir=log_dir)
        if window_s is not None and window_s > 0:
            # device time as a fraction of the WALL the capture spanned
            # (the trace window above is device-event span only)
            rollup["capture_wall_s"] = round(window_s, 6)
        _sinks.event("device_profile", **rollup)
        metrics_mod.counter(
            "device_profiles_total",
            "device trace captures rolled up and journaled").inc(
                trigger=trigger)
        if rollup.get("device_fraction") is not None:
            metrics_mod.gauge(
                "device_trace_fraction",
                "device-busy fraction of the last traced window").set(
                    rollup["device_fraction"])
        return rollup

    def _fresh_capture_dir(self, base: str) -> str:
        """A capture dir that holds ONLY this capture: a resumed job (or
        a re-traced epoch) would otherwise re-enter the same dir and
        rollup_trace_dir would merge the stale run's events — window_us
        then spans the wall between the two processes and every
        fraction collapses toward 0."""
        if not os.path.exists(base):
            return base
        for n in range(1, 1000):
            cand = f"{base}-r{n}"
            if not os.path.exists(cand):
                return cand
        return base  # pathological; the merge is the lesser evil

    def note_superseded(self, epoch: int) -> None:
        """The legacy SHIFU_TPU_PROFILE_DIR dump owns this epoch's
        capture (the two can't nest): when the schedule would have fired,
        say so in the journal instead of silently producing nothing."""
        if (self.enabled and self.tracing_enabled
                and self._sched(epoch, self.start_epoch)):
            from . import _sinks
            _sinks.event(
                "trace_fallback", epoch=int(epoch), stage="superseded",
                error="SHIFU_TPU_PROFILE_DIR owns this epoch's capture "
                      "(raw Chrome-trace dump; no device_profile rollup)")

    @contextlib.contextmanager
    def epoch_capture(self, epoch: int) -> Iterator[None]:
        """Trace the whole epoch when `obs.trace_epochs` schedules it;
        a plain no-op context otherwise."""
        if (not self.enabled or not self.tracing_enabled
                or self._trace_active
                or not self._sched(epoch, self.start_epoch)):
            yield
            return
        log_dir = self._fresh_capture_dir(
            os.path.join(self.trace_dir, f"epoch{epoch:05d}"))
        t0 = time.perf_counter()
        if not self._start_trace(log_dir, epoch):
            yield
            return
        try:
            yield
        finally:
            self._stop_and_journal(log_dir, epoch, "schedule",
                                   window_s=time.perf_counter() - t0)

    # -- flight recorder ----------------------------------------------

    def chunk_hook(self, epoch: int) -> Optional[Callable[[float, float],
                                                          None]]:
        """The per-chunk callback train/profiler.StepTimer feeds (input_s,
        step_s) into; None when the profiler is disabled (timer then pays
        nothing)."""
        if not self.enabled:
            return None

        def hook(input_s: float, step_s: float) -> None:
            try:
                self.note_chunk(epoch, input_s, step_s)
            except Exception:
                pass  # the recorder must never fail the chunk it times

        return hook

    def note_chunk(self, epoch: int, input_s: float, step_s: float) -> None:
        with self._lock:
            # a one-shot armed by the PREVIOUS chunk's anomaly has now
            # traced this chunk: close and journal it first
            if self._oneshot is not None:
                shot, self._oneshot = self._oneshot, None
                self._stop_and_journal(shot["dir"], shot["epoch"], "anomaly")
            verdict = self.recorder.record(epoch, input_s, step_s)
            if verdict is None:
                return
            from . import _sinks, metrics as metrics_mod
            _sinks.event("anomaly", **verdict)
            metrics_mod.counter(
                "anomaly_total",
                "flight-recorder step-time anomalies detected").inc()
            if self.tracing_enabled and not self._trace_active:
                # one-shot capture of the NEXT chunk (the stall's
                # neighborhood): closed at the next note_chunk/end_epoch
                log_dir = self._fresh_capture_dir(os.path.join(
                    self.trace_dir,
                    f"anomaly-e{epoch:05d}-c{verdict['chunk']:06d}"))
                if self._start_trace(log_dir, epoch):
                    self._oneshot = {"dir": log_dir, "epoch": int(epoch)}

    # -- epoch boundary -----------------------------------------------

    def end_epoch(self, epoch: int) -> None:
        """Close a dangling one-shot (anomaly on the epoch's last chunk)
        and journal the HBM watermark."""
        if not self.enabled:
            return
        with self._lock:
            if self._oneshot is not None:
                shot, self._oneshot = self._oneshot, None
                self._stop_and_journal(shot["dir"], shot["epoch"], "anomaly")
        if self.cfg.hbm_watermarks:
            est = None
            if self.state_bytes is not None:
                try:
                    est = int(self.state_bytes())
                except Exception:
                    est = None
            journal_watermark(epoch, est)

    def close(self) -> None:
        """However the loop exits: never leave torch.profiler tracing."""
        with self._lock:
            if self._oneshot is not None:
                shot, self._oneshot = self._oneshot, None
                self._stop_and_journal(shot["dir"], shot["epoch"], "anomaly")
            elif self._trace_active:
                try:
                    from ..train import profiler as prof_lib
                    prof_lib.stop_trace()
                except Exception:
                    pass
                self._trace_active = False
