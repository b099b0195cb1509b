"""Goodput ledger: classify every epoch's wall time into named buckets
(port of shifu_tpu/obs/goodput.py).

- **Buckets** (`BUCKETS`): `compile`, `input` (host-side input wait),
  `step` (step dispatch-to-done), `checkpoint` (save), `restore`, `eval`
  (validation pass) and `other` (the unclassified residue).  They sum to
  the epoch wall by construction (`other` absorbs the remainder).  The
  port compiles nothing inside an epoch (its kernels are built before
  training), so `compile` stays 0 unless a caller notes some.
- **Goodput fraction** = step seconds / wall.
- **MFU** = achieved FLOP/s / the card's peak.  The achieved FLOPs are
  the step programs' counts (`obs/flops.py`: torch.utils.flop_counter's
  formulas over the aten ops, plus each hand-written kernel's `cost`),
  credited through `note_flops` on every dispatch; the peak comes from the
  table below, overridable with `SHIFU_TPU_PEAK_TFLOPS`.  On the CPU the
  peak is unknown, so `mfu` is null and `achieved_tflops` a number.

Every epoch journals one `goodput` event (the JAX package's keys) and
feeds the `goodput_bucket_seconds_total{bucket=...}` counter and the
`goodput_fraction` and `mfu` gauges.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

# peak dense bf16 TFLOP/s by device-name substring; first match wins.
# H100 SXM: 989 TFLOP/s dense bf16 on the tensor cores (NVIDIA H100 data
# sheet, at the 700 W limit), the figure chip_smoke.py's PEAK_16BIT_FLOPS
# holds.
PEAK_BF16_TFLOPS: tuple[tuple[str, float], ...] = (
    ("h100", 989.0),
)

ENV_PEAK_TFLOPS = "SHIFU_TPU_PEAK_TFLOPS"

BUCKETS = ("compile", "input", "step", "checkpoint", "restore", "eval",
           "other")


def peak_tflops(device_kind: Optional[str] = None) -> Optional[float]:
    """Peak bf16 TFLOP/s for a device name (card 0's when omitted and CUDA
    is present); SHIFU_TPU_PEAK_TFLOPS overrides the table; None when the
    device is unknown (the CPU, other cards)."""
    env = os.environ.get(ENV_PEAK_TFLOPS)
    if env:
        try:
            return float(env)
        except ValueError:
            pass  # a typo'd override must not crash telemetry
    if device_kind is None:
        try:
            import torch
            if not torch.cuda.is_available():
                return None
            device_kind = torch.cuda.get_device_name(0)
        except Exception:
            return None
    kind = str(device_kind).lower()
    for sub, peak in PEAK_BF16_TFLOPS:
        if sub in kind:
            return peak
    return None


class GoodputLedger:
    """One epoch's wall-time classification; threads may `add` and
    `add_flops` concurrently."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._seconds: dict[str, float] = {}
        self._flops = 0.0
        self._compiles = 0

    def add(self, bucket: str, seconds: float) -> None:
        # `not (seconds > 0)` also rejects NaN: a clock hiccup must not
        # poison the ledger and every field derived from it
        if not (seconds > 0) or seconds == float("inf"):
            return
        with self._lock:
            self._seconds[bucket] = self._seconds.get(bucket, 0.0) + seconds
            if bucket == "compile":
                self._compiles += 1

    def add_flops(self, flops: float) -> None:
        if flops > 0 and flops != float("inf"):  # NaN > 0 is False
            with self._lock:
                self._flops += float(flops)

    def summary(self, wall_s: float) -> dict:
        """The goodput record for an epoch of `wall_s` seconds.  Compile
        time happens inside the timed step/eval calls, so it is subtracted
        from `step` first, then `eval`; `other` absorbs the residue."""
        with self._lock:
            b = dict(self._seconds)
            flops = self._flops
            compiles = self._compiles
        compile_s = b.get("compile", 0.0)
        overlap = min(compile_s, b.get("step", 0.0))
        b["step"] = b.get("step", 0.0) - overlap
        b["eval"] = max(b.get("eval", 0.0) - (compile_s - overlap), 0.0)
        buckets = {k: round(b.get(k, 0.0), 6) for k in BUCKETS
                   if k != "other"}
        classified = sum(buckets.values())
        buckets["other"] = round(max(wall_s - classified, 0.0), 6)
        out = {
            "wall_s": round(wall_s, 6),
            "buckets": buckets,
            "goodput_fraction": round(buckets["step"] / wall_s, 4)
            if wall_s > 0 else None,
            "compiles": compiles,
        }
        peak = peak_tflops()
        achieved = (flops / wall_s / 1e12) if wall_s > 0 and flops > 0 \
            else None
        # significant digits, not fixed decimals: CPU-scale TFLOP/s (and
        # the MFU they imply) are tiny and must not round to 0.0
        out["achieved_tflops"] = (float(f"{achieved:.6g}")
                                  if achieved is not None else None)
        out["peak_tflops"] = peak
        out["mfu"] = (float(f"{achieved / peak:.6g}")
                      if achieved is not None and peak else None)
        return out


_lock = threading.Lock()
_current: Optional[GoodputLedger] = None


def begin_epoch() -> GoodputLedger:
    """Open a fresh ledger as the process's active epoch ledger."""
    global _current
    with _lock:
        _current = GoodputLedger()
        return _current


def current() -> Optional[GoodputLedger]:
    return _current


def note(bucket: str, seconds: float) -> None:
    """Credit `seconds` to `bucket` on the active ledger; no-op between
    epochs.  Never raises."""
    led = _current
    if led is not None:
        try:
            led.add(bucket, seconds)
        except Exception:
            pass


def note_flops(flops: float) -> None:
    """Credit `flops` to the active ledger; no-op between epochs."""
    led = _current
    if led is not None:
        try:
            led.add_flops(flops)
        except Exception:
            pass


def end_epoch(epoch: int, wall_s: float) -> Optional[dict]:
    """Close the active ledger: journal the `goodput` event, feed the
    registry, return the record (None when no ledger is open)."""
    global _current
    with _lock:
        led = _current
        _current = None
    if led is None:
        return None
    try:
        from . import _sinks, metrics as metrics_mod
        rec = led.summary(wall_s)
        rec["epoch"] = int(epoch)
        sec = metrics_mod.counter(
            "goodput_bucket_seconds_total",
            "epoch wall seconds by goodput bucket")
        for bucket, s in rec["buckets"].items():
            sec.inc(s, bucket=bucket)
        if rec["goodput_fraction"] is not None:
            metrics_mod.gauge(
                "goodput_fraction",
                "last epoch's device-step fraction of wall time",
            ).set(rec["goodput_fraction"])
        if rec["mfu"] is not None:
            metrics_mod.gauge(
                "mfu", "last epoch's model FLOP utilization").set(rec["mfu"])
        _sinks.event("goodput", **rec)
        return rec
    except Exception:
        return None  # telemetry must never fail the epoch it measures


def reset_for_tests() -> None:
    """Drop any ledger left open by an aborted epoch."""
    global _current
    with _lock:
        _current = None
