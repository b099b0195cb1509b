"""Serving-side drift engine: live traffic against the frozen baseline
profile (a copy of shifu_tpu/obs/drift.py: numpy only).

The train loop freezes a reference profile of the training partition into
the export artifact (`baseline_profile.json`, obs/sketch.py,
export/artifact.py); the scoring daemon accumulates the same sketches over
live traffic; and the `DriftEngine` here diffs the two on a fixed tick
over fast and slow trailing windows, with the SLO engine's
fire-once/latch/resolve discipline (obs/slo.py):

- feature_psi: per-feature Population Stability Index on the shared int8
  wire grid.  Fires one `drift_alert` naming the offending features when
  any feature's PSI is at or above the threshold in both windows; latches
  until the fast window is healthy, then resolves.
- score_kl: KL(baseline || live) of the score distribution.
- auc_decay: with the labelled-feedback path on (wire FEEDBACK frames ->
  `ScoringDaemon.feedback`), a trailing-window live AUC against the
  artifact's training AUC, journaled in every `drift_report` (a report
  axis, not an alert objective).

Trailing windows come from cumulative-snapshot subtraction: every
sketch's state is additive, so a window is the newest snapshot minus the
newest snapshot at or older than the horizon.  Pure given injected
timestamps.
"""

from __future__ import annotations

import collections
import json
import os
import threading
from typing import Optional

import numpy as np

from . import sketch as sketch_mod

BASELINE_FILE = "baseline_profile.json"

OBJ_FEATURE_PSI = "feature_psi"
OBJ_SCORE_KL = "score_kl"

# gauges exported per tick (the scrape-file face of the drift plane)
GAUGE_PSI = "drift_psi"
GAUGE_SCORE = "score_drift"
GAUGE_AUC_DECAY = "auc_decay"


# ----------------------------------------------------- baseline loading


def baseline_digest(path: str) -> Optional[str]:
    """blake2b-16 hex of the baseline file bytes: the digest recipe of
    the artifact's sync manifest (runtime/fleet.py)."""
    import hashlib

    try:
        h = hashlib.blake2b(digest_size=16)
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        return h.hexdigest()
    except OSError:
        return None


def load_baseline(export_dir: str) -> Optional[tuple[dict, str]]:
    """(profile, digest) from ``<export_dir>/baseline_profile.json``,
    or None when the artifact carries no profile (pre-drift exports,
    checkpoint-recovery re-exports) or the file fails validation —
    drift degrades to off, it never blocks serving."""
    path = os.path.join(str(export_dir), BASELINE_FILE)
    if not os.path.isfile(path):
        return None
    try:
        with open(path, "r") as f:
            profile = json.load(f)
        sketch_mod.validate_profile(profile)
    except (OSError, ValueError) as e:
        try:
            from . import _sinks
            _sinks.event("drift_baseline_invalid", path=path,
                         error=str(e)[:200])
        except Exception:
            pass
        return None
    return profile, baseline_digest(path) or ""


def feature_names(profile: dict) -> list[str]:
    """Display names for the profile's features (f<j> fallback)."""
    n = int(profile.get("num_features", 0))
    names = profile.get("feature_names")
    if isinstance(names, list) and len(names) == n:
        return [str(x) for x in names]
    return [f"f{j}" for j in range(n)]


# --------------------------------------------------------- live monitor


class DriftMonitor:
    """Live-traffic sketch accumulation for ONE model version: the
    cumulative feature/score sketches the dispatch path feeds, the
    labeled-feedback accumulator, and the ring of timed cumulative
    snapshots that turns them into trailing windows.

    `observe_batch` is the dispatch-path hook: one flattened bincount
    for all features + one score bincount, under a lock the tick
    thread's `snapshot` briefly shares.  Everything else runs at tick
    cadence."""

    def __init__(self, profile: dict, model_id: str = "default",
                 version: int = 1, digest: str = "",
                 feedback_bins: int = 1024):
        self.profile = profile
        self.model_id = str(model_id)
        self.version = int(version)
        self.digest = digest
        base_feat, base_score = sketch_mod.profile_sketches(profile)
        self.base_features = base_feat
        self.base_score = base_score
        self.names = feature_names(profile)
        self._lock = threading.Lock()
        self.features = sketch_mod.FeatureSketch(
            base_feat.num_features, scale=base_feat.scale,
            offset=base_feat.offset)
        self.score = sketch_mod.ScoreSketch(bins=base_score.bins)
        from ..ops.metrics import StreamingMetrics
        self.feedback = StreamingMetrics(bins=int(feedback_bins))
        # ring of cumulative snapshots: (t, rows, hist, score_hist,
        # fb_pos, fb_neg, fb_rows) — pruned to the slow window + 1 base
        self._samples: collections.deque = collections.deque()

    # -- hot path ------------------------------------------------------

    def observe_batch(self, x: np.ndarray, scores) -> None:
        """Accumulate one dispatched batch (features as admitted — int8
        wire bytes bin without dequantization — plus the head-0 scores).
        Never raises into the dispatch path."""
        try:
            s = np.asarray(scores)
            if s.ndim > 1:
                s = s[:, 0]
            with self._lock:
                self.features.update(x)
                self.score.update(s)
        except Exception:
            pass  # the drift plane must never fail a dispatch

    def observe_feedback(self, scores, labels, weights=None) -> int:
        """Labeled feedback (the FEEDBACK wire frame / client.feedback):
        feeds the trailing-window live-AUC accumulator.  Returns rows
        accepted."""
        s = np.asarray(scores, np.float64).ravel()
        with self._lock:
            self.feedback.update(s, labels, weights)
        return int(s.size)

    # -- windows -------------------------------------------------------

    def snapshot(self, now: float, slow_window_s: float) -> None:
        """Append one cumulative snapshot; prune the ring to the slow
        window plus one base sample (the SloEngine ring discipline)."""
        with self._lock:
            fb = self.feedback.state_arrays()
            self._samples.append((
                float(now), int(self.features.rows),
                self.features.hist.copy(), self.score.hist.copy(),
                fb[0].copy(), fb[1].copy(), int(self.feedback.rows)))
            horizon = float(now) - float(slow_window_s)
            while (len(self._samples) >= 2
                   and self._samples[1][0] <= horizon):
                self._samples.popleft()

    def window(self, now: float, seconds: float) -> Optional[dict]:
        """Sketch deltas over the trailing `seconds` (newest snapshot vs
        the newest snapshot at/older than now - seconds; the oldest held
        sample when none is old enough)."""
        with self._lock:
            if len(self._samples) < 2:
                return None
            cur = self._samples[-1]
            cut = float(now) - float(seconds)
            base = self._samples[0]
            for s in self._samples:
                if s[0] <= cut:
                    base = s
                else:
                    break
            span = cur[0] - base[0]
            if span <= 0:
                return None
            return {
                "span_s": span,
                "rows": cur[1] - base[1],
                "hist": cur[2] - base[2],
                "score_hist": cur[3] - base[3],
                "fb_pos": cur[4] - base[4],
                "fb_neg": cur[5] - base[5],
                "fb_rows": cur[6] - base[6],
            }

    def totals(self) -> dict:
        with self._lock:
            return {"rows": int(self.features.rows),
                    "feedback_rows": int(self.feedback.rows)}


def _auc_from_bins(pos: np.ndarray, neg: np.ndarray) -> Optional[float]:
    """Binned weighted Mann-Whitney AUC from (pos, neg) score-bin
    weights — the StreamingMetrics statistic over a WINDOW delta."""
    wp, wn = float(pos.sum()), float(neg.sum())
    if wp <= 0 or wn <= 0:
        return None
    neg_below = np.concatenate([[0.0], np.cumsum(neg)[:-1]])
    credit = neg_below + 0.5 * neg
    return float(np.sum(pos * credit) / (wp * wn))


# --------------------------------------------------------------- engine


class DriftEngine:
    """Fast/slow-window drift evaluation vs the frozen baseline, with
    the SLO engine's alert discipline: an objective fires ONE
    `drift_alert` when BOTH windows violate, stays latched until the
    fast window is healthy again (one "resolved" per episode), and an
    idle monitor (fast window below min_rows) unlatches rather than
    showing a stale FIRING alert forever.

    `tick(now)` is the whole cadence step: snapshot the monitor, build
    both windows, evaluate, and return (transitioned_alerts, report) —
    the caller (the daemon's drift loop) journals them.  Pure given
    injected timestamps, so drills replay deterministically."""

    def __init__(self, monitor: DriftMonitor, config):
        self.monitor = monitor
        self.cfg = config
        self._lock = threading.Lock()
        self._firing: dict[str, dict] = {}
        self._last: dict = {}        # last computed per-objective values
        self.alerts_fired = 0
        self._last_report_t: Optional[float] = None

    # -- per-objective math --------------------------------------------

    def _psi_pair(self, fast: dict, slow: dict) -> tuple:
        base = self.monitor.base_features.hist
        return (sketch_mod.psi(base, fast["hist"]),
                sketch_mod.psi(base, slow["hist"]))

    def _score_pair(self, fast: dict, slow: dict) -> tuple:
        base = self.monitor.base_score.hist
        return (sketch_mod.kl_divergence(base, fast["score_hist"]),
                sketch_mod.kl_divergence(base, slow["score_hist"]))

    def _window_auc(self, w: dict) -> Optional[float]:
        if w["fb_rows"] < max(int(self.cfg.min_rows), 1):
            return None
        return _auc_from_bins(w["fb_pos"], w["fb_neg"])

    def _base_event(self, fast: dict, slow: dict) -> dict:
        return {
            "model": self.monitor.model_id,
            "version": self.monitor.version,
            "fast_window_s": round(fast["span_s"], 3),
            "slow_window_s": round(slow["span_s"], 3),
            "rows_fast": int(fast["rows"]),
            "rows_slow": int(slow["rows"]),
        }

    # -- evaluation ----------------------------------------------------

    def tick(self, now: float,
             force_report: bool = False) -> tuple[list[dict],
                                                  Optional[dict]]:
        """One cadence step: returns (alert transitions, drift_report
        payload or None when the report interval hasn't elapsed).
        `force_report` emits a report regardless of the interval — the
        end-of-drill flush (`ScoringDaemon.drift_flush`) uses it so
        late-landing labeled feedback reaches a journaled report."""
        self.monitor.snapshot(now, self.cfg.slow_window_s)
        fast = self.monitor.window(now, self.cfg.fast_window_s)
        slow = self.monitor.window(now, self.cfg.slow_window_s)
        alerts = self.evaluate(now, fast, slow)
        report = None
        interval = max(float(self.cfg.fast_window_s), 1.0)
        if force_report or self._last_report_t is None \
                or now - self._last_report_t >= interval:
            report = self.report(fast, slow)
            if report is not None:
                self._last_report_t = now
        return alerts, report

    def evaluate(self, now: float, fast: Optional[dict],
                 slow: Optional[dict]) -> list[dict]:
        """The transitioned `drift_alert` payloads at `now` (firing AND
        resolved) — idempotent between transitions, exactly one firing
        per violation episode."""
        out: list[dict] = []
        with self._lock:
            if fast is None or slow is None:
                return out
            min_rows = max(int(self.cfg.min_rows), 1)
            if fast["rows"] < min_rows:
                # no judgment on a near-empty window — but latched
                # alerts must not outlive the traffic that caused them
                for name in list(self._firing):
                    del self._firing[name]
                    out.append({
                        "objective": name, "state": "resolved",
                        **self._base_event(fast, slow),
                        "note": "window below min_rows — traffic "
                                "stopped"})
                return out
            names = self.monitor.names
            k = max(int(self.cfg.top_k), 1)

            # ---- feature PSI ----
            psi_fast, psi_slow = self._psi_pair(fast, slow)
            psi_fast = np.atleast_1d(psi_fast)
            psi_slow = np.atleast_1d(psi_slow)
            t = float(self.cfg.psi_threshold)
            order = np.argsort(psi_fast)[::-1]
            worst = [{"feature": names[j],
                      "psi_fast": round(float(psi_fast[j]), 4),
                      "psi_slow": round(float(psi_slow[j]), 4)}
                     for j in order[:k]]
            self._last["worst_features"] = worst
            self._last["worst_psi"] = round(float(psi_fast[order[0]]), 4) \
                if len(order) else None
            if t > 0:
                offend = np.flatnonzero((psi_fast >= t) & (psi_slow >= t))
                firing = OBJ_FEATURE_PSI in self._firing
                if offend.size and not firing:
                    offend = offend[np.argsort(psi_fast[offend])[::-1]]
                    ev = {
                        "objective": OBJ_FEATURE_PSI, "state": "firing",
                        **self._base_event(fast, slow),
                        "psi_threshold": t,
                        "features": [
                            {"feature": names[j],
                             "psi_fast": round(float(psi_fast[j]), 4),
                             "psi_slow": round(float(psi_slow[j]), 4)}
                            for j in offend[:k]],
                    }
                    self._firing[OBJ_FEATURE_PSI] = ev
                    self.alerts_fired += 1
                    out.append(ev)
                elif firing and float(psi_fast.max(initial=0.0)) < t:
                    ev = {
                        "objective": OBJ_FEATURE_PSI, "state": "resolved",
                        **self._base_event(fast, slow),
                        "psi_threshold": t,
                        "worst_psi_fast":
                            round(float(psi_fast.max(initial=0.0)), 4),
                    }
                    del self._firing[OBJ_FEATURE_PSI]
                    out.append(ev)

            # ---- score KL ----
            kl_fast, kl_slow = self._score_pair(fast, slow)
            self._last["score_kl"] = round(kl_fast, 4)
            st = float(self.cfg.score_kl_threshold)
            if st > 0:
                firing = OBJ_SCORE_KL in self._firing
                if (not firing and kl_fast >= st and kl_slow >= st):
                    ev = {
                        "objective": OBJ_SCORE_KL, "state": "firing",
                        **self._base_event(fast, slow),
                        "score_kl_threshold": st,
                        "score_kl_fast": round(kl_fast, 4),
                        "score_kl_slow": round(kl_slow, 4),
                    }
                    self._firing[OBJ_SCORE_KL] = ev
                    self.alerts_fired += 1
                    out.append(ev)
                elif firing and kl_fast < st:
                    ev = {
                        "objective": OBJ_SCORE_KL, "state": "resolved",
                        **self._base_event(fast, slow),
                        "score_kl_threshold": st,
                        "score_kl_fast": round(kl_fast, 4),
                    }
                    del self._firing[OBJ_SCORE_KL]
                    out.append(ev)

            # ---- mean shift + live AUC (report axes, not alerts) ----
            base_mean, base_var = self.monitor.base_features.moments()
            live_fast = sketch_mod.FeatureSketch(
                self.monitor.base_features.num_features,
                scale=self.monitor.base_features.scale,
                offset=self.monitor.base_features.offset)
            live_fast.hist = fast["hist"]
            live_fast.rows = fast["rows"]
            live_mean, _ = live_fast.moments()
            shift = sketch_mod.mean_shift_sigmas(base_mean, base_var,
                                                 live_mean)
            jmax = int(np.argmax(shift)) if shift.size else 0
            self._last["mean_shift_max"] = round(float(
                shift.max(initial=0.0)), 4)
            self._last["mean_shift_feature"] = names[jmax] \
                if shift.size else None
            auc_live = self._window_auc(fast)
            self._last["auc_live"] = round(auc_live, 6) \
                if auc_live is not None else None
            base_auc = self.monitor.profile.get("train_auc")
            if auc_live is not None and base_auc is not None:
                self._last["auc_decay"] = round(float(base_auc)
                                                - auc_live, 6)
            else:
                self._last["auc_decay"] = None
        return out

    def report(self, fast: Optional[dict],
               slow: Optional[dict]) -> Optional[dict]:
        """The periodic `drift_report` payload (the last evaluated
        values + window row counts); None before any window exists."""
        if fast is None or slow is None:
            return None
        with self._lock:
            rep = {
                "model": self.monitor.model_id,
                "version": self.monitor.version,
                "baseline_digest": self.monitor.digest,
                "rows_fast": int(fast["rows"]),
                "rows_slow": int(slow["rows"]),
                "feedback_rows_fast": int(fast["fb_rows"]),
                "worst": list(self._last.get("worst_features") or []),
                "worst_psi": self._last.get("worst_psi"),
                "score_kl": self._last.get("score_kl"),
                "mean_shift_max": self._last.get("mean_shift_max"),
                "mean_shift_feature": self._last.get(
                    "mean_shift_feature"),
                "auc_live": self._last.get("auc_live"),
                "auc_decay": self._last.get("auc_decay"),
                "firing": sorted(self._firing),
            }
            if self.monitor.profile.get("train_auc") is not None:
                rep["train_auc"] = self.monitor.profile["train_auc"]
            return rep

    def export_gauges(self) -> None:
        """Scrape-file face: drift_psi{feature,model} for the worst
        features, score_drift and auc_decay per model."""
        from . import metrics as metrics_mod

        with self._lock:
            worst = list(self._last.get("worst_features") or [])
            score_kl = self._last.get("score_kl")
            auc_decay = self._last.get("auc_decay")
        model = self.monitor.model_id
        g = metrics_mod.gauge(GAUGE_PSI, "per-feature PSI of live "
                              "traffic vs the frozen baseline profile "
                              "(fast window)")
        for w in worst:
            g.set(w["psi_fast"], feature=w["feature"], model=model)
        if score_kl is not None:
            metrics_mod.gauge(GAUGE_SCORE, "KL(baseline || live) of "
                              "the score distribution").set(
                score_kl, model=model)
        if auc_decay is not None:
            metrics_mod.gauge(GAUGE_AUC_DECAY, "training AUC minus "
                              "trailing-window live AUC from labeled "
                              "feedback").set(auc_decay, model=model)

    def state(self) -> dict:
        """Operator snapshot (`stats()["drift"]` / the `top` drift
        row)."""
        with self._lock:
            totals = self.monitor.totals()
            return {
                "model": self.monitor.model_id,
                "version": self.monitor.version,
                "baseline_digest": self.monitor.digest,
                "baseline_rows": int(self.monitor.profile.get("rows", 0)),
                "rows": totals["rows"],
                "feedback_rows": totals["feedback_rows"],
                "worst_psi": self._last.get("worst_psi"),
                "worst_feature": (self._last.get("worst_features")
                                  or [{}])[0].get("feature"),
                "score_kl": self._last.get("score_kl"),
                "auc_live": self._last.get("auc_live"),
                "auc_decay": self._last.get("auc_decay"),
                "firing": sorted(self._firing),
                "alerts_fired": self.alerts_fired,
            }
