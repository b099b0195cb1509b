"""Diff two device-profile rollups: per-kernel device-time deltas (the
port of the repo's `tools/trace_diff.py`, same argv, exit codes, `--json`
report and text).

Run as `python -m shifu_tpu_torch.tools.trace_diff`.  Each side is a run's
`device_profile` journal event (the port's flight recorder writes one per
captured trace window, obs/devprof.py), located from a job dir /
telemetry dir / journal path exactly like `shifu-tpu-torch trace`, or read
from a JSON file holding a raw rollup (the `--json` output of
`shifu-tpu-torch trace`, or a bare device_profile event dict).

Usage:
    python -m shifu_tpu_torch.tools.trace_diff <run_A> <run_B>
        [--epoch N] [--json] [--fail-above PCT] [--serving | --pod]

By default the LAST device_profile of each journal is compared (`--epoch`
selects a specific captured epoch).  `--fail-above 50` exits 1 when any
kernel seen on both sides grew more than 50% in device time (or the
device total did).

`--serving` diffs the serving plane instead of the device plane: each
side's last `loadtest_report` (p50/p99/rate + per-stage means), its
`route_trace` aggregates (hedge rate, mean hop/queue/e2e), and its
`cold_start` drill results (per-engine spawn/promote-to-first-response)
from the journal tail.  An axis absent on either side gets status SKIP,
never a verdict: a journal predating the tracing layer must not fail the
gate, it just can't vouch for the new axes.

`--pod` diffs the pod data plane: each side's per-host cumulative ingest
seconds/bytes and the derived `train_scaling_efficiency`, read from the
run dir's merged per-rank journals (`pod_epoch_close` rows / chief
`host_skew` per-host rows) or from a bench artifact JSON that recorded
the sweep.  `--fail-above` is direction-aware here too: efficiency
regresses DOWN, per-host ingest seconds regress UP, and ingest bytes are
informational (the gated balance check is `shifu-tpu-torch pod-verify`'s
job).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

EXIT_PASS = 0
EXIT_REGRESSION = 1
EXIT_USAGE = 2


def load_rollup(path: str, epoch: int | None = None) -> dict:
    """One device_profile rollup from a job dir / journal / JSON file.
    Raises ValueError with the fix spelled out when none is found."""
    if os.path.isfile(path) and not path.endswith(".jsonl"):
        with open(path) as f:
            doc = json.load(f)
        if isinstance(doc, dict) and doc.get("kernels") is not None:
            return doc  # a bare rollup / device_profile event
        if isinstance(doc, dict) and isinstance(doc.get("profiles"), list):
            # `shifu-tpu-torch trace --json` output
            profiles = doc["profiles"]
        else:
            raise ValueError(f"{path}: no device_profile rollup found "
                             "(expected a rollup dict or `shifu-tpu-torch "
                             "trace --json` output)")
    else:
        from ..obs import render as obs_render
        summary = obs_render.trace_summary(path)
        if summary is None:
            raise ValueError(f"{path}: no telemetry journal found")
        profiles = summary["profiles"]
    if epoch is not None:
        profiles = [p for p in profiles if p.get("epoch") == epoch]
    if not profiles:
        raise ValueError(
            f"{path}: no device_profile events"
            + (f" for epoch {epoch}" if epoch is not None else "")
            + " — capture one with obs.trace_epochs")
    return profiles[-1]


# axes where a BIGGER number is the good direction (everything
# else — latencies, hedge rate, per-host ingest seconds — regresses upward)
_HIGHER_IS_BETTER = frozenset(("achieved_scores_per_sec",
                               "train_scaling_efficiency"))
# volume axes: informational only, never gated (per-host ingest BYTES are
# a property of the dataset and the shard width, not a perf verdict —
# the gated balance check lives in `shifu-tpu-torch pod-verify`)
_UNGATED = frozenset(("route.count", "hosts"))


def _ungated(axis: str) -> bool:
    return axis in _UNGATED or axis.endswith(".ingest_bytes")


def _serving_axes(report: dict, routes: list,
                  cold_starts: list = ()) -> dict:
    """{axis: value} from one side's last loadtest_report + route_trace
    + cold_start events — the serving-plane analog of a kernel rollup."""
    axes: dict = {}
    for k in ("p50_ms", "p99_ms", "achieved_scores_per_sec"):
        v = report.get(k)
        if isinstance(v, (int, float)):
            axes[k] = float(v)
    for stage, s in (report.get("stages") or {}).items():
        if isinstance(s, dict) and isinstance(s.get("mean_ms"),
                                              (int, float)):
            axes[f"stage.{stage}.mean_ms"] = float(s["mean_ms"])
    if routes:
        axes["route.count"] = float(len(routes))
        axes["route.hedge_rate"] = round(
            sum(1 for r in routes if r.get("hedged")) / len(routes), 4)
        hops = [h.get("ms") for r in routes for h in (r.get("hops") or [])
                if isinstance(h.get("ms"), (int, float))]
        if hops:
            axes["route.hop_ms_mean"] = round(sum(hops) / len(hops), 4)
        for field, axis in (("queue_ms", "route.queue_ms_mean"),
                            ("e2e_ms", "route.e2e_ms_mean")):
            vals = [r[field] for r in routes
                    if isinstance(r.get(field), (int, float))]
            if vals:
                axes[axis] = round(sum(vals) / len(vals), 4)
    # the fleet's cold-start drill: the LAST cold_start event per
    # engine wins — spawn/promote wall to the first healthy response.
    # Latency-style axes (regress upward); the aot-vs-jit spread is the
    # AOT pack's measured value on that host.
    for ev in cold_starts:
        eng = ev.get("engine")
        if not isinstance(eng, str):
            continue
        for k in ("spawn_ms", "promote_ms"):
            if isinstance(ev.get(k), (int, float)):
                axes[f"cold_start.{eng}.{k}"] = float(ev[k])
    return axes


def load_serving_axes(path: str) -> dict:
    """One side's serving decomposition: a telemetry/job dir (journal
    tail) or a loadtest `--json` report file."""
    if os.path.isfile(path) and not path.endswith(".jsonl"):
        with open(path) as f:
            doc = json.load(f)
        if isinstance(doc, dict) and (doc.get("stages")
                                      or doc.get("p50_ms") is not None):
            return _serving_axes(doc, [])
        raise ValueError(f"{path}: not a loadtest report JSON")
    from ..obs import render as obs_render
    jpath = obs_render.find_journal(path)
    if jpath is None:
        raise ValueError(f"{path}: no telemetry journal found")
    events, _n, _trunc = obs_render._load_events_tail(jpath)
    report: dict = {}
    routes: list = []
    cold_starts: list = []
    for ev in events:
        if ev.get("kind") == "loadtest_report":
            report = ev
        elif ev.get("kind") == "route_trace":
            routes.append(ev)
        elif ev.get("kind") == "cold_start":
            cold_starts.append(ev)
    axes = _serving_axes(report, routes, cold_starts)
    if not axes:
        raise ValueError(
            f"{path}: no loadtest_report, route_trace or cold_start "
            "events — run `shifu-tpu-torch loadtest` (or sample traces "
            "with shifu.serving.trace-sample) first")
    return axes


def _diff_axis_table(a: dict, b: dict, args, mode: str) -> int:
    """Shared axis-table diff: direction-aware --fail-above gating,
    SKIP for axes absent on either side, text or --json report."""
    limit = (1.0 + args.fail_above / 100.0) \
        if args.fail_above is not None else None
    rows = []
    blamed = []
    for axis in sorted(set(a) | set(b)):
        va, vb = a.get(axis), b.get(axis)
        row = {"axis": axis, "a": va, "b": vb,
               "delta": None, "ratio": None, "status": "SKIP"}
        if va is not None and vb is not None:
            row["delta"] = round(vb - va, 4)
            row["ratio"] = round(vb / va, 4) if va > 0 else None
            row["status"] = "OK"
            if limit is not None and va > 0 and not _ungated(axis):
                worse = (vb < va / limit if axis in _HIGHER_IS_BETTER
                         else vb > va * limit)
                if worse:
                    row["status"] = "REGRESSION"
                    blamed.append(axis)
        rows.append(row)
    verdict = "REGRESSION" if blamed else "PASS"
    report = {"a": args.run_a, "b": args.run_b, "mode": mode,
              "axes": rows, "blamed": blamed, "verdict": verdict}
    if args.json:
        print(json.dumps(report))
    else:
        print(f"trace-diff: {verdict} — {mode} plane, "
              f"{len(rows)} axis(es), "
              f"{sum(1 for r in rows if r['status'] == 'SKIP')} skipped")
        print(f"  {'axis':<28} {'A':>12} {'B':>12} {'delta':>10} "
              f"{'ratio':>7} {'status':>10}")
        for r in rows:
            ratio = f"x{r['ratio']}" if r["ratio"] is not None else "-"
            print(f"  {r['axis'][:28]:<28} "
                  f"{r['a'] if r['a'] is not None else '-':>12} "
                  f"{r['b'] if r['b'] is not None else '-':>12} "
                  f"{r['delta'] if r['delta'] is not None else '-':>10} "
                  f"{ratio:>7} {r['status']:>10}")
        if blamed:
            print("  blamed: " + ", ".join(blamed))
    return EXIT_PASS if verdict == "PASS" else EXIT_REGRESSION


def _diff_serving(args) -> int:
    try:
        a = load_serving_axes(args.run_a)
        b = load_serving_axes(args.run_b)
    except (OSError, ValueError) as e:
        print(f"trace-diff: {e}", file=sys.stderr, flush=True)
        return EXIT_USAGE
    return _diff_axis_table(a, b, args, "serving")


def load_pod_axes(path: str) -> dict:
    """One side's pod data-plane decomposition: a run dir (merged
    per-rank journals — `pod_epoch_close` rows from data-dryrun gangs or
    the per-host rows inside chief `host_skew` events) or a bench
    artifact JSON carrying `train_scaling_efficiency`.

    From journals, each rank's LAST close row wins (the journaled
    ingest fields are cumulative counter totals), and
    `train_scaling_efficiency` is derived as
    `sum(rank ingest_s) / (hosts x max(rank ingest_s))` — 1.0 when the
    shard assignment splits the ingest evenly, toward 1/n when one host
    ingests everything: the definition a bench artifact's host sweep
    records (there t1 IS the total work, measured on one host).  The
    port writes no such artifact yet; the format is read as JAX's."""
    if os.path.isfile(path) and not path.endswith(".jsonl"):
        with open(path) as f:
            doc = json.load(f)
        if isinstance(doc, dict) \
                and doc.get("train_scaling_efficiency") is not None:
            axes = {"train_scaling_efficiency":
                    float(doc["train_scaling_efficiency"])}
            ts = doc.get("train_scaling") or {}
            for r, v in enumerate(ts.get("host_ingest_s_n4") or ()):
                axes[f"host.{r}.ingest_s"] = float(v)
            for r, v in enumerate(ts.get("host_ingest_bytes_n4") or ()):
                axes[f"host.{r}.ingest_bytes"] = float(v)
            return axes
        raise ValueError(f"{path}: no train_scaling_efficiency field "
                         "(expected a bench artifact from a round with "
                         "the pod data plane)")
    from ..launcher.pod import _pod_close_rows
    from ..obs import timeline as timeline_mod
    merged = timeline_mod.load_merged(path, tail_bytes=None)
    if merged is None:
        raise ValueError(f"{path}: no telemetry journal found")
    rows = _pod_close_rows(merged["events"])
    if not rows:
        raise ValueError(
            f"{path}: no pod data-plane rows (pod_epoch_close events or "
            "host_skew per-host rows) — run a multi-host job or "
            "`shifu-tpu-torch data-dryrun` first")
    last: dict = {}
    for r in rows:  # merged stream is time-ordered: later rows win
        last[r["rank"]] = r
    axes: dict = {"hosts": float(len(last))}
    per_s = []
    for rank, r in sorted(last.items()):
        s = r.get("ingest_s")
        if isinstance(s, (int, float)):
            axes[f"host.{rank}.ingest_s"] = round(float(s), 4)
            per_s.append(float(s))
        if isinstance(r.get("ingest_bytes"), (int, float)):
            axes[f"host.{rank}.ingest_bytes"] = float(r["ingest_bytes"])
    if per_s and max(per_s) > 0:
        axes["train_scaling_efficiency"] = round(
            sum(per_s) / (len(per_s) * max(per_s)), 4)
    return axes


def _diff_pod(args) -> int:
    try:
        a = load_pod_axes(args.run_a)
        b = load_pod_axes(args.run_b)
    except (OSError, ValueError) as e:
        print(f"trace-diff: {e}", file=sys.stderr, flush=True)
        return EXIT_USAGE
    return _diff_axis_table(a, b, args, "pod")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="trace_diff",
        description="per-kernel device-time deltas between two "
                    "device_profile rollups (run A vs run B)")
    p.add_argument("run_a", help="job dir / journal path / rollup JSON "
                                 "(the baseline side)")
    p.add_argument("run_b", help="job dir / journal path / rollup JSON "
                                 "(the fresh side)")
    p.add_argument("--epoch", type=int, default=None,
                   help="compare the capture of this epoch (default: the "
                        "last capture on each side)")
    p.add_argument("--fail-above", type=float, default=None, metavar="PCT",
                   help="exit 1 when a kernel present on both sides (or "
                        "the device total) grew more than PCT%% in device "
                        "time")
    p.add_argument("--json", action="store_true",
                   help="machine-readable report instead of text")
    p.add_argument("--serving", action="store_true",
                   help="diff the serving plane (loadtest stage means + "
                        "route_trace hop/queue aggregates) instead of "
                        "device kernels; missing axes SKIP, never fail")
    p.add_argument("--pod", action="store_true",
                   help="diff the pod data plane (per-host ingest "
                        "seconds/bytes + derived train_scaling_"
                        "efficiency from pod_epoch_close / host_skew "
                        "journal rows, or a bench artifact's recorded "
                        "value) instead of device kernels; "
                        "direction-aware --fail-above, missing axes "
                        "SKIP, ingest bytes informational only")
    args = p.parse_args(argv)

    if args.serving and args.pod:
        print("trace-diff: --serving and --pod are mutually exclusive",
              file=sys.stderr, flush=True)
        return EXIT_USAGE
    if args.serving:
        return _diff_serving(args)
    if args.pod:
        return _diff_pod(args)

    from ..obs import tracefmt

    try:
        a = load_rollup(args.run_a, args.epoch)
        b = load_rollup(args.run_b, args.epoch)
    except (OSError, ValueError) as e:
        print(f"trace-diff: {e}", file=sys.stderr, flush=True)
        return EXIT_USAGE

    rows = tracefmt.diff_rollups(a, b)
    tot_a = float(a.get("device_us_total") or 0.0)
    tot_b = float(b.get("device_us_total") or 0.0)
    report = {
        "a": args.run_a, "b": args.run_b,
        "a_epoch": a.get("epoch"), "b_epoch": b.get("epoch"),
        "a_device_us_total": round(tot_a, 3),
        "b_device_us_total": round(tot_b, 3),
        "total_delta_us": round(tot_b - tot_a, 3),
        "total_ratio": round(tot_b / tot_a, 4) if tot_a > 0 else None,
        "kernels": rows,
    }
    verdict = "PASS"
    if args.fail_above is not None:
        limit = 1.0 + args.fail_above / 100.0
        blamed = [r for r in rows
                  if r["a_us"] > 0 and r["b_us"] > 0
                  and r["b_us"] > r["a_us"] * limit]
        if tot_a > 0 and tot_b > tot_a * limit:
            blamed.append({"name": "<device total>", "a_us": tot_a,
                           "b_us": tot_b})
        if blamed:
            verdict = "REGRESSION"
        report["blamed"] = [r["name"] for r in blamed]
    report["verdict"] = verdict

    if args.json:
        print(json.dumps(report))
    else:
        print(f"trace-diff: {report['verdict']} — device total "
              f"{report['a_device_us_total']}us -> "
              f"{report['b_device_us_total']}us "
              f"(delta {report['total_delta_us']}us"
              + (f", x{report['total_ratio']}" if report["total_ratio"]
                 else "") + ")")
        print(f"  {'kernel':<40} {'A_us':>12} {'B_us':>12} {'delta':>12} "
              f"{'ratio':>7}")
        for r in rows:
            ratio = f"x{r['ratio']}" if r["ratio"] is not None else "new"
            print(f"  {r['name'][:40]:<40} {r['a_us']:>12} {r['b_us']:>12} "
                  f"{r['delta_us']:>12} {ratio:>7}")
        if report.get("blamed"):
            print("  blamed: " + ", ".join(report["blamed"]))
    return EXIT_PASS if verdict == "PASS" else EXIT_REGRESSION


if __name__ == "__main__":
    sys.exit(main())
