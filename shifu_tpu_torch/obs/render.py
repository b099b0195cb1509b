"""Render a job's telemetry (journal + scrape file) for the CLI (port of
shifu_tpu/obs/render.py).

The operator's views land here: `metrics` (`summarize`/`render_text`),
`profile` (`profile_summary`), `trace` (`trace_summary`), `top`
(`top_summary`, and `render_top_fleet_text` over obs/aggregate's
`serving_rollup`) and `drift` (`drift_summary`).  `<dir>` may be a job dir
(telemetry lives under `<dir>/telemetry/`), the telemetry dir itself, or a
direct journal path, local or remote through data/fsio.  Each view reads
journal and scrape files only: it imports neither torch nor numpy, so it
is safe to point at a live job from any machine that can read the dir.
The summary keys and the text are the JAX package's, so one journal
renders the same in both packages.  The port emits no `xla_compile`
events: `profile`'s `compiled_functions` stays `{}` and its section is not
printed, as the JAX renderer does for such a journal.
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Optional

from . import _sinks, journal as journal_mod

TELEMETRY_DIRNAME = "telemetry"


def _exists(path: str) -> bool:
    try:
        from ..data import fsio
        if fsio.is_remote(path):
            try:
                fsio.file_info(path)
                return True
            except FileNotFoundError:
                return False
        return os.path.exists(path)
    except Exception:
        return os.path.exists(path)


def find_journal(path: str) -> Optional[str]:
    """Resolve a journal path from a job dir / telemetry dir / file path."""
    from ..data import fsio

    if path.endswith(".jsonl"):
        return path if _exists(path) else None
    candidates = (
        fsio.join(path, TELEMETRY_DIRNAME, journal_mod.JOURNAL_FILE),
        fsio.join(path, journal_mod.JOURNAL_FILE),
    )
    for c in candidates:
        if _exists(c):
            return c
    return None


def _read_scrape(journal_path: str) -> Optional[str]:
    # a bare relative journal filename (cwd = the telemetry dir) must
    # resolve to ITS directory, not to "/metrics.prom"
    if "/" in journal_path:
        prom = journal_path.rsplit("/", 1)[0] + "/" + _sinks.SCRAPE_FILE
    else:
        prom = _sinks.SCRAPE_FILE
    if not _exists(prom):
        return None
    try:
        from ..data import fsio
        if fsio.is_remote(prom):
            return fsio.read_bytes(prom).decode("utf-8", "replace")
        with open(prom) as f:
            return f.read()
    except Exception:
        return None


def parse_scrape_totals(text: str) -> dict[str, float]:
    """Per-metric totals from Prometheus text: counters/gauges sum across
    label sets; histograms report their `_count` total.  Enough for the
    summary view without a real Prometheus parser."""
    totals: dict[str, float] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = re.match(r"^([A-Za-z_:][A-Za-z0-9_:]*)(\{.*\})?\s+(\S+)$", line)
        if not m:
            continue
        name, _labels, value = m.groups()
        if name.endswith("_bucket") or name.endswith("_sum"):
            continue
        try:
            v = float(value)
        except ValueError:
            continue
        key = name[:-6] if name.endswith("_count") else name
        totals[key] = totals.get(key, 0.0) + v
    return totals


def parse_scrape_histograms(text: str) -> dict:
    """Histogram series from Prometheus text: {metric_name: {label_key:
    {"bounds": [...], "counts": [per-bucket incl +Inf], "sum", "count"}}}
    where label_key is the sorted 'k=v;k=v' spelling WITHOUT `le`.  Enough
    for stage/latency percentile math (`quantile_from_counts`) from the
    scrape file alone — no live process needed."""
    series: dict = {}
    line_re = re.compile(
        r"^([A-Za-z_:][A-Za-z0-9_:]*)_(bucket|sum|count)(\{.*\})?\s+(\S+)$")
    pair_re = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')
    for line in text.splitlines():
        m = line_re.match(line)
        if not m:
            continue
        name, part, labels_s, value_s = m.groups()
        labels = dict(pair_re.findall(labels_s or ""))
        le = labels.pop("le", None)
        key = ";".join(f"{k}={v}" for k, v in sorted(labels.items()))
        try:
            value = float(value_s)
        except ValueError:
            continue
        s = series.setdefault(name, {}).setdefault(
            key, {"le": {}, "sum": 0.0, "count": 0})
        if part == "bucket" and le is not None:
            bound = float("inf") if le == "+Inf" else float(le)
            s["le"][bound] = value
        elif part == "sum":
            s["sum"] = value
        elif part == "count":
            s["count"] = int(value)
    out: dict = {}
    for name, by_key in series.items():
        for key, s in by_key.items():
            if not s["le"]:
                continue  # a _sum/_count pair without buckets (summary)
            bounds = sorted(b for b in s["le"] if b != float("inf"))
            cum = [s["le"][b] for b in bounds]
            # a series whose only bucket is +Inf (legal exposition) has
            # no finite bounds: everything rides the +Inf count
            counts = ([int(cum[0])] + [int(cum[i] - cum[i - 1])
                                       for i in range(1, len(cum))]
                      if cum else [])
            counts.append(max(int(s["count"]) - int(cum[-1] if cum else 0),
                              0))  # +Inf bucket
            out.setdefault(name, {})[key] = {
                "bounds": bounds, "counts": counts,
                "sum": s["sum"], "count": s["count"]}
    return out


def _load_events(jpath: str) -> list[dict]:
    """One journal's events, with the supervisor's remote-dir sidecar
    journal merged when present (two writers on one remote object would
    erase each other — see obs/_sinks.configure); sort restores one
    timeline."""
    events = journal_mod.read_journal(jpath)
    sidecar = (jpath.rsplit("/", 1)[0] + "/journal-supervisor.jsonl"
               if "/" in jpath
               else os.path.join(os.path.dirname(jpath),
                                 "journal-supervisor.jsonl"))
    if sidecar != jpath and _exists(sidecar):
        try:
            events = sorted(events + journal_mod.read_journal(sidecar),
                            key=lambda r: (r.get("ts") or 0,
                                           r.get("seq") or 0))
        except Exception:
            pass
    return events


def summarize(path: str) -> Optional[dict]:
    """The telemetry summary dict for a job/telemetry dir, or None when no
    journal is found."""
    jpath = find_journal(path)
    if jpath is None:
        return None
    events = _load_events(jpath)
    kinds: dict[str, int] = {}
    epochs: list[dict] = []
    run: dict = {}
    spans: dict[str, float] = {}
    for rec in events:
        kind = str(rec.get("kind", "?"))
        kinds[kind] = kinds.get(kind, 0) + 1
        if kind == "epoch":
            epochs.append(rec)
        elif kind in ("run_start", "train_start") and not run:
            run = {k: v for k, v in rec.items()
                   if k not in ("seq", "kind")}
        elif kind == "span":
            name = str(rec.get("span", "?"))
            spans[name] = spans.get(name, 0.0) + float(rec.get("dur_s") or 0)
    out = {
        "journal": jpath,
        "events": len(events),
        "event_kinds": dict(sorted(kinds.items())),
        "run": run,
        "epochs": [
            {k: e.get(k) for k in ("epoch", "train_error", "valid_error",
                                   "valid_auc", "epoch_time", "valid_time")}
            for e in epochs],
        "span_totals_s": {k: round(v, 4)
                          for k, v in sorted(spans.items())},
    }
    if events:
        last = events[-1]
        out["last_event"] = {"kind": last.get("kind"), "ts": last.get("ts")}
    scrape = _read_scrape(jpath)
    if scrape is not None:
        out["metrics"] = {k: v for k, v in
                          sorted(parse_scrape_totals(scrape).items())}
    return out


def render_text(summary: dict) -> str:
    """Human-readable rendering of `summarize`'s dict."""
    lines = [f"journal: {summary['journal']} ({summary['events']} events)"]
    run = summary.get("run") or {}
    if run:
        desc = " ".join(f"{k}={v}" for k, v in run.items()
                        if k not in ("ts",) and v is not None)
        lines.append(f"run: {desc}")
    kinds = summary.get("event_kinds") or {}
    if kinds:
        lines.append("events: " + " ".join(f"{k}={v}"
                                           for k, v in kinds.items()))
    epochs = summary.get("epochs") or []
    if epochs:
        lines.append(f"{'epoch':>5} {'train_err':>10} {'valid_err':>10} "
                     f"{'auc':>7} {'time_s':>8} {'valid_s':>8}")
        for e in epochs:
            def f(v, spec):
                return format(v, spec) if isinstance(v, (int, float)) \
                    else "-"
            lines.append(f"{f(e.get('epoch'), 'd'):>5} "
                         f"{f(e.get('train_error'), '.6f'):>10} "
                         f"{f(e.get('valid_error'), '.6f'):>10} "
                         f"{f(e.get('valid_auc'), '.4f'):>7} "
                         f"{f(e.get('epoch_time'), '.2f'):>8} "
                         f"{f(e.get('valid_time'), '.2f'):>8}")
    spans = summary.get("span_totals_s") or {}
    if spans:
        lines.append("span totals (s): " + " ".join(
            f"{k}={v:g}" for k, v in spans.items()))
    metrics = summary.get("metrics")
    if metrics:
        lines.append(f"metrics ({len(metrics)} series totals):")
        for k, v in metrics.items():
            lines.append(f"  {k} {v:g}")
    last = summary.get("last_event")
    if last:
        lines.append(f"last event: {last.get('kind')} at ts "
                     f"{last.get('ts')}")
    return "\n".join(lines)


# -- `shifu-tpu profile`: the goodput / XLA-cost view ----------------------

def profile_summary(path: str) -> Optional[dict]:
    """The performance-profile dict for a job/telemetry dir: per-epoch
    goodput bucket records, compiled functions aggregated by cost, and
    the recovery tax (restore / fallback / preemption-grace seconds) —
    assembled purely from `goodput` / `xla_compile` / checkpoint journal
    events (docs/PERF.md "Goodput & MFU").  None when no journal."""
    jpath = find_journal(path)
    if jpath is None:
        return None
    events = _load_events(jpath)

    epochs: list[dict] = []
    compiles: dict[str, dict] = {}
    overlap_epochs: list[dict] = []
    ingests: list[dict] = []
    profiles: list[dict] = []
    hbm_peak = 0
    hbm_last: Optional[dict] = None
    anomalies = 0
    trace_fallbacks = 0
    tier_last: Optional[dict] = None
    tier_reports = 0
    dedup_last: Optional[dict] = None
    offload_fallbacks = 0
    aot_loads: list[dict] = []
    aot_fallbacks: list[dict] = []
    aot_packs: list[dict] = []
    prewarm_last: Optional[dict] = None
    skew_last: Optional[dict] = None
    skew_count = 0
    digest_disagreements = 0
    dcn_last: Optional[dict] = None
    dcn_saved_b = 0
    dcn_sync_saved_b = 0
    recovery = {"restore_s": 0.0, "restores": 0, "fallbacks": 0,
                "cache_fallbacks": 0, "preemption_graces": 0, "resumes": 0}
    for rec in events:
        kind = rec.get("kind")
        if kind == "goodput":
            epochs.append({k: rec.get(k) for k in
                           ("epoch", "wall_s", "buckets", "goodput_fraction",
                            "mfu", "achieved_tflops", "peak_tflops",
                            "compiles")})
        elif kind == "overlap_report":
            overlap_epochs.append({k: rec.get(k) for k in
                                   ("epoch", "tier", "overlap",
                                    "prefetch_depth", "input_exposed_s",
                                    "input_production_s", "input_hidden_s",
                                    "eval_s", "prefetched_chunks",
                                    "overlap_efficiency", "order_digest",
                                    "resident_format")})
        elif kind == "xla_compile":
            fn = str(rec.get("fn", "?"))
            c = compiles.setdefault(fn, {"compiles": 0, "compile_s": 0.0,
                                         "cache": {}})
            c["compiles"] += 1
            try:
                c["compile_s"] = round(
                    c["compile_s"] + float(rec.get("compile_s") or 0), 6)
            except (TypeError, ValueError):
                pass
            cache = str(rec.get("cache") or "off")
            c["cache"][cache] = c["cache"].get(cache, 0) + 1
            for k in ("flops", "bytes_accessed", "peak_bytes"):
                if rec.get(k) is not None:
                    c[k] = rec[k]  # last capture wins (latest signature)
        elif kind == "checkpoint_restore":
            recovery["restores"] += 1
            try:
                recovery["restore_s"] = round(
                    recovery["restore_s"] + float(rec.get("dur_s") or 0), 6)
            except (TypeError, ValueError):
                pass
        elif kind == "ingest_report":
            # the cold/warm ingest record (docs/OBSERVABILITY.md): pool
            # shape, phase split, which cache tier served (per_file capped
            # at the source — keep the rollup fields only here)
            ingests.append({k: rec.get(k) for k in
                            ("mode", "files", "pool_width", "wall_s",
                             "rows", "parse_s", "inflate_s", "write_s",
                             "source_bytes", "host_index", "tiers")})
        elif kind == "checkpoint_fallback":
            recovery["fallbacks"] += 1
        elif kind == "cache_fallback":
            recovery["cache_fallbacks"] += 1
        elif kind == "preemption_grace":
            recovery["preemption_graces"] += 1
        elif kind == "train_resume":
            recovery["resumes"] += 1
        elif kind == "device_profile":
            profiles.append(rec)
        elif kind == "hbm_watermark":
            hbm_last = rec
            try:
                hbm_peak = max(hbm_peak, int(rec.get("peak_bytes") or 0))
            except (TypeError, ValueError):
                pass
        elif kind == "anomaly":
            anomalies += 1
        elif kind == "trace_fallback":
            trace_fallbacks += 1
        elif kind == "embed_tier_report":
            tier_last = rec
            tier_reports += 1
        elif kind == "embed_dedup_report":
            dedup_last = rec
        elif kind == "embed_offload_fallback":
            offload_fallbacks += 1
        elif kind == "aot_load":
            aot_loads.append(rec)
        elif kind == "aot_fallback":
            aot_fallbacks.append(rec)
        elif kind == "aot_pack":
            aot_packs.append(rec)
        elif kind == "model_prewarm":
            prewarm_last = rec
        elif kind == "host_skew":
            skew_last = rec
            skew_count += 1
            if rec.get("order_digest_agree") is False:
                digest_disagreements += 1
            if rec.get("shard_digest_agree") is False:
                digest_disagreements += 1
        elif kind == "dcn_placement":
            dcn_last = rec
            try:
                dcn_saved_b += int(rec.get("input_dcn_saved_bytes") or 0)
                dcn_sync_saved_b += int(
                    rec.get("dcn_sync_saved_bytes") or 0)
            except (TypeError, ValueError):
                pass

    totals: dict[str, float] = {}
    fracs, mfus = [], []
    for e in epochs:
        for b, s in (e.get("buckets") or {}).items():
            if isinstance(s, (int, float)):
                totals[b] = round(totals.get(b, 0.0) + s, 6)
        if isinstance(e.get("goodput_fraction"), (int, float)):
            fracs.append(e["goodput_fraction"])
        if isinstance(e.get("mfu"), (int, float)):
            mfus.append(e["mfu"])
    # overlap engine rollup (docs/PERF.md "Overlap engine"): how much of
    # the epochs' host input work ran behind device compute
    hidden = sum(e["input_hidden_s"] for e in overlap_epochs
                 if isinstance(e.get("input_hidden_s"), (int, float)))
    exposed = sum(e["input_exposed_s"] for e in overlap_epochs
                  if isinstance(e.get("input_exposed_s"), (int, float)))
    overlap = None
    if overlap_epochs:
        overlap = {
            "epochs": overlap_epochs,
            "input_hidden_s": round(hidden, 6),
            "input_exposed_s": round(exposed, 6),
            "efficiency": (round(hidden / (hidden + exposed), 4)
                           if hidden + exposed > 0 else None),
        }
    out = {
        "journal": jpath,
        "epochs": epochs,
        "bucket_totals_s": totals,
        "goodput_fraction_mean": (round(sum(fracs) / len(fracs), 4)
                                  if fracs else None),
        "mfu_max": (round(max(mfus), 6) if mfus else None),
        "overlap": overlap,
        "ingest": ingests or None,
        # by cost: captured FLOPs first (the honest "expensive" ranking),
        # compile seconds as the tiebreak/no-capture fallback
        "compiled_functions": dict(sorted(
            compiles.items(),
            key=lambda kv: (-(kv[1].get("flops") or 0),
                            -kv[1]["compile_s"]))),
        "recovery": recovery,
    }
    # device flight recorder rollup (docs/PERF.md "Where the step time
    # goes"): the last device profile's top kernels next to the goodput
    # buckets they decompose, plus the HBM high water and anomaly count
    device: dict = {}
    if profiles:
        last = profiles[-1]
        device["profiles"] = len(profiles)
        device["last"] = {k: last.get(k) for k in
                          ("epoch", "trigger", "window_us",
                           "device_us_total", "device_fraction",
                           "kernel_count", "kernels")}
    if hbm_last is not None:
        device["hbm_peak_bytes"] = hbm_peak
        device["hbm_source"] = hbm_last.get("source")
        device["hbm_bytes_in_use"] = hbm_last.get("bytes_in_use")
    if anomalies:
        device["anomalies"] = anomalies
    if trace_fallbacks:
        device["trace_fallbacks"] = trace_fallbacks
    out["device"] = device or None
    # sparse embedding engine rollup (docs/EMBEDDING.md): the last tier
    # report (hot/cold traffic split), the last dedup report (rows
    # touched vs raw id cells), and how many cold reads hit the
    # journaled fallback chain
    embed: dict = {}
    if tier_last is not None:
        embed["tier_reports"] = tier_reports
        embed["tier"] = {k: tier_last.get(k) for k in
                         ("hit_rate", "hot_rows", "vocab", "lookups",
                          "hits", "misses", "cold_bytes", "cold_seconds",
                          "prefetch_hits", "fallbacks")}
    if dedup_last is not None:
        embed["dedup"] = {k: dedup_last.get(k) for k in
                          ("batches", "rows_touched", "raw_cells",
                           "dedup_ratio")}
    if offload_fallbacks:
        embed["offload_fallbacks"] = offload_fallbacks
    out["embed"] = embed or None
    # AOT serving-executable plane (docs/SERVING.md "Cold start & AOT
    # pack"): packed grids built, executables deserialized (the
    # zero-compile loads), and every fallback with its reason — a
    # fallback row here is the first place a fingerprint drift shows up
    aot: dict = {}
    if aot_packs:
        aot["packs"] = len(aot_packs)
        aot["pack_buckets"] = aot_packs[-1].get("buckets")
    if aot_loads:
        last = aot_loads[-1]
        aot["loads"] = len(aot_loads)
        aot["last_load"] = {k: last.get(k) for k in
                            ("path", "buckets", "bucket_ms", "wall_ms")}
    if aot_fallbacks:
        aot["fallbacks"] = len(aot_fallbacks)
        aot["last_fallback"] = {
            k: aot_fallbacks[-1].get(k) for k in ("path", "reason")}
    if prewarm_last is not None:
        aot["prewarm"] = {k: prewarm_last.get(k) for k in
                          ("engine", "buckets", "wall_ms")}
    out["aot"] = aot or None
    # pod data plane rollup (docs/DATA.md "Multi-host data plane"): the
    # last epoch's per-host skew table (with its ingest bytes/seconds
    # extras), whether the cross-host digest agreement ever broke, and the
    # DCN placement ledger's cumulative savings
    pod: dict = {}
    if skew_last is not None:
        pod["skew_epochs"] = skew_count
        pod["last_epoch"] = skew_last.get("epoch")
        pod["hosts"] = skew_last.get("hosts")
        pod["order_digest_agree"] = skew_last.get("order_digest_agree")
        pod["shard_digest_agree"] = skew_last.get("shard_digest_agree")
        pod["digest_disagreements"] = digest_disagreements
    if dcn_last is not None:
        pod["dcn"] = {k: dcn_last.get(k) for k in
                      ("epoch", "tier", "hosts", "slices",
                       "input_local_bytes", "input_dcn_bytes",
                       "local_sgd_window")}
        pod["dcn"]["input_dcn_saved_bytes_total"] = dcn_saved_b
        pod["dcn"]["dcn_sync_saved_bytes_total"] = dcn_sync_saved_b
    out["pod"] = pod or None
    return out


def render_profile_text(summary: dict) -> str:
    """Human rendering of `profile_summary`'s dict: the per-epoch bucket
    table, top compiled functions, and the recovery tax."""
    lines = [f"journal: {summary['journal']}"]
    epochs = summary.get("epochs") or []
    if not epochs:
        lines.append("no goodput events (run predates the ledger, or no "
                     "epoch completed)")
    else:
        hdr = (f"{'epoch':>5} {'wall_s':>8} {'compile':>8} {'input':>8} "
               f"{'step':>8} {'ckpt':>8} {'restore':>8} {'eval':>8} "
               f"{'other':>8} {'goodput':>8} {'mfu':>8}")
        lines.append(hdr)

        def f(v, spec="0.3f"):
            return format(v, spec) if isinstance(v, (int, float)) else "-"

        for e in epochs:
            b = e.get("buckets") or {}
            lines.append(
                f"{f(e.get('epoch'), 'd'):>5} {f(e.get('wall_s')):>8} "
                f"{f(b.get('compile')):>8} {f(b.get('input')):>8} "
                f"{f(b.get('step')):>8} {f(b.get('checkpoint')):>8} "
                f"{f(b.get('restore')):>8} {f(b.get('eval')):>8} "
                f"{f(b.get('other')):>8} "
                f"{f(e.get('goodput_fraction'), '.1%'):>8} "
                f"{f(e.get('mfu'), '.4f'):>8}")
        mean_frac = summary.get("goodput_fraction_mean")
        mfu_max = summary.get("mfu_max")
        tail = [f"goodput mean {mean_frac:.1%}"
                if isinstance(mean_frac, (int, float)) else "goodput mean -"]
        if isinstance(mfu_max, (int, float)):
            tail.append(f"mfu max {mfu_max:.4f}")
        lines.append("  ".join(tail))
    overlap = summary.get("overlap")
    if overlap:
        eff = overlap.get("efficiency")
        lines.append(
            f"overlap engine: input hidden {overlap['input_hidden_s']:g}s "
            f"exposed {overlap['input_exposed_s']:g}s"
            + (f" ({eff:.1%} hidden)" if isinstance(eff, (int, float))
               else ""))
        for e in overlap.get("epochs") or []:
            if not e.get("overlap"):
                continue
            eeff = e.get("overlap_efficiency")
            lines.append(
                f"  epoch {e.get('epoch')}: tier={e.get('tier')} "
                + (f"[{e['resident_format']}] "
                   if e.get("resident_format") else "")
                + f"depth={e.get('prefetch_depth')} "
                f"hidden={e.get('input_hidden_s')}s "
                f"exposed={e.get('input_exposed_s')}s "
                f"eval={e.get('eval_s')}s "
                f"prefetched_next={e.get('prefetched_chunks')}"
                + (f" eff={eeff:.1%}"
                   if isinstance(eeff, (int, float)) else ""))
    for ing in summary.get("ingest") or []:
        tiers = ing.get("tiers") or {}
        tier_s = " ".join(f"{k}={v}" for k, v in sorted(tiers.items()))
        src_b = ing.get("source_bytes")
        lines.append(
            f"ingest[{ing.get('mode')}]: {ing.get('files')} files "
            f"x{ing.get('pool_width')} pool in {ing.get('wall_s')}s "
            + (f"[host {ing.get('host_index')}: {src_b:,}B source] "
               if isinstance(src_b, (int, float)) and src_b else "")
            + f"(inflate {ing.get('inflate_s')}s parse {ing.get('parse_s')}s "
            f"write {ing.get('write_s')}s; {tier_s})")
    pod = summary.get("pod") or {}
    if pod.get("hosts"):
        agree = pod.get("order_digest_agree")
        shard = pod.get("shard_digest_agree")
        dis = pod.get("digest_disagreements") or 0
        lines.append(
            f"pod data plane: {len(pod['hosts'])} hosts, "
            f"{pod.get('skew_epochs')} skew epoch(s), order digest "
            + ("agree" if agree else "-" if agree is None else "DISAGREE")
            + ", shard digest "
            + ("agree" if shard else "-" if shard is None else "DISAGREE")
            + (f" ({dis} disagreement(s) across run)" if dis else ""))
        for r in pod["hosts"]:
            ib = r.get("ingest_bytes")
            lines.append(
                f"  host {r.get('host', '?')}[{r.get('rank', '?')}]: "
                f"input {r.get('input_s')}s"
                + (f" ingest {ib:,}B/{r.get('ingest_s')}s"
                   if isinstance(ib, (int, float)) else ""))
    dcn = pod.get("dcn") or {}
    if dcn:
        lines.append(
            f"dcn placement: {dcn.get('hosts')} hosts x "
            f"{dcn.get('slices')} slice(s), per-host input "
            f"{dcn.get('input_local_bytes'):,}B local / "
            f"{dcn.get('input_dcn_bytes'):,}B cross-DCN; saved "
            f"{dcn.get('input_dcn_saved_bytes_total'):,}B input + "
            f"{dcn.get('dcn_sync_saved_bytes_total'):,}B sync "
            f"(local-SGD window {dcn.get('local_sgd_window')})")
    comp = summary.get("compiled_functions") or {}
    if comp:
        lines.append("compiled functions (by cost):")
        for fn, c in comp.items():
            parts = [f"  {fn}: {c['compiles']} compile(s) "
                     f"{c['compile_s']:.3f}s"]
            if c.get("flops") is not None:
                parts.append(f"flops/dispatch {c['flops']:.3g}")
            if c.get("bytes_accessed") is not None:
                parts.append(f"bytes {c['bytes_accessed']:.3g}")
            if c.get("peak_bytes") is not None:
                parts.append(f"peak {c['peak_bytes']:.3g}B")
            cache = c.get("cache") or {}
            if cache:
                parts.append("cache " + "/".join(
                    f"{k}={v}" for k, v in sorted(cache.items())))
            lines.append(" ".join(parts))
    aot = summary.get("aot") or {}
    if aot:
        bits = []
        if aot.get("packs"):
            bits.append(f"{aot['packs']} pack(s) built "
                        f"(buckets {aot.get('pack_buckets')})")
        last_load = aot.get("last_load") or {}
        if aot.get("loads"):
            bits.append(
                f"{aot['loads']} zero-compile load(s), last "
                f"{last_load.get('wall_ms')} ms over buckets "
                f"{last_load.get('buckets')}")
        if aot.get("fallbacks"):
            lf = aot.get("last_fallback") or {}
            bits.append(f"{aot['fallbacks']} FALLBACK(s) to jit, last: "
                        f"{lf.get('reason')}")
        if bits:
            lines.append("aot executables: " + "; ".join(bits))
        pw = aot.get("prewarm") or {}
        if pw:
            lines.append(
                f"  pre-warm [{pw.get('engine')}]: ladder "
                f"{pw.get('buckets')} in {pw.get('wall_ms')} ms")
    device = summary.get("device") or {}
    if device:
        bits = []
        if device.get("hbm_peak_bytes") is not None:
            bits.append(f"hbm peak {device['hbm_peak_bytes']:,} B "
                        f"({device.get('hbm_source')})")
        if device.get("profiles"):
            bits.append(f"{device['profiles']} device profile(s)")
        if device.get("anomalies"):
            bits.append(f"{device['anomalies']} anomaly(ies)")
        if device.get("trace_fallbacks"):
            bits.append(f"{device['trace_fallbacks']} trace fallback(s)")
        if bits:
            lines.append("device: " + ", ".join(bits)
                         + "  (`shifu-tpu trace` for the kernel table)")
        last = device.get("last") or {}
        for k in (last.get("kernels") or [])[:5]:
            frac = k.get("fraction")
            lines.append(
                f"  kernel {k.get('name')}: {k.get('device_us')}us"
                + (f" ({frac:.1%} of window)"
                   if isinstance(frac, (int, float)) else "")
                + (f" [{k['bound']}-bound]" if k.get("bound") else ""))
    embed = summary.get("embed") or {}
    if embed:
        tier = embed.get("tier") or {}
        if tier:
            hr = tier.get("hit_rate")
            cb = tier.get("cold_bytes")
            lines.append(
                "embed tier: hit rate "
                + (format(hr, ".1%") if isinstance(hr, (int, float))
                   else "-")
                + f" ({tier.get('hot_rows')} hot rows of "
                f"{tier.get('vocab')} vocab), cold "
                + (f"{cb / 1e6:.1f} MB" if isinstance(cb, (int, float))
                   else "-")
                + f" in {tier.get('cold_seconds')}s host reads"
                + (f", {tier.get('prefetch_hits')} prefetch hit(s)"
                   if tier.get("prefetch_hits") else ""))
        dd = embed.get("dedup") or {}
        if dd:
            dr = dd.get("dedup_ratio")
            lines.append(
                f"embed dedup: {dd.get('rows_touched')} rows touched / "
                f"{dd.get('raw_cells')} raw id cells over "
                f"{dd.get('batches')} batch(es)"
                + (f" ({dr:.1%} of cells)"
                   if isinstance(dr, (int, float)) else ""))
        if embed.get("offload_fallbacks"):
            lines.append(f"embed offload: {embed['offload_fallbacks']} "
                         "cold-read fault(s) served by the fallback chain")
    rec = summary.get("recovery") or {}
    if any(rec.get(k) for k in ("restores", "fallbacks",
                                "preemption_graces", "resumes")):
        lines.append(
            f"recovery: {rec.get('restores', 0)} restore(s) "
            f"{rec.get('restore_s', 0.0):.3f}s, "
            f"{rec.get('fallbacks', 0)} fallback(s), "
            f"{rec.get('preemption_graces', 0)} preemption grace(s), "
            f"{rec.get('resumes', 0)} resume(s)")
    return "\n".join(lines)


# -- `shifu-tpu trace`: the device flight-recorder view ---------------------

def trace_summary(path: str) -> Optional[dict]:
    """The device flight-recorder dict for a job/telemetry dir: every
    `device_profile` rollup (scheduled windows + anomaly one-shots), the
    anomaly log with its ring context, HBM watermark trajectory, and
    trace fallbacks — assembled purely from journal events
    (obs/devprof.py writes them).  None when no journal is found."""
    jpath = find_journal(path)
    if jpath is None:
        return None
    events = _load_events(jpath)
    profiles: list[dict] = []
    anomalies: list[dict] = []
    watermarks: list[dict] = []
    fallbacks: list[dict] = []
    for rec in events:
        kind = rec.get("kind")
        if kind == "device_profile":
            profiles.append({k: rec.get(k) for k in
                             ("epoch", "trigger", "trace_dir", "window_us",
                              "device_us_total", "device_fraction", "lanes",
                              "kernel_count", "kernels", "other_us",
                              "modules", "peak_tflops", "peak_hbm_gbps",
                              "capture_wall_s")})
        elif kind == "anomaly":
            anomalies.append({k: rec.get(k) for k in
                              ("epoch", "chunk", "step_s", "median_s",
                               "mad_s", "zscore", "window", "ring")})
        elif kind == "hbm_watermark":
            watermarks.append({k: rec.get(k) for k in
                               ("epoch", "source", "bytes_in_use",
                                "peak_bytes", "bytes_limit",
                                "device_count")})
        elif kind == "trace_fallback":
            fallbacks.append({k: rec.get(k) for k in
                              ("epoch", "stage", "error")})
    peaks = [w.get("peak_bytes") for w in watermarks
             if isinstance(w.get("peak_bytes"), (int, float))]
    return {
        "journal": jpath,
        "profiles": profiles,
        "anomalies": anomalies,
        "watermarks": watermarks,
        "hbm_peak_bytes": max(peaks) if peaks else None,
        "trace_fallbacks": fallbacks,
    }


def render_trace_text(summary: dict) -> str:
    """Human rendering of `trace_summary`: per-capture kernel tables,
    the anomaly log, and the HBM watermark trajectory."""
    lines = [f"journal: {summary['journal']}"]
    profiles = summary.get("profiles") or []
    if not profiles:
        lines.append("no device_profile events — enable trace capture "
                     "with obs.trace_epochs (shifu.obs.trace-epochs), "
                     "e.g. 'first' (docs/OBSERVABILITY.md)")
    for p in profiles:
        frac = p.get("device_fraction")
        lines.append(
            f"device profile: epoch {p.get('epoch')} "
            f"trigger={p.get('trigger')} window {p.get('window_us')}us "
            f"device {p.get('device_us_total')}us"
            + (f" ({frac:.1%} busy)" if isinstance(frac, (int, float))
               else "")
            + f" kernels={p.get('kernel_count')}")
        kernels = p.get("kernels") or []
        if kernels:
            lines.append(f"  {'kernel':<40} {'calls':>6} {'device_us':>12} "
                         f"{'frac':>7} {'bound':>8}")
        for k in kernels:
            kfrac = k.get("fraction")
            lines.append(
                f"  {str(k.get('name'))[:40]:<40} {k.get('calls', 0):>6} "
                f"{k.get('device_us', 0):>12} "
                f"{(format(kfrac, '.2%') if isinstance(kfrac, (int, float)) else '-'):>7} "
                f"{(k.get('bound') or '-'):>8}")
        other = p.get("other_us")
        if other:
            lines.append(f"  (+{other}us across "
                         f"{p.get('kernel_count', 0) - len(kernels)} more "
                         f"kernels)")
    for a in summary.get("anomalies") or []:
        lines.append(
            f"anomaly: epoch {a.get('epoch')} chunk {a.get('chunk')} "
            f"step {a.get('step_s')}s vs median {a.get('median_s')}s "
            f"(z={a.get('zscore')}, ring of {len(a.get('ring') or [])})")
    wm = summary.get("watermarks") or []
    if wm:
        last = wm[-1]
        peak = summary.get("hbm_peak_bytes")
        lines.append(
            f"hbm: peak {peak:,} B" if isinstance(peak, (int, float))
            else "hbm: peak -")
        lines[-1] += (f" in-use {last.get('bytes_in_use'):,} B "
                      f"source={last.get('source')} "
                      f"({len(wm)} watermark(s))"
                      if isinstance(last.get("bytes_in_use"), (int, float))
                      else f" source={last.get('source')} "
                           f"({len(wm)} watermark(s))")
    for f in summary.get("trace_fallbacks") or []:
        lines.append(f"trace fallback: epoch {f.get('epoch')} "
                     f"stage={f.get('stage')} error={f.get('error')}")
    return "\n".join(lines)


# -- `shifu-tpu top`: the live serving/train operator view -------------------

# journal kinds that mark a telemetry dir as a serving daemon's (or a
# loadtest run against one)
_SERVING_KINDS = ("serve_start", "serving_report", "loadtest_report")

# a `top` frame reads the journal TAIL, not the whole file: a long-lived
# daemon's journal grows without bound, and a 2s-refresh streaming view
# must not pay O(run-length) reads per frame.  4 MiB holds hours of
# report-cadence events; everything a frame shows (latest report, alert
# states newest-wins, scrape histograms) is tail-derivable.
_TOP_TAIL_BYTES = 4 << 20


def _load_events_tail(jpath: str, tail_bytes: int = _TOP_TAIL_BYTES
                      ) -> tuple[list[dict], int, bool]:
    """(events parsed from the journal's last `tail_bytes`, event count
    of what was read, truncated?) — the bounded read behind `top`
    frames: ONE seek + ONE tail-sized read, never a whole-file pass (a
    2 GB journal must not be re-read every refresh).  Falls back to the
    full read for remote paths (fsio reads are whole-object anyway)."""
    import json as json_mod
    try:
        from ..data import fsio
        remote = fsio.is_remote(jpath)
    except Exception:
        remote = False
    if remote:
        events = _load_events(jpath)
        return events, len(events), False
    try:
        size = os.path.getsize(jpath)
        with open(jpath, "rb") as f:
            truncated = size > tail_bytes
            if truncated:
                f.seek(size - tail_bytes)
            tail = f.read(tail_bytes)
            if truncated:
                # the window may open mid-line: drop the torn first line
                nl = tail.find(b"\n")
                tail = tail[nl + 1:] if nl >= 0 else b""
    except OSError:
        return [], 0, False
    events = []
    for line in tail.splitlines():
        try:
            rec = json_mod.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict):
            events.append(rec)
    return events, len(events), truncated


def _read_lease_nearby(journal_path: str) -> Optional[dict]:
    """The fleet membership lease (runtime/fleet.py `lease.json`) next to
    a journal, tolerantly: torn/absent/garbage is None — the top frame
    then falls back to journal-event freshness alone.

    Routed through data/fsio so a REMOTE (gs://-style) fleet telemetry
    dir answers too: with the old local-open-only read, every remote
    member rendered always-fresh — a dead member on shared storage never
    showed DOWN (`--stale-after` satellite fix)."""
    try:
        from ..data import fsio
        if fsio.is_remote(journal_path):
            parent = journal_path.rsplit("/", 1)[0]
            raw = fsio.read_bytes(fsio.join(parent, "lease.json"))
            rec = json.loads(raw.decode())
        else:
            with open(os.path.join(os.path.dirname(journal_path),
                                   "lease.json")) as f:
                rec = json.load(f)
        return rec if isinstance(rec, dict) else None
    except Exception:
        return None


def top_summary(path: str,
                stale_after_s: Optional[float] = None) -> Optional[dict]:
    """One `shifu-tpu top` frame for a job/telemetry dir: journal tail +
    scrape file ONLY (no torch import, bounded reads — safe to refresh
    against a live long-lived daemon).

    Serving dirs render rate / p50 / p99 / queue depth / batch shape, the
    per-stage lifecycle breakdown (always-on `serve_stage_seconds`
    histograms in the scrape file), active SLO alerts (firing `slo_alert`
    events not yet resolved), and sampled `request_trace` / one-shot
    `device_profile` counts.  Train dirs render epoch progress, goodput /
    MFU, and the last event — ONE command tops both planes.  None when no
    journal is found.

    Staleness: a dir whose freshest signal (fleet lease beat or last
    journal event) is older than `stale_after_s` — or than the lease's
    own ttl when a lease is present — gets `down: True` + `stale_s`
    instead of rendering its last report as live forever (a killed
    daemon must READ as dead, not as its final healthy frame)."""
    jpath = find_journal(path)
    if jpath is None:
        return None
    events, total_events, tail_only = _load_events_tail(jpath)
    reports: list[dict] = []
    alerts: list[dict] = []
    epochs: list[dict] = []
    goodput: Optional[dict] = None
    serve_start: Optional[dict] = None
    loadtests: list[dict] = []
    traces = 0
    route_traces = 0
    hedges = 0
    slo_profiles = 0
    tier_last: Optional[dict] = None
    dedup_last: Optional[dict] = None
    drift_last: Optional[dict] = None
    drift_alerts: list[dict] = []
    aot_load_last: Optional[dict] = None
    aot_loads = 0
    aot_fallback_last: Optional[dict] = None
    aot_fallbacks = 0
    mode = "train"
    for rec in events:
        kind = rec.get("kind")
        if kind == "serving_report":
            reports.append(rec)
        elif kind == "slo_alert":
            alerts.append(rec)
        elif kind == "drift_report":
            drift_last = rec
        elif kind == "drift_alert":
            drift_alerts.append(rec)
        elif kind == "serve_start":
            serve_start = rec
        elif kind == "loadtest_report":
            loadtests.append(rec)
        elif kind == "request_trace":
            traces += 1
        elif kind == "route_trace":
            route_traces += 1
            if rec.get("hedged"):
                hedges += 1
        elif kind == "device_profile" and rec.get("trigger") == "slo":
            slo_profiles += 1
        elif kind == "epoch":
            epochs.append(rec)
        elif kind == "goodput":
            goodput = rec
        elif kind == "embed_tier_report":
            tier_last = rec
        elif kind == "embed_dedup_report":
            dedup_last = rec
        elif kind == "aot_load":
            aot_load_last = rec
            aot_loads += 1
        elif kind == "aot_fallback":
            aot_fallback_last = rec
            aot_fallbacks += 1
    if serve_start is not None or reports or loadtests:
        mode = "serving"
    out: dict = {"journal": jpath, "mode": mode, "events": total_events}
    if tail_only:
        out["events_tail_only"] = True  # counts cover the 4 MiB tail
    if events:
        out["last_event"] = {"kind": events[-1].get("kind"),
                             "ts": events[-1].get("ts")}

    # staleness verdict: freshest of (lease beat, last event) vs the
    # caller's threshold or the lease's self-declared ttl
    lease = _read_lease_nearby(jpath)
    now = time.time()
    freshest: Optional[float] = None
    for ts in ((lease or {}).get("ts"),
               (out.get("last_event") or {}).get("ts")):
        if isinstance(ts, (int, float)):
            freshest = ts if freshest is None else max(freshest, ts)
    threshold = stale_after_s
    if threshold is None and lease is not None \
            and isinstance(lease.get("ttl_s"), (int, float)):
        threshold = float(lease["ttl_s"])
    if lease is not None:
        out["lease"] = {"member": lease.get("member"),
                        "ttl_s": lease.get("ttl_s")}
        if lease.get("host"):
            out["lease"]["host"] = lease.get("host")
    if threshold is not None and threshold > 0 and freshest is not None:
        age = max(0.0, now - freshest)
        if age > threshold:
            out["down"] = True
            out["stale_s"] = round(age, 1)

    scrape = _read_scrape(jpath)
    if mode == "serving":
        last = reports[-1] if reports else {}
        if not last and loadtests:
            # a loadtest-only dir (socket run's own telemetry): render
            # the last run's achieved numbers in the serving frame
            lt = loadtests[-1]
            last = {"requests": lt.get("completed"),
                    "rejected": lt.get("rejected"),
                    "errors": lt.get("errors"),
                    "p50_ms": lt.get("p50_ms"),
                    "p99_ms": lt.get("p99_ms"),
                    "engine": lt.get("engine"),
                    "scores_per_sec": lt.get("achieved_scores_per_sec"),
                    "stages": lt.get("stages")}
        out["serving"] = {k: last.get(k) for k in
                          ("requests", "rejected", "errors", "queue_depth",
                           "batch_mean", "p50_ms", "p99_ms", "engine",
                           "version", "model", "uptime_s", "scores_per_sec",
                           "window_s")}
        if out["serving"].get("scores_per_sec") is None and len(reports) >= 2:
            # no windowed report (final-only journal): derive the rate
            # from the last two reports' cumulative request counts
            a, b = reports[-2], reports[-1]
            try:
                dt = float(b.get("ts", 0)) - float(a.get("ts", 0))
                dr = int(b.get("requests", 0)) - int(a.get("requests", 0))
                if dt > 0:
                    out["serving"]["scores_per_sec"] = round(dr / dt, 1)
            except (TypeError, ValueError):
                pass
        if serve_start is not None:
            out["serving"]["path"] = serve_start.get("path")
            out["serving"]["port"] = serve_start.get("port")
        # stage decomposition from the scrape file's always-on histograms
        # — a corrupt/truncated scrape must degrade to no breakdown, not
        # kill the whole frame (the journal half already parsed fine)
        if scrape:
            try:
                out["stages"] = _stage_breakdown_from_scrape(scrape)
            except Exception:
                out["stages"] = None
                out["scrape_error"] = True
        # the daemon's own lifetime-windowed view wins when present (a
        # shared metrics dir can hold more than one daemon's histograms)
        if last.get("stages"):
            out["stages"] = last["stages"]
        out["slo"] = _slo_state_from_alerts(alerts, last.get("slo"))
        # drift observatory row: the last drift_report's worst offender +
        # live AUC decay, and the currently-firing drift objectives
        # (newest transition wins — same discipline as slo alerts)
        if drift_last is not None or drift_alerts:
            firing: dict[str, dict] = {}
            for a in drift_alerts:
                obj = str(a.get("objective", "?"))
                if a.get("state") == "firing":
                    firing[obj] = a
                elif a.get("state") == "resolved":
                    firing.pop(obj, None)
            dr = drift_last or {}
            out["drift"] = {
                "worst": dr.get("worst_psi"),
                "worst_feature": ((dr.get("worst") or [{}])[0]
                                  .get("feature")),
                "score_kl": dr.get("score_kl"),
                "auc_live": dr.get("auc_live"),
                "auc_decay": dr.get("auc_decay"),
                "rows_fast": dr.get("rows_fast"),
                "baseline_digest": dr.get("baseline_digest"),
                "firing": sorted(firing),
                "alerts_total": sum(1 for a in drift_alerts
                                    if a.get("state") == "firing"),
            }
        # AOT executable rows : zero-compile loads vs journaled
        # fallbacks — read straight from the journal tail, no torch needed
        if aot_loads or aot_fallbacks:
            out["aot"] = {"loads": aot_loads, "fallbacks": aot_fallbacks}
            if aot_load_last is not None:
                out["aot"]["buckets"] = aot_load_last.get("buckets")
                out["aot"]["load_ms"] = aot_load_last.get("wall_ms")
            if aot_fallback_last is not None:
                out["aot"]["last_fallback_reason"] = \
                    aot_fallback_last.get("reason")
        out["request_traces"] = traces
        if route_traces:
            out["route_traces"] = route_traces
            out["hedges"] = hedges
        if slo_profiles:
            out["slo_device_profiles"] = slo_profiles
    else:
        if epochs:
            e = epochs[-1]
            out["epoch"] = {k: e.get(k) for k in
                            ("epoch", "train_error", "valid_error",
                             "valid_auc", "epoch_time")}
        if goodput is not None:
            out["goodput"] = {k: goodput.get(k) for k in
                              ("epoch", "goodput_fraction", "mfu")}
        # sparse embedding engine: the live tier/dedup story from the
        # journal tail (docs/EMBEDDING.md)
        embed: dict = {}
        if tier_last is not None:
            embed.update({k: tier_last.get(k) for k in
                          ("hit_rate", "hot_rows", "vocab", "cold_bytes",
                           "fallbacks")})
        if dedup_last is not None:
            embed["dedup_ratio"] = dedup_last.get("dedup_ratio")
        if embed:
            out["embed"] = embed
    # incident digest from the same tail: failover / SLO / degraded-swap
    # episodes stitched by obs/timeline.py (lazy import; `shifu-tpu
    # timeline` holds the full records with causal chains + traces)
    if any(rec.get("kind") in ("fleet_failover", "fleet_swap_degraded",
                               "slo_alert") for rec in events):
        try:
            from . import timeline as timeline_mod
            inc = timeline_mod.reconstruct_incidents(
                timeline_mod.merge_sources([(events, "")]))
        except Exception:
            inc = []
        if inc:
            out["incidents"] = {
                "total": len(inc),
                "open": sum(1 for i in inc if not i["resolved"]),
                "last": {"id": inc[-1]["id"], "kind": inc[-1]["kind"],
                         "resolved": inc[-1]["resolved"],
                         "recovery_s": inc[-1]["recovery_s"]}}
    return out


def _stage_breakdown_from_scrape(scrape_text: str) -> Optional[dict]:
    """{stage: {mean_ms, p99_ms, count, share}} from the scrape file's
    `serve_stage_seconds` histograms — same shape as loadtest/stats()
    (the ONE decomposition helper, obs/slo.stage_stats)."""
    from .slo import stage_stats

    hists = parse_scrape_histograms(scrape_text).get("serve_stage_seconds")
    if not hists:
        return None
    per_stage: dict = {}
    for key, s in hists.items():
        stage = dict(kv.split("=", 1) for kv in key.split(";")
                     if "=" in kv).get("stage")
        if not stage:
            continue
        per_stage[stage] = (s["bounds"], s["counts"], s["sum"], s["count"])
    return stage_stats(per_stage) or None


def _slo_state_from_alerts(alerts: list[dict],
                           live_state: Optional[dict]) -> dict:
    """Active (firing, not yet resolved) alerts from the journaled
    `slo_alert` transitions, plus the last serving_report's live burn
    snapshot when present."""
    firing: dict[str, dict] = {}
    for a in alerts:
        obj = str(a.get("objective", "?"))
        if a.get("state") == "firing":
            firing[obj] = a
        elif a.get("state") == "resolved":
            firing.pop(obj, None)
    out = {
        "alerts_total": sum(1 for a in alerts
                            if a.get("state") == "firing"),
        "active": [
            {k: a.get(k) for k in
             ("objective", "burn_fast", "burn_slow", "observed_p99_ms",
              "observed_error_rate", "observed_availability", "ts")}
            for a in firing.values()],
    }
    if isinstance(live_state, dict):
        out["burns"] = live_state.get("burns")
        out["objectives"] = live_state.get("objectives")
    return out


def render_top_text(summary: dict) -> str:
    """One `shifu-tpu top` frame as text."""
    lines = [f"[{summary.get('mode')}] {summary['journal']} "
             f"({summary.get('events')} events)"]
    if summary.get("down"):
        lines.append(f"DOWN — no heartbeat/journal activity for "
                     f"{summary.get('stale_s')}s (showing last frame)")
    sv = summary.get("serving")
    if sv:
        rate = sv.get("scores_per_sec")
        lines.append(
            "rate "
            + (f"{rate:,.0f}/s" if isinstance(rate, (int, float)) else "-")
            + f"  p50 {sv.get('p50_ms')} ms  p99 {sv.get('p99_ms')} ms  "
            f"queue {sv.get('queue_depth')}  batch {sv.get('batch_mean')}  "
            f"engine {sv.get('engine')} v{sv.get('version')}")
        lines.append(
            f"requests {sv.get('requests')}  rejected {sv.get('rejected')}"
            f"  errors {sv.get('errors')}  uptime {sv.get('uptime_s')}s")
    stages = summary.get("stages")
    if stages:
        lines.append(f"  {'stage':<10} {'mean_ms':>9} {'p99_ms':>9} "
                     f"{'share':>7}")
        order = ("admission", "queue", "coalesce", "dispatch", "device",
                 "reply")
        for stage in order:
            s = stages.get(stage)
            if not s:
                continue
            share = s.get("share")
            lines.append(
                f"  {stage:<10} {s.get('mean_ms', '-'):>9} "
                f"{(s.get('p99_ms') if s.get('p99_ms') is not None else '-'):>9} "
                f"{(format(share, '.1%') if isinstance(share, (int, float)) else '-'):>7}")
    slo = summary.get("slo")
    if slo is not None:
        active = slo.get("active") or []
        if active:
            for a in active:
                obs_bits = [f"{k.replace('observed_', '')}="
                            f"{a[k]}" for k in
                            ("observed_p99_ms", "observed_error_rate",
                             "observed_availability") if a.get(k) is not None]
                lines.append(
                    f"ALERT {a.get('objective')}: burn fast "
                    f"{a.get('burn_fast')} / slow {a.get('burn_slow')}"
                    + (f"  ({' '.join(obs_bits)})" if obs_bits else ""))
        else:
            objectives = slo.get("objectives")
            lines.append("slo: ok"
                         + (f" (objectives: "
                            f"{', '.join(sorted(objectives))})"
                            if objectives else
                            f" ({slo.get('alerts_total', 0)} alert(s) "
                            "this run)"))
    dr = summary.get("drift")
    if dr:
        worst = dr.get("worst")
        decay = dr.get("auc_decay")
        bits = ["drift: "
                + ("PSI "
                   + (format(worst, ".3f")
                      if isinstance(worst, (int, float)) else "-")
                   + (f" ({dr.get('worst_feature')})"
                      if dr.get("worst_feature") else ""))]
        if dr.get("score_kl") is not None:
            bits.append(f"score KL {dr['score_kl']}")
        if isinstance(decay, (int, float)):
            bits.append(f"auc live {dr.get('auc_live')} "
                        f"(decay {decay:+.4f})")
        if dr.get("firing"):
            bits.append("FIRING " + ",".join(dr["firing"]))
        lines.append("  ".join(bits))
    aot = summary.get("aot")
    if aot:
        bits = []
        if aot.get("loads"):
            bits.append(
                f"{aot['loads']} zero-compile load(s)"
                + (f" of buckets {aot.get('buckets')}"
                   if aot.get("buckets") else "")
                + (f" in {aot.get('load_ms')} ms"
                   if aot.get("load_ms") is not None else ""))
        if aot.get("fallbacks"):
            bits.append(f"{aot['fallbacks']} FALLBACK(s) to jit"
                        + (f" ({aot.get('last_fallback_reason')})"
                           if aot.get("last_fallback_reason") else ""))
        lines.append("aot: " + "  ".join(bits))
    if summary.get("request_traces"):
        lines.append(f"sampled request traces: "
                     f"{summary['request_traces']}"
                     + (f"  slo device profiles: "
                        f"{summary['slo_device_profiles']}"
                        if summary.get("slo_device_profiles") else ""))
    if summary.get("route_traces"):
        lines.append(f"route traces: {summary['route_traces']}"
                     + (f"  hedged: {summary['hedges']}"
                        if summary.get("hedges") else ""))
    inc = summary.get("incidents")
    if inc:
        last = inc.get("last") or {}
        lines.append(
            f"incidents: {inc.get('total')} ({inc.get('open')} open)"
            + (f"  last: {last.get('kind')}"
               + (f" recovered in {last.get('recovery_s')}s"
                  if last.get("recovery_s") is not None else
                  ("" if last.get("resolved") else " OPEN"))
               if last else "")
            + "  — `shifu-tpu timeline` for causal chains")
    ep = summary.get("epoch")
    if ep:
        lines.append(
            f"epoch {ep.get('epoch')}  train_err {ep.get('train_error')}  "
            f"valid_err {ep.get('valid_error')}  auc {ep.get('valid_auc')}  "
            f"epoch_s {ep.get('epoch_time')}")
    gp = summary.get("goodput")
    if gp:
        frac = gp.get("goodput_fraction")
        mfu = gp.get("mfu")
        lines.append(
            "goodput "
            + (format(frac, ".1%") if isinstance(frac, (int, float))
               else "-")
            + ("  mfu " + format(mfu, ".4f")
               if isinstance(mfu, (int, float)) else ""))
    em = summary.get("embed")
    if em:
        hr = em.get("hit_rate")
        dr = em.get("dedup_ratio")
        cb = em.get("cold_bytes")
        bits = []
        if hr is not None:
            bits.append("tier hit "
                        + (format(hr, ".1%")
                           if isinstance(hr, (int, float)) else str(hr))
                        + f" ({em.get('hot_rows')}/{em.get('vocab')} hot)")
        if isinstance(cb, (int, float)) and cb:
            bits.append(f"cold {cb / 1e6:.1f} MB")
        if em.get("fallbacks"):
            bits.append(f"{em['fallbacks']} offload fallback(s)")
        if dr is not None:
            bits.append("dedup "
                        + (format(dr, ".1%")
                           if isinstance(dr, (int, float)) else str(dr)))
        lines.append("embed: " + "  ".join(bits))
    last = summary.get("last_event")
    if last:
        lines.append(f"last event: {last.get('kind')} at ts "
                     f"{last.get('ts')}")
    return "\n".join(lines)


# -- `shifu-tpu drift`: the model-quality / data-drift view ------------------

def drift_summary(path: str, model: Optional[str] = None,
                  feature: Optional[str] = None) -> Optional[dict]:
    """One `shifu-tpu drift` frame for a serving telemetry dir — journal
    tail ONLY (no torch, bounded read; the same contract as `top`): per
    model, the latest `drift_report` (per-feature PSI table, score KL,
    live AUC vs the frozen baseline's), the currently-firing drift
    objectives (newest `drift_alert` transition wins), and the alert
    history.  Train dirs answer too: the journaled `baseline_profile`
    summary renders when no serving reports exist yet.

    `model` filters to one model_id; `feature` filters the PSI table to
    one named feature (exact match).  None when no journal is found."""
    jpath = find_journal(path)
    if jpath is None:
        return None
    events, total_events, tail_only = _load_events_tail(jpath)
    reports: dict[str, dict] = {}        # model -> latest drift_report
    alerts: dict[str, list] = {}         # model -> [drift_alert ...]
    invalid: list[dict] = []
    baseline: Optional[dict] = None
    for rec in events:
        kind = rec.get("kind")
        if kind == "drift_report":
            reports[str(rec.get("model", "default"))] = rec
        elif kind == "drift_alert":
            alerts.setdefault(str(rec.get("model", "default")),
                              []).append(rec)
        elif kind == "baseline_profile":
            baseline = rec
        elif kind == "drift_baseline_invalid":
            invalid.append(rec)
    models: dict[str, dict] = {}
    for mid in sorted(set(reports) | set(alerts)):
        if model is not None and mid != model:
            continue
        rep = reports.get(mid) or {}
        firing: dict[str, dict] = {}
        for a in alerts.get(mid, []):
            obj = str(a.get("objective", "?"))
            if a.get("state") == "firing":
                firing[obj] = a
            elif a.get("state") == "resolved":
                firing.pop(obj, None)
        worst = rep.get("worst") or []
        if feature is not None:
            worst = [w for w in worst if w.get("feature") == feature]
        models[mid] = {
            "report": {k: rep.get(k) for k in
                       ("ts", "version", "baseline_digest", "rows_fast",
                        "rows_slow", "feedback_rows_fast", "worst_psi",
                        "score_kl", "mean_shift_max",
                        "mean_shift_feature", "auc_live", "auc_decay",
                        "train_auc")} if rep else None,
            "worst": worst,
            "firing": [
                {k: a.get(k) for k in
                 ("objective", "ts", "features", "score_kl")}
                for a in firing.values()],
            "alerts_total": sum(1 for a in alerts.get(mid, [])
                                if a.get("state") == "firing"),
        }
    out: dict = {"journal": jpath, "events": total_events,
                 "models": models}
    if tail_only:
        out["events_tail_only"] = True
    if baseline is not None:
        out["baseline"] = {k: baseline.get(k) for k in
                           ("epoch", "rows", "num_features", "train_auc",
                            "train_error", "score_mean")}
    if invalid:
        out["baseline_invalid"] = len(invalid)
    return out


def render_drift_text(summary: dict) -> str:
    """Human rendering of `drift_summary`: per-model drift panel — the
    PSI offender table, score divergence, and the live-AUC decay row."""
    lines = [f"journal: {summary['journal']} "
             f"({summary.get('events')} events)"]
    base = summary.get("baseline")
    if base:
        lines.append(
            f"baseline: epoch {base.get('epoch')}  rows {base.get('rows')}"
            f"  features {base.get('num_features')}"
            + (f"  train_auc {base.get('train_auc')}"
               if base.get("train_auc") is not None else ""))
    if summary.get("baseline_invalid"):
        lines.append(f"WARNING: {summary['baseline_invalid']} invalid "
                     "baseline-profile load(s) — drift dormant there")
    models = summary.get("models") or {}
    if not models:
        lines.append("no drift reports — daemon without a baseline "
                     "profile, drift disabled (shifu.drift.enabled), or "
                     "nothing served yet")
    for mid, m in models.items():
        rep = m.get("report")
        firing = m.get("firing") or []
        head = f"model {mid}"
        if rep:
            head += (f" v{rep.get('version')}  baseline "
                     f"{rep.get('baseline_digest')}  rows "
                     f"{rep.get('rows_fast')}/{rep.get('rows_slow')} "
                     "(fast/slow)")
        lines.append(head + ("  FIRING "
                             + ",".join(sorted(a.get("objective", "?")
                                               for a in firing))
                             if firing else "  ok"))
        if rep:
            kl = rep.get("score_kl")
            bits = ["  score KL "
                    + (format(kl, ".4f")
                       if isinstance(kl, (int, float)) else "-")]
            if rep.get("mean_shift_max") is not None:
                bits.append(f"mean shift {rep['mean_shift_max']} sigma "
                            f"({rep.get('mean_shift_feature')})")
            lines.append("  ".join(bits))
            if rep.get("auc_live") is not None:
                decay = rep.get("auc_decay")
                lines.append(
                    f"  auc live {rep.get('auc_live')}"
                    + (f" vs train {rep.get('train_auc')}"
                       if rep.get("train_auc") is not None else "")
                    + (f"  decay {decay:+.4f}"
                       if isinstance(decay, (int, float)) else "")
                    + f"  ({rep.get('feedback_rows_fast')} labeled rows "
                    "in window)")
            elif rep.get("feedback_rows_fast") is not None:
                lines.append("  auc live: - (no labeled feedback in "
                             "window — wire FEEDBACK frames or "
                             "ServeClient.feedback())")
        worst = m.get("worst") or []
        if worst:
            lines.append(f"  {'feature':<24} {'psi_fast':>9} "
                         f"{'psi_slow':>9}")
            for w in worst:
                def f(v):
                    return (format(v, ".4f")
                            if isinstance(v, (int, float)) else "-")
                lines.append(f"  {str(w.get('feature'))[:24]:<24} "
                             f"{f(w.get('psi_fast')):>9} "
                             f"{f(w.get('psi_slow')):>9}")
        for a in firing:
            feats = [f.get("feature") for f in (a.get("features") or [])]
            lines.append(
                f"  ALERT {a.get('objective')}"
                + (f": {', '.join(map(str, feats))}" if feats else "")
                + (f" (score KL {a.get('score_kl')})"
                   if a.get("score_kl") is not None else ""))
    return "\n".join(lines)


def render_top_fleet_text(rollup: dict) -> str:
    """The multi-daemon `shifu-tpu top` frame (obs/aggregate.py
    serving_rollup): fleet totals + one row per daemon."""
    fleet = rollup.get("fleet") or {}
    down = fleet.get("down") or 0
    lines = [
        f"fleet: {fleet.get('daemons')} daemon(s)"
        + (f" ({down} DOWN)" if down else "")
        + "  rate "
        + (f"{fleet['scores_per_sec']:,.0f}/s"
           if isinstance(fleet.get("scores_per_sec"), (int, float))
           else "-")
        + f"  worst p99 {fleet.get('worst_p99_ms')} ms  "
        f"active alerts {fleet.get('active_alerts')}"]
    if fleet.get("route_traces") or fleet.get("incidents"):
        lines.append(
            f"  route traces {fleet.get('route_traces', 0)}"
            f"  hedged {fleet.get('hedges', 0)}"
            f"  incidents {fleet.get('incidents', 0)}"
            f" ({fleet.get('incidents_open', 0)} open)")
    dw = fleet.get("drift_worst")
    if dw or fleet.get("drift_firing"):
        lines.append(
            "  drift: worst PSI "
            + (f"{dw['psi']:.3f} ({dw.get('feature')} @ "
               f"{str(dw.get('dir'))[-28:]})" if dw else "-")
            + (("  FIRING " + ",".join(fleet["drift_firing"]))
               if fleet.get("drift_firing") else ""))
    hosts = fleet.get("hosts") or {}
    if [h for h in hosts if h != "-"]:
        # the cross-host view: one cell per placement, dark hosts loud
        cells = []
        for h in sorted(hosts):
            slot = hosts[h]
            n, dn = slot.get("members", 0), slot.get("down", 0)
            cells.append(f"{h}:{n - dn}/{n}"
                         + (" DOWN" if dn and dn == n else ""))
        lines.append("  hosts: " + "  ".join(cells))
    lines.append(f"  {'daemon':<28} {'rate/s':>10} {'p99_ms':>8} "
                 f"{'queue':>6} {'alerts':>7} {'psi':>7} {'slo':>8}")
    for d in rollup.get("daemons") or []:
        sv = d.get("serving") or {}
        active = (d.get("slo") or {}).get("active") or []
        dr = d.get("drift") or {}
        psi = dr.get("worst")
        psi_s = (format(psi, ".3f") if isinstance(psi, (int, float))
                 else "-") + ("!" if dr.get("firing") else "")
        rate = sv.get("scores_per_sec")
        if d.get("down"):
            # the stale-frame fix: a dead member renders DOWN with its
            # lease age, never its last healthy numbers as if live
            lines.append(
                f"  {str(d.get('dir'))[-28:]:<28} "
                f"{'-':>10} {'-':>8} {'-':>6} {len(active):>7} "
                f"{'-':>7} {'DOWN':>8}  (stale {d.get('stale_s')}s)")
            continue
        lines.append(
            f"  {str(d.get('dir'))[-28:]:<28} "
            + (f"{rate:>10,.0f}" if isinstance(rate, (int, float))
               else f"{'-':>10}")
            + f" {sv.get('p99_ms') if sv.get('p99_ms') is not None else '-':>8}"
            f" {sv.get('queue_depth') if sv.get('queue_depth') is not None else '-':>6}"
            f" {len(active):>7}"
            f" {psi_s:>7}"
            f" {'FIRING' if active else 'ok':>8}")
    return "\n".join(lines)
