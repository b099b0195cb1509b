"""Skew-corrected fleet timeline (port of shifu_tpu/obs/timeline.py):
merge every member's journal into one causally-ordered event stream and
reconstruct incidents from it (docs/OBSERVABILITY.md "Fleet timeline").

A fleet's journals are per-member files stamped by per-host clocks.
Raw concatenation therefore lies about causality: a standby promoted on
a host whose clock runs 10s slow appears to serve *before* the failover
that promoted it.  This module fixes the merge in three layers:

1. **Clock-offset correction** — the manager observes every member's
   lease round-trip (runtime/fleet.py `check_members`) and journals a
   `fleet_clock_skew` event per host: a running MIN over
   ``manager_now - lease.ts``.  True lease age is >= 0, so the min
   approximates the host's clock offset with a positive bias bounded by
   one heartbeat period — good enough to order events separated by more
   than a beat, which is exactly the failover/promotion scale.  Each
   member event's corrected time is ``ts + offset[host]`` (the manager's
   own journal is the reference frame, offset 0).

2. **Happens-before nudging** — causal edges the protocol guarantees
   (failover -> promotion, failover -> rejoin, swap-degraded ->
   readmit, member `request_trace` -> router `route_trace` of the same
   trace) override residual clock error: a child event is never ordered
   before its parent, whatever the clocks claim.

3. **Incident reconstruction** — `fleet_failover`, `slo_alert`, and
   `fleet_swap_degraded` episodes become first-class `incident` records:
   root event, causal chain, affected sampled traces (hedged or failed
   `route_trace`s in the window), recovery duration, and a chaos-inject
   root-cause hint when an injection immediately precedes the root.

Everything here is journal-reads only — no torch import, bounded tails for
the CLI path (`timeline`, like `top`), full reads for `fleet-verify`
(which needs complete history for its counting checks).  A single-host
journal has no `fleet_clock_skew` events: its offset is 0, and the
incidents it holds (SLO episodes) are stitched all the same.
"""

from __future__ import annotations

import os
from typing import Optional

from . import journal as journal_mod

# journaled by the manager per host (runtime/fleet.py `_observe_skew`)
CLOCK_SKEW_KIND = "fleet_clock_skew"

# bounded per-journal tail for interactive views (same rationale as
# render._TOP_TAIL_BYTES: a long-lived fleet's journals grow without
# bound; a timeline frame must not pay O(run-length) reads)
TAIL_BYTES = 4 << 20

# a chaos injection at most this many seconds before an incident's root
# event is surfaced as the root-cause hint
_CHAOS_HINT_WINDOW_S = 5.0
# affected-trace collection window pads the incident span by this much
# on each side (route_trace lands at reply time, after the damage)
_TRACE_WINDOW_PAD_S = 1.0
_MAX_AFFECTED_TRACES = 20
_MAX_JOURNALS = 64
_EPS = 1e-4  # minimal causal nudge past a parent event


# -- journal discovery ------------------------------------------------------


def discover_journals(path: str) -> list[str]:
    """Every journal under a fleet dir: the root journal (job dir /
    telemetry dir / direct path, resolved like `top`) plus one level of
    member subdirs holding their own `journal.jsonl` (process-mode
    members each journal into their tele dir).  Remote roots resolve the
    root journal only — no remote listdir."""
    from . import render

    out: list[str] = []
    root = render.find_journal(path)
    if root is not None:
        out.append(root)
    base = os.path.dirname(root) if root else (
        path if os.path.isdir(path) else None)
    if base and os.path.isdir(base):
        try:
            names = sorted(os.listdir(base))
        except OSError:
            names = []
        for name in names:
            j = os.path.join(base, name, journal_mod.JOURNAL_FILE)
            if os.path.isfile(j):
                out.append(j)
    return out[:_MAX_JOURNALS]


def _journal_host(jpath: str) -> str:
    """The host a journal's events were stamped by, from the member
    lease next to it (runtime/fleet.py writes `host` into the lease).
    No lease / no host -> "" (reference frame: no correction)."""
    from . import render

    lease = render._read_lease_nearby(jpath)
    if lease and lease.get("host"):
        return str(lease["host"])
    return ""


# -- skew-corrected merge ---------------------------------------------------


def estimate_offsets(events: list[dict]) -> dict[str, float]:
    """{host: clock offset_s} from the manager's `fleet_clock_skew`
    events (newest observation per host wins — the manager already
    publishes a running min, so the last event is the best estimate)."""
    out: dict[str, float] = {}
    for ev in events:
        if ev.get("kind") == CLOCK_SKEW_KIND and ev.get("host"):
            try:
                out[str(ev["host"])] = float(ev.get("offset_s", 0.0))
            except (TypeError, ValueError):
                continue
    return out


def _order_key(ev: dict):
    return (ev.get("ts_fleet", 0.0), ev.get("src", 0), ev.get("seq", 0))


def _apply_happens_before(events: list[dict]) -> None:
    """Enforce protocol-guaranteed causal edges on an already
    ts-sorted merge: a child event whose corrected clock still places it
    before its parent is nudged just past the parent.  Edges:
    failover -> promotion swap, failover -> rejoin, swap-degraded ->
    readmit, member request_trace -> router route_trace (same trace).
    In-place; re-sorts at the end."""
    failover_by_standby: dict[str, dict] = {}
    failover_by_member: dict[str, dict] = {}
    degraded_by_member: dict[str, dict] = {}
    last_request_ts: dict[str, float] = {}
    for ev in events:
        k = ev.get("kind")
        if k == "fleet_failover":
            if ev.get("standby"):
                failover_by_standby[str(ev["standby"])] = ev
            if ev.get("member"):
                failover_by_member[str(ev["member"])] = ev
        elif k == "fleet_swap_degraded" and ev.get("member"):
            degraded_by_member[str(ev["member"])] = ev
        elif k == "request_trace" and ev.get("trace_id"):
            tid = str(ev["trace_id"])
            last_request_ts[tid] = max(last_request_ts.get(tid, 0.0),
                                       ev.get("ts_fleet", 0.0))
    for ev in events:
        k = ev.get("kind")
        parent = None
        if k == "fleet_member_swap" and ev.get("via") == "promote":
            parent = failover_by_standby.get(str(ev.get("member")))
        elif k == "fleet_rejoin":
            parent = failover_by_member.get(str(ev.get("member")))
        elif k == "fleet_readmit":
            parent = degraded_by_member.get(str(ev.get("member")))
        if parent is not None and ev["ts_fleet"] <= parent["ts_fleet"]:
            ev["ts_fleet"] = parent["ts_fleet"] + _EPS
        if k == "route_trace" and ev.get("trace_id"):
            t = last_request_ts.get(str(ev["trace_id"]), 0.0)
            if 0.0 < ev["ts_fleet"] < t:
                ev["ts_fleet"] = t + _EPS
    events.sort(key=_order_key)


def merge_sources(sources: list[tuple[list[dict], str]], *,
                  skew_correct: bool = True,
                  max_offset_s: float = 300.0) -> list[dict]:
    """Merge per-journal event lists into one causally-ordered stream.
    `sources` is ``[(events, host), ...]``; host "" means the reference
    (manager) clock.  Pure — the unit under test for the skew-regression
    suite.  Each returned event is a copy annotated with `ts_fleet`
    (corrected epoch seconds), `src` (source index), and `host` (when
    the journal has one and the event doesn't)."""
    offsets: dict[str, float] = {}
    if skew_correct:
        for evs, _host in sources:
            offsets.update(estimate_offsets(evs))
    merged: list[dict] = []
    for si, (evs, host) in enumerate(sources):
        off = offsets.get(host, 0.0) if (skew_correct and host) else 0.0
        off = max(-max_offset_s, min(max_offset_s, off))
        last_ts = 0.0  # a ts-less event rides at its predecessor's time
        for ev in evs:
            ts = ev.get("ts")
            if isinstance(ts, (int, float)):
                last_ts = float(ts)
            rec = dict(ev)
            rec["ts_fleet"] = round(last_ts + off, 6)
            rec["src"] = si
            if host and "host" not in rec:
                rec["host"] = host
            merged.append(rec)
    # stable sort: ts-less runs keep their within-journal order
    merged.sort(key=_order_key)
    _apply_happens_before(merged)
    return merged


def load_merged(path: str, *, skew_correct: bool = True,
                max_offset_s: float = 300.0,
                tail_bytes: Optional[int] = None) -> Optional[dict]:
    """Discover + read + merge a fleet dir's journals.  `tail_bytes`
    bounds each journal read (CLI views); None reads whole journals
    (fleet-verify needs complete history).  None when no journal."""
    from . import render

    jpaths = discover_journals(path)
    if not jpaths:
        return None
    sources: list[tuple[list[dict], str]] = []
    truncated = False
    for jp in jpaths:
        if tail_bytes:
            evs, _n, trunc = render._load_events_tail(jp, tail_bytes)
            truncated = truncated or trunc
        else:
            evs = journal_mod.read_journal(jp)
        sources.append((evs, _journal_host(jp)))
    offsets: dict[str, float] = {}
    for evs, _host in sources:
        offsets.update(estimate_offsets(evs))
    events = merge_sources(sources, skew_correct=skew_correct,
                           max_offset_s=max_offset_s)
    return {"journals": jpaths,
            "hosts": [h for _evs, h in sources],
            "offsets": {h: round(o, 4) for h, o in offsets.items()},
            "skew_correct": bool(skew_correct),
            "truncated": truncated,
            "events": events}


def merged_fleet_events(path: str, *, skew_correct: bool = True,
                        max_offset_s: float = 300.0) -> list[dict]:
    """The full skew-corrected merged event stream for `fleet-verify`:
    whole-journal reads (its checks count events over the entire run).
    Empty list when no journal resolves."""
    merged = load_merged(path, skew_correct=skew_correct,
                         max_offset_s=max_offset_s, tail_bytes=None)
    return merged["events"] if merged else []


# -- traces -----------------------------------------------------------------


def collect_traces(events: list[dict]) -> dict[str, dict]:
    """Group trace-carrying events by trace_id: the router's terminal
    `route_trace` (hops + queueing + e2e) joined with every member-side
    `request_trace` (stage decomposition) of the same trace."""
    traces: dict[str, dict] = {}
    for ev in events:
        tid = ev.get("trace_id")
        if not tid:
            continue
        t = traces.setdefault(str(tid), {"trace_id": str(tid),
                                         "route": None, "requests": []})
        if ev.get("kind") == "route_trace":
            t["route"] = ev
        elif ev.get("kind") == "request_trace":
            t["requests"].append(ev)
    return traces


_REQUEST_FIELDS = ("seq", "hop", "admission_ms", "queue_ms",
                   "coalesce_ms", "dispatch_ms", "device_ms", "reply_ms",
                   "e2e_ms", "batch", "engine", "model_version", "error")


def _trace_row(t: dict) -> dict:
    route = t.get("route") or {}
    row = {"trace_id": t["trace_id"],
           "ts": route.get("ts_fleet"),
           "hops": route.get("hops") or [],
           "queue_ms": route.get("queue_ms"),
           "e2e_ms": route.get("e2e_ms"),
           "hedged": bool(route.get("hedged")),
           "outcome": route.get("outcome"),
           "rows": route.get("rows")}
    row["requests"] = [
        {k: ev[k] for k in _REQUEST_FIELDS if k in ev}
        | {"host": ev.get("host", ""), "ts": ev.get("ts_fleet")}
        for ev in t.get("requests", ())]
    return row


# -- incidents --------------------------------------------------------------


def _affected_traces(events: list[dict], t0: float, t1: float) -> list[str]:
    """trace_ids of hedged or non-ok route_traces inside [t0, t1],
    padded — the sampled requests an incident actually touched."""
    out: list[str] = []
    lo, hi = t0 - _TRACE_WINDOW_PAD_S, t1 + _TRACE_WINDOW_PAD_S
    for ev in events:
        if ev.get("kind") != "route_trace" or not ev.get("trace_id"):
            continue
        ts = ev.get("ts_fleet", 0.0)
        if lo <= ts <= hi and (ev.get("hedged")
                               or ev.get("outcome") not in (None, "ok")):
            tid = str(ev["trace_id"])
            if tid not in out:
                out.append(tid)
            if len(out) >= _MAX_AFFECTED_TRACES:
                break
    return out


def _chaos_hint(events: list[dict], root_ts: float) -> Optional[dict]:
    """The latest chaos injection at most _CHAOS_HINT_WINDOW_S before
    the incident root — the injected-fault root-cause pointer."""
    hint = None
    for ev in events:
        if ev.get("kind") != "chaos_inject":
            continue
        ts = ev.get("ts_fleet", 0.0)
        if root_ts - _CHAOS_HINT_WINDOW_S <= ts <= root_ts:
            hint = {"site": ev.get("site"), "action": ev.get("action"),
                    "ts": ts}
    return hint


def reconstruct_incidents(events: list[dict]) -> list[dict]:
    """First-class incident records from a merged, causally-ordered
    stream.  Three episode shapes:

    - **fleet failover** (one per `fleet_failover`): chain lease_expiry
      -> failover -> promotion -> recovery.  Promotion is the matching
      ``fleet_member_swap via="promote"``; recovery is the failed
      member's later `fleet_rejoin` when one exists, else the moment the
      promoted standby restored capacity.  No standby -> the chain stops
      at failover and the incident stays unresolved until a rejoin.
    - **SLO episode**: `slo_alert` firing -> resolved per objective.
    - **degraded swap**: `fleet_swap_degraded` -> that member's
      `fleet_readmit`.

    Each record: {id, kind, root, chain, affected_traces, recovery_s,
    resolved, [suspect_chaos]}."""
    incidents: list[dict] = []

    def _finish(kind: str, root: dict, chain: list[dict],
                resolved: bool) -> None:
        root_ts = root.get("ts", 0.0)
        end_ts = chain[-1]["ts"] if chain else root_ts
        rec = {"id": f"inc-{len(incidents) + 1:03d}",
               "kind": kind, "root": root, "chain": chain,
               "affected_traces": _affected_traces(events, root_ts,
                                                   end_ts),
               "recovery_s": (round(end_ts - root_ts, 3)
                              if resolved else None),
               "resolved": bool(resolved)}
        hint = _chaos_hint(events, root_ts)
        if hint is not None:
            rec["suspect_chaos"] = hint
        incidents.append(rec)

    # fleet failovers
    for i, ev in enumerate(events):
        if ev.get("kind") != "fleet_failover":
            continue
        member = ev.get("member")
        standby = ev.get("standby")
        ts = ev.get("ts_fleet", 0.0)
        root = {"event": "lease_expiry", "ts": ts,
                "member": member, "host": ev.get("host", ""),
                "lease_age_s": ev.get("lease_age_s"),
                "ttl_s": ev.get("ttl_s")}
        chain = [{"step": "lease_expiry", "ts": ts, "member": member,
                  "lease_age_s": ev.get("lease_age_s")},
                 {"step": "failover", "ts": ts, "member": member,
                  "host": ev.get("host", "")}]
        # an explicit promote-swap only exists when the standby needed a
        # generation catch-up; a plain promotion is implicit in the
        # fleet_failover record itself (standby + promoted_in_s fields)
        promo = next(
            (e for e in events[i:]
             if e.get("kind") == "fleet_member_swap"
             and e.get("via") == "promote"
             and standby and e.get("member") == standby), None)
        rejoin = next(
            (e for e in events[i:]
             if e.get("kind") == "fleet_rejoin"
             and member and e.get("member") == member), None)
        resolved = False
        if standby:
            promo_ts = promo.get("ts_fleet", ts) if promo is not None \
                else ts
            step = {"step": "promotion", "ts": promo_ts,
                    "member": standby,
                    "host": (promo.get("host", "") if promo is not None
                             else ev.get("standby_host") or "")}
            if ev.get("promoted_in_s") is not None:
                step["promoted_in_s"] = ev["promoted_in_s"]
            chain.append(step)
            recovery_ts = (rejoin.get("ts_fleet", promo_ts)
                           if rejoin is not None else promo_ts)
            chain.append({"step": "recovery",
                          "ts": max(recovery_ts, promo_ts),
                          "via": ("rejoin" if rejoin is not None
                                  else "promote")})
            resolved = True
        elif rejoin is not None:
            chain.append({"step": "recovery",
                          "ts": rejoin.get("ts_fleet", ts),
                          "via": "rejoin"})
            resolved = True
        _finish("fleet_failover", root, chain, resolved)

    # SLO episodes
    open_alerts: dict[str, dict] = {}
    for ev in events:
        if ev.get("kind") != "slo_alert":
            continue
        obj = str(ev.get("objective", ""))
        if ev.get("state") == "firing":
            open_alerts[obj] = ev
        elif ev.get("state") == "resolved" and obj in open_alerts:
            fired = open_alerts.pop(obj)
            t0 = fired.get("ts_fleet", 0.0)
            root = {"event": "slo_alert", "ts": t0, "objective": obj}
            chain = [{"step": "firing", "ts": t0, "objective": obj},
                     {"step": "resolved",
                      "ts": ev.get("ts_fleet", t0), "objective": obj}]
            _finish("slo_alert", root, chain, True)
    for obj, fired in open_alerts.items():
        t0 = fired.get("ts_fleet", 0.0)
        _finish("slo_alert",
                {"event": "slo_alert", "ts": t0, "objective": obj},
                [{"step": "firing", "ts": t0, "objective": obj}], False)

    # degraded swaps
    for i, ev in enumerate(events):
        if ev.get("kind") != "fleet_swap_degraded":
            continue
        member = ev.get("member")
        t0 = ev.get("ts_fleet", 0.0)
        root = {"event": "fleet_swap_degraded", "ts": t0,
                "member": member, "error": ev.get("error")}
        chain = [{"step": "swap_degraded", "ts": t0, "member": member}]
        readmit = next(
            (e for e in events[i:]
             if e.get("kind") == "fleet_readmit"
             and member and e.get("member") == member), None)
        resolved = readmit is not None
        if resolved:
            chain.append({"step": "readmit",
                          "ts": readmit.get("ts_fleet", t0),
                          "generation": readmit.get("generation")})
        _finish("fleet_swap_degraded", root, chain, resolved)

    incidents.sort(key=lambda r: r["root"].get("ts", 0.0))
    for n, rec in enumerate(incidents):
        rec["id"] = f"inc-{n + 1:03d}"
    return incidents


# -- the timeline view ------------------------------------------------------

# event kinds worth a row in the human timeline (everything else —
# reports, epochs, goodput ticks — is cadence noise at incident scale)
_TIMELINE_KINDS = frozenset((
    "fleet_start", "fleet_failover", "fleet_member_swap", "fleet_rejoin",
    "fleet_readmit", "fleet_swap", "fleet_swap_degraded",
    "fleet_standby_down", "fleet_scale", "fleet_clock_skew",
    "slo_alert", "chaos_inject", "route_trace", "serve_start",
    "serve_stop", "loadtest_report",
))
_MAX_TIMELINE_ROWS = 200
_MAX_TRACE_ROWS = 50


def timeline_summary(path: str, *, trace_id: Optional[str] = None,
                     incidents_only: bool = False,
                     skew_correct: bool = True,
                     max_offset_s: float = 300.0,
                     tail_bytes: int = TAIL_BYTES) -> Optional[dict]:
    """One `shifu-tpu timeline` frame: bounded journal tails only (no
    torch, safe against a live fleet).  None when no journal resolves."""
    merged = load_merged(path, skew_correct=skew_correct,
                         max_offset_s=max_offset_s, tail_bytes=tail_bytes)
    if merged is None:
        return None
    events = merged.pop("events")
    out = dict(merged)
    out["path"] = path
    out["event_count"] = len(events)
    out["incidents"] = reconstruct_incidents(events)
    traces = collect_traces(events)
    if trace_id is not None:
        traces = ({trace_id: traces[trace_id]}
                  if trace_id in traces else {})
    if incidents_only:
        # incident records only: the incidents carry their own
        # affected_traces — keep just those, drop the general sample
        affected = {tid for inc in out["incidents"]
                    for tid in inc.get("affected_traces", ())}
        traces = {k: v for k, v in traces.items() if k in affected}
    rows = [_trace_row(t) for t in traces.values()]
    rows.sort(key=lambda r: r["ts"] or 0.0)
    out["traces"] = rows[-_MAX_TRACE_ROWS:]
    if incidents_only:
        out["timeline"] = []
        return out
    tl = []
    for ev in events:
        if ev.get("kind") not in _TIMELINE_KINDS:
            continue
        if trace_id is not None and ev.get("trace_id") not in (None,
                                                               trace_id):
            continue
        row = {"ts": ev.get("ts_fleet"), "kind": ev.get("kind")}
        for k in ("host", "member", "standby", "via", "generation",
                  "objective", "state", "site", "action", "trace_id",
                  "outcome", "offset_s"):
            if ev.get(k) not in (None, ""):
                row[k] = ev[k]
        tl.append(row)
    out["timeline"] = tl[-_MAX_TIMELINE_ROWS:]
    return out


def _fmt_ts(ts) -> str:
    if not isinstance(ts, (int, float)):
        return "-"
    import datetime
    return datetime.datetime.fromtimestamp(ts).strftime("%H:%M:%S.%f")[:-3]


def render_timeline_text(summary: dict) -> str:
    lines = []
    hosts = [h for h in summary.get("hosts", ()) if h]
    lines.append(
        f"fleet timeline — {len(summary.get('journals', ()))} journal(s)"
        + (f", hosts: {', '.join(sorted(set(hosts)))}" if hosts else "")
        + (", skew-corrected" if summary.get("skew_correct") else
           ", raw clocks")
        + (", tail-truncated" if summary.get("truncated") else ""))
    if summary.get("offsets"):
        offs = ", ".join(f"{h}: {o:+.3f}s"
                         for h, o in sorted(summary["offsets"].items()))
        lines.append(f"  clock offsets  {offs}")
    incidents = summary.get("incidents", ())
    lines.append(f"  incidents      {len(incidents)} "
                 f"({sum(1 for i in incidents if not i['resolved'])} open)")
    for inc in incidents:
        root = inc["root"]
        head = (f"  {inc['id']}  {inc['kind']}"
                f"  root={root.get('event')}@{_fmt_ts(root.get('ts'))}"
                + (f"  member={root['member']}" if root.get("member")
                   else "")
                + (f"  objective={root['objective']}"
                   if root.get("objective") else ""))
        if inc.get("recovery_s") is not None:
            head += f"  recovered_in={inc['recovery_s']:.3f}s"
        elif not inc["resolved"]:
            head += "  OPEN"
        lines.append(head)
        lines.append("    chain: " + " -> ".join(
            s["step"] for s in inc["chain"]))
        if inc.get("suspect_chaos"):
            c = inc["suspect_chaos"]
            lines.append(f"    suspect chaos: {c.get('action')} @ "
                         f"{c.get('site')}")
        if inc.get("affected_traces"):
            lines.append("    affected traces: "
                         + ", ".join(inc["affected_traces"][:6])
                         + (" …" if len(inc["affected_traces"]) > 6
                            else ""))
    traces = summary.get("traces", ())
    if traces:
        lines.append(f"  traces         {len(traces)} sampled")
        for t in traces[-10:]:
            hops = t.get("hops") or []
            hop_s = " + ".join(
                f"{h.get('member', '?')}@{h.get('host', '?')}"
                f"[{h.get('outcome', '?')} {h.get('ms', 0):.1f}ms]"
                for h in hops)
            lines.append(
                f"    {t['trace_id']}  "
                + (f"e2e={t['e2e_ms']:.1f}ms  "
                   if isinstance(t.get("e2e_ms"), (int, float)) else "")
                + (f"queue={t['queue_ms']:.1f}ms  "
                   if isinstance(t.get("queue_ms"), (int, float)) else "")
                + ("HEDGED  " if t.get("hedged") else "")
                + (f"hops: {hop_s}" if hop_s else "no hops"))
    tl = summary.get("timeline", ())
    if tl:
        lines.append(f"  events         last {len(tl)}")
        for row in tl:
            extra = " ".join(f"{k}={v}" for k, v in row.items()
                             if k not in ("ts", "kind"))
            lines.append(f"    {_fmt_ts(row.get('ts'))}  "
                         f"{row['kind']:<20} {extra}")
    return "\n".join(lines)
