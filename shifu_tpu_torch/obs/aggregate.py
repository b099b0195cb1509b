"""Telemetry aggregation (port of shifu_tpu/obs/aggregate.py): the
per-host skew table of a pod, the digest agreement rule, the pod's ingest
ledger, and the multi-daemon serving rollup behind `top` over N dirs.

Each host of a pod encodes a small summary of its telemetry, ONE
all-gather moves them all (`gather_host_summaries`: torch.distributed's
`all_gather_object` over the mesh's gloo control group, so an NCCL world
moves no pickle through the card), and the chief prints the slowest-first
line and journals `host_skew` (`epoch_skew`, once per epoch).  A host is a
JAX process: with several ranks on a host, the chief keeps one row per
host, its first rank's, with `rank` the host's index.

Nothing here imports torch: `top` and `pod-verify` read journals on any
machine; the gather finds torch where a process group is up.
"""

from __future__ import annotations

import os
import sys
from typing import Optional


def _dist():
    """torch.distributed when a process group is up (never importing
    torch for it), else None."""
    torch = sys.modules.get("torch")
    dist = getattr(torch, "distributed", None) if torch else None
    try:
        if dist is not None and dist.is_available() and dist.is_initialized():
            return dist
    except Exception:
        pass
    return None


def _rank() -> int:
    """This process's host index under a pod, else its rank (0 alone)."""
    dist = _dist()
    if dist is None:
        return 0
    pod = sys.modules.get("shifu_tpu_torch.parallel.distributed")
    contract = pod.pod_contract() if pod is not None else None
    return contract[0] if contract else int(dist.get_rank())


def host_summary(input_seconds: float = 0.0, epoch_seconds: float = 0.0,
                 valid_seconds: float = 0.0, **extra) -> dict:
    """This host's skew-table row: identity and the per-host timings
    (host-side input production is where a degraded disk or NIC shows
    first), plus any caller extras."""
    row = {
        "host": os.uname().nodename,
        "rank": _rank(),
        "input_s": round(float(input_seconds), 4),
        "epoch_s": round(float(epoch_seconds), 4),
        "valid_s": round(float(valid_seconds), 4),
    }
    row.update(extra)
    return row


def skew_line(epoch: int, rows: list[dict],
              sort_key: str = "input_s") -> str:
    """One console line, hosts slowest-first by `sort_key` — the same
    operator read the reference AM printed, under SPMD semantics (input
    seconds are the per-host-attributable cost; epoch wall converges)."""
    ordered = sorted(rows, key=lambda r: -float(r.get(sort_key, 0.0)))

    def _one(r: dict) -> str:
        s = (f"{r.get('host', '?')}[{r.get('rank', '?')}] "
             f"input {float(r.get('input_s', 0.0)):.2f}s "
             f"(epoch {float(r.get('epoch_s', 0.0)):.2f}s, "
             f"valid {float(r.get('valid_s', 0.0)):.2f}s)")
        if r.get("ingest_bytes") is not None:
            # pod data plane: cumulative source ingest per host — a host
            # rereading more than its ~1/N slice, or grinding on a slow
            # disk, is named right here in the straggler line
            s += (f" ingest {float(r['ingest_bytes']) / 1e6:.1f}MB"
                  f"/{float(r.get('ingest_s', 0.0)):.1f}s")
        return s

    return (f"Epoch {epoch} hosts by input time (slowest first): "
            + " | ".join(_one(r) for r in ordered))


def gather_host_summaries(summary: dict, group=None) -> list[dict]:
    """Every rank's summary, in rank order, on every rank: one
    `all_gather_object` over `group` (the mesh's gloo control group).
    Alone: [summary], no collective."""
    dist = _dist()
    if dist is None or dist.get_world_size(group) <= 1:
        return [dict(summary)]
    rows: list = [None] * dist.get_world_size(group)
    dist.all_gather_object(rows, dict(summary), group=group)
    out = []
    for r, rec in enumerate(rows):
        if isinstance(rec, dict):
            rec.setdefault("rank", r)
            out.append(rec)
    return out


def _one_per_host(rows: list[dict]) -> list[dict]:
    """The first row of each host index (rows arrive in rank order, and a
    host's ranks are consecutive)."""
    seen: set = set()
    out = []
    for r in rows:
        if r.get("rank") not in seen:
            seen.add(r.get("rank"))
            out.append(r)
    return out


def epoch_skew(epoch: int, input_seconds: float, epoch_seconds: float,
               valid_seconds: float, console=None, journal: bool = True,
               extra: Optional[dict] = None, group=None
               ) -> Optional[list[dict]]:
    """The per-epoch cross-host skew: gather every host's summary, print
    the slowest-first line on the chief, journal a `host_skew` event with
    the hosts' agreement on `order_digest` and `shard_digest` (the
    digests `pod-verify` audits).  Collective: every rank of `group` calls
    it.  Returns the rows on the chief, None elsewhere and alone.  `extra`
    (ingest bytes and seconds, the digests) rides each row through the
    one gather, with this host's peak device memory where known."""
    dist = _dist()
    if dist is None or dist.get_world_size(group) <= 1:
        return None
    fields = dict(extra or {})
    try:
        from . import devprof
        snap = devprof.hbm_snapshot()
        if snap.get("peak_bytes"):
            fields["hbm_peak_bytes"] = int(snap["peak_bytes"])
    except Exception:
        pass
    rows = _one_per_host(gather_host_summaries(host_summary(
        input_seconds, epoch_seconds, valid_seconds, **fields), group))
    if dist.get_rank() != 0:
        return None
    if console is not None:
        console(skew_line(epoch, rows))
    if journal:
        from . import _sinks
        _sinks.event("host_skew", epoch=epoch, hosts=rows,
                     order_digest_agree=digest_agreement(
                         rows, "order_digest"),
                     shard_digest_agree=digest_agreement(
                         rows, "shard_digest"))
    return rows


def pod_ingest_rollup(events: list) -> dict:
    """Fold a pod run's merged journal events (obs/timeline.load_merged)
    into the per-host ingest ledger: source bytes and ingest seconds per
    host, the pod's totals and its max/min byte imbalance.  A pure fold.
    A host is the event's `host` stamp, else `rank<src>` (the merge's
    journal index).  `ingest_report` rows add up (their phase seconds
    summed); a `host_skew` row's cumulative extras replace them (newest
    wins)."""
    hosts: dict = {}

    def slot(key) -> dict:
        return hosts.setdefault(str(key), {
            "ingest_bytes": 0, "ingest_s": 0.0, "files": 0, "reports": 0})

    for ev in events:
        kind = ev.get("kind")
        key = ev.get("host") or f"rank{ev.get('src', 0)}"
        if kind == "ingest_report":
            s = slot(key)
            s["reports"] += 1
            s["files"] += int(ev.get("files") or 0)
            s["ingest_s"] += sum(
                float(ev.get(k) or 0.0)
                for k in ("parse_s", "inflate_s", "write_s"))
            if ev.get("source_bytes") is not None:
                s["ingest_bytes"] += int(ev["source_bytes"])
        elif kind == "host_skew":
            for r in ev.get("hosts") or []:
                if r.get("ingest_bytes") is None:
                    continue
                s = slot(r.get("host") or f"rank{r.get('rank', 0)}")
                s["ingest_bytes"] = int(r["ingest_bytes"])
                s["ingest_s"] = float(r.get("ingest_s") or 0.0)
    total_b = sum(h["ingest_bytes"] for h in hosts.values())
    loads = [h["ingest_bytes"] for h in hosts.values()
             if h["ingest_bytes"] > 0]
    return {
        "hosts": {k: hosts[k] for k in sorted(hosts)},
        "pod": {
            "hosts": len(hosts),
            "ingest_bytes_total": total_b,
            "ingest_s_total": round(
                sum(h["ingest_s"] for h in hosts.values()), 3),
            "imbalance": (round(max(loads) / max(min(loads), 1), 3)
                          if loads else None),
        },
    }


def digest_agreement(rows: list[dict], key: str) -> Optional[bool]:
    """Do all hosts agree on digest `key`?  None when NO row carries the
    field (pre-field journals stay un-audited, not failing); False when
    any host disagrees or is missing it while others have it."""
    values = [r.get(key) for r in rows]
    present = [v for v in values if v is not None]
    if not present:
        return None
    return len(present) == len(values) and len(set(present)) == 1


# -- multi-daemon serving rollup ------------------------------------------

def serving_rollup(paths: list,
                   stale_after_s: Optional[float] = None) -> dict:
    """Join N serving telemetry dirs into one fleet view — journal/scrape
    reads only (obs/render.top_summary per dir), no torch, no collectives:
    the rollup runs on any machine that can read the dirs, the serving
    analog of the training plane's host_skew table.

    A daemon whose freshest signal (fleet lease or journal tail) is
    older than `stale_after_s` — or than its own lease ttl — is DOWN:
    excluded from the live rate / p99 / queue / alert totals (its last
    frame is history, not throughput) and counted in `fleet.down`.

    Returns {"daemons": [per-dir top summaries + "dir"],
    "fleet": {daemons, down, scores_per_sec (sum of live rates),
    worst_p99_ms, queue_depth (sum), active_alerts,
    firing (objective names)}} — rendered by
    `shifu-tpu top <dir> <dir> ...` (render.render_top_fleet_text)."""
    from . import render

    daemons: list[dict] = []
    for p in paths:
        try:
            s = render.top_summary(str(p), stale_after_s=stale_after_s)
        except Exception as e:  # noqa: BLE001 — one bad dir, not the view
            s = {"error": f"{type(e).__name__}: {e}"[:200]}
        if s is None:
            s = {"dir": str(p), "error": "no telemetry journal"}
        else:
            s["dir"] = str(p)
        daemons.append(s)
    rates = []
    p99s = []
    queue = 0
    down = 0
    active: list[dict] = []
    firing: set = set()
    drift_worst: Optional[dict] = None  # fleet-wide worst PSI + where
    drift_firing: set = set()
    route_traces = 0
    hedges = 0
    incidents = 0
    incidents_open = 0
    for d in daemons:
        # tracing/incident counts are historical, not live capacity —
        # a DOWN member's journal still tells the incident story
        route_traces += int(d.get("route_traces") or 0)
        hedges += int(d.get("hedges") or 0)
        inc = d.get("incidents") or {}
        incidents += int(inc.get("total") or 0)
        incidents_open += int(inc.get("open") or 0)
        if d.get("down"):
            down += 1
            continue  # a dead member's last frame is not live capacity
        sv = d.get("serving") or {}
        if isinstance(sv.get("scores_per_sec"), (int, float)):
            rates.append(sv["scores_per_sec"])
        if isinstance(sv.get("p99_ms"), (int, float)):
            p99s.append(sv["p99_ms"])
        if isinstance(sv.get("queue_depth"), (int, float)):
            queue += int(sv["queue_depth"])
        for a in (d.get("slo") or {}).get("active") or []:
            active.append(a)
            if a.get("objective"):
                firing.add(str(a["objective"]))
        dr = d.get("drift") or {}
        if isinstance(dr.get("worst"), (int, float)) and (
                drift_worst is None or dr["worst"] > drift_worst["psi"]):
            drift_worst = {"psi": dr["worst"],
                           "feature": dr.get("worst_feature"),
                           "dir": d.get("dir")}
        for obj in dr.get("firing") or []:
            drift_firing.add(str(obj))
    # per-host grouping off the lease's host stamp (the cross-host fleet
    # writes it; dirs without one group under "-"): live/down counts per
    # placement, so a whole-host loss reads as ONE row going dark
    hosts: dict = {}
    for d in daemons:
        host = str((d.get("lease") or {}).get("host") or "-")
        slot = hosts.setdefault(host, {"members": 0, "down": 0})
        slot["members"] += 1
        if d.get("down"):
            slot["down"] += 1
    return {
        "daemons": daemons,
        "fleet": {
            "daemons": len(daemons),
            "down": down,
            "scores_per_sec": round(sum(rates), 1) if rates else None,
            "worst_p99_ms": max(p99s) if p99s else None,
            "queue_depth": queue,
            "active_alerts": len(active),
            "firing": sorted(firing),
            "drift_worst": drift_worst,
            "drift_firing": sorted(drift_firing),
            "route_traces": route_traces,
            "hedges": hedges,
            "incidents": incidents,
            "incidents_open": incidents_open,
            "hosts": {h: hosts[h] for h in sorted(hosts)},
        },
    }
