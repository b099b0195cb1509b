"""Telemetry aggregation (port of shifu_tpu/obs/aggregate.py, its
single-process parts): the per-host skew-table row and line, the digest
agreement rule, and the multi-daemon serving rollup behind `top` over N
dirs.

The cross-host gather (`gather_host_summaries`), the per-epoch
`epoch_skew` and `pod_ingest_rollup` are multi-host and wait for the port's
multi-GPU slice (ROADMAP.md queue A item (f)).  Nothing here imports torch:
`top` reads journals on any machine.
"""

from __future__ import annotations

import os
import sys
from typing import Optional


def _rank() -> int:
    """This process's rank: torch.distributed's when a process group is
    up (never importing torch for it), else 0."""
    torch = sys.modules.get("torch")
    dist = getattr(torch, "distributed", None) if torch else None
    try:
        if dist is not None and dist.is_available() and dist.is_initialized():
            return int(dist.get_rank())
    except Exception:
        pass
    return 0


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
