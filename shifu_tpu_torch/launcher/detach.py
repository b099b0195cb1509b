"""Detached jobs: a `train` that outlives the terminal that submitted it
(port of shifu_tpu/launcher/detach.py).

`train --detach` re-launches the dispatcher as a fresh `python -m
shifu_tpu_torch.launcher.cli train ... --supervise` session leader (a new
process: it inherits no CUDA context of the caller), whose stdout goes to
`<job>/supervisor.log`; it records `<job>/job.json` and returns at once.
The daemon writes `<job>/job.status` when the job ends.  `status`,
`attach` and `kill` drive the job from its directory afterwards.  The file
names and the environment variable are the JAX package's.

A job dir that records a provisioned slice (`provision.json`, the
marker of launcher/provision.py) shows it in `status` as
`provisioned_slice`, and `kill` releases it once the dispatcher is gone;
`kill --force` releases it even when the marker names a live foreground
dispatcher or another host.

One deliberate difference from the JAX package: `_is_our_job` accepts
only a `shifu_tpu_torch` / `shifu-tpu-torch` command line, so the port's
`kill` never signals a JAX dispatcher (the JAX package's substring test
matches the port's command lines too).  `kill`'s SIGKILL escalation also
reaches the supervised attempt's own session, so a drain that outlasts
the grace leaves no process behind, and a zombie counts as ended (an
orphaned daemon may wait for its reaper).

Everything here reads and writes files and signals processes: nothing
imports torch.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from typing import Optional, Sequence

# marks the daemonized dispatcher so that `main` records its final status
ENV_DETACHED = "SHIFU_TPU_DETACHED_JOB_DIR"

JOB_FILE = "job.json"
STATUS_FILE = "job.status"
LOG_FILE = "supervisor.log"
BOARD_FILE = "console.board"

CLI_MODULE = "shifu_tpu_torch.launcher.cli"
# the command-line spellings of a port dispatcher: `python -m` and the
# installed console script
_OUR_COMMANDS = (b"shifu_tpu_torch", b"shifu-tpu-torch")


def submit(child_argv: Sequence[str], out_dir: str, echo=print) -> int:
    """Launch `python -m shifu_tpu_torch.launcher.cli <child_argv>` as a
    detached session leader and return at once (0 = submitted)."""
    from ..data import fsio
    if fsio.is_remote(out_dir):
        echo("--detach needs a LOCAL job dir (job.json/pid live beside "
             "the daemon); use a local --output whose board/checkpoint "
             "paths may still be remote")
        return 1
    os.makedirs(out_dir, exist_ok=True)
    env = dict(os.environ)
    env[ENV_DETACHED] = out_dir
    with open(os.path.join(out_dir, LOG_FILE), "ab") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", CLI_MODULE, *child_argv],
            stdout=log, stderr=subprocess.STDOUT,
            stdin=subprocess.DEVNULL,
            start_new_session=True,  # outlives the client's session
            env=env, cwd=os.getcwd())
    with open(os.path.join(out_dir, JOB_FILE), "w") as f:
        json.dump({"pid": proc.pid, "argv": list(child_argv),
                   "submitted_at": time.time(),
                   "host": os.uname().nodename}, f)
    echo(f"submitted: pid {proc.pid}, job dir {out_dir}")
    echo(f"  follow:  shifu-tpu-torch attach {out_dir}")
    echo(f"  status:  shifu-tpu-torch status {out_dir}")
    echo(f"  stop:    shifu-tpu-torch kill {out_dir}")
    return 0


def write_status(out_dir: str, exit_code: int) -> None:
    """The daemonized dispatcher records the job's end (`job.status`).

    Guarded by pid: ENV_DETACHED reaches the dispatcher's whole tree (the
    supervised attempts), and an attempt exiting mid-restart must not
    record its code as the job's; only the process `submit` recorded
    writes."""
    job = _read_json(os.path.join(out_dir, JOB_FILE))
    if not job or job.get("pid") != os.getpid():
        return
    try:
        with open(os.path.join(out_dir, STATUS_FILE), "w") as f:
            json.dump({"exit": int(exit_code), "finished_at": time.time()}, f)
    except OSError:
        pass


def _read_json(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _alive(pid: int) -> bool:
    """The pid runs: it exists and is not a zombie (an orphaned daemon
    whose reaper has not collected it yet has ended all the same)."""
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            stat = f.read()
        return stat[stat.rindex(b")") + 2:][:1] != b"Z"
    except (OSError, ValueError):
        return True


def _cmdline(pid: int) -> Optional[bytes]:
    """The pid's command line, NUL-separated; None without /proc."""
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return f.read()
    except OSError:
        return None


def _is_our_job(pid: int, job: Optional[dict]) -> bool:
    """The recorded pid must be a port dispatcher on the recording host: a
    recycled pid (the daemon died uncleanly) or another machine's job dir
    must not make `kill` signal an innocent process tree, and neither
    must a JAX package's dispatcher."""
    if job and job.get("host") and job["host"] != os.uname().nodename:
        return False
    cmd = _cmdline(pid)
    if cmd is None:
        return True  # no /proc: pid liveness alone
    return any(word in cmd for word in _OUR_COMMANDS)


def _child_pgids(pid: int) -> list[int]:
    """The process groups of `pid`'s descendants other than its own
    (Linux /proc; empty elsewhere)."""
    try:
        own = os.getpgid(pid)
    except OSError:
        return []
    out: list[int] = []
    todo = [pid]
    while todo:
        p = todo.pop()
        try:
            with open(f"/proc/{p}/task/{p}/children") as f:
                kids = [int(k) for k in f.read().split()]
        except (OSError, ValueError):
            continue
        for k in kids:
            try:
                pg = os.getpgid(k)
            except OSError:
                continue
            if pg != own and pg not in out:
                out.append(pg)
            todo.append(k)
    return out


def job_state(out_dir: str) -> dict:
    """One dict describing the job: RUNNING / FINISHED / FAILED (with the
    exit) / DEAD / UNKNOWN, the last board line, and the telemetry and
    checkpoint summaries where the job dir has them."""
    job = _read_json(os.path.join(out_dir, JOB_FILE))
    status = _read_json(os.path.join(out_dir, STATUS_FILE))
    out: dict = {"job_dir": out_dir}
    if job:
        out.update(pid=job.get("pid"), submitted_at=job.get("submitted_at"))
    try:  # an acquired slice not yet released (provision.json)
        from .provision import read_marker
        marker = read_marker(out_dir)
        if marker and marker.get("name"):
            out["provisioned_slice"] = marker["name"]
    except Exception:
        pass
    if status is not None:
        rc = int(status.get("exit", 1))
        out.update(state="FINISHED" if rc == 0 else "FAILED", exit=rc,
                   finished_at=status.get("finished_at"))
    elif (job and isinstance(job.get("pid"), int) and _alive(job["pid"])
          and _is_our_job(job["pid"], job)):
        out["state"] = "RUNNING"
    elif job:
        # pid gone with no status file: the daemon was killed uncleanly
        out.update(state="DEAD", exit=None)
    else:
        out["state"] = "UNKNOWN"
    try:
        with open(os.path.join(out_dir, BOARD_FILE)) as f:
            lines = f.read().splitlines()
        if lines:
            out["last_progress"] = lines[-1]
    except OSError:
        pass
    try:
        tele = _telemetry_quick_summary(
            os.path.join(out_dir, "telemetry", "journal.jsonl"))
        if tele:
            out["telemetry"] = tele
    except Exception:
        pass
    try:
        ckpt = _checkpoint_summary(out_dir)
        if ckpt:
            out["checkpoints"] = ckpt
    except Exception:
        pass
    return out


def _checkpoint_summary(out_dir: str) -> Optional[dict]:
    """Kept checkpoint steps of the job's tmp_model dir, how many carry a
    digest manifest, and the GC totals from the scrape file: one listing
    and one small file, fit for status polls."""
    ckpt_dir = os.path.join(out_dir, "tmp_model")
    if not os.path.isdir(ckpt_dir):
        return None
    kept = sorted(int(n) for n in os.listdir(ckpt_dir)
                  if n.isdigit() and os.path.isdir(os.path.join(ckpt_dir, n)))
    verified = sum(
        1 for s in kept
        if os.path.exists(os.path.join(ckpt_dir, f"manifest-{s}.json")))
    summary = {"kept_steps": kept, "manifests": verified}
    try:
        from ..obs.render import parse_scrape_totals
        with open(os.path.join(out_dir, "telemetry", "metrics.prom")) as f:
            totals = parse_scrape_totals(f.read())
        if "checkpoint_gc_total" in totals:
            summary["gc_steps"] = int(totals["checkpoint_gc_total"])
        if "checkpoint_gc_bytes_total" in totals:
            summary["gc_freed_bytes"] = int(
                totals["checkpoint_gc_bytes_total"])
    except OSError:
        pass
    return summary


def _telemetry_quick_summary(jpath: str) -> Optional[dict]:
    """A bounded journal probe for `status` polls: count the lines in one
    chunked pass and decode only the 64 KiB tail (a status poll must not
    decode a long run's whole journal; `metrics` does that on demand)."""
    if not os.path.exists(jpath):
        return None
    n = 0
    tail = b""
    with open(jpath, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            n += chunk.count(b"\n")
            tail = (tail + chunk)[-65536:]
    last_kind = None
    goodput = None
    hbm = None
    serving = None
    slo_firing: dict = {}
    slo_seen: set = set()
    for line in reversed(tail.splitlines()):
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if not isinstance(rec, dict):
            continue
        if last_kind is None:
            last_kind = rec.get("kind")
        if serving is None and rec.get("kind") == "serving_report":
            serving = {"requests": rec.get("requests"),
                       "scores_per_sec": rec.get("scores_per_sec"),
                       "p99_ms": rec.get("p99_ms"),
                       "queue_depth": rec.get("queue_depth"),
                       "errors": rec.get("errors")}
        if rec.get("kind") == "slo_alert":
            # newest first: the first state seen per objective is its own
            obj = str(rec.get("objective", "?"))
            if obj not in slo_seen:
                slo_seen.add(obj)
                if rec.get("state") == "firing":
                    slo_firing[obj] = {
                        "burn_fast": rec.get("burn_fast"),
                        "observed_p99_ms": rec.get("observed_p99_ms")}
        if goodput is None and rec.get("kind") == "goodput":
            goodput = {"epoch": rec.get("epoch"),
                       "goodput_fraction": rec.get("goodput_fraction"),
                       "mfu": rec.get("mfu")}
        if hbm is None and rec.get("kind") == "hbm_watermark":
            hbm = {"epoch": rec.get("epoch"),
                   "peak_bytes": rec.get("peak_bytes"),
                   "bytes_in_use": rec.get("bytes_in_use"),
                   "source": rec.get("source")}
        if last_kind is not None and goodput is not None and hbm is not None:
            break
    out = {"events": n, "last_event": last_kind}
    if goodput is not None:
        out["goodput"] = goodput
    if hbm is not None:
        out["hbm"] = hbm
    if serving is not None:
        out["serving"] = serving
    if slo_seen:
        out["slo"] = {"firing": sorted(slo_firing),
                      "alerts": slo_firing}
    return out


def run_status(out_dir: str, echo=print) -> int:
    st = job_state(out_dir)
    echo(json.dumps(st))
    return 1 if st["state"] == "UNKNOWN" else 0


def attach(out_dir: str, echo=print, poll_seconds: float = 0.5,
           from_start: bool = True) -> int:
    """Follow the job's console board until the job ends; returns the
    job's exit code.  A remote job dir is followed through fsio until ^C
    (no local pid or status to consult)."""
    from ..data import fsio
    try:
        if fsio.is_remote(out_dir):
            from .console import tail_board
            for line in tail_board(fsio.join(out_dir, BOARD_FILE),
                                   from_start=from_start):
                echo(line)
            return 0
    except KeyboardInterrupt:
        return 0
    board = os.path.join(out_dir, BOARD_FILE)
    pos = 0
    if not from_start and os.path.exists(board):
        pos = os.path.getsize(board)

    def drain() -> None:
        nonlocal pos
        if os.path.exists(board):
            with open(board) as f:
                f.seek(pos)
                chunk = f.read()
                pos = f.tell()
            for line in chunk.splitlines():
                echo(line)

    try:
        while True:
            drain()
            st = job_state(out_dir)
            if st["state"] in ("FINISHED", "FAILED"):
                drain()  # what was written between the read and the status
                echo(f"job {st['state'].lower()} (exit {st.get('exit')})")
                return int(st.get("exit") or 0)
            if st["state"] in ("DEAD", "UNKNOWN"):
                echo(f"job state: {st['state']}")
                return 1
            time.sleep(poll_seconds)
    except KeyboardInterrupt:
        return 0  # stop following; the job keeps running


def _release_slice(out_dir: str, echo, force: bool = False,
                   killed_pid: Optional[int] = None) -> bool:
    """Release the slice the job dir records, best-effort: killing the job
    frees its compute, and a dispatcher's unclean death must leave no
    billing slice behind.  Unless `force`, refuse (False) when the marker
    names a live dispatcher (a foreground `--provision` run, which writes
    no job.json) or another host, whose pid table this host cannot read.
    `killed_pid`, the dispatcher `kill` just signalled, may still look
    alive (a zombie): it does not count as live."""
    try:
        from .provision import read_marker, release_from_marker
        marker = read_marker(out_dir)
        if marker and not force:
            mpid = marker.get("pid")
            mhost = marker.get("host")
            if mhost and mhost != os.uname().nodename:
                echo(f"provision marker was written on {mhost!r} — run kill "
                     "there (its pid table can check dispatcher liveness) "
                     "or re-run with --force")
                return False
            if (isinstance(mpid, int) and mpid != killed_pid
                    and _alive(mpid) and _is_our_job(mpid, marker)):
                echo(f"provision marker records a LIVE dispatcher (pid "
                     f"{mpid}) — a foreground --provision run is still "
                     "using the slice; SIGTERM that process (or re-run "
                     "with --force) instead")
                return False
        release_from_marker(out_dir, echo=echo)
        return True
    except Exception as e:
        echo(f"provision: release check failed ({e}); see provision.json "
             f"in {out_dir}")
        return True


def kill(out_dir: str, echo=print, grace_seconds: float = 10.0,
         force: bool = False) -> int:
    """SIGTERM the detached dispatcher's process group (a session leader:
    the supervisor forwards the drain to its attempt, which saves and
    exits 75), then SIGKILL the group after `grace_seconds`; then release
    the slice the job dir records (`_release_slice`), one left behind by
    an earlier unclean death included.  Exit 1 when a recorded slice was
    deliberately not released."""
    job = _read_json(os.path.join(out_dir, JOB_FILE))
    if not job or not isinstance(job.get("pid"), int):
        echo(f"no submitted job under {out_dir}")
        # a foreground --provision run writes no job.json but may have
        # left a marker (an unclean death): the rescue release still runs
        _release_slice(out_dir, echo, force=force)
        return 1
    pid = job["pid"]
    if not _alive(pid):
        echo(f"job pid {pid} is not running")
        return 0 if _release_slice(out_dir, echo, force=force) else 1
    if not _is_our_job(pid, job):
        echo(f"pid {pid} is not this job's dispatcher (recycled pid or a "
             f"different host — job.json says {job.get('host')!r}); "
             "refusing to signal it")
        if not (job.get("host") and job["host"] != os.uname().nodename):
            # this host, a recycled pid: the dispatcher is gone
            _release_slice(out_dir, echo, force=force)
        return 1
    try:
        os.killpg(pid, signal.SIGTERM)
    except OSError:
        try:
            os.kill(pid, signal.SIGTERM)
        except OSError:
            pass
    deadline = time.monotonic() + grace_seconds
    while time.monotonic() < deadline:
        if not _alive(pid):
            echo(f"job pid {pid} terminated")
            return 0 if _release_slice(out_dir, echo, force=force) else 1
        time.sleep(0.2)
    # the supervised attempt runs in a session of its own: its group is
    # killed with the dispatcher's, so no process of the tree outlives it
    for pg in [pid] + _child_pgids(pid):
        try:
            os.killpg(pg, signal.SIGKILL)
        except OSError:
            pass
    reap_deadline = time.monotonic() + 2.0
    while time.monotonic() < reap_deadline and _alive(pid):
        time.sleep(0.1)
    echo(f"job pid {pid} killed")
    return 0 if _release_slice(out_dir, echo, force=force,
                               killed_pid=pid) else 1
