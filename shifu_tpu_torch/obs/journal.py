"""Structured run journal: an append-only JSONL event stream (port of
shifu_tpu/obs/journal.py).

The machine-readable record of a run (run metadata, epoch records,
checkpoint saves and restores, spans, goodput, overlap reports, device
profiles), one JSON object per line: grep-able, tail-able, no runtime
needed to read it.  A local path appends through a line-buffered handle;
`path=None` keeps the events in memory (`records`).  A remote journal
(gs:// hdfs:// mock://) writes through data/fsio: object stores have no
append, so the journal keeps its lines in memory and rewrites the object
every `flush_every` events and at flush/close, with a retained-line cap so
the rewrite stays bounded.  `flush` carries the chaos site
`journal.flush`.

`tail_journal` follows a journal (a local stream, or a remote poll that
tracks `seq`), yielding decoded events.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Iterator, Optional

JOURNAL_FILE = "journal.jsonl"

# remote journals rewrite the whole object: bound the retained lines so an
# epochs=50k run cannot turn every flush into a multi-MB PUT
DEFAULT_MAX_REMOTE_LINES = 20_000


def _is_remote(path: Optional[str]) -> bool:
    if not path:
        return False
    try:
        from ..data import fsio
        return fsio.is_remote(path)
    except Exception:
        return False


def _clean(v):
    """NaN/Inf are not valid strict JSON; journal consumers get null."""
    if isinstance(v, float) and not math.isfinite(v):
        return None
    if isinstance(v, dict):
        return {k: _clean(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_clean(x) for x in v]
    return v


class RunJournal:
    """One journal stream.  `path=None` keeps events in memory only
    (`records`), read back programmatically rather than from disk."""

    def __init__(self, path: Optional[str], flush_every: int = 16,
                 max_remote_lines: int = DEFAULT_MAX_REMOTE_LINES):
        self.path = path
        self.records: list[dict] = []  # memory mode retains decoded events
        self._seq = 0
        self._lock = threading.RLock()
        self._fh = None
        self._remote = _is_remote(path)
        self._lines: list[str] = []
        self._pending = 0
        self._flush_every = max(1, flush_every)
        self._max_remote_lines = max_remote_lines
        self._truncated = 0
        if path and not self._remote:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a", buffering=1)
        elif self._remote:
            # seed from the existing object: remote flushes rewrite the
            # whole object from THIS writer's lines, so a restarted attempt
            # opening fresh would erase the previous attempt's history —
            # and restarting seq at 1 would make seq-tracking tails
            # (tail_journal --follow) silently discard the new attempt's
            # events.  One read at open keeps both monotonic.
            try:
                for rec in read_journal(path):
                    if rec.get("kind") == "journal_truncated":
                        # absorb the prior writer's drop count instead of
                        # retaining its marker as an ordinary line (the
                        # flush re-synthesizes ONE cumulative marker)
                        try:
                            self._truncated += int(rec.get("dropped") or 0)
                        except (TypeError, ValueError):
                            pass
                        continue
                    self._lines.append(json.dumps(rec, allow_nan=False))
                    try:
                        self._seq = max(self._seq, int(rec.get("seq") or 0))
                    except (TypeError, ValueError):
                        pass
                if len(self._lines) > self._max_remote_lines:
                    drop = len(self._lines) - self._max_remote_lines
                    del self._lines[:drop]
                    self._truncated += drop
            except FileNotFoundError:
                pass
            except Exception:
                pass  # unreadable prior object: start fresh, never fail

    def event(self, kind: str, **fields) -> dict:
        """Append one event; returns the record written (post-cleaning)."""
        with self._lock:
            self._seq += 1
            rec = {"ts": round(time.time(), 3), "seq": self._seq,
                   "kind": kind}
            rec.update({k: _clean(v) for k, v in fields.items()})
            if self.path is None:
                self.records.append(rec)
                return rec
            line = json.dumps(rec, allow_nan=False)
            if self._fh is not None:
                self._fh.write(line + "\n")  # line-buffered: flushed per line
            else:
                self._lines.append(line)
                if len(self._lines) > self._max_remote_lines:
                    drop = len(self._lines) - self._max_remote_lines
                    del self._lines[:drop]
                    self._truncated += drop
                self._pending += 1
                if self._pending >= self._flush_every:
                    self._flush_remote_locked()
            return rec

    def flush(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    # chaos site "journal.flush": models the sink's disk /
                    # object store failing — the journal is observability,
                    # so the failure is absorbed, never the job's
                    from .. import chaos
                    chaos.maybe_fail("journal.flush", path=self.path)
                    self._fh.flush()
                except Exception:
                    pass
            elif self._remote and self._pending:
                self._flush_remote_locked()

    def _flush_remote_locked(self) -> None:
        # best-effort whole-object rewrite (the board's contract): a sink
        # failure must never fail the job the journal describes
        try:
            from .. import chaos
            chaos.maybe_fail("journal.flush", path=self.path)
            from ..data import fsio
            lines = self._lines
            if self._truncated:
                head = json.dumps({"ts": round(time.time(), 3), "seq": 0,
                                   "kind": "journal_truncated",
                                   "dropped": self._truncated})
                lines = [head] + lines
            fsio.write_bytes(self.path, ("\n".join(lines) + "\n").encode())
            self._pending = 0
        except Exception:
            pass

    def close(self) -> None:
        with self._lock:
            self.flush()
            if self._fh is not None:
                self._fh.close()
                self._fh = None


def read_journal(path: str) -> list[dict]:
    """Decode every complete event of a journal (local or remote); corrupt
    or partial trailing lines are skipped, not fatal — a crash mid-append
    must not make the whole record unreadable."""
    if _is_remote(path):
        from ..data import fsio
        text = fsio.read_bytes(path).decode("utf-8", "replace")
    else:
        with open(path) as f:
            text = f.read()
    out = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict):
            out.append(rec)
    return out


def tail_journal(path: str, from_start: bool = True,
                 poll_seconds: float = 0.2) -> Iterator[dict]:
    """Generator yielding journal events as they appear — the structured
    sibling of launcher.console.tail_board.  Local journals stream from the
    file handle; remote journals poll the object through fsio and yield the
    delta.  Stops when the journal is removed after having existed."""
    if _is_remote(path):
        yield from _tail_remote(path, from_start, poll_seconds)
        return
    while not os.path.exists(path):
        time.sleep(0.1)
    with open(path, "r") as f:
        if not from_start:
            f.seek(0, os.SEEK_END)
        buf = ""
        while True:
            chunk = f.readline()
            if chunk:
                buf += chunk
                if not buf.endswith("\n"):
                    continue  # partial line: complete it next read
                line, buf = buf, ""
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict):
                    yield rec
            else:
                if not os.path.exists(path):
                    return
                time.sleep(poll_seconds)


def _tail_remote(path: str, from_start: bool,
                 poll_seconds: float) -> Iterator[dict]:
    """Delta-tracking by `seq`, NOT line index: once the retained-line cap
    engages, every rewrite drops old lines (and prepends a truncation
    marker), so the object's line count plateaus and an index-based tail
    would stall forever / skip shifted lines.  seq is monotonic per
    journal, so new events are exactly those above the high-water mark."""
    from ..data import fsio

    last_seq = -1.0
    first = True
    missing_grace = True
    while True:
        try:
            text = fsio.read_bytes(path).decode("utf-8", "replace")
            missing_grace = False
        except FileNotFoundError:
            if missing_grace:
                time.sleep(poll_seconds)
                continue
            return
        except Exception:
            time.sleep(poll_seconds)
            continue
        # read only up to the last newline: a half-written final line
        # completes next poll (same contract as tail_board)
        complete = text[: text.rfind("\n") + 1]
        recs = []
        for line in complete.splitlines():
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict):
                recs.append(rec)
        if first and not from_start:
            last_seq = max((float(r.get("seq") or 0) for r in recs),
                           default=-1.0)
        first = False
        for rec in recs:
            seq = rec.get("seq")
            if isinstance(seq, (int, float)):
                if seq <= last_seq:
                    continue
                last_seq = max(last_seq, float(seq))
            yield rec
        time.sleep(poll_seconds)
