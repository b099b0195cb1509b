"""Structured run journal: an append-only JSONL event stream (port of
shifu_tpu/obs/journal.py, local paths only).

The machine-readable record of a run (run metadata, epoch records,
checkpoint saves and restores, spans, goodput, overlap reports), one JSON
object per line: grep-able, tail-able, no runtime needed to read it.  A
local path appends through a line-buffered handle; `path=None` keeps the
events in memory (`records`).  A remote journal (the JAX package rewrites
the whole object on a cadence) waits for the remote half of
`data/fsio.py`, ROADMAP.md queue A item (a)4, and raises.  `flush`
carries the chaos site `journal.flush`.

`tail_journal` follows a journal, yielding decoded events.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Iterator, Optional

from ..data import fsio

JOURNAL_FILE = "journal.jsonl"


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
    (`records`).  A local journal is flushed at every line, so the JAX
    signature's `flush_every` (its remote rewrite cadence) is accepted and
    has nothing to pace."""

    def __init__(self, path: Optional[str], flush_every: int = 16):
        if path:
            fsio._local_only(path)
        self.path = path
        self.records: list[dict] = []  # memory mode retains decoded events
        self._seq = 0
        self._lock = threading.RLock()
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a", buffering=1)

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
            return rec

    def flush(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    # chaos site "journal.flush": the sink's disk failing;
                    # the journal is observability, so the failure is
                    # absorbed, never the job's
                    from .. import chaos
                    chaos.maybe_fail("journal.flush", path=self.path)
                    self._fh.flush()
                except Exception:
                    pass  # the journal is observability, never the job

    def close(self) -> None:
        with self._lock:
            self.flush()
            if self._fh is not None:
                self._fh.close()
                self._fh = None


def read_journal(path: str) -> list[dict]:
    """Decode every complete event of a journal; corrupt or partial
    trailing lines are skipped, not fatal (a crash mid-append must not make
    the whole record unreadable)."""
    text = fsio.read_bytes(path).decode("utf-8", "replace")
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
    """Generator yielding journal events as they appear.  Stops when the
    journal is removed after having existed."""
    fsio._local_only(path)
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
