"""Console board: progress lines to stdout and an append-only board file
(port of shifu_tpu/launcher/console.py).

Every line goes to stdout at once, stamped, and is appended (and flushed)
to the board file, which an external tail, or the supervisor's liveness
monitor, follows.  A board write that fails (the chaos site `board.flush`
models it) degrades to stdout only: the board never kills the training it
narrates.

A remote job dir (gs:// hdfs:// mock://) writes the board through
data/fsio: object stores have no append, so the board keeps its lines in
memory and rewrites the object, and `tail_board` polls the object and
yields the new lines.  Retained lines are capped
(SHIFU_TPU_BOARD_MAX_LINES, default 2000; the oldest drop, journaled once
as `board_truncated`, with a marker line in the object), and rewrites
within SHIFU_TPU_BOARD_FLUSH_SECONDS (default 0.2 s) of the previous one
batch into one deferred write.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Optional

ENV_BOARD_MAX_LINES = "SHIFU_TPU_BOARD_MAX_LINES"
DEFAULT_MAX_REMOTE_LINES = 2000
ENV_BOARD_FLUSH_SECONDS = "SHIFU_TPU_BOARD_FLUSH_SECONDS"
DEFAULT_FLUSH_SECONDS = 0.2


def _env_number(name: str, default, cast):
    try:
        raw = os.environ.get(name)
        return cast(raw) if raw else default
    except ValueError:
        return default


def _is_remote(path: Optional[str]) -> bool:
    if not path:
        return False
    try:
        from ..data import fsio
        return fsio.is_remote(path)
    except Exception:
        return False


class ConsoleBoard:
    def __init__(self, board_path: Optional[str] = None, echo: bool = True,
                 max_remote_lines: Optional[int] = None,
                 flush_seconds: Optional[float] = None):
        self.board_path = board_path
        self.echo = echo
        self._fh = None
        self._remote = _is_remote(board_path)
        self._lines: list[str] = []
        self._lock = threading.Lock()
        self._io_lock = threading.Lock()  # serializes remote PUTs
        self._gen = 0          # snapshot generation (under _lock)
        self._written_gen = 0  # newest generation PUT (under _io_lock)
        self._dirty = False
        self._timer: Optional[threading.Timer] = None
        self._last_flush = 0.0  # epoch-0 monotonic: first line flushes now
        self._truncated = 0
        self._warned = False
        self._max_lines = (max_remote_lines
                           if max_remote_lines is not None
                           else _env_number(ENV_BOARD_MAX_LINES,
                                            DEFAULT_MAX_REMOTE_LINES, int))
        self._flush_seconds = (flush_seconds
                               if flush_seconds is not None
                               else _env_number(ENV_BOARD_FLUSH_SECONDS,
                                                DEFAULT_FLUSH_SECONDS,
                                                float))
        if board_path and not self._remote:
            os.makedirs(os.path.dirname(os.path.abspath(board_path)),
                        exist_ok=True)
            self._fh = open(board_path, "a", buffering=1)

    def __call__(self, line: str) -> None:
        stamped = f"[{time.strftime('%Y-%m-%d %H:%M:%S')}] {line}"
        if self.echo:
            print(stamped, flush=True)
        if self._fh is not None:
            try:
                # chaos site "board.flush": a failing board disk/volume must
                # degrade to stdout-only, never kill the training it narrates
                from .. import chaos
                chaos.maybe_fail("board.flush", path=self.board_path)
                self._fh.write(stamped + "\n")
                self._fh.flush()
            except Exception as e:  # noqa: BLE001 - board is observability
                print(f"board write failed ({e}); continuing",
                      file=sys.stderr, flush=True)
        elif self._remote:
            with self._lock:
                self._lines.append(stamped)
                overflow = len(self._lines) - max(self._max_lines, 1)
                if overflow > 0:
                    # the remote board is a whole-object rewrite: without a
                    # cap a 50k-epoch job turns every line into a multi-MB
                    # PUT.  Drop the OLDEST lines (they already reached
                    # stdout and the journal) and say so — once — through
                    # the journal and stderr.
                    del self._lines[:overflow]
                    self._truncated += overflow
                    if not self._warned:
                        self._warned = True
                        try:
                            from .. import obs
                            obs.event("board_truncated",
                                      path=self.board_path,
                                      line_cap=self._max_lines)
                        except Exception:
                            pass
                        print(f"board line cap ({self._max_lines}) reached: "
                              f"older lines drop from the remote object "
                              f"(stdout and the run journal keep them)",
                              file=sys.stderr, flush=True)
                self._dirty = True
            self._maybe_flush_remote()

    def _maybe_flush_remote(self) -> None:
        """Rewrite the remote object now, or defer: lines arriving within
        `flush_seconds` of the previous rewrite batch into ONE deferred
        write (a daemon timer) instead of one PUT per line."""
        with self._lock:
            if not self._dirty:
                return
            wait = self._flush_seconds - (time.monotonic() - self._last_flush)
            if wait > 0:
                if self._timer is None:
                    self._timer = threading.Timer(wait, self._timer_fire)
                    self._timer.daemon = True
                    self._timer.start()
                return
            lines = list(self._lines)
            truncated = self._truncated
            self._gen += 1
            gen = self._gen
            self._dirty = False
            self._last_flush = time.monotonic()
        self._write_remote(lines, truncated, gen)

    def _timer_fire(self) -> None:
        with self._lock:
            self._timer = None
        self._maybe_flush_remote()

    def _write_remote(self, lines: list, truncated: int, gen: int) -> None:
        # whole-object rewrite: appends don't exist on object stores —
        # best-effort, the lines already reached stdout.  PUTs are
        # serialized under _io_lock and generation-guarded: a slow write
        # overlapping a newer one (timer thread vs direct flush) must not
        # land LAST and regress the object to an older snapshot — the
        # stale generation is simply skipped.
        if truncated:
            lines = [f"[... {truncated} earlier lines dropped "
                     f"(board line cap {self._max_lines}) ...]"] + lines
        with self._io_lock:
            if gen <= self._written_gen:
                return  # a newer snapshot already reached the store
            try:
                from .. import chaos
                chaos.maybe_fail("board.flush", path=self.board_path)
                from ..data import fsio
                fsio.write_bytes(self.board_path,
                                 ("\n".join(lines) + "\n").encode())
                self._written_gen = gen
            except Exception as e:  # noqa: BLE001 - board is observability
                print(f"board write failed ({e}); continuing",
                      file=sys.stderr, flush=True)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        if self._remote:
            with self._lock:
                timer, self._timer = self._timer, None
                lines = list(self._lines) if self._dirty else None
                truncated = self._truncated
                self._gen += 1
                gen = self._gen
                self._dirty = False
            if timer is not None:
                timer.cancel()
            if lines is not None:  # pending batched lines must not be lost
                self._write_remote(lines, truncated, gen)


def tail_board(board_path: str, from_start: bool = True,
               poll_seconds: float = 0.2):
    """Generator yielding board lines as they appear (the reference
    client's TailThread).  Local boards stream from
    the file handle; remote (gs:// hdfs:// mock://) boards poll the object
    through fsio and yield the delta — follow a running job from any
    machine that can read the job dir.  Stops when the board is removed;
    callers normally run it in a thread."""
    if _is_remote(board_path):
        yield from _tail_remote(board_path, from_start, poll_seconds)
        return
    while not os.path.exists(board_path):
        time.sleep(0.1)
    with open(board_path, "r") as f:
        if not from_start:
            f.seek(0, os.SEEK_END)
        while True:
            line = f.readline()
            if line:
                yield line.rstrip("\n")
            else:
                if not os.path.exists(board_path):
                    return
                time.sleep(poll_seconds)


_TRUNC_MARKER_RE = None  # compiled lazily (module import stays light)


def _parse_trunc_marker(line: str):
    """Dropped-line count from the board's truncation marker, or None."""
    global _TRUNC_MARKER_RE
    if _TRUNC_MARKER_RE is None:
        import re
        _TRUNC_MARKER_RE = re.compile(
            r"^\[\.\.\. (\d+) earlier lines dropped ")
    m = _TRUNC_MARKER_RE.match(line)
    return int(m.group(1)) if m else None


def _tail_remote(board_path: str, from_start: bool, poll_seconds: float):
    """Delta-tracking by ABSOLUTE line position (dropped + visible index),
    not raw index: once the board's retained-line cap engages, every
    rewrite drops the oldest line and prepends/updates a truncation
    marker, so the visible line count plateaus and a raw-index tail would
    stall forever (and the marker would shift every index by one)."""
    from ..data import fsio

    seen_abs = 0  # total board lines ever observed (dropped + yielded)
    first = True
    missing_grace = True
    while True:
        try:
            text = fsio.read_bytes(board_path).decode("utf-8", "replace")
            missing_grace = False
        except FileNotFoundError:
            if missing_grace:  # not yet written: keep waiting for the job
                time.sleep(poll_seconds)
                continue
            return  # existed once, now gone: the board was removed
        except Exception:
            time.sleep(poll_seconds)
            continue
        # the board rewrite is not atomic on every store: only count lines
        # up to the last newline, so a partially-written final line is
        # neither emitted truncated nor marked seen (it completes next poll)
        complete = text[:text.rfind("\n") + 1]
        lines = complete.splitlines()
        dropped = 0
        if lines:
            d = _parse_trunc_marker(lines[0])
            if d is not None:
                dropped = d
                lines = lines[1:]
        total = dropped + len(lines)
        if first and not from_start:
            seen_abs = total
        first = False
        start = max(seen_abs - dropped, 0)  # lines past the cap are gone
        for line in lines[start:]:
            yield line
        seen_abs = max(seen_abs, total)
        time.sleep(poll_seconds)
