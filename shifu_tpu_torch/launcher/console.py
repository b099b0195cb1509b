"""Console board: progress lines to stdout and an append-only board file
(the port's copy of the local half of shifu_tpu/launcher/console.py).

Every line goes to stdout at once, stamped, and is appended (and flushed)
to the board file, which an external tail, or the supervisor's liveness
monitor, follows.  A board write that fails (the chaos site `board.flush`
models it) degrades to stdout only: the board never kills the training it
narrates.  A remote board (gs://, hdfs://: the JAX package rewrites the
object) waits for the remote half of data/fsio.py, ROADMAP.md queue A
item (a)4, and raises.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Iterator, Optional

from ..data import fsio


class ConsoleBoard:
    def __init__(self, board_path: Optional[str] = None, echo: bool = True):
        self.board_path = board_path
        self.echo = echo
        self._fh = None
        if board_path:
            fsio._local_only(board_path)
            os.makedirs(os.path.dirname(os.path.abspath(board_path)),
                        exist_ok=True)
            self._fh = open(board_path, "a", buffering=1)

    def __call__(self, line: str) -> None:
        stamped = f"[{time.strftime('%Y-%m-%d %H:%M:%S')}] {line}"
        if self.echo:
            print(stamped, flush=True)
        if self._fh is not None:
            try:
                from .. import chaos
                chaos.maybe_fail("board.flush", path=self.board_path)
                self._fh.write(stamped + "\n")
                self._fh.flush()
            except Exception as e:  # noqa: BLE001 - board is observability
                print(f"board write failed ({e}); continuing",
                      file=sys.stderr, flush=True)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def tail_board(board_path: str, from_start: bool = True,
               poll_seconds: float = 0.2) -> Iterator[str]:
    """Generator yielding board lines as they appear (the reference
    client's TailThread).  Waits for the board to exist; stops when it is
    removed."""
    fsio._local_only(board_path)
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
