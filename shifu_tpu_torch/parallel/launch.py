"""The local rank spawner behind `train --devices N` and a `shifu.mesh.*`
mesh of N devices.

The JAX package drives every device of a host from one process; the port
runs one process per device, as torch does, so the dispatcher starts N
ranks of the same command, each with the environment contract of
`parallel/distributed.py` (a coordinator on 127.0.0.1 at a free port, the
world size and its rank), and waits for them:
- rank 0 writes to this process's stdout; the other ranks' stdout is
  dropped (they print nothing: only the chief speaks) and their stderr
  kept;
- the first rank to fail tears the others down (SIGTERM, then SIGKILL
  after a grace: the drain's, when it exited 75 from a drain, else a
  second), and its exit code is the gang's;
- a SIGTERM or SIGHUP to the dispatcher is forwarded to every rank, which
  drain as one (train/loop.py agrees on the drain over the mesh);
- each rank dies with the dispatcher (supervisor.ENV_PDEATHSIG), so a
  `--supervise` restart, which kills the dispatcher's session, takes the
  whole gang down and starts a new one.

A pod's host with several cards runs its ranks the same way, as part of
the pod's group: the pod's coordinator, its world, and ranks numbered
from host * cards (launcher/cli.py).
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import time
from typing import Callable, Optional, Sequence

from . import distributed

CHILD_MODULE = "shifu_tpu_torch.launcher.cli"
PREEMPTED_EXIT = 75  # train/loop.py's SIGTERM drain
DRAIN_GRACE_S = 10.0  # the others' time to finish a drain's save
CRASH_GRACE_S = 1.0   # after a crash they have nothing left to save
POLL_S = 0.2


def free_port(host: str = "127.0.0.1") -> int:
    """A TCP port that was free a moment ago on `host`."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def _signal(procs: Sequence[subprocess.Popen], sig: int) -> None:
    for p in procs:
        if p.poll() is None:
            try:
                p.send_signal(sig)
            except OSError:
                pass


def _stop(procs: Sequence[subprocess.Popen], sig: int,
          grace_seconds: float) -> None:
    _signal(procs, sig)
    deadline = time.monotonic() + grace_seconds
    for p in procs:
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 0.0))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def spawn_ranks(argv_for_rank: Callable[[int], list[str]],
                count: int, coordinator: Optional[str] = None,
                world: Optional[int] = None, first_rank: int = 0) -> int:
    """Run `python -m shifu_tpu_torch.launcher.cli <argv_for_rank(i)>` for
    i in [0, count) as one gang, ranks first_rank + i of a group of
    `world` (default `count`) at `coordinator` (default a free port on
    127.0.0.1); returns 0 when every rank exits 0, else the first failed
    rank's exit code (module docstring)."""
    from ..launcher.supervisor import ENV_PDEATHSIG

    coordinator = coordinator or f"127.0.0.1:{free_port()}"
    world = count if world is None else world
    procs: list[subprocess.Popen] = []

    old = []
    try:
        for s in (signal.SIGTERM, signal.SIGHUP):
            old.append((s, signal.signal(
                s, lambda signum, _frame: _signal(procs, signum))))
    except ValueError:  # not the main thread: no forwarding
        pass
    try:
        for i in range(count):
            env = dict(os.environ)
            env[distributed.ENV_COORDINATOR] = coordinator
            env[distributed.ENV_NUM_PROCESSES] = str(world)
            env[distributed.ENV_PROCESS_ID] = str(first_rank + i)
            env[ENV_PDEATHSIG] = f"{os.getpid()}:{int(signal.SIGKILL)}"
            procs.append(subprocess.Popen(
                [sys.executable, "-m", CHILD_MODULE, *argv_for_rank(i)],
                env=env,
                stdout=None if i == 0 else subprocess.DEVNULL))
        while True:
            codes = [p.poll() for p in procs]
            failed = [c for c in codes if c not in (None, 0)]
            if failed:
                # the first failure ends the gang: the others would wait
                # in their next collective for a rank that is gone
                _stop(procs, signal.SIGTERM,
                      DRAIN_GRACE_S if failed[0] == PREEMPTED_EXIT
                      else CRASH_GRACE_S)
                return failed[0]
            if all(c == 0 for c in codes):
                return 0
            time.sleep(POLL_S)
    finally:
        _stop(procs, signal.SIGKILL, 0.0)
        for s, h in old:
            signal.signal(s, h)
