"""Restart supervisor: failure detection and checkpoint-restart (the port's
copy of the single-host part of shifu_tpu/launcher/supervisor.py).

The training job runs as a child process, `python -m
shifu_tpu_torch.launcher.cli train ...`.  A child that exits nonzero (75
after a SIGTERM drain, or any failure) is restarted, and the checkpoint's
auto-resume continues from the last saved epoch; a child that stops making
progress (its console board stops growing for the liveness window) is
killed and restarted, the heartbeat analogue.  The restart budget bounds
consecutive failures without durable progress: progress is the epoch the
`PROGRESS` marker or the newest committed step records, so a resumed
attempt that saves an epoch resets the budget.  A child exiting
EXIT_TIMEOUT (3), or the job's own deadline, is terminal.  The journal
events are the JAX package's: `supervisor_start`, `supervisor_restart`,
`supervisor_liveness_kill`, `supervisor_timeout`, `supervisor_exhausted`,
`supervisor_done`.  The chaos site `supervisor.spawn` models a child that
cannot start.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from typing import Optional, Sequence

from ..data import fsio

# the job-timeout exit status (cli.EXIT_TIMEOUT, kept here so the
# supervisor never imports the CLI it launches); terminal: a restarted
# timed-out child would run the job forever in timeout-sized chunks
EXIT_TIMEOUT = 3

# set on supervised children (value: the spawning parent's pid):
# cli._arm_pdeathsig arms PR_SET_PDEATHSIG(SIGTERM), so an uncatchable
# supervisor death tears the attempt down instead of orphaning it
ENV_PDEATHSIG = "SHIFU_TPU_PDEATHSIG"

CHILD_MODULE = "shifu_tpu_torch.launcher.cli"


def _marker_epoch(ckpt_dir: str) -> int:
    """Epoch of the `PROGRESS` marker (-1 if absent or unreadable), local
    or remote (through fsio)."""
    from ..train.checkpoint import PROGRESS_MARKER
    try:
        if fsio.is_remote(ckpt_dir):
            raw = fsio.read_bytes(fsio.join(ckpt_dir, PROGRESS_MARKER))
        else:
            with open(os.path.join(ckpt_dir, PROGRESS_MARKER), "rb") as f:
                raw = f.read()
        return int(json.loads(raw).get("epoch", -1))
    except Exception:
        return -1


def _committed_step_epoch(ckpt_dir: str) -> int:
    """Epoch in the newest committed step tree's `extra.json` (-1 if none):
    an async save can land and the process die before the marker is
    written, so the step tree itself is the authority.  Step trees are
    renamed into place whole, so a digit-named directory is committed."""
    from ..train.checkpoint import EXTRA_FILE
    try:
        names = sorted((n for n in os.listdir(ckpt_dir) if n.isdigit()),
                       key=int, reverse=True)
    except OSError:
        return -1
    for name in names:
        try:
            with open(os.path.join(ckpt_dir, name, EXTRA_FILE)) as f:
                return int((json.load(f) or {}).get("epoch", -1))
        except (OSError, ValueError, AttributeError):
            continue
    return -1


def _committed_step_epoch_remote(ckpt_dir: str) -> int:
    """_committed_step_epoch for gs:// hdfs:// mock:// checkpoint dirs: one
    listing and small reads per probe.  A remote step tree is committed
    once its `extra.json` exists (the save writes it last).  Without this
    probe a remote-checkpoint job whose attempts each commit one async save
    before a kill (marker pending) would look like no progress and exhaust
    the restart budget."""
    from ..train.checkpoint import EXTRA_FILE
    try:
        from pyarrow import fs as pafs
        filesystem, fs_path = fsio._filesystem(ckpt_dir)
        base = fs_path.rstrip("/")
        infos = filesystem.get_file_info(
            pafs.FileSelector(base, recursive=False))
        steps = sorted((int(i.base_name) for i in infos
                        if i.type == pafs.FileType.Directory
                        and i.base_name.isdigit()), reverse=True)
        for s in steps:
            try:
                with filesystem.open_input_stream(
                        f"{base}/{s}/{EXTRA_FILE}") as f:
                    return int((json.loads(f.read()) or {}).get("epoch",
                                                                 -1))
            except Exception:
                continue  # uncommitted (no extra.json yet) or unreadable
    except Exception:
        return -1
    return -1


def checkpoint_progress(ckpt_dir: Optional[str]) -> int:
    """Durable progress of a checkpoint dir, local or remote: the larger
    of the `PROGRESS` marker's epoch and the newest committed step's (-1
    if neither).  The epoch, not the step: a mid-epoch resume replays its
    epoch, so a crash loop there would look like progress by steps."""
    if not ckpt_dir:
        return -1
    committed = (_committed_step_epoch_remote(ckpt_dir)
                 if fsio.is_remote(ckpt_dir)
                 else _committed_step_epoch(ckpt_dir))
    return max(_marker_epoch(ckpt_dir), committed)


class ProgressProbe:
    """Per-attempt durable-progress capture and compare."""

    def __init__(self, ckpt_dir: Optional[str]):
        self._dir = ckpt_dir
        self._mark = checkpoint_progress(ckpt_dir)

    def advanced(self) -> bool:
        return (self._dir is not None
                and checkpoint_progress(self._dir) > self._mark)


def charge_restart_budget(failures_since_progress: int, progressed: bool,
                          echo=None, what: str = "supervisor") -> int:
    """The budget bounds consecutive failures without durable progress,
    not lifetime restarts: a long job on preemptible capacity restarts
    many times, each resuming further; only a crash loop that persists
    nothing burns it.  Shared by both supervisors (`what` names which)."""
    if progressed:
        if failures_since_progress:
            msg = f"{what}: progress since last failure — restart budget reset"
            if echo is None:
                print(msg, flush=True)
            else:
                echo(msg)
        return 1
    return failures_since_progress + 1


def _telemetry_dir(board_path: Optional[str]) -> Optional[str]:
    """SHIFU_TPU_METRICS_DIR when set, else `<job dir>/telemetry`: the dir
    the train child writes, so restarts and epochs interleave in one
    journal (append-only JSONL tolerates two writers)."""
    from .. import obs
    d = obs.resolve_metrics_dir()
    if d:
        return d
    if not board_path:
        return None
    if fsio.is_remote(board_path):
        return fsio.join(board_path.rsplit("/", 1)[0], "telemetry")
    return os.path.join(os.path.dirname(os.path.abspath(board_path)),
                        "telemetry")


def _board_size(path: str) -> int:
    """The liveness monitor's progress signature, -1 when the board is
    missing: its size locally; on a remote job dir its size plus its
    mtime, since once the board's line cap engages a rewrite drops one
    line and adds one, and the size alone would stop moving."""
    try:
        if fsio.is_remote(path):
            size, mtime_ns = fsio.file_info(path)
            if size is None and mtime_ns is None:
                return -1
            return int(size or 0) + int(mtime_ns or 0)
        return os.path.getsize(path)
    except Exception:
        return -1


class JobDeadline:
    """One clock for the whole job, shared across attempts: a child
    re-derives a fresh per-attempt deadline it may never hit; the
    supervisor enforces this job-level one."""

    def __init__(self, timeout_seconds: float):
        self.seconds = timeout_seconds
        self._at = (time.monotonic() + timeout_seconds
                    if timeout_seconds > 0 else None)

    def expired(self) -> bool:
        return self._at is not None and time.monotonic() > self._at


class _Terminated(Exception):
    """A stop signal (SIGTERM, SIGHUP) reached the supervisor."""


def _raise_terminated(signum, frame):
    raise _Terminated()


def _kill_tree(proc: subprocess.Popen, sig: Optional[int] = None,
               grace_seconds: float = 5.0) -> None:
    """Signal the child's process group (it runs in its own session),
    escalating to SIGKILL after a grace window.  sig=None hard-kills at
    once (a hung tree); SIGTERM gives the train loop's drain a window to
    save."""
    def _pg(s: int) -> None:
        try:
            os.killpg(proc.pid, s)
        except (ProcessLookupError, PermissionError, OSError):
            try:
                proc.send_signal(s)
            except (ProcessLookupError, OSError):
                pass

    if sig is not None:
        _pg(sig)
        try:
            proc.wait(timeout=grace_seconds)
        except subprocess.TimeoutExpired:
            pass
    if proc.poll() is None:
        _pg(signal.SIGKILL)
    proc.wait()


def supervise(child_argv: Sequence[str],
              max_restarts: int = 2,
              board_path: Optional[str] = None,
              liveness_seconds: float = 0.0,
              poll_seconds: float = 0.5,
              python: Optional[str] = None,
              checkpoint_dir: Optional[str] = None,
              timeout_seconds: float = 0.0,
              module: str = CHILD_MODULE) -> int:
    """Run `python -m <module> <child_argv>` with restarts; returns the
    final exit code (0 on eventual success).

    A failed child is restarted while consecutive failures without durable
    progress stay within `max_restarts`.  With `liveness_seconds` > 0 a
    board that does not grow for that long (a missing board counts as no
    progress, so a child wedged before its first line is caught) marks the
    child hung: it is killed and the budget charged.  Size the window
    above start-up (CUDA init, the kernels' load) plus one epoch.
    `timeout_seconds` bounds the whole job; a child exiting EXIT_TIMEOUT
    and the supervisor's own deadline are terminal (exit 3)."""
    from .. import chaos, obs

    # the journal only (scrape=False): the child owns the scrape file.  A
    # local dir shares the child's journal (O_APPEND tolerates two
    # writers); a remote one gets a sidecar object, since a remote journal
    # is a whole-object rewrite of its writer's own lines
    tele_dir = _telemetry_dir(board_path)
    if tele_dir:
        obs.configure(tele_dir, scrape=False, flush_every=1,
                      journal_name=("journal-supervisor.jsonl"
                                    if fsio.is_remote(tele_dir)
                                    else "journal.jsonl"))
    obs.event("supervisor_start", max_restarts=max_restarts,
              liveness_seconds=liveness_seconds,
              timeout_seconds=timeout_seconds)
    python = python or sys.executable
    cmd = [python, "-m", module, *child_argv]
    attempts = 0
    failures_since_progress = 0
    deadline = JobDeadline(timeout_seconds)
    # the child runs in its own session, out of reach of group-wide
    # signals: a SIGTERM or SIGHUP to this parent is forwarded
    old_handlers: list[tuple[int, object]] = []
    try:
        for s in (signal.SIGTERM, signal.SIGHUP):
            if signal.getsignal(s) is signal.SIG_IGN:
                continue  # nohup'd: SIGHUP is ignored on purpose
            old_handlers.append((s, signal.signal(s, _raise_terminated)))
    except ValueError:  # not the main thread: no handlers, kills still work
        pass
    proc: Optional[subprocess.Popen] = None
    try:
        while True:
            if deadline.expired():
                print("supervisor: job timeout exceeded — terminal, "
                      "no restart", flush=True)
                obs.event("supervisor_timeout", attempts=attempts)
                return EXIT_TIMEOUT
            attempts += 1
            start = time.monotonic()
            probe = ProgressProbe(checkpoint_dir)
            child_env = dict(os.environ)
            child_env[ENV_PDEATHSIG] = str(os.getpid())
            spawn_cmd = cmd
            try:
                # chaos site "supervisor.spawn": a child that cannot even
                # start, modelled as a stub exiting with the fault's code
                chaos.maybe_fail("supervisor.spawn", attempt=attempts)
            except chaos.ChaosError as e:
                print(f"supervisor: chaos: attempt {attempts} spawn fails "
                      f"({e})", flush=True)
                spawn_cmd = [python, "-c",
                             f"import sys; sys.exit({int(e.exit_code)})"]
            proc = subprocess.Popen(spawn_cmd, start_new_session=True,
                                    env=child_env)
            last_size = -1
            last_progress = time.monotonic()
            killed_for_hang = False
            try:
                while True:
                    rc = proc.poll()
                    if rc is not None:
                        break
                    if deadline.expired():
                        print(f"supervisor: job timeout "
                              f"({timeout_seconds:.0f}s) exceeded — killing "
                              f"attempt {attempts}", flush=True)
                        obs.event("supervisor_timeout", attempt=attempts)
                        _kill_tree(proc, signal.SIGTERM)
                        return EXIT_TIMEOUT
                    if liveness_seconds > 0 and board_path:
                        size = _board_size(board_path)
                        if size != last_size:
                            last_size = size
                            last_progress = time.monotonic()
                        elif (time.monotonic() - last_progress
                                > liveness_seconds):
                            print(f"supervisor: no progress for "
                                  f"{liveness_seconds}s — killing attempt "
                                  f"{attempts}", flush=True)
                            obs.event("supervisor_liveness_kill",
                                      attempt=attempts,
                                      window_s=liveness_seconds)
                            _kill_tree(proc)  # hung: no grace
                            rc = -9
                            killed_for_hang = True
                            break
                    time.sleep(poll_seconds)
            except KeyboardInterrupt:
                # the child's own session detaches it from the terminal
                _kill_tree(proc, signal.SIGINT)
                raise
            if rc == 0:
                if attempts > 1:
                    print(f"supervisor: succeeded after {attempts} attempts",
                          flush=True)
                obs.event("supervisor_done", attempts=attempts)
                return 0
            if rc == EXIT_TIMEOUT:
                print(f"supervisor: attempt {attempts} hit the job timeout — "
                      "terminal, no restart", flush=True)
                return EXIT_TIMEOUT
            elapsed = time.monotonic() - start
            progressed = probe.advanced()
            failures_since_progress = charge_restart_budget(
                failures_since_progress, progressed)
            print(f"supervisor: attempt {attempts} exited rc={rc} "
                  f"after {elapsed:.1f}s"
                  + (" (liveness kill)" if killed_for_hang else ""),
                  flush=True)
            obs.event("supervisor_restart", attempt=attempts, rc=rc,
                      progressed=progressed,
                      liveness_kill=killed_for_hang,
                      elapsed_s=round(elapsed, 2))
            if failures_since_progress > max_restarts:
                print(f"supervisor: restart budget exhausted "
                      f"({max_restarts} restarts without progress)",
                      flush=True)
                obs.event("supervisor_exhausted", attempts=attempts, rc=rc)
                return rc if isinstance(rc, int) and rc > 0 else 1
    except _Terminated:
        print("supervisor: stop signal (SIGTERM/SIGHUP) — draining the job",
              flush=True)
        # a second signal must not abort the drain
        for s, _h in old_handlers:
            signal.signal(s, signal.SIG_IGN)
        if proc is not None and proc.poll() is None:
            # the child's drain saves a final checkpoint before it exits
            _kill_tree(proc, signal.SIGTERM, grace_seconds=15.0)
        return 143
    finally:
        for s, h in old_handlers:
            signal.signal(s, h)
