"""Chaos plane: declarative, deterministic, journaled fault injection (the
port's copy of shifu_tpu/chaos/__init__.py).

Production code carries explicit probes — ``chaos.maybe_fail("site.name",
**context)`` — at the places faults actually happen in the field.  The
port's sites sit where their JAX twins do: `launcher.start` and
`train.epoch` (launcher/cli.py), `supervisor.spawn`
(launcher/supervisor.py), `board.flush` (launcher/console.py),
`train.epoch_start` and `train.chunk` (train/loop.py), `checkpoint.save`,
`checkpoint.post_save` and `checkpoint.restore` (train/checkpoint.py),
`data.cache` (data/cache.py), `data.feeder` (data/pipeline.py),
`fsio.read_bytes`, `fsio.write_bytes` and `fsio.list_files`
(data/fsio.py, on its remote branch), `journal.flush` (obs/journal.py),
`runtime.serve` and `runtime.serve.dispatch` (runtime/serve.py),
`embed.offload` (embed/tiering.py), and the fleet's `fleet.heartbeat`,
`fleet.lease` and `fleet.sync` (runtime/fleet.py; the last two take a
`member`-targeted fault) and `fleet.route` (runtime/router.py).  A probe
is a no-op until a chaos plan (chaos/plan.py) is active, so the cost in a
healthy run is one attribute check.

When a plan is active every probe call is counted per site, triggers are
evaluated deterministically (call counts, epoch context, rank, or a
seed+counter-hashed coin), and an injected fault is journaled through obs
(`chaos_inject` events + the `chaos_injected_total` counter) before the
action runs — so a chaos drill's injections can be replayed and audited
against what the system recovered from.

The successor of the reference's commented-out PS-killer
(yarn/util/CommonUtils.java:265-274) and of the four ad-hoc
SHIFU_TPU_FAULT_* env hooks this subsumed (they still work — the plan
loader synthesizes equivalent faults from them).
"""

from __future__ import annotations

import fnmatch
import hashlib
import json
import os
import threading
import time
from typing import Callable, Optional

from .plan import (ENV_CHAOS_PLAN, ENV_CHAOS_STATE, ChaosPlan,  # noqa: F401
                   ChaosPlanError, FaultSpec, load_plan, load_plan_env,
                   parse_plan, plan_from_legacy_env)


class ChaosError(OSError):
    """An injected failure.  An OSError subclass on purpose: probes sit at
    I/O boundaries, and the surrounding retry/fallback machinery must treat
    an injected fault exactly like the real error it models."""

    def __init__(self, message: str, exit_code: int = 17):
        super().__init__(message)
        self.exit_code = exit_code


_lock = threading.RLock()
# set while an injection journals itself: a probe reached from there (the
# journal's flush, the scrape file's fsio write) is a no-op, not a
# recursion into another injection
_tls = threading.local()
_plan: Optional[ChaosPlan] = None
_loaded = False          # env probed at least once (negative result cached)
_calls: dict = {}        # site -> process-local probe call count
_fires: dict = {}        # fault key -> process-local injection count


def configure(plan: Optional[ChaosPlan]) -> None:
    """Install a plan directly (tests, library callers)."""
    global _plan, _loaded
    with _lock:
        _plan = plan
        _loaded = True
        _calls.clear()
        _fires.clear()


def reload_from_env() -> Optional[ChaosPlan]:
    """(Re)load the plan from SHIFU_TPU_CHAOS_PLAN + legacy env hooks —
    called by the CLI after it exports the env so probes in this process
    see the plan too.  A malformed plan raises ChaosPlanError here, at
    launch, never from a probe mid-run."""
    configure(load_plan_env())
    return _plan


def reset_for_tests() -> None:
    global _plan, _loaded
    with _lock:
        _plan = None
        _loaded = False
        _calls.clear()
        _fires.clear()


def active_plan() -> Optional[ChaosPlan]:
    _ensure_loaded()
    return _plan


def _ensure_loaded() -> None:
    global _loaded
    if _loaded:
        return
    with _lock:
        if _loaded:
            return
        try:
            reload_from_env()
        except ChaosPlanError:
            # a probe must never crash the job on a bad plan; the CLI's
            # explicit reload_from_env surfaces the error at launch
            configure(None)


def _rank() -> int:
    try:
        return int(os.environ.get("SHIFU_TPU_PROCESS_ID", "0"))
    except ValueError:
        return 0


def _coin(seed: int, site: str, call_n: int) -> float:
    """Deterministic uniform [0,1): a pure function of (seed, site, call
    number), so the same plan + seed yields the identical injection
    sequence on every replay."""
    h = hashlib.blake2b(f"{seed}:{site}:{call_n}".encode(),
                        digest_size=8).digest()
    return int.from_bytes(h, "big") / float(1 << 64)


# --- job-scoped counter persistence ---------------------------------------
# Sites with scope="job" faults count calls/fires across supervised process
# restarts via a small JSON state file (SHIFU_TPU_CHAOS_STATE, pointed into
# the job dir by the CLI) — "the first checkpoint restore of the JOB fails"
# is only expressible with a counter that survives the restart.

def _state_path() -> Optional[str]:
    return os.environ.get(ENV_CHAOS_STATE) or None


class _StateFileLock:
    """Cross-PROCESS mutex for the job-scoped state file: gang ranks and
    supervisor attempts on one machine read-modify-write the same counters,
    and the module RLock only covers threads of this process.  flock on a
    sidecar `.lock` (advisory, released on close/exit — a crashed holder
    never wedges the job).  Best-effort: where flock is unavailable the
    counters degrade to last-writer-wins, never to a crash."""

    def __init__(self, path: str):
        self._path = f"{path}.lock"
        self._fd: Optional[int] = None

    def __enter__(self):
        try:
            import fcntl
            self._fd = os.open(self._path, os.O_CREAT | os.O_RDWR, 0o644)
            fcntl.flock(self._fd, fcntl.LOCK_EX)
        except Exception:
            if self._fd is not None:
                try:
                    os.close(self._fd)
                except OSError:
                    pass
                self._fd = None
        return self

    def __exit__(self, *exc):
        if self._fd is not None:
            try:
                import fcntl
                fcntl.flock(self._fd, fcntl.LOCK_UN)
            except Exception:
                pass
            try:
                os.close(self._fd)
            except OSError:
                pass
            self._fd = None
        return False


def _load_state(path: str) -> dict:
    try:
        with open(path) as f:
            st = json.load(f)
        if isinstance(st, dict):
            st.setdefault("calls", {})
            st.setdefault("fires", {})
            return st
    except (OSError, ValueError):
        pass
    return {"calls": {}, "fires": {}}


def _save_state(path: str, state: dict) -> None:
    try:
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(state, f)
        os.replace(tmp, path)
    except OSError:
        pass  # best-effort: chaos must not fail on its own bookkeeping


def _matches(spec: FaultSpec, site: str) -> bool:
    return spec.site == site or fnmatch.fnmatchcase(site, spec.site)


def _triggered(spec: FaultSpec, call_n: int, seed: int, site: str,
               epoch: Optional[int],
               member: Optional[str] = None) -> bool:
    if spec.rank >= 0 and _rank() != spec.rank:
        return False
    if spec.member and (member is None or not fnmatch.fnmatchcase(
            str(member), spec.member)):
        # member-targeted fault (fleet.lease / fleet.sync drills): only
        # the named member's probes fire, its peers beat/sync untouched
        return False
    if spec.at_epoch >= 0 and (epoch is None or int(epoch) != spec.at_epoch):
        return False
    if spec.before_epoch >= 0 and (epoch is None
                                   or int(epoch) >= spec.before_epoch):
        return False
    # call-count triggers AND epoch triggers must all hold when both are
    # set; a fault with ONLY epoch/rank conditions fires whenever they hold
    if spec.at_call > 0 and call_n != spec.at_call:
        return False
    if spec.every > 0 and call_n % spec.every != 0:
        return False
    if spec.prob > 0.0 and _coin(seed, site, call_n) >= spec.prob:
        return False
    return True


def maybe_fail(site: str, echo: Optional[Callable[[str], None]] = None,
               **ctx) -> None:
    """The chaos probe.  No-op without an active plan.  With one: count
    this call, evaluate each fault in plan order, and run the FIRST
    matching fault's action (journaling the injection first).  `ctx`
    carries site-specific context — ``epoch`` feeds the epoch triggers,
    ``path`` is the file tree a ``corrupt`` action mutates; everything is
    journaled with the injection."""
    _ensure_loaded()
    plan = _plan
    if plan is None or not plan.faults or getattr(_tls, "journaling", False):
        return
    candidates = [(i, f) for i, f in enumerate(plan.faults)
                  if _matches(f, site)]
    if not candidates:
        return
    epoch = ctx.get("epoch")
    job_scoped = any(f.scope == "job" for _i, f in candidates)
    state_path = _state_path() if job_scoped else None

    def decide(state: Optional[dict]):
        if state is not None:
            # ONE call counter per site: the job-scoped count is the
            # authority when any job fault watches this site (a process
            # counter alongside would make at_call ambiguous across specs)
            call_n = int(state["calls"].get(site, 0)) + 1
            state["calls"][site] = call_n
        else:
            call_n = _calls.get(site, 0) + 1
            _calls[site] = call_n
        for idx, spec in candidates:
            key = f"{spec.site}#{idx}"
            if spec.scope == "job" and state is not None:
                n_fired = int(state["fires"].get(key, 0))
            else:
                n_fired = _fires.get(key, 0)
            if spec.max_times > 0 and n_fired >= spec.max_times:
                continue
            if not _triggered(spec, call_n, plan.seed, site, epoch,
                              member=ctx.get("member")):
                continue
            if spec.scope == "job" and state is not None:
                state["fires"][key] = n_fired + 1
            else:
                _fires[key] = n_fired + 1
            return spec, call_n
        return None, call_n

    with _lock:
        if state_path:
            # the flock spans the WHOLE read-decide-write: concurrent gang
            # ranks must each observe a distinct call number, or at_call /
            # max_times fire twice (or never) and the drill loses its
            # determinism
            with _StateFileLock(state_path):
                state = _load_state(state_path)
                spec, call_n = decide(state)
                _save_state(state_path, state)
        else:
            spec, call_n = decide(None)
    if spec is None:
        return
    _inject(site, spec, call_n, echo, ctx)


def _inject(site: str, spec: FaultSpec, call_n: int,
            echo: Optional[Callable[[str], None]], ctx: dict) -> None:
    msg = spec.message or f"chaos injection at {site} (call {call_n})"
    fmt = {"site": site, "call": call_n, "rank": _rank()}
    fmt.update(ctx)
    try:
        msg = msg.format(**fmt)
    except Exception:
        pass  # a message with unknown fields still injects
    # journal BEFORE the action: an `exit` action never returns, and the
    # injection record is what an audit replays against
    _tls.journaling = True
    try:
        from .. import obs
        obs.counter("chaos_injected_total",
                    "chaos faults injected").inc(site=site,
                                                 action=spec.action)
        fields = {k: v for k, v in ctx.items()
                  if isinstance(v, (int, float, str, bool, type(None)))}
        obs.event("chaos_inject", site=site, action=spec.action,
                  call=call_n, rank=_rank(), **fields)
        obs.flush()  # the process may be about to die — make it durable
    except Exception:
        pass
    finally:
        _tls.journaling = False
    if echo is not None:
        try:
            echo(msg)
        except Exception:
            pass
    else:
        print(msg, flush=True)
    if spec.action == "raise":
        raise ChaosError(msg, exit_code=spec.exit_code)
    if spec.action == "exit":
        os._exit(spec.exit_code)
    if spec.action == "hang":
        while True:
            time.sleep(3600)
    if spec.action == "delay":
        # a slowdown, not a failure: the probe returns normally after the
        # sleep — latency monitors (serving SLO burn rates, the flight
        # recorder's anomaly z-score) are what a delay drill exercises
        time.sleep(spec.delay_s)
        return
    if spec.action == "corrupt":
        path = ctx.get("path")
        if path:
            _corrupt_tree(str(path), site)


def _corrupt_tree(path: str, site: str) -> None:
    """Deterministically damage one file under `path` (or `path` itself):
    the LARGEST file (ties broken by name) gets its middle byte flipped —
    a digest-detectable, restore-breaking mutation that models silent
    storage corruption.  Local paths and fsio-remote trees both work."""
    try:
        from ..data import fsio
        remote = fsio.is_remote(path)
        files = [(p, s) for p, s in fsio.walk_files(path) if s > 0]
        if not files:
            return
        target, size = sorted(files, key=lambda t: (-t[1], t[0]))[0]
        off = size // 2
        if remote:
            data = bytearray(fsio.read_bytes(target))
            data[off] ^= 0xFF
            fsio.write_bytes(target, bytes(data))
        else:
            with open(target, "r+b") as f:
                f.seek(off)
                b = f.read(1)
                f.seek(off)
                f.write(bytes([b[0] ^ 0xFF]))
        try:
            from .. import obs
            obs.event("chaos_corrupt", site=site, file=target,
                      offset=int(off), size=int(size))
            obs.flush()
        except Exception:
            pass
    except Exception:
        pass  # corruption is best-effort; the drill asserts on outcomes
