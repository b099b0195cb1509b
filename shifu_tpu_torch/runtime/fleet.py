"""The serving fleet on one host (port of shifu_tpu/runtime/fleet.py):
lease membership on shared storage, hot-standby failover, placement on
hosts, atomic artifact sync, the fleet-wide swap and the burn-rate scale
loop.

The production form of the reference ApplicationMaster's container
supervision (it placed containers across hosts, heartbeated N workers and
promoted pre-warmed hot-standby backups on a failure).  The unit is the
scoring daemon (runtime/serve.py); the fleet adds:

- **membership through leases** on shared storage: every member runs a
  `Heartbeat` that writes a small lease file into its telemetry dir each
  beat (through data/fsio, so a remote fleet root works as a local one
  does; the `fleet.heartbeat` and `fleet.lease` chaos probes silence a
  member without killing it).  A lease older than its TTL marks the
  member DOWN whichever host can see whom.  The monitor journals
  `fleet_failover` as it promotes a hot standby, one on ANOTHER host than
  the victim's where there is one.  The split-brain guard: a member whose
  lease comes back REJOINS AS A STANDBY (`fleet_rejoin`), never into a
  slot its replacement already serves.
- **the host plane**: `HostPlane` places members on the hosts of
  launcher/pod.py's grammar (`local:N` simulated hosts, or an ssh host
  list); failover replenishment and `scale_tick` spawn and retire through
  the same placement.
- **the fleet-wide swap with atomic artifact sync**: the exporter writes
  the artifact and a blake2b manifest; each HOST pulls once, verifies the
  digests, renames the copy into its local cache in one step, and only
  then do that host's members swap.  A torn or corrupt pull quarantines
  the member (`fleet_swap_degraded`; the old version keeps serving) and
  the monitor pulls again; once the barrier is set the router refuses
  members behind the target generation, so no request is served by a
  stale version past it.  Every member's application is journaled
  (`fleet_member_swap`), and `fleet-verify` audits that each swap reached
  each live member exactly once.
- **the scale loop**: `decide_scale` promotes or spawns a member when the
  worst member burns its SLO budget at or above the up threshold on both
  windows, and retires one when every member is at or below the down
  threshold on both, journaling `fleet_scale`.

The routing front end (consistent ring, hedged retry, overload shedding,
reconnect backoff) is runtime/router.py; the `fleet` command drives both.

Members score on `device` (default `cuda:0`; the CPU only when asked).
They are in-process by default (`FleetMember`: a ScoringDaemon with its
own loopback wire server), or real `serve` children (`ProcessMember`,
`python -m shifu_tpu_torch.launcher.cli serve ... --device <device>`,
torn down through launcher/supervisor._kill_tree).  Unlike the JAX
manager, which builds in-process members whatever `member_mode` says,
this one honours it: "process" spawns children (placed through the host
plane's transport where there is one), "auto" spawns them over ssh only.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import time
from typing import TYPE_CHECKING, Callable, Optional

from ..config.schema import FleetConfig, ServingConfig
from ..data import fsio

if TYPE_CHECKING:
    from ..device import DeviceLike

# the heartbeat probe: every beat passes here, so a chaos plan can
# silence a member's lease (a partition, a wedged reporter) without
# touching its scoring path: the manager must then mark it DOWN and fail
# over although the daemon still answers
HEARTBEAT_SITE = "fleet.heartbeat"
# the lease-WRITE probe: fires inside write_lease itself, member-targeted
# (`"member": "member-1"` in the fault spec): one member's lease
# blackholed, the storage-level sibling of fleet.heartbeat
LEASE_SITE = "fleet.lease"
# the artifact-sync probe: fires between a host's pull and its digest
# check; a `corrupt` action models silent storage damage to the synced
# copy, `raise` a torn pull
SYNC_SITE = "fleet.sync"
LEASE_FILE = "lease.json"
MANIFEST_FILE = "sync_manifest.json"
# host identity a process-mode member stamps into its lease (the host
# plane exports it to its `serve` children)
ENV_FLEET_HOST = "SHIFU_TPU_FLEET_HOST"


# -- leases ----------------------------------------------------------------


def write_lease(lease_dir: str, member_id: str, seq: int,
                ttl_s: float, pid: Optional[int] = None,
                host: Optional[str] = None) -> str:
    """Atomically write `<lease_dir>/lease.json`, the membership beat.
    `ttl_s` rides in the lease, so any reader (serving_rollup, `top`)
    knows this member's own staleness bound; `host` rides along so the
    fleet view can group members by placement.  Through data/fsio: a
    remote lease dir gets the same no-torn-reads publish as a local one
    (fsio.write_bytes_atomic)."""
    from .. import chaos
    chaos.maybe_fail(LEASE_SITE, member=member_id, path=lease_dir)
    path = fsio.join(lease_dir, LEASE_FILE)
    rec = {"member": member_id, "ts": round(time.time(), 3),
           "seq": int(seq), "ttl_s": round(float(ttl_s), 3),
           "pid": int(pid if pid is not None else os.getpid())}
    if host is None:
        host = os.environ.get(ENV_FLEET_HOST) or None
    if host:
        rec["host"] = str(host)
    if not fsio.is_remote(lease_dir):
        os.makedirs(lease_dir, exist_ok=True)
    fsio.write_bytes_atomic(path, json.dumps(rec).encode())
    return path


def read_lease(lease_dir: str) -> Optional[dict]:
    """Tolerant lease read: a torn, garbage, absent or unreachable lease
    is None, never an exception (the monitor treats unreadable as stale).
    Remote lease dirs go through data/fsio."""
    try:
        path = fsio.join(lease_dir, LEASE_FILE)
        if fsio.is_remote(path):
            rec = json.loads(fsio.read_bytes(path).decode())
        else:
            with open(path) as f:
                rec = json.load(f)
        return rec if isinstance(rec, dict) else None
    except Exception:
        return None


def lease_age_s(lease: Optional[dict],
                now: Optional[float] = None) -> Optional[float]:
    if not lease or not isinstance(lease.get("ts"), (int, float)):
        return None
    return max(0.0, (time.time() if now is None else now)
               - float(lease["ts"]))


class Heartbeat:
    """One member's lease writer: beats every `every_s` through the
    `fleet.heartbeat` chaos probe.  An injected fault SKIPS the beat (the
    lease ages, as a partitioned or wedged member's does); the thread
    itself never dies of it."""

    def __init__(self, lease_dir: str, member_id: str, every_s: float,
                 ttl_s: float,
                 is_alive: Optional[Callable[[], bool]] = None,
                 host: Optional[str] = None):
        self._dir = lease_dir
        self._member_id = member_id
        self._every_s = every_s
        self._ttl_s = ttl_s
        self._is_alive = is_alive or (lambda: True)
        self._host = host
        self._stop = threading.Event()
        self._seq = 0
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "Heartbeat":
        self.beat()  # the first lease lands at once: a member is never
        #              seen lease-less between spawn and its first tick
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"fleet-heartbeat-{self._member_id}")
        self._thread.start()
        return self

    def stop(self) -> None:
        """Abrupt: no farewell beat, so a killed member's lease AGES."""
        self._stop.set()

    def beat(self) -> bool:
        from .. import chaos
        try:
            chaos.maybe_fail(HEARTBEAT_SITE, member=self._member_id)
            self._seq += 1
            write_lease(self._dir, self._member_id, self._seq,
                        self._ttl_s, host=self._host)
            return True
        except Exception:
            # chaos (or a full or read-only disk) silenced this beat: the
            # lease ages and the manager decides; the thread lives on to
            # beat again once the fault clears
            return False

    def _loop(self) -> None:
        while not self._stop.wait(self._every_s):
            if not self._is_alive():
                return
            self.beat()


# -- atomic artifact sync --------------------------------------------------


class SyncError(OSError):
    """An artifact pull that cannot be trusted: a torn copy, a digest
    mismatch, an unreadable manifest.  An OSError, so the degraded-swap
    handling treats it as any other I/O failure: the OLD version keeps
    serving."""


def write_sync_manifest(export_dir: str) -> str:
    """Write `<export_dir>/sync_manifest.json`: a blake2b-16 digest per
    file, the manifest itself excluded; returns its path.  The exporter
    calls it last; each host checks its pull against it.  Raises on any
    failure (unlike the JAX exporter, which swallows it)."""
    prefix = (export_dir.rstrip("/") + "/" if fsio.is_remote(export_dir)
              else export_dir.rstrip(os.sep) + os.sep)
    files = {}
    for path, _size in fsio.walk_files(export_dir):
        rel = path[len(prefix):] if path.startswith(prefix) else path
        if rel == MANIFEST_FILE or rel.endswith("/" + MANIFEST_FILE):
            continue
        digest = hashlib.blake2b(fsio.read_bytes(path),
                                 digest_size=16).hexdigest()
        files[rel.replace(os.sep, "/")] = digest
    manifest = {"algo": "blake2b-16", "files": files}
    path = fsio.join(export_dir, MANIFEST_FILE)
    fsio.write_bytes_atomic(path, json.dumps(manifest, indent=2,
                                             sort_keys=True).encode())
    return path


def read_sync_manifest(export_dir: str) -> Optional[dict]:
    """The manifest of `export_dir`, or None when it is missing or
    unreadable."""
    try:
        raw = fsio.read_bytes(fsio.join(export_dir, MANIFEST_FILE))
        rec = json.loads(raw.decode())
        if isinstance(rec, dict) and isinstance(rec.get("files"), dict):
            return rec
    except Exception:
        pass
    return None


def sync_artifact(src: str, cache_dir: str, generation: int, *,
                  host: str = "", member: str = "") -> str:
    """Pull `src` into `<cache_dir>/gen-NNNNNN` with the torn/corrupt
    guard: copy into a staging dir, check every file's digest against
    the exporter's manifest, then one `os.rename` publishes the whole
    tree, so a reader sees the complete verified artifact or nothing.  A
    generation already published returns its path untouched.  Raises
    SyncError (staging removed) on any mismatch."""
    import shutil

    from .. import chaos

    dest = os.path.join(cache_dir, f"gen-{int(generation):06d}")
    if os.path.isdir(dest):
        return dest
    manifest = read_sync_manifest(src)
    if manifest is None:
        # no manifest (a bare dir): build one at the source, so every
        # host checks against the SAME digests
        try:
            write_sync_manifest(src)
        except Exception as e:
            raise SyncError(f"sync {src}: cannot write manifest: {e}")
        manifest = read_sync_manifest(src)
        if manifest is None:
            raise SyncError(f"sync {src}: unreadable manifest")
    staging = f"{dest}.incoming.{os.getpid()}"
    try:
        os.makedirs(staging, exist_ok=True)
        for rel in manifest["files"]:
            data = fsio.read_bytes(fsio.join(src, rel))
            local = os.path.join(staging, rel.replace("/", os.sep))
            os.makedirs(os.path.dirname(local), exist_ok=True)
            with open(local, "wb") as f:
                f.write(data)
        # the drill hook sits between pull and check: a `corrupt` here is
        # silent storage damage the digest check below must catch
        chaos.maybe_fail(SYNC_SITE, member=member, host=host,
                         path=staging, generation=int(generation))
        for rel, want in manifest["files"].items():
            local = os.path.join(staging, rel.replace("/", os.sep))
            with open(local, "rb") as f:
                got = hashlib.blake2b(f.read(),
                                      digest_size=16).hexdigest()
            if got != want:
                raise SyncError(
                    f"sync {src}: digest mismatch on {rel!r} "
                    f"(want {want[:12]}, got {got[:12]})")
        try:
            os.rename(staging, dest)  # the atomic publish
        except OSError:
            if os.path.isdir(dest):   # a concurrent pull won the rename
                shutil.rmtree(staging, ignore_errors=True)
                return dest
            raise
    except SyncError:
        shutil.rmtree(staging, ignore_errors=True)
        raise
    except Exception as e:
        shutil.rmtree(staging, ignore_errors=True)
        raise SyncError(f"sync {src}: {type(e).__name__}: {e}")
    try:
        from .. import obs
        obs.event("fleet_sync", path=src, dest=dest, host=host,
                  generation=int(generation),
                  files=len(manifest["files"]))
    except Exception:
        pass
    return dest


# -- the host plane --------------------------------------------------------


class HostPlane:
    """Member placement across hosts on launcher/pod.py's grammar:
    `local:N` gives N simulated hosts (`local-0` .. `local-N-1`: members
    tagged with a host id), a comma or @file host list gives ssh hosts.
    Placement is least-loaded, ties broken by host order, so a fixed
    config places deterministically (a drill can kill "the host member-1
    landed on" by name)."""

    def __init__(self, hosts: str, root_dir: str):
        from ..launcher import pod

        self.spec = pod.parse_hosts(hosts)
        if self.spec.transport == "local":
            self.host_ids = tuple(f"local-{i}"
                                  for i in range(len(self.spec.hosts)))
        else:
            self.host_ids = tuple(self.spec.hosts)
        self._root = root_dir
        self._load: dict[str, int] = {h: 0 for h in self.host_ids}

    @property
    def n_hosts(self) -> int:
        return len(self.host_ids)

    def place(self) -> str:
        """Pick the least-loaded host (first wins ties) and count the
        slot against it."""
        host = min(self.host_ids, key=lambda h: self._load[h])
        self._load[host] += 1
        return host

    def release(self, host_id: str) -> None:
        if host_id in self._load and self._load[host_id] > 0:
            self._load[host_id] -= 1

    def cache_dir(self, host_id: str) -> str:
        """This host's local artifact cache, where `sync_artifact`
        publishes verified generations: a subdir per host id under the
        fleet root keeps simulated hosts' caches apart."""
        d = os.path.join(self._root, "sync", host_id)
        os.makedirs(d, exist_ok=True)
        return d

    def serve_command(self, host_id: str, serve_args: list,
                      env_contract: Optional[dict] = None):
        """(argv, env) to spawn one `serve` member on `host_id`, built by
        launcher/pod.member_command (a local child, or one over ssh)."""
        from ..launcher import pod

        rank = self.host_ids.index(host_id)
        contract = dict(env_contract or {})
        contract[ENV_FLEET_HOST] = host_id
        return pod.member_command(self.spec, rank, list(serve_args),
                                  contract)


# -- members ---------------------------------------------------------------

STATE_ACTIVE = "active"
STATE_STANDBY = "standby"
STATE_STALE = "stale"     # failed the fleet swap: out of rotation
STATE_DOWN = "down"
STATE_RETIRED = "retired"


class FleetMember:
    """One in-process scoring daemon under the fleet: its own
    ScoringDaemon (scoring on `device`) behind a loopback wire server,
    with a heartbeat lease.  `kill()` is the SIGKILL analogue of the
    drills: no drain, no farewell beat."""

    def __init__(self, member_id: str, export_dir: Optional[str], *,
                 serving: ServingConfig, fleet: FleetConfig,
                 tele_dir: str,
                 loader: Optional[Callable] = None,
                 model_id: str = "default",
                 host_id: str = "",
                 device: "DeviceLike" = None):
        from . import serve, serve_wire

        self.member_id = member_id
        self.tele_dir = tele_dir
        os.makedirs(tele_dir, exist_ok=True)
        self.state = STATE_STANDBY
        self.generation = 0
        self.export_dir = export_dir
        # which simulated or real host this member occupies ("" = no host
        # plane); not the wire bind, which is `self.host`
        self.host_id = host_id
        self._fleet = fleet
        # the daemon owns its registry, built on `loader` (the engines of
        # runtime/serve.load_engine on `device` by default) with the
        # bucket ladder pre-warmed
        self.daemon = serve.ScoringDaemon(
            export_dir, config=serving, loader=loader, device=device,
            model_id=model_id)
        self.daemon.start()
        self.server = serve_wire.ServeServer(
            self.daemon, host="127.0.0.1", port=0).start()
        self.host, self.port = self.server.host, self.server.port
        # the member's own journal holds its serve_start, so that `top`
        # over the member dirs renders each in-process member (and a dead
        # one DOWN off its aged lease); the daemon's events go to the
        # process's journal.  (JAX's in-process member dirs hold the
        # lease only.)
        from ..obs import journal as journal_mod
        handle = self.daemon._registry.current(model_id)
        own = journal_mod.RunJournal(
            os.path.join(tele_dir, journal_mod.JOURNAL_FILE))
        own.event("serve_start", path=export_dir, member=member_id,
                  host=host_id, engine=handle.engine_name if handle else None,
                  port=self.port, pid=os.getpid())
        own.close()
        self.heartbeat = Heartbeat(
            tele_dir, member_id, fleet.heartbeat_every_s,
            fleet.heartbeat_ttl_s,
            is_alive=lambda: self.daemon._running,
            host=host_id or None).start()

    @property
    def version(self) -> Optional[int]:
        handle = self.daemon._registry.current(self.daemon.model_id)
        return handle.version if handle else None

    def swap(self, export_dir: str,
             engine: Optional[str] = None) -> dict:
        return self.daemon.swap(export_dir, engine=engine)

    def burns(self) -> list:
        """[(burn_fast, burn_slow)] per SLO objective, the scale loop's
        and the router's shedding signal; [] when SLO is off."""
        eng = self.daemon._slo
        if eng is None:
            return []
        return [(b.get("burn_fast", 0.0), b.get("burn_slow", 0.0))
                for b in eng.state().get("burns", {}).values()]

    def stats(self) -> dict:
        return self.daemon.stats()

    def kill(self) -> None:
        """SIGKILL semantics for in-process drills: the wire server
        closes mid-connection, queued requests fail, the heartbeat stops
        with no farewell beat, and the lease ages into the DOWN verdict.
        `self.state` stays as it was: a dead process cannot update the
        manager's books either; the verdict is the monitor's."""
        self.heartbeat.stop()
        self.server.kill()   # live connections too: peers must see the
        self.daemon.kill()   # transport die, not a zombie's errors

    def stop(self) -> None:
        """Graceful retire: drain the daemon, close the wire server."""
        self.heartbeat.stop()
        self.server.close()
        self.daemon.stop()
        self.state = STATE_RETIRED


class ProcessMember:
    """A fleet member as a real `serve` child process (`python -m
    shifu_tpu_torch.launcher.cli serve ... --heartbeat-s ... --device
    <device>`) in its own session, torn down through
    launcher/supervisor._kill_tree.  The child writes its own lease into
    its telemetry dir, which the manager's monitor reads as it reads an
    in-process member's.  `argv` / `env_extra` override the command (the
    host plane's, launcher/pod.member_command)."""

    # a child has this long to load its engine, warm its ladder and write
    # its first lease before `wait_ready` gives up (and before the standby
    # sweep counts a lease-less live child as dead)
    START_TIMEOUT_S = 300.0

    def __init__(self, member_id: str, export_dir: str, *,
                 serving: ServingConfig, fleet: FleetConfig,
                 tele_dir: str, port: int,
                 python: Optional[str] = None,
                 host_id: str = "",
                 argv: Optional[list] = None,
                 env_extra: Optional[dict] = None,
                 device: "DeviceLike" = None):
        import subprocess
        import sys

        self.member_id = member_id
        self.tele_dir = tele_dir
        os.makedirs(tele_dir, exist_ok=True)
        self.state = STATE_STANDBY
        self.generation = 0
        self.export_dir = export_dir
        self.host_id = host_id
        self.host, self.port = serving.host, port
        self._spawn_t = time.monotonic()
        env = dict(os.environ)
        env["SHIFU_TPU_METRICS_DIR"] = tele_dir
        if host_id:
            env[ENV_FLEET_HOST] = host_id
        if env_extra:
            env.update(env_extra)
        cmd = list(argv) if argv else [
            python or sys.executable, "-m", "shifu_tpu_torch.launcher.cli",
            *serve_args(export_dir, serving, fleet, port, device)]
        # its own session: retire and kill signal the whole tree
        self.proc = subprocess.Popen(cmd, env=env, start_new_session=True)

    @property
    def version(self) -> Optional[int]:
        try:
            return self.stats().get("version")
        except Exception:
            return None

    @property
    def spawn_grace_s(self) -> float:
        """How long the standby sweep waits for this child's first lease:
        START_TIMEOUT_S while the child lives, 0 once it has exited."""
        return self.START_TIMEOUT_S if self.proc.poll() is None else 0.0

    def wait_ready(self) -> None:
        """Block until the child has written its lease and answers a PING;
        raises RuntimeError when it exits first or START_TIMEOUT_S runs
        out."""
        deadline = self._spawn_t + self.START_TIMEOUT_S
        while True:
            rc = self.proc.poll()
            if rc is not None:
                raise RuntimeError(f"fleet member {self.member_id}: serve "
                                   f"child exited {rc} before it was ready")
            if read_lease(self.tele_dir) is not None:
                try:
                    with self._client() as c:
                        c.ping()
                    return
                except OSError:
                    pass
            if time.monotonic() > deadline:
                raise RuntimeError(f"fleet member {self.member_id}: not "
                                   f"ready within {self.START_TIMEOUT_S} s")
            time.sleep(0.1)

    def _client(self):
        from . import serve_wire
        return serve_wire.ServeClient(self.host, self.port, timeout=5.0)

    def swap(self, export_dir: str,
             engine: Optional[str] = None) -> dict:
        try:
            with self._client() as c:
                return c.swap(export_dir, engine=engine)
        except Exception as e:  # noqa: BLE001 — degrade like daemon.swap
            return {"ok": False,
                    "error": f"{type(e).__name__}: {e}"[:300]}

    def burns(self) -> list:
        try:
            slo = self.stats().get("slo") or {}
            return [(b.get("burn_fast", 0.0), b.get("burn_slow", 0.0))
                    for b in (slo.get("burns") or {}).values()]
        except Exception:
            return []

    def stats(self) -> dict:
        with self._client() as c:
            return c.stats()

    def kill(self) -> None:
        # the state stays with the manager, as in FleetMember.kill
        from ..launcher.supervisor import _kill_tree
        _kill_tree(self.proc, sig=None)

    def stop(self) -> None:
        import signal

        from ..launcher.supervisor import _kill_tree
        _kill_tree(self.proc, sig=signal.SIGTERM)
        self.state = STATE_RETIRED


def serve_args(export_dir: str, serving: ServingConfig, fleet: FleetConfig,
               port: int, device: "DeviceLike" = None) -> list:
    """The `serve` command's arguments for one process-mode member."""
    return ["serve", export_dir, "--engine", serving.engine,
            "--port", str(port), "--host", serving.host,
            "--heartbeat-s", str(fleet.heartbeat_every_s),
            "--heartbeat-misses", str(fleet.heartbeat_misses),
            "--device", str("cuda:0" if device is None else device)]


# -- scale decisions -------------------------------------------------------


def decide_scale(burns: list, n_active: int, cfg: FleetConfig) -> str:
    """"up" / "down" / "hold" from per-member (fast, slow) burn pairs;
    pure, so the policy is testable without a live fleet.

    Both windows must AGREE (the multiwindow rule of the SLO engine at
    fleet scope): up when the worst member burns >= scale_up_burn on fast
    AND slow (a fast-only spike is noise, a slow-only burn is already
    recovering); down only when EVERY member is idle on both windows."""
    if not burns or n_active < 1:
        return "hold"
    worst_fast = max(f for f, _s in burns)
    worst_slow = max(s for _f, s in burns)
    if (worst_fast >= cfg.scale_up_burn
            and worst_slow >= cfg.scale_up_burn
            and n_active < cfg.max_daemons):
        return "up"
    if (worst_fast <= cfg.scale_down_burn
            and worst_slow <= cfg.scale_down_burn
            and n_active > cfg.min_daemons):
        return "down"
    return "hold"


# -- the manager -----------------------------------------------------------


class FleetManager:
    """Spawns and supervises N members and their hot standbys, owns the
    router's membership, and runs the heartbeat monitor, the swap retry
    and the scale loop.

    Members are in-process (`FleetMember`) or `serve` children
    (`ProcessMember`), as `member_mode` says (see the module docstring);
    `member_factory(member_id, tele_dir, host_id)` replaces both.  Lease
    expiry, failover and promotion, the fleet swap with its straggler
    quarantine, and the burn-driven scale loop are the same in every
    mode: they touch only leases, the member protocol and the router's
    table.  Members score on `device` (default `cuda:0`)."""

    def __init__(self, export_dir: str, *,
                 fleet: Optional[FleetConfig] = None,
                 serving: Optional[ServingConfig] = None,
                 root_dir: Optional[str] = None,
                 loader: Optional[Callable] = None,
                 member_factory: Optional[Callable] = None,
                 model_id: str = "default",
                 device: "DeviceLike" = None):
        import tempfile

        from .router import FleetRouter

        self.fleet = fleet or FleetConfig()
        self.fleet.validate()
        # per-member daemons inherit the serving config minus the wire
        # bind (each member binds its own ephemeral loopback port)
        base = serving or ServingConfig()
        self.serving = dataclasses.replace(base, port=0)
        self.export_dir = export_dir
        self.model_id = model_id
        self.device = device
        self._loader = loader
        self.root_dir = root_dir or tempfile.mkdtemp(prefix="fleet_")
        # the host plane: with no hosts the fleet is single-host;
        # `local:N` or a host list turns on placement across hosts and
        # the per-host artifact sync
        self.hosts: Optional[HostPlane] = (
            HostPlane(self.fleet.hosts, self.root_dir)
            if self.fleet.hosts else None)
        self.member_mode = self._resolve_mode()
        self._factory = member_factory or (
            self._spawn_process if self.member_mode == "process"
            else self._spawn_inproc)
        self.router = FleetRouter(self.fleet)
        # ingress trace sampling rides the serving config: the router
        # mints 1-in-N; members force-sample whatever arrives sampled
        self.router.trace_sample = self.serving.trace_sample
        self._lock = threading.RLock()
        # per-host clock-offset estimation (see _observe_skew)
        self._skew_offsets: dict = {}
        self._skew_published: dict = {}
        self._skew_samples: dict = {}
        self.members: dict[str, FleetMember] = {}   # in rotation or stale
        self.standbys: list[FleetMember] = []
        # split-brain ledger: DOWN members kept (not killed) awaiting
        # either a lease resurrection -> standby rejoin, or the reap
        # deadline -> kill.  member_id -> (member, downed_at_monotonic)
        self._downed: dict = {}
        # per-host verified artifact cache: (host_id, generation) ->
        # local synced path, so one host pulls each export exactly once
        self._sync_cache: dict = {}
        self._next_id = 0
        self._generation = 0
        self._running = False
        self._monitor_thread: Optional[threading.Thread] = None
        self._last_scale_t = 0.0
        self._failovers = 0

    # -- lifecycle -----------------------------------------------------

    def _resolve_mode(self) -> str:
        """"inproc" or "process": `member_mode`, where "auto" spawns
        children only over ssh."""
        mode = self.fleet.member_mode
        if mode == "auto":
            ssh = self.hosts is not None \
                and self.hosts.spec.transport == "ssh"
            mode = "process" if ssh else "inproc"
        return mode

    def start(self) -> "FleetManager":
        from .. import obs

        with self._lock:
            if self._running:
                return self
            self._running = True
            # every member spawned first, so that process children start
            # in parallel; each must be ready before it is admitted
            spawned = []
            try:
                for _ in range(self.fleet.n_daemons + self.fleet.standbys):
                    spawned.append(self._spawn())
                for m in spawned:
                    if hasattr(m, "wait_ready"):
                        m.wait_ready()
            except Exception:
                self._running = False
                for m in spawned:
                    try:
                        m.kill()
                    except Exception:
                        pass
                raise
            for m in spawned[:self.fleet.n_daemons]:
                self._admit(m)
            self.standbys.extend(spawned[self.fleet.n_daemons:])
        obs.event("fleet_start", n_daemons=self.fleet.n_daemons,
                  standbys=self.fleet.standbys, path=self.export_dir,
                  heartbeat_every_s=self.fleet.heartbeat_every_s,
                  heartbeat_misses=self.fleet.heartbeat_misses)
        self._monitor_thread = threading.Thread(
            target=self._monitor_loop, daemon=True, name="fleet-monitor")
        self._monitor_thread.start()
        return self

    def stop(self) -> None:
        with self._lock:
            self._running = False
            members = list(self.members.values()) + list(self.standbys)
            downed = [m for m, _t in self._downed.values()]
            self.members.clear()
            self.standbys.clear()
            self._downed.clear()
        if self._monitor_thread is not None:
            self._monitor_thread.join(timeout=5)
        self.router.close()
        for m in members:
            if m.state not in (STATE_DOWN, STATE_RETIRED):
                try:
                    m.stop()
                except Exception:
                    pass
        for m in downed:
            # a blackholed-lease member in the DOWN ledger is still a
            # live daemon: it must not outlive the manager
            try:
                m.kill()
            except Exception:
                pass

    def __enter__(self) -> "FleetManager":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- membership ----------------------------------------------------

    def _spawn_inproc(self, member_id: str, tele_dir: str,
                      host_id: str = "") -> FleetMember:
        export = self.export_dir
        if host_id:
            export = self._host_artifact(host_id, export,
                                         self._generation,
                                         member=member_id)
        return FleetMember(member_id, export,
                           serving=self.serving, fleet=self.fleet,
                           tele_dir=tele_dir, loader=self._loader,
                           model_id=self.model_id, host_id=host_id,
                           device=self.device)

    def _spawn_process(self, member_id: str, tele_dir: str,
                       host_id: str = "") -> ProcessMember:
        """A `serve` child on `member_port_base + n` for member-n: through
        the host plane's transport where there is one (the host's synced
        artifact, the pdeathsig tether of a local child), else a local
        child of this interpreter."""
        export = self.export_dir
        if host_id:
            export = self._host_artifact(host_id, export,
                                         self._generation,
                                         member=member_id)
        port = self.fleet.member_port_base + int(member_id.rsplit("-", 1)[1])
        argv = env = None
        if host_id:
            argv, env = self.hosts.serve_command(
                host_id, serve_args(export, self.serving, self.fleet, port,
                                    self.device),
                {"SHIFU_TPU_METRICS_DIR": tele_dir})
        return ProcessMember(member_id, export, serving=self.serving,
                             fleet=self.fleet, tele_dir=tele_dir, port=port,
                             host_id=host_id, argv=argv, env_extra=env,
                             device=self.device)

    def _spawn(self):
        with self._lock:
            member_id = f"member-{self._next_id}"
            self._next_id += 1
            host_id = self.hosts.place() if self.hosts else ""
        tele_dir = os.path.join(self.root_dir, member_id)
        try:
            m = self._factory(member_id, tele_dir, host_id)
        except Exception:
            if self.hosts and host_id:
                self.hosts.release(host_id)
            raise
        m.generation = self._generation
        m._spawn_wall_t = time.time()  # the standby sweep's warm-up grace
        return m

    # -- per-host artifact sync ----------------------------------------

    def _syncable(self, export_dir: str) -> bool:
        """Only real file trees sync: loader-scheme handles (stub://, the
        test loaders) and anything else fsio cannot walk serve from the
        source path, as in the single-host fleet."""
        if self.hosts is None or not self.fleet.sync_artifacts:
            return False
        if fsio.is_remote(export_dir):
            return True
        return "://" not in export_dir and os.path.isdir(export_dir)

    def _host_artifact(self, host_id: str, export_dir: str,
                       generation: int, member: str = "") -> str:
        """The path a member on `host_id` loads `export_dir` from: the
        host's digest-verified local copy where the sync plane applies
        (pulled at most once per (host, generation)), else the source
        path itself.  Raises SyncError on a torn or corrupt pull."""
        if not host_id or not self._syncable(export_dir):
            return export_dir
        key = (host_id, int(generation), export_dir)
        with self._lock:
            hit = self._sync_cache.get(key)
        if hit:
            return hit
        dest = sync_artifact(export_dir, self.hosts.cache_dir(host_id),
                             generation, host=host_id, member=member)
        with self._lock:
            self._sync_cache[key] = dest
        return dest

    def _admit(self, m) -> None:
        """Into the membership table and the router's rotation (the
        caller makes sure it is on the current generation)."""
        m.state = STATE_ACTIVE
        self.members[m.member_id] = m
        self.router.add(m.member_id, m.host, m.port,
                        generation=m.generation,
                        host_id=getattr(m, "host_id", ""))

    def member_dirs(self) -> list:
        """Telemetry dirs of every member (active, standby, stale and in
        the DOWN ledger): the input of `serving_rollup` and of `top`'s
        fleet view, where downed members render DOWN off their aged
        lease."""
        with self._lock:
            return [m.tele_dir for m in self.members.values()] + \
                   [m.tele_dir for m in self.standbys] + \
                   [m.tele_dir for m, _t in self._downed.values()]

    def summary(self) -> dict:
        with self._lock:
            return {
                "active": [mid for mid, m in self.members.items()
                           if m.state == STATE_ACTIVE],
                "stale": [mid for mid, m in self.members.items()
                          if m.state == STATE_STALE],
                "standbys": [m.member_id for m in self.standbys],
                "down": sorted(self._downed),
                "hosts": list(self.hosts.host_ids) if self.hosts else [],
                "generation": self._generation,
                "failovers": self._failovers,
            }

    # -- heartbeat monitor + failover ----------------------------------

    def _monitor_loop(self) -> None:
        tick = self.fleet.heartbeat_every_s
        nap, held = min(tick, 0.2), False
        while self._running:
            t_nap = time.monotonic()
            time.sleep(nap)
            if not self._running:
                return
            if time.monotonic() - t_nap > nap + tick and not held:
                # this process was starved for more than a beat (a loaded
                # host): its in-process members' heartbeats were held up
                # alike, so their leases get one tick to catch up.  Only
                # one: the next tick judges whatever its delay, or a
                # process that stays starved would never fail over a
                # member that really died
                held = True
                continue
            held = False
            try:
                self.check_members()
                self._retry_stale()
                if self.fleet.scale_every_s > 0:
                    now = time.monotonic()
                    if now - self._last_scale_t \
                            >= self.fleet.scale_every_s:
                        self._last_scale_t = now
                        self.scale_tick()
            except Exception:
                # the control plane outlives any single bad tick
                continue

    def check_members(self) -> list:
        """One monitor pass: expire leases, fail over, sweep dead
        standbys, tend the DOWN ledger (rejoin or reap).  Returns the
        member ids failed over in this pass."""
        ttl = self.fleet.heartbeat_ttl_s
        now = time.time()
        failed = []
        with self._lock:
            suspects = [m for m in self.members.values()
                        if m.state == STATE_ACTIVE]
        for m in suspects:
            lease = read_lease(m.tele_dir)
            self._observe_skew(lease, now)
            age = lease_age_s(lease, now=now)
            if age is None or age > ttl:
                self.failover(m, lease_age=age)
                failed.append(m.member_id)
        self._sweep_standbys(now, ttl)
        self._tend_downed(now, ttl)
        return failed

    def _observe_skew(self, lease: Optional[dict], now: float) -> None:
        """Per-host clock-offset estimate off the leases the monitor reads
        anyway: each fresh lease is one sample of ``manager_now -
        lease_ts``.  A true lease age is >= 0, so the RUNNING MIN of the
        samples approximates the host's offset with a positive bias of at
        most one heartbeat period, enough to order cross-host journal
        events at failover scale (obs/timeline.py).  Journals
        `fleet_clock_skew` per host on the first sample and whenever the
        estimate moves by more than 5 ms; |offset| is clamped to
        `timeline_max_offset_s`."""
        if not self.fleet.timeline_skew_correct:
            return
        if not lease or not isinstance(lease.get("ts"), (int, float)):
            return
        host = lease.get("host")
        if not host:
            return  # a single-host fleet: one clock, no offsets
        from .. import obs

        cap = self.fleet.timeline_max_offset_s
        sample = max(-cap, min(cap, now - float(lease["ts"])))
        with self._lock:
            n = self._skew_samples.get(host, 0) + 1
            self._skew_samples[host] = n
            prev = self._skew_offsets.get(host)
            est = sample if prev is None else min(prev, sample)
            self._skew_offsets[host] = est
            published = self._skew_published.get(host)
            if published is not None and abs(est - published) <= 0.005:
                return
            self._skew_published[host] = est
        obs.event("fleet_clock_skew", host=str(host),
                  offset_s=round(est, 4),
                  rtt_bound_s=round(self.fleet.heartbeat_every_s, 4),
                  samples=n)

    def _sweep_standbys(self, now: float, ttl: float) -> None:
        """A standby is a standby only while ITS lease is fresh: promoting
        a dead one would turn one outage into two.  A swept standby is
        replaced, so the warm pool keeps its depth.  The spawn warm-up
        grace is max(ttl, 2 s), and for a process child that has written
        no lease yet, its `spawn_grace_s` (its engine loads first)."""
        from .. import obs

        with self._lock:
            pool = list(self.standbys)
        dead = []
        for s in pool:
            lease = read_lease(s.tele_dir)
            age = lease_age_s(lease, now=now)
            if age is not None and age <= ttl:
                continue
            grace = max(ttl, 2.0)
            if lease is None:
                grace = max(grace, getattr(s, "spawn_grace_s", 0.0))
            if now - getattr(s, "_spawn_wall_t", now) < grace:
                continue
            dead.append(s)
        for s in dead:
            with self._lock:
                if s not in self.standbys:
                    continue
                self.standbys.remove(s)
            obs.event("fleet_standby_down", member=s.member_id,
                      host=getattr(s, "host_id", ""))
            try:
                s.kill()
            except Exception:
                pass
            if self.hosts and getattr(s, "host_id", ""):
                self.hosts.release(s.host_id)
            if self._running:
                try:
                    replacement = self._spawn()
                    with self._lock:
                        self.standbys.append(replacement)
                except Exception:
                    pass

    def _tend_downed(self, now: float, ttl: float) -> None:
        """The split-brain guard's second half.  A DOWN member whose lease
        RESURRECTS (its partition healed: the process lived all along,
        only its lease writes were lost) rejoins as a STANDBY, since its
        old slot already has a promoted replacement.  A member whose
        lease stays dead past the reap deadline is killed for good."""
        from .. import obs

        reap_after = max(10.0 * ttl, 5.0 * self.fleet.heartbeat_every_s)
        with self._lock:
            ledger = list(self._downed.items())
        for member_id, (m, downed_t) in ledger:
            age = lease_age_s(read_lease(m.tele_dir), now=now)
            if (age is not None and age <= ttl
                    and self.fleet.rejoin_standby):
                with self._lock:
                    if self._downed.pop(member_id, None) is None:
                        continue
                    gen = self._generation
                caught_up = m.generation == gen
                if not caught_up:
                    # catch the returnee up BEFORE it is promotable: a
                    # rejoined member never serves a generation the
                    # barrier has left behind
                    try:
                        target = self._host_artifact(
                            getattr(m, "host_id", ""), self.export_dir,
                            gen, member=member_id)
                        r = m.swap(target)
                    except SyncError as e:
                        r = {"ok": False, "error": str(e)}
                    if r.get("ok"):
                        m.generation = gen
                        caught_up = True
                        obs.event("fleet_member_swap", member=member_id,
                                  generation=gen,
                                  host=getattr(m, "host_id", ""),
                                  via="rejoin",
                                  baseline_digest=r.get(
                                      "baseline_digest"))
                with self._lock:
                    m.state = STATE_STANDBY
                    self.standbys.append(m)
                obs.event("fleet_rejoin", member=member_id,
                          generation=m.generation, caught_up=caught_up,
                          host=getattr(m, "host_id", ""))
            elif time.monotonic() - downed_t > reap_after:
                with self._lock:
                    if self._downed.pop(member_id, None) is None:
                        continue
                try:
                    m.kill()
                except Exception:
                    pass
                if self.hosts and getattr(m, "host_id", ""):
                    self.hosts.release(m.host_id)

    def failover(self, member, lease_age: Optional[float] = None) -> None:
        """The DOWN member out of rotation and a pre-warmed standby
        promoted in its place, journaled as ONE `fleet_failover` event.
        With a host plane a standby on ANOTHER host than the victim's is
        preferred (a whole-host loss must not promote onto the same dead
        host)."""
        from .. import obs

        t0 = time.perf_counter()
        promoted_swap = promoted_digest = None
        with self._lock:
            if self.members.get(member.member_id) is not member:
                return  # already handled (a monitor and drill race)
            self.router.remove(member.member_id)
            del self.members[member.member_id]
            member.state = STATE_DOWN
            idx = 0
            victim_host = getattr(member, "host_id", "")
            if victim_host:
                for i, s in enumerate(self.standbys):
                    if getattr(s, "host_id", "") != victim_host:
                        idx = i
                        break
            standby = self.standbys.pop(idx) if self.standbys else None
            if standby is not None:
                if standby.generation != self._generation:
                    # a fleet swap landed while this standby idled: catch
                    # it up BEFORE it takes traffic
                    try:
                        target = self._host_artifact(
                            getattr(standby, "host_id", ""),
                            self.export_dir, self._generation,
                            member=standby.member_id)
                        r = standby.swap(target)
                    except SyncError as e:
                        r = {"ok": False, "error": str(e)}
                    if r.get("ok"):
                        standby.generation = self._generation
                        promoted_swap = self._generation
                        promoted_digest = r.get("baseline_digest")
                self.members[standby.member_id] = standby
                self._admit(standby)
                if standby.generation != self._generation:
                    # the catch-up failed: serve nothing stale; it waits
                    # behind the barrier for the monitor's retry
                    standby.state = STATE_STALE
                    self.router.remove(standby.member_id)
            # to the DOWN ledger, not straight to kill(): a member whose
            # lease was blackholed is alive and may rejoin as a standby
            self._downed[member.member_id] = (member, time.monotonic())
            self._failovers += 1
        obs.counter("fleet_failover_total",
                    "members failed over after missed heartbeats").inc()
        obs.event("fleet_failover", member=member.member_id,
                  standby=standby.member_id if standby else None,
                  host=getattr(member, "host_id", ""),
                  standby_host=(getattr(standby, "host_id", "")
                                if standby else None),
                  lease_age_s=(round(lease_age, 3)
                               if lease_age is not None else None),
                  ttl_s=round(self.fleet.heartbeat_ttl_s, 3),
                  promoted_in_s=round(time.perf_counter() - t0, 4))
        if promoted_swap is not None:
            obs.event("fleet_member_swap", member=standby.member_id,
                      generation=promoted_swap,
                      host=getattr(standby, "host_id", ""),
                      via="promote", baseline_digest=promoted_digest)
        try:
            obs.flush()
        except Exception:
            pass
        # refill the standby pool AFTER journaling (a slow spawn must
        # not delay the fleet_failover record), so the NEXT failure has a
        # warm takeover too
        if standby is not None and self._running:
            try:
                replacement = self._spawn()
                with self._lock:
                    if self._running:
                        self.standbys.append(replacement)
                    else:
                        replacement.stop()
            except Exception:
                pass  # degraded: fleet serves on without a standby

    def kill_host(self, host_id: str) -> list:
        """SIGKILL everything placed on `host_id`, the whole-host-loss
        drill.  Dead standbys leave the pool at once (a corpse is never
        promoted); actives keep their slot until the lease verdict drives
        `failover`, as when a real host vanishes."""
        from .. import obs

        with self._lock:
            victims = [m for m in list(self.members.values())
                       + list(self.standbys)
                       if getattr(m, "host_id", "") == host_id]
        killed = []
        for m in victims:
            try:
                m.kill()
            except Exception:
                pass
            killed.append(m.member_id)
        with self._lock:
            dead_standbys = [s for s in self.standbys
                             if getattr(s, "host_id", "") == host_id]
            self.standbys = [s for s in self.standbys
                             if getattr(s, "host_id", "") != host_id]
        for s in dead_standbys:
            obs.event("fleet_standby_down", member=s.member_id,
                      host=host_id)
        return killed

    # -- fleet-wide hot swap -------------------------------------------

    def swap_fleet(self, export_dir: str,
                   engine: Optional[str] = None) -> dict:
        """One export to every member (actives AND standbys, so that a
        later promotion is already current).  A failure quarantines the
        member (STALE, out of rotation, journaled) and the monitor
        retries it; the barrier then refuses any member still on the old
        generation, so after this returns only the new version serves."""
        from .. import obs

        with self._lock:
            self._generation += 1
            gen = self._generation
            self.export_dir = export_dir
            targets = list(self.members.values()) + list(self.standbys)
        swapped, failed = [], []
        for m in targets:
            try:
                # with a host plane each member loads its HOST's verified
                # copy (pulled once per host); a torn or corrupt pull
                # fails this member's swap as a bad artifact would
                target = self._host_artifact(
                    getattr(m, "host_id", ""), export_dir, gen,
                    member=m.member_id)
                r = m.swap(target, engine=engine)
            except SyncError as e:
                r = {"ok": False, "error": f"sync: {e}"}
            if r.get("ok"):
                m.generation = gen
                m.export_dir = export_dir
                self.router.set_generation(m.member_id, gen)
                swapped.append(m.member_id)
                obs.event("fleet_member_swap", member=m.member_id,
                          generation=gen,
                          host=getattr(m, "host_id", ""), via="fanout",
                          baseline_digest=r.get("baseline_digest"))
            else:
                failed.append({"member": m.member_id,
                               "error": r.get("error")})
                with self._lock:
                    if m.member_id in self.members:
                        m.state = STATE_STALE
                        self.router.remove(m.member_id)
                obs.event("fleet_swap_degraded", member=m.member_id,
                          path=export_dir,
                          error=str(r.get("error"))[:300])
        # the barrier: from here the router refuses any member whose
        # generation predates this swap, until the monitor's retry
        # catches it up and re-admits it
        self.router.set_barrier(gen)
        obs.event("fleet_swap", path=export_dir, generation=gen,
                  swapped=swapped,
                  failed=[f["member"] for f in failed])
        return {"ok": not failed, "generation": gen,
                "swapped": swapped, "failed": failed}

    def _retry_stale(self) -> list:
        """The monitor's leg: swap STALE members to the current target
        again; success re-admits them (`fleet_readmit`)."""
        from .. import obs

        with self._lock:
            stale = [m for m in self.members.values()
                     if m.state == STATE_STALE]
            target, gen = self.export_dir, self._generation
        readmitted = []
        for m in stale:
            try:
                # a member quarantined by a CORRUPT sync pulls again here:
                # the per-host cache holds verified publishes only
                host_target = self._host_artifact(
                    getattr(m, "host_id", ""), target, gen,
                    member=m.member_id)
                r = m.swap(host_target)
            except SyncError:
                continue
            if not r.get("ok"):
                continue
            m.generation = gen
            m.export_dir = target
            with self._lock:
                if self.members.get(m.member_id) is m:
                    self._admit(m)
                    self.router.set_generation(m.member_id, gen)
            readmitted.append(m.member_id)
            obs.event("fleet_member_swap", member=m.member_id,
                      generation=gen, host=getattr(m, "host_id", ""),
                      via="retry",
                      baseline_digest=r.get("baseline_digest"))
            obs.event("fleet_readmit", member=m.member_id,
                      generation=gen, path=target)
        return readmitted

    # -- scale loop ----------------------------------------------------

    def scale_tick(self, burns: Optional[list] = None) -> str:
        """One scale decision over the live members' burn pairs (or the
        given `burns`).  "up" promotes a standby (or spawns a member);
        "down" retires the least-burned member.  Journals `fleet_scale` on
        every action but "hold"."""
        from .. import obs

        with self._lock:
            active = [m for m in self.members.values()
                      if m.state == STATE_ACTIVE]
        if burns is None:
            burns = []
            for m in active:
                pairs = m.burns()
                if pairs:
                    burns.append((max(f for f, _ in pairs),
                                  max(s for _, s in pairs)))
        action = decide_scale(burns, len(active), self.fleet)
        if action == "hold":
            return action
        n_before = len(active)
        if action == "up":
            with self._lock:
                grown = self.standbys.pop(0) if self.standbys else None
            if grown is None:
                grown = self._spawn()
            if grown.generation != self._generation:
                try:
                    target = self._host_artifact(
                        getattr(grown, "host_id", ""), self.export_dir,
                        self._generation, member=grown.member_id)
                    r = grown.swap(target)
                except SyncError as e:
                    r = {"ok": False, "error": str(e)}
                if r.get("ok"):
                    grown.generation = self._generation
                    obs.event("fleet_member_swap",
                              member=grown.member_id,
                              generation=self._generation,
                              host=getattr(grown, "host_id", ""),
                              via="scale",
                              baseline_digest=r.get("baseline_digest"))
            with self._lock:
                self.members[grown.member_id] = grown
                self._admit(grown)
                n_after = sum(1 for m in self.members.values()
                              if m.state == STATE_ACTIVE)
        else:
            # retire the least-burned active member gracefully: a drain,
            # so scaling down costs no request
            victim = active[-1]
            if burns and len(burns) == len(active):
                victim = min(zip(burns, active),
                             key=lambda p: p[0][0])[1]
            with self._lock:
                self.router.remove(victim.member_id)
                self.members.pop(victim.member_id, None)
                n_after = sum(1 for m in self.members.values()
                              if m.state == STATE_ACTIVE)
            try:
                victim.stop()
            except Exception:
                pass
            if self.hosts and getattr(victim, "host_id", ""):
                self.hosts.release(victim.host_id)
        worst_fast = max((f for f, _ in burns), default=0.0)
        worst_slow = max((s for _, s in burns), default=0.0)
        obs.counter("fleet_scale_total",
                    "burn-rate-driven fleet scale actions").inc(
            action=action)
        obs.event("fleet_scale", action=action, n_before=n_before,
                  n_after=n_after, burn_fast=round(worst_fast, 4),
                  burn_slow=round(worst_slow, 4))
        return action

    def push_burns(self) -> None:
        """Feed each member's fast-window burn to the router, whose
        overload shedding reads it (the `fleet` command's loop calls this
        every beat)."""
        with self._lock:
            active = [m for m in self.members.values()
                      if m.state == STATE_ACTIVE]
        for m in active:
            pairs = m.burns()
            if pairs:
                self.router.set_burn(
                    m.member_id, max(f for f, _ in pairs))


# -- fleet-verify: the journal audit ---------------------------------------


def fleet_verify_events(events: list) -> dict:
    """The `fleet-verify` audit, pure over journal events (chaos-verify's
    counterpart for the fleet).  The invariants:

    - every `fleet_failover` promoted a standby (no unanswered loss)
    - `fleet_swap` generations strictly increase (no barrier rollback)
    - every swap reached every targeted member EXACTLY once — counting
      `fleet_member_swap` applications per (member, generation); a
      member that died before its retry (it appears in a later failover
      or standby-down record) is excused
    - no member's applied generation ever regresses
    - every `fleet_rejoin` follows that member's own failover (nobody
      rejoins who never left)
    - within a generation, every member that reported a baseline-profile
      digest reported the SAME one: the whole fleet checks drift against
      one frozen baseline (a member with no digest passes: an artifact
      without a profile, or drift off)
    """
    from collections import Counter

    failovers = [e for e in events if e.get("kind") == "fleet_failover"]
    swaps = [e for e in events if e.get("kind") == "fleet_swap"]
    applies = [e for e in events
               if e.get("kind") == "fleet_member_swap"]
    checks = []

    unanswered = [e.get("member") for e in failovers
                  if not e.get("standby")]
    checks.append({"check": "failover_promotion", "ok": not unanswered,
                   "detail": ("every failover promoted a standby"
                              if not unanswered else
                              f"no standby for: {unanswered}")})

    gens = [e.get("generation") for e in swaps]
    mono = (all(isinstance(g, int) for g in gens)
            and all(b > a for a, b in zip(gens, gens[1:])))
    checks.append({"check": "swap_generations_increase", "ok": mono,
                   "detail": f"fleet_swap generations: {gens}"})

    counts = Counter((e.get("member"), e.get("generation"))
                     for e in applies)
    dupes = sorted(f"{m}@gen{g}" for (m, g), n in counts.items()
                   if n > 1)
    checks.append({"check": "swap_applied_exactly_once",
                   "ok": not dupes,
                   "detail": ("no duplicate applications" if not dupes
                              else f"applied more than once: {dupes}")})

    died = {e.get("member") for e in failovers} | \
           {e.get("member") for e in events
            if e.get("kind") == "fleet_standby_down"}
    uncovered = []
    for e in swaps:
        g = e.get("generation")
        for mid in (list(e.get("swapped") or [])
                    + list(e.get("failed") or [])):
            if counts.get((mid, g), 0) == 0 and mid not in died:
                uncovered.append(f"{mid}@gen{g}")
    checks.append({"check": "swap_reached_every_member",
                   "ok": not uncovered,
                   "detail": ("every swap reached every live member"
                              if not uncovered else
                              f"never applied: {sorted(uncovered)}")})

    regressions, last_gen = [], {}
    for e in applies:
        mid, g = e.get("member"), e.get("generation")
        if not isinstance(g, int):
            continue
        if g < last_gen.get(mid, g):
            regressions.append(f"{mid}: gen{last_gen[mid]} -> gen{g}")
        last_gen[mid] = max(g, last_gen.get(mid, g))
    checks.append({"check": "member_generation_monotonic",
                   "ok": not regressions,
                   "detail": ("no per-member regressions"
                              if not regressions else
                              f"regressed: {regressions}")})

    ghost_rejoins, down_now = [], set()
    for e in events:
        kind = e.get("kind")
        if kind == "fleet_failover":
            down_now.add(e.get("member"))
        elif kind == "fleet_rejoin":
            if e.get("member") not in down_now:
                ghost_rejoins.append(e.get("member"))
            else:
                down_now.discard(e.get("member"))
    checks.append({"check": "rejoin_follows_failover",
                   "ok": not ghost_rejoins,
                   "detail": ("every rejoin had a prior failover"
                              if not ghost_rejoins else
                              f"rejoin without failover: {ghost_rejoins}")})

    gen_digests: dict = {}
    for e in applies:
        d = e.get("baseline_digest")
        if d:
            gen_digests.setdefault(e.get("generation"), set()).add(d)
    split = sorted(f"gen{g}: {sorted(ds)}"
                   for g, ds in gen_digests.items() if len(ds) > 1)
    checks.append({"check": "baseline_profile_consistent",
                   "ok": not split,
                   "detail": ("every generation served one baseline "
                              "profile" if not split else
                              f"digest split within generation: {split}")})

    ok = all(c["ok"] for c in checks)
    return {
        "verdict": "PASS" if ok else "FAIL",
        "checks": checks,
        "counts": {
            "failovers": len(failovers),
            "swaps": len(swaps),
            "member_swaps": len(applies),
            "rejoins": sum(1 for e in events
                           if e.get("kind") == "fleet_rejoin"),
            "degraded": sum(1 for e in events
                            if e.get("kind") == "fleet_swap_degraded"),
            "syncs": sum(1 for e in events
                         if e.get("kind") == "fleet_sync"),
        },
    }


def fleet_forever(export_dir: str, *, fleet: FleetConfig,
                  serving: ServingConfig, router_host: str,
                  router_port: int, root_dir: Optional[str] = None,
                  echo=print, device: "DeviceLike" = None) -> int:
    """The `fleet` command's body: the manager (members on `device`,
    default `cuda:0`) and the router's wire face until SIGINT or SIGTERM.
    Returns a process exit code."""
    import signal

    from .. import obs
    from .router import RouterServer

    manager = FleetManager(export_dir, fleet=fleet, serving=serving,
                           root_dir=root_dir, device=device)
    manager.start()
    try:
        front = RouterServer(manager.router, host=router_host,
                             port=router_port, manager=manager).start()
    except OSError:
        manager.stop()
        raise
    stop_evt = threading.Event()

    def _stop(signum, _frame):
        echo(f"fleet: signal {signum} - draining")
        stop_evt.set()

    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            signal.signal(sig, _stop)
        except ValueError:
            pass  # not the main thread
    echo(f"fleet: {fleet.n_daemons} member(s) + {fleet.standbys} "
         f"standby(s) on {front.host}:{front.port} "
         f"(heartbeat {fleet.heartbeat_every_s}s x "
         f"{fleet.heartbeat_misses}, {manager.member_mode} members, "
         f"artifact {export_dir})")
    obs.event("fleet_serve_start", path=export_dir, port=front.port,
              n_daemons=fleet.n_daemons, pid=os.getpid())
    try:
        while not stop_evt.wait(max(fleet.heartbeat_every_s, 0.5)):
            manager.push_burns()
    except KeyboardInterrupt:
        pass
    front.close()
    manager.stop()
    echo("fleet: stopped - " + json.dumps(manager.router.router_stats()))
    return 0
