"""Pod-scale launch: one command -> one training process per host, per-host
log collection, and whole-gang supervised restart from the checkpoint
(port of shifu_tpu/launcher/pod.py).

The host list comes from `--hosts`, SHIFU_TPU_HOSTS or a provisioned
slice (launcher/provision.py).  `launch_gang` dispatches one process per
host, ranks in list order, streams every host's output into per-host logs
under the job dir (rank 0's echoed live), and tears the gang down at the
first failure: a half gang would wait in its collectives forever.
`supervise_pod` restarts the whole gang from the shared checkpoint, bounded
by the restart budget the one-host supervisor uses, and with `min_hosts`
drops a host that keeps failing alone (the elastic reshape).

Transports:
- ``local:N``: N simulated hosts on this machine (the tests' and the card
  machine's pods); a child inherits this process's environment plus the
  contract, and is tethered to this process by the pdeathsig marker
  (launcher/supervisor.ENV_PDEATHSIG, armed by cli._arm_pdeathsig).
- ``h1,h2,...`` or ``@hostfile``: one process per host over ``ssh -tt``
  (the tty makes a parent-side kill reach the remote process as HUP); the
  contract rides inline (``env K=V ...``), so no remote shell profile can
  drop it.  Host order is rank order; checkpoint and export paths must be
  on storage every host shares.

The contract is the JAX package's (SHIFU_TPU_COORDINATOR, _NUM_PROCESSES,
_PROCESS_ID, the chaos plan and state) plus SHIFU_TPU_NUM_HOSTS, which
tells a rank it is one host of a pod (parallel/distributed.pod_contract):
the coordinator is 127.0.0.1 at a free port for local hosts and
hosts[0]:coordinator_port over ssh.  A host with several cards runs one
rank per card (launcher/cli.py).  The children run `python -m
shifu_tpu_torch.launcher.cli`.

The serving fleet (runtime/fleet.py `HostPlane`) places its members on the
hosts this grammar names and spawns each `serve` child through
`member_command`.

`pod_verify_events` audits a pod run's merged journals: every epoch closed
by a complete cohort of ranks, the order and shard digests agreeing inside
each, balanced ingest, and recovery after every injected kill.
"""

from __future__ import annotations

import os
import shlex
import subprocess
import sys
import threading
import time
from dataclasses import dataclass
from typing import Optional, Sequence

from .supervisor import CHILD_MODULE, ENV_PDEATHSIG

ENV_HOSTS = "SHIFU_TPU_HOSTS"
ENV_COORDINATOR_PORT = "SHIFU_TPU_COORDINATOR_PORT"
DEFAULT_COORDINATOR_PORT = 8476
# reconnects of one host whose ssh client exits 255 (a transport failure,
# not the child's exit), before the gang restarts on the transport budget
SSH_CONNECT_RETRIES = 3
# marks a rank as one host of a pod (parallel/distributed.ENV_NUM_HOSTS;
# spelled here too, so that the dispatcher imports no torch)
ENV_NUM_HOSTS = "SHIFU_TPU_NUM_HOSTS"


@dataclass(frozen=True)
class PodSpec:
    hosts: tuple[str, ...]           # rank i runs on hosts[i]
    transport: str                   # "local" | "ssh"
    coordinator_port: int = DEFAULT_COORDINATOR_PORT
    remote_python: str = sys.executable  # interpreter on the hosts


def parse_hosts(value: str, coordinator_port: int = 0) -> PodSpec:
    """``local:N`` -> N simulated hosts here; ``@file`` -> a newline-
    separated host list; ``h1,h2,...`` -> ssh to each host.

    `coordinator_port` (or SHIFU_TPU_COORDINATOR_PORT) overrides the ssh
    rendezvous port on hosts[0], 8476 by default.  It is resolved only for
    ssh: local hosts take a free port, so a bad environment value must
    not break `local:N`."""
    value = value.strip()
    if value.startswith("local:"):
        n = int(value.split(":", 1)[1])
        if n < 1:
            raise ValueError(f"--hosts {value!r}: need at least 1 process")
        return PodSpec(hosts=("local",) * n, transport="local")
    try:
        port = (coordinator_port
                or int(os.environ.get(ENV_COORDINATOR_PORT, "0") or 0)
                or DEFAULT_COORDINATOR_PORT)
    except ValueError:
        raise ValueError(
            f"{ENV_COORDINATOR_PORT}="
            f"{os.environ.get(ENV_COORDINATOR_PORT)!r} is not a port number")
    if not (0 < port < 65536):
        raise ValueError(f"coordinator port {port} out of range")
    if value.startswith("@"):
        with open(value[1:]) as f:
            hosts = tuple(h.strip() for h in f if h.strip()
                          and not h.lstrip().startswith("#"))
    else:
        hosts = tuple(h.strip() for h in value.split(",") if h.strip())
    if not hosts:
        raise ValueError(f"--hosts {value!r}: no hosts")
    return PodSpec(hosts=hosts, transport="ssh", coordinator_port=port)


def detect_hosts_env() -> Optional[str]:
    """The flagless spelling: SHIFU_TPU_HOSTS.  Not TPU_WORKER_HOSTNAMES,
    which a TPU runtime sets on every worker of a pod: dispatching from
    it would turn every worker into a dispatcher.  Dispatch is opt-in."""
    return os.environ.get(ENV_HOSTS) or None


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _host_command(spec: PodSpec, rank: int, child_args: Sequence[str],
                  env_contract: dict[str, str]
                  ) -> tuple[list[str], Optional[dict]]:
    """(argv, env-or-None): a local child inherits and extends this
    environment; an ssh child carries the contract inline."""
    module_argv = ["-m", CHILD_MODULE, *child_args]
    if spec.transport == "local":
        env = dict(os.environ)
        env.update(env_contract)
        # the child dies with this process even on its uncatchable death;
        # SIGKILL, since a child's libraries may swallow a SIGTERM.  Set
        # per spawn: an inherited value would name the wrong parent.  An
        # ssh child must not carry it (the pid means nothing there; the
        # ssh -tt HUP tether covers it)
        import signal as signal_lib
        env[ENV_PDEATHSIG] = f"{os.getpid()}:{int(signal_lib.SIGKILL)}"
        return [sys.executable, *module_argv], env
    assigns = [f"{k}={v}" for k, v in env_contract.items()]
    remote = " ".join(
        shlex.quote(p) for p in
        ["env", *assigns, spec.remote_python, *module_argv])
    return (["ssh", "-tt", "-o", "BatchMode=yes", spec.hosts[rank], remote],
            None)


def member_command(spec: PodSpec, rank: int, child_args: Sequence[str],
                   env_contract: dict[str, str]
                   ) -> tuple[list[str], Optional[dict]]:
    """(argv, env-or-None) to run one child of the CLI on host `rank`:
    the serving fleet's spawn path (runtime/fleet.py HostPlane)."""
    if not (0 <= rank < len(spec.hosts)):
        raise ValueError(f"member rank {rank} outside the host list "
                         f"({len(spec.hosts)} hosts)")
    return _host_command(spec, rank, child_args, env_contract)


def launch_gang(spec: PodSpec, child_args: Sequence[str], out_dir: str,
                attempt: int, liveness_seconds: float = 0.0,
                echo=print, deadline=None) -> tuple[int, tuple[int, ...]]:
    """Run one gang attempt: dispatch every host, echo rank 0's output,
    capture every rank's to `logs/host-<rank>.attempt-<attempt>.log`, tear
    the gang down on the first failure (or a liveness stall), and return
    (the gang's exit code, the culprit ranks).

    The culprits are the ranks seen failing on their own: the first, and
    any other that fails within the 1 s grace window after it (failures
    after the teardown began are its collateral).  The elastic reshape of
    `supervise_pod` reads them.  Empty on success, timeout and liveness
    kills.  `deadline` (supervisor.JobDeadline) is the job's: past it the
    gang is torn down and EXIT_TIMEOUT returned."""
    from .. import chaos
    from ..data import fsio
    from .supervisor import EXIT_TIMEOUT
    n = len(spec.hosts)
    try:
        remote_out = fsio.is_remote(out_dir)
    except Exception:
        remote_out = False
    if remote_out:
        # the host logs are local pipes: a remote job dir keeps its board,
        # metrics and checkpoints remote, the raw logs stay here
        import tempfile
        log_dir = tempfile.mkdtemp(prefix="shifu_tpu_pod_logs_")
    else:
        log_dir = os.path.join(out_dir, "logs")
        os.makedirs(log_dir, exist_ok=True)
    if spec.transport == "local":
        coordinator = f"127.0.0.1:{_free_port()}"
    else:
        coordinator = f"{spec.hosts[0]}:{spec.coordinator_port}"

    procs: list[subprocess.Popen] = []
    threads: list[threading.Thread] = []
    log_paths: list[str] = []
    # each rank's last output line: any rank's output is the gang's
    # progress for the liveness watch (rank 0 prints the epochs)
    progress = [time.monotonic()] * n
    ssh_retries = [0] * n
    lock = threading.Lock()

    def _contract(rank: int) -> dict[str, str]:
        contract = {
            "SHIFU_TPU_COORDINATOR": coordinator,
            "SHIFU_TPU_NUM_PROCESSES": str(n),
            "SHIFU_TPU_PROCESS_ID": str(rank),
            ENV_NUM_HOSTS: str(n),
        }
        # an active chaos plan reaches every rank: a local child inherits
        # it, an ssh child gets only the contract
        for key in (chaos.ENV_CHAOS_PLAN, chaos.ENV_CHAOS_STATE):
            val = os.environ.get(key)
            if val:
                contract[key] = val
        return contract

    def pump(rank: int, proc: subprocess.Popen, log_path: str,
             mode: str = "w") -> None:
        with open(log_path, mode) as log:
            for line in proc.stdout:  # text mode; ends with the child
                log.write(line)
                log.flush()
                with lock:
                    progress[rank] = time.monotonic()
                if rank == 0:
                    echo(line.rstrip("\n"))

    def dispatch(rank: int, mode: str = "w") -> None:
        argv, env = _host_command(spec, rank, child_args, _contract(rank))
        try:
            # chaos site "pod.dispatch": the transport to one host fails
            # (ssh refused, a runtime down), as a stub child exiting with
            # the fault's code, so that the teardown, the ssh retries and
            # the reshape see a real dead rank (255 takes the ssh path)
            chaos.maybe_fail("pod.dispatch", rank=rank, attempt=attempt,
                             host=spec.hosts[rank])
        except chaos.ChaosError as e:
            echo(f"pod: chaos: host {rank} dispatch fails ({e})")
            argv = [sys.executable, "-c",
                    f"import sys; sys.exit({int(e.exit_code)})"]
            env = None
        proc = subprocess.Popen(argv, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        procs[rank] = proc
        t = threading.Thread(target=pump,
                             args=(rank, proc, log_paths[rank], mode),
                             daemon=True)
        t.start()
        threads.append(t)

    for rank in range(n):
        log_paths.append(
            os.path.join(log_dir, f"host-{rank}.attempt-{attempt}.log"))
        procs.append(None)  # type: ignore[arg-type]
        dispatch(rank)

    echo(f"pod: attempt {attempt}: {n} processes "
         f"({spec.transport}), coordinator {coordinator}, "
         f"logs {log_dir}/host-*.attempt-{attempt}.log")

    status = 0
    failed_ranks: list[int] = []
    # the teardown waits one short window after the first failure, so a
    # rank failing on its own inside it is a culprit too (blaming only
    # the first one polled could let a fast collateral victim take the
    # blame, and the reshape evict a healthy host); several culprits make
    # the reshape decline, which is the safe side
    teardown_at: Optional[float] = None
    try:
        remaining = set(range(n))
        while remaining:
            for rank in sorted(remaining):
                rc = procs[rank].poll()
                if rc is None:
                    continue
                if (rc == 255 and spec.transport == "ssh"
                        and ssh_retries[rank] < SSH_CONNECT_RETRIES):
                    # 255 is the ssh client's own code: reconnect this
                    # host with a backoff; the restart budget is not
                    # charged (a mid-run drop fails the re-join fast, and
                    # supervise_pod's transport budget takes it)
                    ssh_retries[rank] += 1
                    echo(f"pod: host {rank} ({spec.hosts[rank]}) ssh "
                         f"connect failed (rc=255) — reconnect "
                         f"{ssh_retries[rank]}/{SSH_CONNECT_RETRIES}")
                    time.sleep(min(2.0 * ssh_retries[rank], 10.0))
                    dispatch(rank, mode="a")
                    continue
                remaining.discard(rank)
                if rc != 0:
                    if teardown_at is None:
                        failed_ranks.append(rank)
                        echo(f"pod: host {rank} ({spec.hosts[rank]}) "
                             f"exited rc={rc} — tearing down the gang "
                             f"(see {log_paths[rank]})")
                        teardown_at = time.monotonic() + 1.0
                    elif time.monotonic() < teardown_at:
                        failed_ranks.append(rank)
                    status = status or rc
            if (teardown_at is not None and remaining
                    and time.monotonic() >= teardown_at):
                for other in sorted(remaining):
                    procs[other].terminate()
            # the deadline after the poll: a gang that finished in the last
            # sleep reports its real status, not a timeout
            if deadline is not None and remaining and deadline.expired():
                # no drain: a pod rank does not catch SIGTERM (one rank
                # draining while its peers run collectives would
                # deadlock), so the teardown is immediate and the
                # checkpoint cadence keeps the progress
                echo("pod: job timeout exceeded — tearing down the gang")
                for other in sorted(remaining):
                    procs[other].terminate()
                return EXIT_TIMEOUT, ()
            if liveness_seconds > 0 and remaining:
                with lock:
                    newest = max(progress)
                if time.monotonic() - newest > liveness_seconds:
                    echo(f"pod: no output from any host for "
                         f"{liveness_seconds}s — killing the gang")
                    status = status or -9
                    for other in sorted(remaining):
                        procs[other].kill()
            if remaining:
                time.sleep(0.5)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
        for t in threads:
            t.join(timeout=5)
    return status, tuple(failed_ranks)


def supervise_pod(spec: PodSpec, child_args: Sequence[str], out_dir: str,
                  max_restarts: int = 2, liveness_seconds: float = 0.0,
                  echo=print, checkpoint_dir: Optional[str] = None,
                  timeout_seconds: float = 0.0, min_hosts: int = 0) -> int:
    """Whole-gang restarts: any host's failure restarts the whole gang
    (the checkpoint's auto-resume continues the job), bounded by
    `max_restarts` consecutive failures without durable progress (the
    checkpoint's epoch advancing, supervisor.ProgressProbe).

    `timeout_seconds` bounds the whole job across attempts; a timeout is
    terminal.  ssh transport failures (rc 255) restart the gang on their
    own budget of SSH_CONNECT_RETRIES consecutive failures.

    `min_hosts` > 0 enables the elastic reshape: when a budget is spent
    and every failure in it blamed the same one host, that host is
    presumed lost and the gang restarts without it (the shards rebalance
    through the contract's new host count, the loop re-rounds the global
    batch, the checkpoint resumes), with a fresh budget, while at least
    `min_hosts` remain.  Data-parallel state survives the new width;
    model- or pipe-split jobs should keep `min_hosts` at 0."""
    import dataclasses as _dc

    from .supervisor import (EXIT_TIMEOUT, JobDeadline, ProgressProbe,
                             charge_restart_budget)

    attempts = 0
    failures_since_progress = 0
    transport_failures = 0
    # the culprits over the no-progress window: the reshape drops a host
    # only when every budgeted failure blamed the same one
    window_culprits: set[int] = set()
    deadline = JobDeadline(timeout_seconds)

    def _reshape(reason: str) -> bool:
        nonlocal spec, failures_since_progress, transport_failures
        if min_hosts <= 0 or len(spec.hosts) <= max(min_hosts, 1):
            return False
        if len(window_culprits) != 1:
            return False
        drop = next(iter(window_culprits))
        gone = spec.hosts[drop]
        new_hosts = tuple(h for i, h in enumerate(spec.hosts) if i != drop)
        echo(f"pod: host {drop} ({gone}) {reason} — presumed permanently "
             f"lost; reshaping the gang to {len(new_hosts)} hosts "
             f"(floor {max(min_hosts, 1)}), rebalancing file shards, and "
             "resuming from checkpoint")
        spec = _dc.replace(spec, hosts=new_hosts)
        failures_since_progress = 0
        transport_failures = 0
        window_culprits.clear()
        return True

    while True:
        if deadline.expired():
            echo("pod: job timeout exceeded — terminal, no restart")
            return EXIT_TIMEOUT
        attempts += 1
        start = time.monotonic()
        probe = ProgressProbe(checkpoint_dir)
        rc, failed = launch_gang(spec, child_args, out_dir, attempts,
                                 liveness_seconds=liveness_seconds, echo=echo,
                                 deadline=deadline)
        if rc == 0:
            if attempts > 1:
                echo(f"pod: succeeded after {attempts} attempts")
            return 0
        if rc == EXIT_TIMEOUT:
            echo(f"pod: attempt {attempts} hit the job timeout — terminal, "
                 "no restart")
            return EXIT_TIMEOUT
        if rc == 255 and spec.transport == "ssh":
            # a transport fault, not a training crash: its own budget of
            # consecutive no-progress failures
            if probe.advanced():
                transport_failures = 0
                window_culprits.clear()
            transport_failures += 1
            window_culprits.update(failed)
            if transport_failures <= SSH_CONNECT_RETRIES:
                echo(f"pod: ssh transport failure — restarting the gang "
                     f"without charging the restart budget "
                     f"({transport_failures}/{SSH_CONNECT_RETRIES})")
                continue
            if _reshape("is unreachable over ssh after "
                        f"{transport_failures} consecutive attempts"):
                continue
            echo("pod: ssh transport failure budget exhausted")
            return 1
        progressed = probe.advanced()
        if progressed:
            window_culprits.clear()
        window_culprits.update(failed)
        failures_since_progress = charge_restart_budget(
            failures_since_progress, progressed, echo=echo, what="pod")
        echo(f"pod: attempt {attempts} failed rc={rc} after "
             f"{time.monotonic() - start:.1f}s")
        if failures_since_progress > max_restarts:
            if _reshape(f"failed {failures_since_progress} consecutive "
                        "attempts without progress"):
                continue
            echo(f"pod: restart budget exhausted ({max_restarts} restarts "
                 "without progress)")
            return rc if isinstance(rc, int) and rc > 0 else 1


# -- the pod data plane's journal audit --------------------------------------


def _pod_close_rows(events: Sequence[dict]) -> list[dict]:
    """The per-epoch close rows of a merged event stream: `pod_epoch_close`
    rows (one per rank per epoch, from `data-dryrun`) and the per-host
    rows of each chief `host_skew` event (pod training), each normalized
    to {epoch, rank, hosts, order_digest, shard_digest, ingest_bytes,
    ingest_s}."""
    rows: list[dict] = []
    for ev in events:
        kind = ev.get("kind")
        if kind == "pod_epoch_close":
            rows.append({
                "epoch": ev.get("epoch"), "rank": ev.get("rank"),
                "hosts": ev.get("hosts"),
                "order_digest": ev.get("order_digest"),
                "shard_digest": ev.get("shard_digest"),
                "ingest_bytes": ev.get("ingest_bytes"),
                "ingest_s": ev.get("ingest_s"),
            })
        elif kind == "host_skew":
            members = ev.get("hosts") or []
            for r in members:
                if not isinstance(r, dict):
                    continue
                rows.append({
                    "epoch": ev.get("epoch"), "rank": r.get("rank"),
                    "hosts": len(members),
                    "order_digest": r.get("order_digest"),
                    "shard_digest": r.get("shard_digest"),
                    "ingest_bytes": r.get("ingest_bytes"),
                    "ingest_s": r.get("ingest_s"),
                })
    return [r for r in rows
            if isinstance(r["epoch"], int) and isinstance(r["rank"], int)]


def pod_verify_events(events: Sequence[dict],
                      balance_limit: float = 1.5) -> dict:
    """Audit a pod run's merged journals (obs/timeline.load_merged) against
    the pod data plane's invariants:
    - epoch_coverage: every epoch up to the last seen was closed by a
      complete cohort, some gang width n whose ranks 0..n-1 all closed it
      (a killed attempt's partial rows and a reshaped, narrower cohort
      are fine);
    - order_digest_agreement / shard_digest_agreement: inside every
      complete cohort the ranks carry one digest (rows without the field
      are skipped);
    - ingest_balance: the largest rank's cumulative source bytes at its
      last row within `balance_limit` x the even share (with at least two
      ranks ingesting);
    - recovery: after every injected `exit`/`raise`/`hang` chaos fault, a
      complete cohort closed at or after its epoch."""
    rows = _pod_close_rows(events)
    injections = [ev for ev in events
                  if ev.get("kind") == "chaos_inject"
                  and ev.get("action") in ("exit", "raise", "hang")]
    checks: list[dict] = []

    def check(name: str, ok: bool, detail: str) -> None:
        checks.append({"check": name, "ok": bool(ok), "detail": detail})

    by_epoch: dict[int, list[dict]] = {}
    for r in rows:
        by_epoch.setdefault(int(r["epoch"]), []).append(r)

    def complete_cohorts(epoch_rows: list[dict]) -> list[list[dict]]:
        """The groups by gang width whose ranks cover 0..n-1 (the newest
        row of a (width, rank) wins: a re-run epoch supersedes)."""
        by_width: dict[int, dict[int, dict]] = {}
        for r in epoch_rows:
            n = r.get("hosts")
            if isinstance(n, int) and n > 0:
                by_width.setdefault(n, {})[int(r["rank"])] = r
        return [list(ranks.values())
                for n, ranks in sorted(by_width.items())
                if set(ranks) == set(range(n))]

    epochs = sorted(by_epoch)
    missing = []
    disagree_order: list[int] = []
    disagree_shard: list[int] = []
    for ep in (range(epochs[-1] + 1) if epochs else ()):
        cohorts = complete_cohorts(by_epoch.get(ep, []))
        if not cohorts:
            missing.append(ep)
            continue
        for cohort in cohorts:
            for key, sink in (("order_digest", disagree_order),
                              ("shard_digest", disagree_shard)):
                vals = {r[key] for r in cohort if r.get(key) is not None}
                if len(vals) > 1:
                    sink.append(ep)
    n_epochs = (epochs[-1] + 1) if epochs else 0
    check("epoch_coverage", not missing and n_epochs > 0,
          f"{n_epochs - len(missing)}/{n_epochs} epochs closed by a "
          f"complete cohort" + (f"; missing {missing}" if missing else ""))
    check("order_digest_agreement", not disagree_order,
          "all complete cohorts agree" if not disagree_order
          else f"disagreement at epochs {sorted(set(disagree_order))}")
    check("shard_digest_agreement", not disagree_shard,
          "all complete cohorts agree" if not disagree_shard
          else f"disagreement at epochs {sorted(set(disagree_shard))}")

    # cumulative ingest bytes at each rank's last row (the counters only
    # grow within an attempt)
    last_by_rank: dict[int, int] = {}
    for r in sorted(rows, key=lambda r: (r["epoch"])):
        if isinstance(r.get("ingest_bytes"), (int, float)):
            last_by_rank[int(r["rank"])] = int(r["ingest_bytes"])
    loads = [b for b in last_by_rank.values() if b > 0]
    if len(loads) >= 2:
        share = sum(loads) / len(loads)
        worst = max(loads)
        ok = worst <= share * balance_limit
        check("ingest_balance", ok,
              f"max {worst} bytes vs even share {share:.0f} "
              f"(limit x{balance_limit:g}) across {len(loads)} ranks")
    else:
        check("ingest_balance", True,
              "fewer than 2 ranks recorded ingest bytes — skipped")
    if injections:
        last_inj_epoch = max(int(ev.get("epoch") or 0) for ev in injections)
        recovered = any(
            ep >= last_inj_epoch and complete_cohorts(by_epoch.get(ep, []))
            for ep in epochs)
        check("recovery", recovered,
              f"{len(injections)} injected kill(s), last at epoch "
              f"{last_inj_epoch}; "
              + ("a complete cohort closed at/after it"
                 if recovered else "no complete cohort after it"))
    verdict = "PASS" if all(c["ok"] for c in checks) else "FAIL"
    return {
        "verdict": verdict,
        "checks": checks,
        "counts": {
            "epochs": n_epochs,
            "close_rows": len(rows),
            "ranks": len({r["rank"] for r in rows}),
            "injections": len(injections),
        },
    }
