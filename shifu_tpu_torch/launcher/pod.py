"""The pod plane's host grammar and per-host spawn command (the port's copy
of `PodSpec`, `parse_hosts`, `_host_command` and `member_command` of
shifu_tpu/launcher/pod.py).

The serving fleet (runtime/fleet.py `HostPlane`) places its members on
the hosts this grammar names and spawns each `serve` child through
`member_command`:

- ``local:N``: N simulated hosts on this machine (the fleet's drills); a
  child inherits this process's environment plus the contract, and is
  tethered to this process by the pdeathsig marker
  (launcher/supervisor.ENV_PDEATHSIG, armed by cli._arm_pdeathsig).
- ``h1,h2,...`` or ``@hostfile``: one child per host over ``ssh -tt``
  (the tty makes a parent-side kill reach the remote process as HUP);
  the environment contract rides inline (``env K=V ...``), so no remote
  shell profile can drop it.

The children run `python -m shifu_tpu_torch.launcher.cli`.  The gang
launch of a multi-host training job (`launch_gang`, `supervise_pod`,
`pod_verify_events`, `detect_hosts_env`) is ROADMAP.md queue A item (f).
"""

from __future__ import annotations

import os
import shlex
import sys
from dataclasses import dataclass
from typing import Optional, Sequence

from .supervisor import CHILD_MODULE, ENV_PDEATHSIG


@dataclass(frozen=True)
class PodSpec:
    hosts: tuple[str, ...]           # rank i runs on hosts[i]
    transport: str                   # "local" | "ssh"
    remote_python: str = sys.executable  # interpreter on the hosts


def parse_hosts(value: str) -> PodSpec:
    """``local:N`` -> N simulated hosts here; ``@file`` -> a newline-
    separated host list; ``h1,h2,...`` -> ssh to each host.

    The serving fleet needs no rendezvous port, so the JAX PodSpec's
    `coordinator_port` comes with the gang launch (ROADMAP.md (f))."""
    value = value.strip()
    if value.startswith("local:"):
        n = int(value.split(":", 1)[1])
        if n < 1:
            raise ValueError(f"--hosts {value!r}: need at least 1 process")
        return PodSpec(hosts=("local",) * n, transport="local")
    if value.startswith("@"):
        with open(value[1:]) as f:
            hosts = tuple(h.strip() for h in f if h.strip()
                          and not h.lstrip().startswith("#"))
    else:
        hosts = tuple(h.strip() for h in value.split(",") if h.strip())
    if not hosts:
        raise ValueError(f"--hosts {value!r}: no hosts")
    return PodSpec(hosts=hosts, transport="ssh")


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
