"""TPU slice provisioning — the compute-acquisition layer (port of
shifu_tpu/launcher/provision.py: the same gcloud command lines for the
same spec).

The port drives the JAX package's control surface unchanged: Cloud TPU
queued resources through `gcloud`.  It has no provisioner of its own for
GPU machines, which the JAX package lacks too.

Successor of the reference's YARN resource acquisition: one command there
went `yarnClient.createApplication -> submitApplication ->
monitorApplication` (yarn/client/TensorflowClient.java:339-426) with the AM
allocating containers (yarn/appmaster/AMRMCallbackHandler.java:148-190).
On Cloud TPU the unit of compute is a *queued resource* — a slice request
the TPU scheduler fulfils when capacity frees — so acquisition is:

    create (queued-resources create)
      -> await ACTIVE (describe poll; WAITING_FOR_RESOURCES is the queue)
      -> derive worker hosts (tpu-vm describe networkEndpoints, worker order)
      -> run the pod (launcher/pod.py dispatch over ssh)
      -> release (queued-resources delete)

Everything shells out to `gcloud` (the supported control surface; no egress
assumptions beyond it), so tests drive the full flow against a fake gcloud
on PATH — the same technique as the fake-ssh transport e2e.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import time
from dataclasses import dataclass, replace
from typing import Callable, Optional, Sequence

# Hadoop-style XML keys (the shifu.* namespace, like every other subsystem)
KEY_NAME = "shifu.provision.name"
KEY_ACCELERATOR = "shifu.provision.accelerator-type"
KEY_ZONE = "shifu.provision.zone"
KEY_PROJECT = "shifu.provision.project"
KEY_RUNTIME_VERSION = "shifu.provision.runtime-version"
KEY_SPOT = "shifu.provision.spot"
KEY_TIMEOUT = "shifu.provision.ready-timeout-seconds"

# states a queued resource moves through (queued-resources describe)
_READY_STATES = ("ACTIVE",)
_PENDING_STATES = ("ACCEPTED", "PROVISIONING", "WAITING_FOR_RESOURCES",
                   "CREATING")
_DEAD_STATES = ("FAILED", "SUSPENDED", "SUSPENDING", "DELETING")


class ProvisionError(RuntimeError):
    """gcloud failed or the slice cannot become ready."""


@dataclass(frozen=True)
class ProvisionSpec:
    name: str
    accelerator_type: str            # e.g. v5litepod-16
    zone: str                        # e.g. us-west4-a
    project: str = ""                # "" = gcloud's configured default
    runtime_version: str = "tpu-ubuntu2204-base"
    spot: bool = False               # preemptible capacity
    ready_timeout_seconds: float = 1800.0
    poll_seconds: float = 10.0       # reference client polled every 10s
                                     # (TensorflowClient.java:625-658)

    def validate(self) -> None:
        missing = [k for k, v in (("name", self.name),
                                  ("accelerator-type", self.accelerator_type),
                                  ("zone", self.zone)) if not v]
        if missing:
            raise ProvisionError(
                "provisioning needs shifu.provision."
                + "/".join(missing)
                + " (or the matching --provision-* flags)")


def spec_from_xml(conf: dict, **overrides) -> ProvisionSpec:
    """Build a spec from shifu.provision.* keys, overridden by kwargs
    (CLI flags are the programmatic layer, like the reference's)."""
    from ..utils.xmlconfig import parse_bool
    raw_timeout = conf.get(KEY_TIMEOUT, ProvisionSpec.ready_timeout_seconds)
    try:
        timeout = float(raw_timeout)
    except (TypeError, ValueError):
        raise ProvisionError(
            f"{KEY_TIMEOUT} must be a number of seconds, got "
            f"{raw_timeout!r}") from None
    spec = ProvisionSpec(
        name=conf.get(KEY_NAME, ""),
        accelerator_type=conf.get(KEY_ACCELERATOR, ""),
        zone=conf.get(KEY_ZONE, ""),
        project=conf.get(KEY_PROJECT, ""),
        runtime_version=conf.get(KEY_RUNTIME_VERSION,
                                 ProvisionSpec.runtime_version),
        spot=parse_bool(conf.get(KEY_SPOT, False)),
        ready_timeout_seconds=timeout,
    )
    fields = {k: v for k, v in overrides.items() if v}
    return replace(spec, **fields) if fields else spec


def _gcloud_bin() -> str:
    path = shutil.which("gcloud")
    if not path:
        raise ProvisionError(
            "no `gcloud` on PATH — provisioning drives Cloud TPU queued "
            "resources through the gcloud CLI")
    return path


def _run(args: Sequence[str]) -> str:
    proc = subprocess.run([_gcloud_bin(), *args], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise ProvisionError(
            f"gcloud {' '.join(args[:4])}... failed (rc={proc.returncode}): "
            f"{proc.stderr.strip()[:500]}")
    return proc.stdout


def _common(spec: ProvisionSpec) -> list[str]:
    out = ["--zone", spec.zone]
    if spec.project:
        out += ["--project", spec.project]
    return out


def create(spec: ProvisionSpec, echo=print) -> None:
    """Submit the slice request (node id == queued-resource id == name)."""
    spec.validate()
    args = ["compute", "tpus", "queued-resources", "create", spec.name,
            "--node-id", spec.name,
            "--accelerator-type", spec.accelerator_type,
            "--runtime-version", spec.runtime_version,
            *_common(spec)]
    if spec.spot:
        args.append("--spot")
    echo(f"provision: requesting {spec.accelerator_type} in {spec.zone} "
         f"as {spec.name!r}" + (" (spot)" if spec.spot else ""))
    _run(args)


def state(spec: ProvisionSpec) -> str:
    out = _run(["compute", "tpus", "queued-resources", "describe", spec.name,
                *_common(spec), "--format", "json"])
    doc = json.loads(out or "{}")
    st = doc.get("state")
    if isinstance(st, dict):  # API nests it: {"state": {"state": "ACTIVE"}}
        st = st.get("state")
    return str(st or "UNKNOWN").upper()


def await_ready(spec: ProvisionSpec, echo=print) -> None:
    """Poll until ACTIVE; raise on a dead state or timeout (the successor
    of the client-side monitor loop, TensorflowClient.java:625-658)."""
    deadline = time.monotonic() + spec.ready_timeout_seconds
    last = None
    while True:
        st = state(spec)
        if st != last:
            echo(f"provision: {spec.name} is {st}")
            last = st
        if st in _READY_STATES:
            return
        if st in _DEAD_STATES:
            raise ProvisionError(f"queued resource {spec.name} entered "
                                 f"terminal state {st}")
        if time.monotonic() > deadline:
            raise ProvisionError(
                f"queued resource {spec.name} not ready after "
                f"{spec.ready_timeout_seconds:.0f}s (last state {st}); it "
                "remains queued — `shifu-tpu-torch provision delete` to "
                "release")
        time.sleep(spec.poll_seconds)


def worker_hosts(spec: ProvisionSpec) -> list[str]:
    """The slice's worker IPs in WORKER ORDER — the order that defines the
    pod's host ranks (launcher/pod.py dispatch)."""
    out = _run(["compute", "tpus", "tpu-vm", "describe", spec.name,
                *_common(spec), "--format", "json"])
    doc = json.loads(out or "{}")
    endpoints = doc.get("networkEndpoints") or []
    hosts = [e.get("ipAddress", "") for e in endpoints]
    hosts = [h for h in hosts if h]
    if not hosts:
        raise ProvisionError(
            f"tpu-vm describe {spec.name} returned no networkEndpoints — "
            "is the node ready?")
    return hosts


def serving_hosts(spec: ProvisionSpec) -> str:
    """The slice's workers as a `--hosts`-grammar string (comma-joined,
    worker order) — what `shifu-tpu-torch fleet --hosts` / `shifu.fleet.hosts`
    consume to place serving members on a provisioned slice through the
    same launcher/pod.py ssh transport the training gang uses."""
    return ",".join(worker_hosts(spec))


def delete(spec: ProvisionSpec, echo=print) -> bool:
    """Release the slice (idempotent best-effort: releasing twice or
    releasing a failed create must not mask the original error).  Returns
    True when gcloud accepted the delete — callers keeping a release
    trail (the provision.json marker) must NOT clear it on False.

    A NOT_FOUND answer counts as a successful release: the resource never
    materialized (create itself failed) or is already gone, and either way
    there is nothing left to bill — treating it as failure would pin the
    marker forever and make every later `kill` retry a delete that can
    never succeed.  The match is anchored to the RESOURCE (the NOT_FOUND
    API code, or 'not found' near the slice's own name): a 'project foo
    not found' / 'zone bar not found' environment error at release time
    must stay a FAILURE so the still-billing slice keeps its trail."""
    import re as re_lib
    try:
        _run(["compute", "tpus", "queued-resources", "delete", spec.name,
              *_common(spec), "--quiet", "--force"])
        echo(f"provision: released {spec.name}")
        return True
    except ProvisionError as e:
        msg = str(e)
        name = re_lib.escape(spec.name)
        if ("NOT_FOUND" in msg
                or re_lib.search(name + r".{0,60}not found", msg, re_lib.I)
                or re_lib.search(r"not found.{0,60}" + name, msg, re_lib.I)):
            echo(f"provision: {spec.name} not found — nothing to release")
            return True
        echo(f"provision: release of {spec.name} failed ({e}); release "
             "manually with `gcloud compute tpus queued-resources delete`")
        return False


MARKER_FILE = "provision.json"


def write_marker(spec: ProvisionSpec, out_dir: str, keep: bool = False,
                 echo=print) -> None:
    """Durable record of the acquired slice in the JOB DIR: if the
    provisioning dispatcher dies uncleanly (SIGKILL, host loss) between
    create and release, the billing slice would otherwise leak with no
    record outside `gcloud list` — the marker lets `kill <job_dir>` (and
    an operator reading the dir) find and release it.  Best-effort and
    local-only: a remote job dir keeps its authoritative state in gcloud
    itself."""
    try:
        from ..data import fsio
        if fsio.is_remote(out_dir):
            return
        os.makedirs(out_dir, exist_ok=True)
        # the dispatcher's pid+host let a later `kill <job_dir>` tell a
        # LIVE foreground provision run (which writes no job.json) from a
        # dead one before releasing the slice out from under a gang
        with open(os.path.join(out_dir, MARKER_FILE), "w") as f:
            json.dump({"name": spec.name, "zone": spec.zone,
                       "project": spec.project, "keep": bool(keep),
                       "pid": os.getpid(), "host": os.uname().nodename,
                       "created_at": time.time()}, f)
    except Exception as e:  # never fail the job for bookkeeping
        echo(f"provision: could not record {MARKER_FILE} ({e})")


def clear_marker(out_dir: str) -> None:
    try:
        os.unlink(os.path.join(out_dir, MARKER_FILE))
    except OSError:
        pass


def read_marker(out_dir: str) -> Optional[dict]:
    try:
        with open(os.path.join(out_dir, MARKER_FILE)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def release_from_marker(out_dir: str, echo=print) -> bool:
    """Release the slice a marker records (used by `kill <job_dir>` —
    YARN parity: killing the application frees its containers).  Returns
    True when a release was attempted and the marker cleared; a marker
    with keep=True is respected and left in place."""
    marker = read_marker(out_dir)
    if not marker or not marker.get("name"):
        return False
    if marker.get("keep"):
        echo(f"provision: slice {marker['name']!r} was kept deliberately "
             "(--keep-slice); not releasing")
        return False
    spec = ProvisionSpec(name=marker["name"],
                         accelerator_type="-",  # delete needs name+zone only
                         zone=marker.get("zone", ""),
                         project=marker.get("project", ""))
    if delete(spec, echo=echo):
        clear_marker(out_dir)  # gcloud REFUSED -> keep the release trail
        return True
    return False


def provision_and_run(spec: ProvisionSpec,
                      run_fn: Callable[[list[str]], int],
                      echo=print,
                      keep: bool = False,
                      marker_dir: Optional[str] = None) -> int:
    """The one-command lifecycle: nothing -> slice -> gang -> released.

    `run_fn(hosts)` runs the job (the pod dispatch) once the slice is
    ACTIVE; the slice is released on EVERY exit path unless `keep` (a
    failed run must not leak a billing TPU — the YARN analog was the RM
    reclaiming containers when the app died).  `marker_dir` records the
    acquisition durably so even an UNCLEAN dispatcher death leaves a
    release trail (write_marker) — written BEFORE the create call, so a
    death mid-create still leaves the trail (a marker for a slice that
    never materialized is harmless: delete answers NOT_FOUND, which counts
    as released, so the marker drains instead of orphaning)."""
    # Whether the marker dir already trailed THIS slice name before we
    # (re)wrote it: a same-name, unkept marker survives the clobber guard
    # precisely because it is the trail of a previous unclean death — and
    # that is also the case where create() answers ALREADY_EXISTS (the
    # dead run's slice still exists and bills).  In that case the marker
    # is the ONLY release path (`kill --force`), so it must be kept.
    prior_same_name_trail = False
    if marker_dir:
        # a marker dir holds ONE release trail: clobbering a previous
        # run's marker for a DIFFERENT slice — or for a deliberately KEPT
        # one — would destroy the only record of a still-billing TPU.
        # Refuse loudly; overwriting our own (same-name, unkept) stale
        # trail is fine — delete is idempotent for the same resource.
        existing = read_marker(marker_dir)
        if existing and existing.get("name") and (
                existing["name"] != spec.name or existing.get("keep")):
            raise ProvisionError(
                f"{marker_dir}/{MARKER_FILE} already records slice "
                f"{existing['name']!r}"
                + (" (kept with --keep-slice)" if existing.get("keep")
                   else "")
                + " — release it first (`shifu-tpu-torch kill --force "
                f"{marker_dir}` or gcloud delete) or use a different "
                "--output")
        prior_same_name_trail = bool(existing and existing.get("name"))
        # written UNKEPT even under --keep-slice: the keep flag makes
        # release_from_marker refuse unconditionally, and until create()
        # succeeds this marker may be trailing a PREVIOUS unclean death's
        # still-billing slice (the ALREADY_EXISTS branch below), whose only
        # kill path it is.  The keep flag is recorded once create() proves
        # the slice is this run's own.
        write_marker(spec, marker_dir, keep=False, echo=echo)
    release = True
    try:
        # create() inside the release scope: a failed create still runs
        # the delete (NOT_FOUND -> released) so the marker never orphans.
        # EXCEPT name collisions: ALREADY_EXISTS means a slice this run
        # did NOT create (e.g. an earlier --keep-slice run) — releasing
        # it would tear down a live slice we don't own, so drop only our
        # marker and leave the resource alone.  UNLESS the marker dir
        # already trailed this same name before this run: then the
        # colliding slice is a previous unclean death's still-billing
        # resource and the marker is its only kill path — keep it.
        try:
            create(spec, echo=echo)
        except ProvisionError as e:
            if ("ALREADY_EXISTS" in str(e)
                    or "already exists" in str(e).lower()):
                release = False
                if marker_dir and not prior_same_name_trail:
                    clear_marker(marker_dir)
            raise
        if marker_dir and keep:
            # create succeeded: the slice is ours — NOW record the keep
            # flag so the clobber guard protects it from later runs
            write_marker(spec, marker_dir, keep=True, echo=echo)
        await_ready(spec, echo=echo)
        hosts = worker_hosts(spec)
        echo(f"provision: {len(hosts)} worker hosts: {', '.join(hosts)}")
        return run_fn(hosts)
    finally:
        if not release:
            pass
        elif keep:
            echo(f"provision: keeping {spec.name} (--keep-slice)")
        elif delete(spec, echo=echo) and marker_dir:
            clear_marker(marker_dir)
