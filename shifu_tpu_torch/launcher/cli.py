"""The operator's command line (the port's copy of the single-host `train`
and `cache` commands of shifu_tpu/launcher/cli.py).

Usage:
    python -m shifu_tpu_torch.launcher.cli train \\
        --modelconfig ModelConfig.json --columnconfig ColumnConfig.json \\
        --data /path/to/normalized [...] \\
        [--globalconfig global.xml] [--output out_dir] [--supervise] \\
        [--device cpu]
    python -m shifu_tpu_torch.launcher.cli cache <dir> [--prune] [--json]

`train` assembles the job from the Shifu files, the `shifu.*` keys of the
--globalconfig XML (`utils/xmlconfig.py`) and the flags, in that order of
precedence, writes `ModelConfig.json`, `ColumnConfig.json`,
`global-final.xml` and `job-config.json` into the job dir, trains on
`cuda:0` (or `--device`; the CPU only when asked), streams the epoch lines
to `console.board`, and at the end writes `final_model` (the artifact
`ScoringDaemon(engine="torch")` serves), `metrics.jsonl` and the
`telemetry/` journal and scrape file.  A remote --output (gs:// hdfs://
mock://) writes the same tree through `data/fsio.py`; the artifact is
built locally and uploaded.  It returns a Shifu-style exit
status: 0 success, 1 failure, 3 timeout; a SIGTERM drain exits 75.
`--supervise` runs the same command as a child under the restart
supervisor (`launcher/supervisor.py`), which restarts it on 75 or any
other failure, and the checkpoint's auto-resume continues it.

Not ported yet, each raising NotImplementedError that names its ROADMAP.md
item: `--hosts` and `--num-processes` > 1 (multi-host, queue A item (f)),
`--detach` (e)5, the AOT serving pack (e)4, and a mesh of more than one
device (f).  The other subcommands of the JAX CLI are queue A item (e)5.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import shutil
import sys
import tempfile
import time
from typing import Optional, Sequence

from ..data import fsio

EXIT_OK = 0
EXIT_FAIL = 1
EXIT_TIMEOUT = 3


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="shifu-tpu-torch")
    sub = p.add_subparsers(dest="command", required=True)

    t = sub.add_parser("train", help="train a model from Shifu configs")
    t.add_argument("--modelconfig", required=True,
                   help="Shifu ModelConfig.json")
    t.add_argument("--columnconfig", required=True,
                   help="Shifu ColumnConfig.json")
    t.add_argument("--data", nargs="*", default=[],
                   help="training data files/dirs")
    t.add_argument("--globalconfig", default=None,
                   help="Hadoop-style XML (-globalconfig parity)")
    t.add_argument("--output", default=None, help="job output dir")
    t.add_argument("--devices", type=int, default=0,
                   help="limit device count (0 = all; the port trains on "
                        "one device)")
    t.add_argument("--device", default=None,
                   help="torch device to train on (default cuda:0; 'cpu' "
                        "only when asked)")
    t.add_argument("--epochs", type=int, default=0, help="override epochs")
    t.add_argument("--batch-size", type=int, default=0,
                   help="override batch size")
    t.add_argument("--cache-dir", default=None,
                   help="parse-once columnar data cache dir (also via "
                        "SHIFU_TPU_DATA_CACHE)")
    t.add_argument("--timeout", type=int, default=0,
                   help="job timeout seconds (0 = none)")
    t.add_argument("--supervise", action="store_true",
                   help="run under the restart supervisor")
    t.add_argument("--num-processes", type=int, default=0,
                   help="coordinated processes on this machine (not ported "
                        "yet beyond 1: ROADMAP.md queue A item (f))")
    t.add_argument("--hosts", default=None,
                   help="pod-scale launch (not ported yet: ROADMAP.md "
                        "queue A item (f))")
    t.add_argument("--max-restarts", type=int, default=-1,
                   help="supervisor restart budget (-1 = from config)")
    t.add_argument("--detach", action="store_true",
                   help="submit and return (not ported yet: ROADMAP.md "
                        "queue A item (e)5)")
    t.add_argument("--chaos-plan", default=None,
                   help="declarative fault-injection plan: inline JSON or a "
                        "path to a JSON file (schema in shifu_tpu_torch/"
                        "chaos/plan.py); exported to children as "
                        "SHIFU_TPU_CHAOS_PLAN")

    ch = sub.add_parser(
        "cache", help="inspect the columnar data cache: list entries "
                      "(tier/version/bytes/source) and prune superseded, "
                      "orphaned, or legacy-format ones (data/cache.py)")
    ch.add_argument("cache_dir",
                    help="cache directory (DataConfig.cache_dir / "
                         "SHIFU_TPU_DATA_CACHE)")
    ch.add_argument("--prune", action="store_true",
                    help="remove tmp leftovers, legacy pre-v2 entries, and "
                         "entries whose source changed or vanished")
    ch.add_argument("--json", action="store_true",
                    help="machine-readable entry list instead of text")
    return p


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, queue A item {item})")


def _assemble_job(args, write_files: bool = True):
    """(JobConfig, job dir): the Shifu files, then the XML's `shifu.*`
    keys, then the flags; with `write_files` the raw Shifu inputs and the
    merged view (`global-final.xml`, `job-config.json`) go into the job
    dir."""
    from ..config import job_config_from_shifu
    from ..utils import xmlconfig

    job = job_config_from_shifu(args.modelconfig, args.columnconfig,
                                data_paths=tuple(args.data))
    merged_xml: dict[str, str] = {}
    if args.globalconfig:
        merged_xml = xmlconfig.parse_configuration_xml(args.globalconfig)
        job = xmlconfig.apply_to_job(job, merged_xml)

    out_dir = _resolve_out_dir(args)
    remote_out = fsio.is_remote(out_dir)
    if not remote_out:
        os.makedirs(out_dir, exist_ok=True)

    # overrides, highest precedence (the reference's programmatic layer)
    train = job.train
    if args.epochs:
        train = dataclasses.replace(train, epochs=args.epochs)
    data = job.data
    if args.batch_size:
        data = dataclasses.replace(data, batch_size=args.batch_size)
    if args.cache_dir:
        data = dataclasses.replace(data, cache_dir=args.cache_dir)
    runtime = job.runtime
    if args.timeout:
        runtime = dataclasses.replace(runtime, timeout_seconds=args.timeout)
    if not runtime.checkpoint.directory:
        runtime = dataclasses.replace(
            runtime, checkpoint=dataclasses.replace(
                runtime.checkpoint,
                directory=fsio.join(out_dir, "tmp_model")))
    if not runtime.final_model_path:
        runtime = dataclasses.replace(
            runtime, final_model_path=fsio.join(out_dir, "final_model"))
    job = job.replace(train=train, data=data, runtime=runtime)

    if write_files:
        # the raw Shifu inputs beside the derived configs: the job dir
        # alone reproduces the run (a remote job dir writes through fsio)
        for src in (args.modelconfig, args.columnconfig):
            dst = fsio.join(out_dir, os.path.basename(src))
            if remote_out:
                with open(src, "rb") as f:
                    fsio.write_bytes(dst, f.read())
            elif os.path.realpath(src) != os.path.realpath(dst):
                shutil.copyfile(src, dst)
        final_conf = {**merged_xml,
                      "shifu.application.epochs": str(job.train.epochs),
                      "shifu.application.final-model-path":
                          job.runtime.final_model_path,
                      "shifu.application.tmp-model-path":
                          job.runtime.checkpoint.directory}
        if remote_out:
            fsio.write_bytes(fsio.join(out_dir, "global-final.xml"),
                             xmlconfig.configuration_xml_bytes(final_conf))
            fsio.write_bytes(fsio.join(out_dir, "job-config.json"),
                             job.to_json().encode())
        else:
            xmlconfig.write_configuration_xml(
                final_conf, os.path.join(out_dir, "global-final.xml"))
            with open(os.path.join(out_dir, "job-config.json"), "w") as f:
                f.write(job.to_json())
    return job, out_dir


def _resolve_out_dir(args) -> str:
    """The job output dir, resolved once (attempts must share it)."""
    return args.output or os.path.join(
        os.getcwd(), f"shifu_tpu_job_{time.strftime('%Y%m%d_%H%M%S')}")


def _child_train_args(args, out_dir: str) -> list[str]:
    """A `train` child argv rebuilt from the parsed args, --output pinned
    (shared checkpoints and board), the supervisor's flags stripped."""
    child = ["train",
             "--modelconfig", args.modelconfig,
             "--columnconfig", args.columnconfig,
             "--output", out_dir]
    if args.data:
        child += ["--data", *args.data]
    if args.globalconfig:
        child += ["--globalconfig", args.globalconfig]
    for flag, val in (("--devices", args.devices), ("--epochs", args.epochs),
                      ("--batch-size", args.batch_size),
                      ("--timeout", args.timeout),
                      ("--cache-dir", args.cache_dir),
                      ("--device", args.device)):
        if val:
            child += [flag, str(val)]
    return child


def _activate_chaos(args) -> int:
    """Export `--chaos-plan` into the environment (children inherit it on
    every restart), validate it now (a typo'd plan fails the launch), pin
    the job-scoped trigger state file into the job dir and keep the plan
    beside the job.  Returns nonzero on a bad plan."""
    from .. import chaos

    try:
        if args.chaos_plan:
            # export the content, never a path: a child may run elsewhere
            base = chaos.load_plan(args.chaos_plan.strip())
            os.environ[chaos.ENV_CHAOS_PLAN] = base.to_json(indent=None)
        plan = chaos.reload_from_env()
    except chaos.ChaosPlanError as e:
        print(f"chaos plan: {e}", file=sys.stderr, flush=True)
        return EXIT_FAIL
    if plan is None or not plan.faults:
        return EXIT_OK
    if chaos.ENV_CHAOS_STATE not in os.environ:
        out_dir = _resolve_out_dir(args)
        args.output = out_dir  # pin: a re-resolve could timestamp anew
        if not fsio.is_remote(out_dir):
            os.makedirs(out_dir, exist_ok=True)
            os.environ[chaos.ENV_CHAOS_STATE] = os.path.join(
                out_dir, "chaos_state.json")
            try:
                with open(os.path.join(out_dir, "chaos_plan.json"),
                          "w") as f:
                    f.write(plan.to_json())
            except OSError:
                pass
        else:
            try:  # the audit trail persists through fsio; no state file
                fsio.write_bytes(fsio.join(out_dir, "chaos_plan.json"),
                                 plan.to_json().encode())
            except Exception:
                pass
    return EXIT_OK


def _check_ported(args) -> None:
    if args.hosts:
        raise _not_ported("--hosts (pod-scale launch)", "(f)")
    if args.num_processes > 1:
        raise _not_ported("--num-processes > 1", "(f)")
    if args.detach:
        raise _not_ported("--detach", "(e)5")
    if args.devices > 1:
        raise _not_ported("--devices > 1 (the port trains on one device)",
                          "(f)")


def _check_job_ported(job, args) -> None:
    from ..utils import xmlconfig
    mesh = job.runtime.mesh
    if mesh.data * mesh.model * mesh.seq * mesh.pipe > 1:
        raise _not_ported(f"a mesh of more than one device ({mesh})", "(f)")
    if args.globalconfig:
        conf = xmlconfig.parse_configuration_xml(args.globalconfig)
        if xmlconfig.parse_bool(conf.get(xmlconfig.KEY_SERVING_AOT_PACK,
                                         "false")):
            raise _not_ported("the AOT serving pack "
                              "(shifu.serving.aot-pack)", "(e)4")


def run_train(args) -> int:
    # the chaos plan first: its env must be exported before any child
    # spawns, and a malformed plan fails here, at submit time
    rc_chaos = _activate_chaos(args)
    if rc_chaos != EXIT_OK:
        return rc_chaos
    _check_ported(args)

    from ..device import resolve_device
    dev = resolve_device(args.device)  # raises where CUDA is absent

    if args.supervise:
        from .supervisor import supervise
        out_dir = _resolve_out_dir(args)
        args.output = out_dir  # pin: a second resolve could timestamp anew
        if not fsio.is_remote(out_dir):
            os.makedirs(out_dir, exist_ok=True)
        sup_job = _assemble_job(args, write_files=False)[0]
        _check_job_ported(sup_job, args)
        max_restarts = (args.max_restarts if args.max_restarts >= 0
                        else sup_job.runtime.max_restarts)
        return supervise(_child_train_args(args, out_dir),
                         max_restarts=max_restarts,
                         board_path=fsio.join(out_dir, "console.board"),
                         liveness_seconds=sup_job.runtime.liveness_seconds,
                         checkpoint_dir=sup_job.runtime.checkpoint.directory,
                         timeout_seconds=sup_job.runtime.timeout_seconds)

    # chaos site "launcher.start": process start-up, before any work
    from .. import chaos
    try:
        chaos.maybe_fail("launcher.start")
    except chaos.ChaosError as e:
        print(f"chaos: {e}", file=sys.stderr, flush=True)
        return EXIT_FAIL

    job, out_dir = _assemble_job(args)
    _check_job_ported(job, args)

    from .security import KerberosError, ensure_kerberos_ticket
    try:
        ensure_kerberos_ticket(job.runtime.kerberos_principal,
                               job.runtime.kerberos_keytab)
    except KerberosError as e:
        print(f"kerberos auth failed: {e}", file=sys.stderr, flush=True)
        return EXIT_FAIL

    from .. import obs
    from ..train.loop import train
    from .console import ConsoleBoard
    from .supervisor import JobDeadline

    t_run = time.monotonic()
    # telemetry: SHIFU_TPU_METRICS_DIR wins, else <job dir>/telemetry
    try:
        obs.configure(obs.resolve_metrics_dir()
                      or fsio.join(out_dir, "telemetry"))
    except Exception:
        pass  # telemetry must never block the job
    obs.counter("launcher_runs_total", "train runs started").inc()
    board = ConsoleBoard(fsio.join(out_dir, "console.board"))
    board(f"shifu_tpu_torch train: {job.runtime.app_name} device={dev} "
          f"model={job.model.model_type} epochs={job.train.epochs} "
          f"batch={job.data.batch_size}")
    obs.gauge("launcher_devices_in_use", "devices this run trains on").set(1)
    obs.event("run_start", command="train", app_name=job.runtime.app_name,
              devices=1, mesh=None, model=job.model.model_type,
              epochs=job.train.epochs, batch_size=job.data.batch_size,
              processes=1)

    def _finish(rc: int) -> int:
        # the terminal record and scrape file on every exit path
        obs.event("run_end", exit=rc,
                  wall_s=round(time.monotonic() - t_run, 2))
        obs.flush()
        return rc

    deadline = JobDeadline(job.runtime.timeout_seconds)
    kinit_renew_s = 4 * 3600
    last_kinit = time.monotonic()

    def check_timeout(m) -> None:
        nonlocal last_kinit
        if deadline.expired():
            board(f"job timeout ({job.runtime.timeout_seconds}s) exceeded "
                  "— aborting")
            raise TimeoutError("job timeout")
        if (job.runtime.kerberos_principal
                and time.monotonic() - last_kinit > kinit_renew_s):
            ensure_kerberos_ticket(job.runtime.kerberos_principal,
                                   job.runtime.kerberos_keytab)
            last_kinit = time.monotonic()
        _maybe_inject_fault(m, board)

    try:
        result = train(job, console=board, epoch_callback=check_timeout,
                       device=dev)
    except TimeoutError:
        board.close()
        return _finish(EXIT_TIMEOUT)
    except Exception as e:  # noqa: BLE001 - job boundary
        board(f"training failed: {type(e).__name__}: {e}")
        obs.event("run_error", error=f"{type(e).__name__}: {e}"[:500])
        board.close()
        return _finish(EXIT_FAIL)

    export_dir = _export(result, job)
    board(f"model exported to {export_dir}")
    _write_metrics_jsonl(result, fsio.join(out_dir, "metrics.jsonl"))
    if result.history:
        last = result.history[-1]
        board(f"final: valid_error={last.valid_error:.6f} "
              f"valid_auc={last.valid_auc:.4f}")
    board.close()
    return _finish(EXIT_OK)


def _export(result, job) -> str:
    """The artifact at `runtime.final_model_path`; a remote destination
    is built in a local temporary directory and uploaded through fsio."""
    from .. import obs
    from ..export.artifact import save_artifact

    dest = job.runtime.final_model_path
    with obs.span("export", journal=False):
        if fsio.is_remote(dest):
            local_dir = tempfile.mkdtemp(prefix="shifu_tpu_torch_export_")
            try:
                save_artifact(result.state.model, job.model, job.schema,
                              local_dir)
                fsio.upload_dir(local_dir, dest)
            finally:
                shutil.rmtree(local_dir, ignore_errors=True)
        else:
            save_artifact(result.state.model, job.model, job.schema, dest)
    obs.event("export", dest=dest)
    return dest


def _write_metrics_jsonl(result, path: str) -> None:
    """One JSON object per epoch (`EpochMetrics`), NaN and Inf as null."""
    def _clean(v):
        if isinstance(v, float) and not math.isfinite(v):
            return None
        return v

    lines = [json.dumps({k: _clean(v) for k, v in
                         dataclasses.asdict(m).items()}, allow_nan=False)
             for m in result.history]
    payload = ("\n".join(lines) + "\n") if lines else ""
    try:
        if fsio.is_remote(path):
            fsio.write_bytes(path, payload.encode())
        else:
            with open(path, "w") as f:
                f.write(payload)
    except Exception:
        pass  # best-effort; the board already has the lines


def _maybe_inject_fault(metrics, board) -> None:
    """Chaos site "train.epoch": the post-epoch boundary, after the epoch's
    checkpoint save."""
    from .. import chaos

    def echo(msg: str) -> None:
        print(msg, flush=True)
        board(msg)

    chaos.maybe_fail("train.epoch", echo=echo, epoch=metrics.epoch)


def run_cache(args) -> int:
    """`cache <dir>`: every cache artifact classified (raw, projected,
    consolidated dataset; format version, bytes, recorded source,
    freshness), and `--prune` to reclaim superseded, orphaned, legacy or
    half-written entries.  File reads only."""
    from ..data import cache as cache_lib

    if not os.path.isdir(args.cache_dir):
        print(f"cache: no such directory: {args.cache_dir}",
              file=sys.stderr, flush=True)
        return EXIT_FAIL
    try:
        entries = cache_lib.scan_cache(args.cache_dir)
    except OSError as e:
        print(f"cache: {e}", file=sys.stderr, flush=True)
        return EXIT_FAIL
    removed = cache_lib.prune_cache(args.cache_dir, entries) \
        if args.prune else []
    kept = [e for e in entries if e not in removed]
    if args.json:
        print(json.dumps({"cache_dir": args.cache_dir, "entries": kept,
                          "pruned": removed,
                          "total_bytes": sum(e["bytes"] for e in kept)}))
        return EXIT_OK
    if not entries:
        print(f"{args.cache_dir}: empty cache")
        return EXIT_OK

    def line(e):
        src = e["source"] or "-"
        ver = e["version"] if e["version"] is not None else "-"
        return (f"  {e['tier']:<9} v{ver:<3} {e['bytes']:>12,} B  "
                f"{e['status']:<8} {e['name']}"
                + (f"  <- {src}" if src != "-" else ""))

    print(f"{args.cache_dir}: {len(kept)} entries, "
          f"{sum(e['bytes'] for e in kept):,} bytes")
    for e in kept:
        print(line(e))
    if args.prune:
        print(f"pruned {len(removed)} entries "
              f"({sum(e['bytes'] for e in removed):,} bytes reclaimed)")
        for e in removed:
            print(f"  removed [{e['status']}] {e['name']}")
    else:
        stale = [e for e in kept
                 if e["status"] in cache_lib.PRUNE_STATUSES]
        if stale:
            print(f"{len(stale)} prunable entries "
                  f"({sum(e['bytes'] for e in stale):,} bytes) — "
                  f"rerun with --prune to reclaim")
    return EXIT_OK


def _arm_pdeathsig() -> None:
    """A supervised child dies with its supervisor.

    The supervisor spawns each attempt in its own session, which also
    detaches it from the supervisor's fate: a SIGTERM is forwarded, but an
    uncatchable supervisor death (SIGKILL, OOM kill) would orphan the
    attempt.  When the supervisor marks the environment
    (supervisor.ENV_PDEATHSIG = its pid, optionally ":<signum>"), arm
    Linux PR_SET_PDEATHSIG(SIGTERM) through ctypes `prctl`, so the kernel
    delivers the drain signal on the parent's death; then close the
    fork-to-arm race by signalling ourselves when os.getppid() is no
    longer the recorded parent.  The variable is popped, so no descendant
    sees a stale parent pid.  Linux only; best-effort."""
    val = os.environ.pop("SHIFU_TPU_PDEATHSIG", None)
    if not val or sys.platform != "linux":
        return
    try:
        import signal as signal_lib

        parts = val.split(":")
        expected_parent = int(parts[0])
        sig = int(parts[1]) if len(parts) > 1 else int(signal_lib.SIGTERM)
    except ValueError:
        return
    try:
        import ctypes

        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(1, sig, 0, 0, 0)  # 1 = PR_SET_PDEATHSIG
        if os.getppid() != expected_parent:
            os.kill(os.getpid(), sig)
    except Exception:
        pass  # never block start-up


def main(argv: Optional[Sequence[str]] = None) -> int:
    _arm_pdeathsig()
    args = build_parser().parse_args(argv)
    if args.command == "train":
        return run_train(args)
    if args.command == "cache":
        return run_cache(args)
    return EXIT_FAIL


if __name__ == "__main__":
    sys.exit(main())
