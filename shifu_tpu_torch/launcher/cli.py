"""The operator's command line (the port's copy of shifu_tpu/launcher/
cli.py: `train`, `cache`, `score`, `eval`, `export`, `serve`,
`loadtest`, `fleet`, `fleet-verify`, `provision`, `pod-verify`,
`data-dryrun`, the views and the job commands).

Usage:
    python -m shifu_tpu_torch.launcher.cli train \\
        --modelconfig ModelConfig.json --columnconfig ColumnConfig.json \\
        --data /path/to/normalized [...] \\
        [--globalconfig global.xml] [--output out_dir] [--supervise] \\
        [--device cpu]
    python -m shifu_tpu_torch.launcher.cli cache <dir> [--prune] [--json]
    python -m shifu_tpu_torch.launcher.cli score --model ART --input ROWS \\
        [--output -] [--native | --engine auto|torch|export|aot|numpy|native]
    python -m shifu_tpu_torch.launcher.cli eval --model ART \\
        --columnconfig C.json --data DIR [--scores-output F] [--engine ...]
    python -m shifu_tpu_torch.launcher.cli export --modelconfig M.json \\
        --columnconfig C.json --checkpoint-dir JOB/tmp_model --output ART \\
        [--aot-pack]
    python -m shifu_tpu_torch.launcher.cli serve ART [--port 0] [--engine ...]
        [--heartbeat-s S [--heartbeat-misses N]]
    python -m shifu_tpu_torch.launcher.cli loadtest (--model ART |
        --connect HOST:PORT) [--rate R] [--duration S] [--json]
    python -m shifu_tpu_torch.launcher.cli fleet ART [--n-daemons N] \
        [--standbys K] [--hosts local:N|h1,h2|@file] \
        [--member-mode auto|inproc|process] [--port 8571] [--device cpu]
    python -m shifu_tpu_torch.launcher.cli fleet-verify DIR [--json]
    python -m shifu_tpu_torch.launcher.cli metrics|profile|trace|drift|
        timeline|chaos-verify JOB [--json] [...]
    python -m shifu_tpu_torch.launcher.cli top DIR [DIR ...] [--once]
    python -m shifu_tpu_torch.launcher.cli train ... --detach
    python -m shifu_tpu_torch.launcher.cli train ... --hosts local:N \
        [--coordinator-port P] | --num-processes N | --provision [...]
    python -m shifu_tpu_torch.launcher.cli provision create|status|hosts|
        delete [--provision-name ...]
    python -m shifu_tpu_torch.launcher.cli pod-verify DIR [--json]
    python -m shifu_tpu_torch.launcher.cli data-dryrun --data D --out O
    python -m shifu_tpu_torch.launcher.cli status|attach|kill [--force] JOB

Each command that scores takes `--device` (default `cuda:0`; the torch
tiers raise where CUDA is absent unless `--device cpu`; the numpy and
native engines score on the host either way).  The engines are
runtime/serve.load_engine's; the default, `auto`, is the best tier for
`--device` (export/scorer.load_scorer): aot, export, torch on the card,
the op-list interpreter first on the CPU.  `--native` is `--engine
native` and contradicts any other engine, as in JAX.

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

The export sequence (`_export_and_pack`, shared by the train tail and the
`export` command) writes the artifact with its `scoring.pt2`, the AOT pack
where `shifu.serving.aot-pack` (or `export --aot-pack`) asks, and then
`model.bin` for the native engine, best-effort, as in JAX.

The operator's views (`metrics`, `profile`, `trace`, `top`, `drift`,
`timeline`, `chaos-verify`) render the journals and scrape files a job or
a daemon wrote (obs/render.py, obs/timeline.py, obs/aggregate.py), and
the job commands (`status`, `attach`, `kill`) drive a `train --detach` job
from its directory (launcher/detach.py).  Like the JAX package's, which
never import jax, they import no torch and touch no card: each is safe to
point at a live job from any machine that can read its dir.

`fleet` runs N scoring daemons and their hot standbys behind the router's
wire face (runtime/fleet.py, runtime/router.py), its members scoring on
`--device` (default `cuda:0`); in-process members by default, `serve`
children with `--member-mode process`.  `serve --heartbeat-s` writes the
fleet's membership lease, and `fleet-verify` audits a fleet's merged
journals, importing no torch, as the views do.

`train --devices N`, or a `shifu.mesh.*` mesh of N devices, trains on N
devices: the dispatcher spawns N ranks of the same command with the
environment contract of `parallel/distributed.py` (`parallel/launch.py`),
each on `cuda:r` (or the CPU under `--device cpu`); each rank joins the
process group, builds the mesh and trains its part (`train(...,
mesh=)`); the chief alone writes the job dir's files, the journal, the
board, the checkpoints and the artifact, and the ranks end on a barrier.
`--supervise` restarts the whole gang as one child.  A mesh larger than
the visible cards exits 1 with the JAX package's message; `--devices 1`
is the single-device path.

`train --hosts local:N|h1,h2|@file` (or SHIFU_TPU_HOSTS) runs a pod
(launcher/pod.py): one process per host, each reading its own shard of
the files, supervised as one gang with the restart budget and, with
`shifu.pod.min-hosts`, the elastic reshape; `--num-processes N` is one
unsupervised attempt of `local:N`.  A host with several cards (on the CPU
SHIFU_TPU_CPU_DEVICES) runs one rank per card.  `train --provision`
acquires a Cloud TPU slice through gcloud first and releases it after,
as the JAX package does (launcher/provision.py; the `provision` command
drives the slice alone).  `pod-verify` audits a pod's journals, and
`data-dryrun` is the data plane's rank without training, the child of
the elastic drill.
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
                   help="limit device count (0 = all visible cards; on the "
                        "CPU the ranks to spawn); one rank per device")
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
                   help="spawn N coordinated processes on this machine, "
                        "each a host of a simulated pod with its own file "
                        "shard (the one-machine spelling of --hosts "
                        "local:N)")
    t.add_argument("--hosts", default=None,
                   help="pod-scale launch: dispatch one process per host "
                        "with whole-gang supervised restart. Forms: "
                        "'h1,h2,...' (ssh, in worker order), '@hostfile', "
                        "or 'local:N' (simulated pod on this machine). Env "
                        "spelling: SHIFU_TPU_HOSTS")
    t.add_argument("--max-restarts", type=int, default=-1,
                   help="supervisor restart budget (-1 = from config)")
    t.add_argument("--coordinator-port", type=int, default=0,
                   help="ssh-pod rendezvous port on hosts[0] (default 8476; "
                        "env spelling: SHIFU_TPU_COORDINATOR_PORT)")
    t.add_argument("--detach", action="store_true",
                   help="submit as a detached daemon (supervised) and "
                        "return; drive it with status/attach/kill")
    t.add_argument("--chaos-plan", default=None,
                   help="declarative fault-injection plan: inline JSON or a "
                        "path to a JSON file (schema in shifu_tpu_torch/"
                        "chaos/plan.py); exported to children as "
                        "SHIFU_TPU_CHAOS_PLAN")
    t.add_argument("--provision", action="store_true",
                   help="acquire a TPU slice first (shifu.provision.* keys "
                        "/ --provision-* flags), dispatch the pod onto its "
                        "workers, release the slice when the job ends")
    t.add_argument("--keep-slice", action="store_true",
                   help="with --provision: leave the slice running after "
                        "the job (release with `provision delete`)")
    _add_provision_flags(t)

    pv = sub.add_parser(
        "provision", help="TPU slice lifecycle (Cloud TPU queued "
                          "resources through gcloud, as the JAX package "
                          "drives them)")
    pv.add_argument("action", choices=["create", "status", "hosts", "delete"])
    pv.add_argument("--globalconfig", default=None,
                    help="Hadoop-style XML carrying shifu.provision.* keys")
    pv.add_argument("--wait", action="store_true",
                    help="with create: block until the slice is ACTIVE")
    _add_provision_flags(pv)

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

    st = sub.add_parser("status", help="report a detached job's state "
                                       "(RUNNING/FINISHED/FAILED + last "
                                       "progress line + telemetry summary) "
                                       "from its job dir")
    st.add_argument("job_dir")
    mt = sub.add_parser(
        "metrics", help="render a job's telemetry — run journal + "
                        "Prometheus scrape file — for a running or "
                        "finished job")
    mt.add_argument("job_dir",
                    help="job dir, telemetry dir, or journal.jsonl path "
                         "(local or gs:// hdfs:// URI)")
    mt.add_argument("--json", action="store_true",
                    help="machine-readable summary dict instead of text")
    mt.add_argument("--follow", action="store_true",
                    help="stream journal events as JSONL until ^C "
                         "(tail_board for the structured stream)")
    pf = sub.add_parser(
        "profile", help="render a job's goodput ledger: per-epoch wall-time "
                        "buckets (compile/input/step/checkpoint/restore/"
                        "eval/other), MFU, the flight recorder's top "
                        "kernels, and the recovery tax")
    pf.add_argument("job_dir",
                    help="job dir, telemetry dir, or journal.jsonl path "
                         "(local or gs:// hdfs:// URI)")
    pf.add_argument("--json", action="store_true",
                    help="machine-readable profile dict instead of text")
    tr = sub.add_parser(
        "trace", help="render a job's device flight recorder: per-kernel "
                      "device-time rollups from the captured trace "
                      "windows (compute- vs HBM-bound), the anomaly log "
                      "with its per-chunk ring, and HBM watermarks")
    tr.add_argument("job_dir",
                    help="job dir, telemetry dir, or journal.jsonl path "
                         "(local or gs:// hdfs:// URI)")
    tr.add_argument("--json", action="store_true",
                    help="machine-readable trace dict instead of text")
    tp = sub.add_parser(
        "top", help="live streaming view of a job or serving daemon — "
                    "rate/p50/p99, queue depth, lifecycle stage breakdown "
                    "(queue/coalesce/dispatch/device), active SLO alerts; "
                    "pass several dirs for a multi-daemon fleet rollup "
                    "(journal/scrape tail only — no torch import)")
    tp.add_argument("job_dirs", nargs="+",
                    help="job dir(s), telemetry dir(s), or journal.jsonl "
                         "path(s) — N dirs render the fleet rollup "
                         "(obs/aggregate.serving_rollup)")
    tp.add_argument("--once", action="store_true",
                    help="render one frame and exit (scripting / CI)")
    tp.add_argument("--json", action="store_true",
                    help="machine-readable frame(s): one JSON dict per "
                         "frame (JSONL when streaming)")
    tp.add_argument("--interval", type=float, default=2.0,
                    help="refresh seconds for the streaming view "
                         "(default 2)")
    tp.add_argument("--stale-after", type=float, default=None,
                    help="mark a daemon DOWN when its freshest signal "
                         "(fleet lease or journal tail) is older than "
                         "this many seconds (default: each member's own "
                         "lease ttl when present, else never)")
    cv = sub.add_parser(
        "chaos-verify", help="audit a finished chaos drill: replay the "
                             "recorded plan against the run journal and "
                             "report injected-vs-recovered counts")
    cv.add_argument("job_dir", help="job dir (or telemetry dir / journal "
                                    "path) of the finished run")
    cv.add_argument("--plan", default=None,
                    help="chaos plan to check against (inline JSON or "
                         "path); default: <job_dir>/chaos_plan.json")
    cv.add_argument("--json", action="store_true",
                    help="machine-readable report dict instead of text")
    at = sub.add_parser("attach", help="follow a detached job's console "
                                       "board until it ends; exits with "
                                       "the job's code")
    at.add_argument("job_dir")
    at.add_argument("--tail", action="store_true",
                    help="start from the board's current end, not the top")
    kl = sub.add_parser("kill", help="terminate a detached job's whole "
                                     "process tree (SIGTERM drain, then "
                                     "SIGKILL)")
    kl.add_argument("job_dir")
    kl.add_argument("--force", action="store_true",
                    help="release a provisioned slice even when the marker "
                         "names a live dispatcher or another host")
    dr = sub.add_parser(
        "drift", help="model-quality / data-drift panel for a serving "
                      "daemon: per-feature PSI vs the frozen baseline "
                      "profile, score-distribution divergence, live AUC "
                      "decay from labeled feedback, and firing drift "
                      "alerts (journal tail only — no torch import)")
    dr.add_argument("job_dir",
                    help="serving job dir, telemetry dir, or "
                         "journal.jsonl path (train dirs render the "
                         "journaled baseline-profile summary)")
    dr.add_argument("--json", action="store_true",
                    help="machine-readable drift dict instead of text")
    dr.add_argument("--model", default=None,
                    help="restrict to one model_id (default: all)")
    dr.add_argument("--feature", default=None,
                    help="restrict the PSI table to one named feature")
    tl = sub.add_parser(
        "timeline", help="skew-corrected causal timeline: merge every "
                         "member's journal into one ordered event "
                         "stream, stitch incidents (failover / SLO / "
                         "degraded-swap episodes) and show sampled "
                         "request traces end to end")
    tl.add_argument("job_dir", help="telemetry/job dir (member journals "
                                    "are discovered one level below)")
    tl.add_argument("--json", action="store_true",
                    help="machine-readable summary on stdout")
    tl.add_argument("--trace-id", default=None,
                    help="show one trace: its router hop spans and "
                         "per-member stage decompositions")
    tl.add_argument("--incident", action="store_true",
                    help="incident records only (root event, causal "
                         "chain, affected traces, recovery)")
    tl.add_argument("--no-skew-correct", action="store_true",
                    help="merge on raw per-host timestamps (skip the "
                         "heartbeat-derived clock-offset correction)")

    s = sub.add_parser("score", help="score rows with an exported artifact")
    s.add_argument("--model", required=True, help="artifact dir")
    s.add_argument("--input", required=True,
                   help="rows file (pipe-delimited or .parquet)")
    s.add_argument("--output", default="-", help="output file (- = stdout)")
    s.add_argument("--native", action="store_true",
                   help="use the C++ engine")
    _add_engine_flag(s, "auto", "scoring engine tier (auto = best "
                                "tier for --device)")
    s.add_argument("--globalconfig", default=None,
                   help="Hadoop-style XML (shifu.security.* for secured "
                        "HDFS)")
    _add_device_flag(s)

    sv = sub.add_parser(
        "serve", help="run the persistent scoring daemon on an exported "
                      "artifact: admission queue + adaptive micro-batching "
                      "under a latency budget, hot-swap, TCP wire front-end")
    sv.add_argument("model", help="artifact dir (the export output)")
    _add_engine_flag(sv, None, "scoring engine tier (default: "
                               "serving.engine / torch)")
    sv.add_argument("--port", type=int, default=-1,
                    help="TCP port (0 = ephemeral, printed at startup; "
                         "default: shifu.serving.port / 8571)")
    sv.add_argument("--host", default=None,
                    help="bind host (default: shifu.serving.host / "
                         "127.0.0.1)")
    sv.add_argument("--budget-ms", type=float, default=0,
                    help="micro-batcher latency budget in ms (default: "
                         "shifu.serving.latency-budget-ms / 2)")
    sv.add_argument("--max-batch", type=int, default=0,
                    help="largest coalesced batch (default: "
                         "shifu.serving.max-batch / 4096)")
    sv.add_argument("--workers", type=int, default=0,
                    help="scoring worker threads (default: "
                         "shifu.serving.workers / 1)")
    sv.add_argument("--globalconfig", default=None,
                    help="Hadoop-style XML carrying shifu.serving.* keys "
                         "(flags override)")
    sv.add_argument("--chaos-plan", default=None,
                    help="fault-injection plan for serving drills "
                         "(runtime.serve probe site)")
    sv.add_argument("--allow-swap", action="store_true",
                    help="permit wire SWAP frames on a non-loopback bind "
                         "(hot-loads a filesystem path as the model, an "
                         "AOT pack's kernel libraries included; loopback "
                         "binds allow it by default)")
    sv.add_argument("--heartbeat-s", type=float, default=0.0,
                    help="write a fleet membership lease into the metrics "
                         "dir every N seconds (0 = off; a fleet manager in "
                         "another process reads it)")
    sv.add_argument("--heartbeat-misses", type=int, default=3,
                    help="missed beats before the fleet marks this "
                         "daemon DOWN (rides in the lease; default 3)")
    _add_device_flag(sv)

    fl = sub.add_parser(
        "fleet", help="run a fault-tolerant serving fleet: N scoring "
                      "daemons + hot standbys under heartbeat "
                      "supervision, a consistent-hash routing front end "
                      "with hedged retries and overload shedding, "
                      "fleet-wide hot-swap, burn-rate scale loop "
                      "(runtime/fleet.py)")
    fl.add_argument("model", help="artifact dir (the export output)")
    fl.add_argument("--n-daemons", type=int, default=0,
                    help="fleet members (default: shifu.fleet.n-daemons "
                         "/ 2)")
    fl.add_argument("--standbys", type=int, default=-1,
                    help="hot-standby daemons pre-warmed on the current "
                         "artifact (default: shifu.fleet.standbys / 1)")
    fl.add_argument("--heartbeat-s", type=float, default=0,
                    help="membership lease cadence (default: "
                         "shifu.fleet.heartbeat-every-s / 0.5)")
    fl.add_argument("--heartbeat-misses", type=int, default=0,
                    help="missed beats before failover (default: "
                         "shifu.fleet.heartbeat-misses / 3)")
    fl.add_argument("--port", type=int, default=8571,
                    help="router front-end TCP port (0 = ephemeral, "
                         "printed at startup; default 8571)")
    fl.add_argument("--host", default="127.0.0.1",
                    help="router bind host (default 127.0.0.1)")
    _add_engine_flag(fl, None, "member scoring engine tier (default: "
                               "serving.engine / torch)")
    fl.add_argument("--budget-ms", type=float, default=0,
                    help="member micro-batcher latency budget "
                         "(default: shifu.serving.latency-budget-ms / 2)")
    fl.add_argument("--workers", type=int, default=0,
                    help="scoring worker threads per member")
    fl.add_argument("--scale-every-s", type=float, default=-1,
                    help="burn-rate scale-loop cadence, 0 disables "
                         "(default: shifu.fleet.scale-every-s / 0)")
    fl.add_argument("--root-dir", default=None,
                    help="fleet state dir for member leases + telemetry "
                         "(default: <model>/fleet)")
    fl.add_argument("--globalconfig", default=None,
                    help="Hadoop-style XML carrying shifu.fleet.* and "
                         "shifu.serving.* keys (flags override)")
    fl.add_argument("--hosts", default=None,
                    help="cross-host member placement (launcher/pod.py "
                         "grammar: local:N simulated hosts, h1,h2 or "
                         "@file over ssh; default: shifu.fleet.hosts / "
                         "single-host)")
    fl.add_argument("--member-mode", default=None,
                    choices=["auto", "inproc", "process"],
                    help="member spawn mode (default: "
                         "shifu.fleet.member-mode / auto: in-process, "
                         "serve children over ssh)")
    fl.add_argument("--chaos-plan", default=None,
                    help="fault-injection plan (fleet.heartbeat / "
                         "fleet.lease / fleet.sync / fleet.route / "
                         "runtime.serve sites)")
    _add_device_flag(fl, "device the members score on")

    fv = sub.add_parser(
        "fleet-verify", help="audit a fleet run's journal: every "
                             "failover promoted a standby, swap "
                             "generations never regress, every swap "
                             "reached every live member exactly once "
                             "(chaos-verify's counterpart for the "
                             "serving fleet)")
    fv.add_argument("job_dir", help="fleet telemetry/job dir (or any "
                                    "dir holding its journal.jsonl)")
    fv.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout")

    pdv = sub.add_parser(
        "pod-verify", help="audit a pod training run's per-rank journals: "
                           "every epoch closed by a complete agreeing "
                           "cohort (order + shard digests), per-host "
                           "ingest stayed balanced, and every injected "
                           "host kill was followed by recovery")
    pdv.add_argument("job_dir", help="pod job/telemetry dir (per-rank "
                                     "journals are discovered one level "
                                     "below the root journal)")
    pdv.add_argument("--json", action="store_true",
                     help="machine-readable report on stdout")
    pdv.add_argument("--balance-limit", type=float, default=1.5,
                     help="max per-rank ingest bytes as a multiple of the "
                          "even share (default 1.5)")

    dd = sub.add_parser(
        "data-dryrun", help="pod data-plane dryrun rank: shard-local "
                            "ingest, per-epoch order/shard digests "
                            "journaled per rank, no device training — "
                            "the gang child of the elastic recovery drill "
                            "under `supervise_pod`")
    dd.add_argument("--data", required=True,
                    help="directory (or file) of delimited part files; "
                         "layout [target, f0..fN-1]")
    dd.add_argument("--out", required=True, help="job dir for per-rank "
                                                 "telemetry + progress")
    dd.add_argument("--features", type=int, default=8,
                    help="numeric feature count in the files (default 8)")
    dd.add_argument("--epochs", type=int, default=3)
    dd.add_argument("--batch-size", type=int, default=32)
    dd.add_argument("--delimiter", default="|")
    dd.add_argument("--seed", type=int, default=0,
                    help="shuffle seed pinning permutations and digests")
    dd.add_argument("--host-shard", default="auto",
                    choices=["auto", "static", "rotate"],
                    help="shard-assignment mode "
                         "(data/pipeline.host_shard_assignment)")
    dd.add_argument("--epoch-seconds", type=float, default=0.0,
                    help="simulated per-epoch wall (sleep) so kill/"
                         "liveness windows have something to land in")

    lt = sub.add_parser(
        "loadtest", help="open-loop (Poisson-arrival) load harness for "
                         "the scoring plane: reports scores/s and "
                         "p50/p99 latency (runtime/loadtest.py)")
    lt.add_argument("--model", default=None,
                    help="artifact dir: in-process mode, a daemon driven "
                         "directly")
    lt.add_argument("--connect", default=None,
                    help="host:port of a running `serve` daemon: socket "
                         "mode")
    lt.add_argument("--rate", type=float, default=50_000,
                    help="offered request rate per second (Poisson "
                         "arrivals; default 50000)")
    lt.add_argument("--duration", type=float, default=5.0,
                    help="seconds of offered load (default 5)")
    _add_engine_flag(lt, "auto", "engine tier for --model mode (auto = "
                                 "best tier for --device)")
    lt.add_argument("--senders", type=int, default=2,
                    help="open-loop sender threads (default 2)")
    lt.add_argument("--budget-ms", type=float, default=0,
                    help="daemon latency budget for --model mode "
                         "(default: serving default)")
    lt.add_argument("--capacity", action="store_true",
                    help="ramp the offered rate to find the highest one "
                         "meeting the p99 target instead of a single run")
    lt.add_argument("--p99-target-ms", type=float, default=10.0,
                    help="p99 target for --capacity (default 10ms)")
    lt.add_argument("--trace-sample", type=int, default=0,
                    help="trace 1-in-N requests and report the trace ids "
                         "of the slowest sampled ones (0 = off)")
    lt.add_argument("--trace-exemplars", type=int, default=5,
                    help="how many slowest-trace exemplars to report")
    lt.add_argument("--drift-after", type=float, default=0.0,
                    help="drift drill: after this many seconds, shift the "
                         "--drift-features columns by --drift-shift "
                         "(0 = off)")
    lt.add_argument("--drift-shift", type=float, default=2.0,
                    help="feature shift applied after --drift-after")
    lt.add_argument("--drift-features", default=None,
                    help="comma-separated feature indices to shift "
                         "(default: 0,1)")
    lt.add_argument("--feedback", action="store_true",
                    help="ship synthetic labeled feedback after the run")
    lt.add_argument("--json", action="store_true",
                    help="machine-readable report instead of text")
    _add_device_flag(lt)

    x = sub.add_parser(
        "export", help="re-export the scoring artifact from a checkpoint "
                       "(no retraining; crash-after-train recovery)")
    x.add_argument("--modelconfig", required=True,
                   help="Shifu ModelConfig.json")
    x.add_argument("--columnconfig", required=True,
                   help="Shifu ColumnConfig.json")
    x.add_argument("--checkpoint-dir", required=True,
                   help="checkpoint dir (the job's tmp_model)")
    x.add_argument("--output", required=True, help="artifact output dir")
    x.add_argument("--globalconfig", default=None,
                   help="Hadoop-style XML (same layering as train)")
    x.add_argument("--aot-pack", action="store_true",
                   help="also export the serving bucket ladder's programs "
                        "and their kernel libraries into aot/ "
                        "(export/aot.py; same opt-in as the "
                        "shifu.serving.aot-pack key)")
    _add_device_flag(x, "device the AOT pack is built for")

    e = sub.add_parser(
        "eval", help="score labeled rows and report AUC/error (the Shifu "
                     "eval step against this backend's artifacts)")
    e.add_argument("--model", required=True, help="artifact dir")
    e.add_argument("--columnconfig", required=True,
                   help="Shifu ColumnConfig.json (locates target/weight "
                        "cols)")
    e.add_argument("--data", nargs="+", required=True,
                   help="labeled normalized data files/dirs")
    e.add_argument("--modelconfig", default=None,
                   help="optional ModelConfig.json (target/weight col "
                        "names)")
    e.add_argument("--scores-output", default=None,
                   help="also write per-row scores to this file")
    e.add_argument("--native", action="store_true",
                   help="use the C++ engine")
    _add_engine_flag(e, "auto", "scoring engine tier (auto = best "
                                "tier for --device)")
    e.add_argument("--globalconfig", default=None,
                   help="Hadoop-style XML (shifu.security.* for secured "
                        "HDFS)")
    _add_device_flag(e)
    return p


# the JAX CLI's engine names are accepted so that "jax" and "stablehlo"
# fail with the port's counterparts named (runtime/serve.load_engine)
_ENGINE_CHOICES = ("auto", "torch", "export", "aot", "numpy", "native",
                   "jax", "stablehlo")


def _add_engine_flag(p, default, help_text: str) -> None:
    p.add_argument("--engine", default=default, choices=_ENGINE_CHOICES,
                   help=help_text)


def _add_device_flag(p, what: str = "device the torch tiers score on"
                     ) -> None:
    p.add_argument("--device", default=None,
                   help=f"{what} (default cuda:0; 'cpu' only when asked)")


def _add_provision_flags(p) -> None:
    p.add_argument("--provision-name", default="",
                   help="queued-resource / node id (shifu.provision.name)")
    p.add_argument("--accelerator-type", default="",
                   help="e.g. v5litepod-16 (shifu.provision.accelerator-type)")
    p.add_argument("--zone", default="",
                   help="e.g. us-west4-a (shifu.provision.zone)")
    p.add_argument("--project", default="",
                   help="GCP project (shifu.provision.project; default = "
                        "gcloud's configured project)")
    p.add_argument("--runtime-version", default="",
                   help="TPU VM runtime (shifu.provision.runtime-version)")
    p.add_argument("--spot", action="store_true",
                   help="request spot/preemptible capacity "
                        "(shifu.provision.spot)")


def _provision_spec(args):
    """ProvisionSpec from the --globalconfig shifu.provision.* keys, the
    flags on top."""
    from ..utils import xmlconfig
    from .provision import spec_from_xml

    conf: dict = {}
    if getattr(args, "globalconfig", None):
        conf = xmlconfig.parse_configuration_xml(args.globalconfig)
    return spec_from_xml(
        conf, name=args.provision_name,
        accelerator_type=args.accelerator_type, zone=args.zone,
        project=args.project, runtime_version=args.runtime_version,
        spot=args.spot)


def run_provision(args) -> int:
    from . import provision as prov

    try:
        spec = _provision_spec(args)
        if args.action == "create":
            prov.create(spec)
            if args.wait:
                prov.await_ready(spec)
            return EXIT_OK
        spec.validate()
        if args.action == "status":
            print(prov.state(spec))
        elif args.action == "hosts":
            print(",".join(prov.worker_hosts(spec)))
        else:
            prov.delete(spec)
        return EXIT_OK
    except prov.ProvisionError as e:
        print(f"provision: {e}", file=sys.stderr, flush=True)
        return EXIT_FAIL


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


def _child_train_args(args, out_dir: str,
                      num_processes: int = 0) -> list[str]:
    """A `train` child argv rebuilt from the parsed args, --output pinned
    (shared checkpoints and board), the supervisor's and the pod's flags
    stripped unless re-asked through `num_processes`."""
    child = ["train",
             "--modelconfig", args.modelconfig,
             "--columnconfig", args.columnconfig,
             "--output", out_dir]
    if args.data:
        child += ["--data", *args.data]
    if args.globalconfig:
        child += ["--globalconfig", args.globalconfig]
    if num_processes > 1:
        child += ["--num-processes", str(num_processes)]
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


def _train_world(args, job, dev) -> tuple[int, Optional[str]]:
    """(ranks to train on, or 0 with the reason it cannot), the JAX
    launcher's rule: a `shifu.mesh.*` mesh of more than one device takes
    exactly its size, which must fit the visible devices; else data
    parallelism over them.  Visible: the cards, capped by --devices; on
    the CPU, --devices ranks (the mesh's size when 0)."""
    need = job.runtime.mesh.num_devices
    if dev.type == "cuda":
        import torch
        n_devices = torch.cuda.device_count()
        if args.devices:
            n_devices = min(n_devices, args.devices)
    else:
        n_devices = args.devices or need
    if need > 1:
        if need > n_devices:
            return 0, (f"mesh {job.runtime.mesh} needs {need} devices, "
                       f"have {n_devices}")
        return need, None
    return max(n_devices, 1), None


def _run_gang(args, out_dir: str, world: int, dev) -> int:
    """Spawn `world` ranks of this `train` command (parallel/launch.py):
    rank r on cuda:r, or on the CPU."""
    from ..parallel.launch import spawn_ranks

    base = _child_train_args(args, out_dir)
    if "--device" in base:
        i = base.index("--device")
        del base[i:i + 2]

    def argv(rank: int) -> list[str]:
        return base + ["--device",
                       "cpu" if dev.type == "cpu" else f"cuda:{rank}"]

    return spawn_ranks(argv, world)


def _check_device(device: Optional[str]) -> None:
    """resolve_device's refusal of a missing card, without touching the
    card (a dispatcher only spawns the processes that use it)."""
    import torch
    if torch.device(device or "cuda:0").type == "cuda" \
            and not torch.cuda.is_available():
        from ..device import resolve_device
        resolve_device(device)  # raises, naming the CPU


def _spawn_processes(args, out_dir: str) -> int:
    """`--num-processes N`: N processes on this machine, each a host of a
    simulated pod (the one-machine spelling of `--hosts local:N`): one
    gang attempt through the pod launcher; restarts come from an outer
    `--supervise`, which re-enters here with a fresh gang."""
    from . import pod as pod_lib

    if args.devices:
        # a device prefix of the whole list would strand the other
        # processes outside the mesh; device counts are per process here
        print("--devices cannot combine with --num-processes "
              "(set SHIFU_TPU_CPU_DEVICES per process instead)",
              file=sys.stderr, flush=True)
        return EXIT_FAIL
    os.makedirs(out_dir, exist_ok=True)
    spec = pod_lib.PodSpec(hosts=("local",) * args.num_processes,
                           transport="local")
    rc, _failed = pod_lib.launch_gang(spec, _child_train_args(args, out_dir),
                                      out_dir, attempt=1)
    return rc


def _detach_argv(args, out_dir: str) -> list[str]:
    """The detached daemon's `train` argv: the slim child's, with the
    orchestration flags it strips put back."""
    child = _child_train_args(args, out_dir,
                              num_processes=args.num_processes)
    if args.hosts:
        child += ["--hosts", args.hosts]
    if args.provision:
        child += ["--provision"]
        for flag, val in (("--provision-name", args.provision_name),
                          ("--accelerator-type", args.accelerator_type),
                          ("--zone", args.zone), ("--project", args.project),
                          ("--runtime-version", args.runtime_version)):
            if val:
                child += [flag, val]
        if args.spot:
            child += ["--spot"]
        if args.keep_slice:
            child += ["--keep-slice"]
    elif args.supervise or not args.hosts:
        child += ["--supervise"]  # a detached job heals itself
    if args.max_restarts >= 0:
        child += ["--max-restarts", str(args.max_restarts)]
    if args.coordinator_port:
        child += ["--coordinator-port", str(args.coordinator_port)]
    return child


def _run_provisioned(args) -> int:
    """`--provision`: acquire a slice, dispatch the pod onto its workers,
    release it on every exit path (launcher/provision.provision_and_run).
    A SIGTERM meanwhile unwinds through SystemExit, so the release still
    runs (the marker in the job dir covers an uncatchable death)."""
    from . import provision as prov
    try:
        spec = _provision_spec(args)
        spec.validate()
    except prov.ProvisionError as e:
        print(f"provision: {e}", file=sys.stderr, flush=True)
        return EXIT_FAIL

    def _dispatch(hosts: list) -> int:
        args.hosts = ",".join(hosts)
        args.provision = False  # the re-entry takes the pod branch
        return run_train(args)

    import signal as signal_lib

    def _term_to_exit(signum, _frame):
        # the first SIGTERM starts the unwind; later ones are ignored, so
        # that none aborts the release's own gcloud call
        signal_lib.signal(signal_lib.SIGTERM, signal_lib.SIG_IGN)
        raise SystemExit(128 + signum)

    old_term, installed = None, False
    try:
        old_term = signal_lib.signal(signal_lib.SIGTERM, _term_to_exit)
        installed = True
    except ValueError:
        pass  # not the main thread: the marker still covers it
    try:
        args.output = _resolve_out_dir(args)
        return prov.provision_and_run(spec, _dispatch, keep=args.keep_slice,
                                      marker_dir=args.output)
    except prov.ProvisionError as e:
        print(f"provision: {e}", file=sys.stderr, flush=True)
        return EXIT_FAIL
    finally:
        if installed:
            signal_lib.signal(signal_lib.SIGTERM,
                              old_term if old_term is not None
                              else signal_lib.SIG_DFL)


def run_train(args) -> int:
    # the chaos plan first: its env must be exported before any child
    # spawns, and a malformed plan fails here, at submit time
    rc_chaos = _activate_chaos(args)
    if rc_chaos != EXIT_OK:
        return rc_chaos

    # --detach: re-launch this dispatcher as a session-leader daemon and
    # return; the daemon is a fresh process, so it holds no CUDA context
    # of this one, and trains on the parent's --device
    from . import detach as detach_lib
    if args.detach and detach_lib.ENV_DETACHED not in os.environ:
        out_dir = _resolve_out_dir(args)
        args.output = out_dir
        return detach_lib.submit(_detach_argv(args, out_dir), out_dir)

    # the pod (launcher/pod.py) and the provisioned pod: the dispatcher
    # routes here only in the parent; a dispatched child carries the
    # environment contract and runs the plain train path below
    from ..parallel import distributed
    from . import pod as pod_lib
    in_gang = distributed.ENV_PROCESS_ID in os.environ
    pod_hosts = args.hosts or pod_lib.detect_hosts_env()
    if args.provision and not in_gang:
        if pod_hosts:
            print("--provision and --hosts are exclusive (provisioning "
                  "derives the hosts from the new slice)",
                  file=sys.stderr, flush=True)
            return EXIT_FAIL
        return _run_provisioned(args)
    _check_device(args.device)
    if pod_hosts and not in_gang:
        try:
            spec = pod_lib.parse_hosts(pod_hosts, args.coordinator_port)
        except (ValueError, OSError) as e:
            print(f"--hosts: {e}", file=sys.stderr, flush=True)
            return EXIT_FAIL
        if args.num_processes > 1:
            print("--hosts and --num-processes are alternative spellings of "
                  "a process gang; use one", file=sys.stderr, flush=True)
            return EXIT_FAIL
        out_dir = _resolve_out_dir(args)
        args.output = out_dir  # pin: a second resolve could timestamp anew
        if not fsio.is_remote(out_dir):
            os.makedirs(out_dir, exist_ok=True)
        sup_job = _assemble_job(args, write_files=False)[0]
        max_restarts = (args.max_restarts if args.max_restarts >= 0
                        else sup_job.runtime.max_restarts)
        return pod_lib.supervise_pod(
            spec, _child_train_args(args, out_dir), out_dir,
            max_restarts=max_restarts,
            liveness_seconds=sup_job.runtime.liveness_seconds,
            checkpoint_dir=sup_job.runtime.checkpoint.directory,
            timeout_seconds=sup_job.runtime.timeout_seconds,
            min_hosts=sup_job.runtime.min_hosts)

    if args.supervise:
        from .supervisor import supervise
        out_dir = _resolve_out_dir(args)
        args.output = out_dir  # pin: a second resolve could timestamp anew
        if not fsio.is_remote(out_dir):
            os.makedirs(out_dir, exist_ok=True)
        sup_job = _assemble_job(args, write_files=False)[0]
        max_restarts = (args.max_restarts if args.max_restarts >= 0
                        else sup_job.runtime.max_restarts)
        return supervise(_child_train_args(args, out_dir,
                                           num_processes=args.num_processes),
                         max_restarts=max_restarts,
                         board_path=fsio.join(out_dir, "console.board"),
                         liveness_seconds=sup_job.runtime.liveness_seconds,
                         checkpoint_dir=sup_job.runtime.checkpoint.directory,
                         timeout_seconds=sup_job.runtime.timeout_seconds)

    if args.num_processes > 1 and not in_gang:
        return _spawn_processes(args, _resolve_out_dir(args))

    from ..device import resolve_device
    if distributed.pod_contract() is not None:
        if args.devices:
            print("--devices is not supported under multi-host (device "
                  "counts are per-process)", file=sys.stderr, flush=True)
            return EXIT_FAIL
        local = _host_devices(args.device)
        if local > 1 and int(os.environ[distributed.ENV_NUM_PROCESSES]) \
                == distributed.pod_contract()[1]:
            return _run_host_ranks(args, local)
    elif distributed.ENV_NUM_PROCESSES not in os.environ:
        # the dispatcher: more than one device spawns the gang of ranks
        dev = resolve_device(args.device)  # raises where CUDA is absent
        out_dir = _resolve_out_dir(args)
        args.output = out_dir  # pin: the ranks share one job dir
        world, why = _train_world(
            args, _assemble_job(args, write_files=False)[0], dev)
        if why is not None:
            from .console import ConsoleBoard
            board = ConsoleBoard(fsio.join(out_dir, "console.board"))
            board(why)
            board.close()
            return EXIT_FAIL
        if world > 1:
            return _run_gang(args, out_dir, world, dev)
    rc = _train_rank(args)
    if rc == EXIT_OK:
        # a failed rank leaves without the group's goodbye, which would
        # wait for peers that are gone
        distributed.shutdown()
    return rc


def _host_devices(device: Optional[str]) -> int:
    """The devices of this host a pod member drives: every visible card,
    or on the CPU SHIFU_TPU_CPU_DEVICES (the JAX package's spelling of a
    CPU host's device count; 1 without it)."""
    import torch
    if torch.device(device or "cuda:0").type == "cuda":
        return max(torch.cuda.device_count(), 1)
    try:
        return max(int(os.environ.get("SHIFU_TPU_CPU_DEVICES", "1") or 1), 1)
    except ValueError:
        return 1


def _run_host_ranks(args, local: int) -> int:
    """A pod member whose host has `local` devices: one rank per device
    in the pod's group, rank host * local + i on cuda:i (or the CPU),
    the world hosts * local (parallel/launch.spawn_ranks)."""
    from ..parallel import distributed
    from ..parallel.launch import spawn_ranks

    host, hosts = distributed.pod_contract()
    base = _child_train_args(args, _resolve_out_dir(args))
    if "--device" in base:
        i = base.index("--device")
        del base[i:i + 2]
    cpu = args.device == "cpu"

    def argv(i: int) -> list[str]:
        return base + ["--device", "cpu" if cpu else f"cuda:{i}"]

    return spawn_ranks(argv, local,
                       coordinator=os.environ[distributed.ENV_COORDINATOR],
                       world=hosts * local, first_rank=host * local)


def _train_rank(args) -> int:
    """`train` in this process: alone, or as a rank of a gang (the
    environment contract names its coordinator, world and rank; under a
    pod also its host count)."""
    # chaos site "launcher.start": process start-up, before the rendezvous
    # (a host that never joins; its peers are torn down by the gang's
    # dispatcher, and one down for good drives the pod's elastic reshape)
    from .. import chaos
    try:
        chaos.maybe_fail("launcher.start")
    except chaos.ChaosError as e:
        print(f"chaos: {e}", file=sys.stderr, flush=True)
        return EXIT_FAIL

    # the rendezvous, before any work on the card: every rank joins the
    # group (the placement decides its backend, parallel/distributed.py)
    from ..device import resolve_device
    from ..parallel import distributed
    dev = resolve_device(args.device)
    joined = distributed.initialize(device=dev)
    chief = distributed.is_chief()

    job, out_dir = _assemble_job(args, write_files=chief)
    mesh = None
    if joined:
        from ..config.schema import MeshConfig
        from ..parallel import make_mesh
        cfg = (job.runtime.mesh if job.runtime.mesh.num_devices > 1
               else MeshConfig(data=distributed.process_count()))
        mesh = make_mesh(cfg)

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
    # telemetry: SHIFU_TPU_METRICS_DIR wins, else <job dir>/telemetry; the
    # other ranks of a one-host gang journal nothing, a pod's other ranks
    # journal into rank-<r> below it (its chaos injections among their
    # events, which `pod-verify` audits)
    tele = obs.resolve_metrics_dir() or fsio.join(out_dir, "telemetry")
    if not chief and distributed.pod_contract() is not None:
        tele = fsio.join(tele, f"rank-{distributed.process_index()}")
    if chief or distributed.pod_contract() is not None:
        try:
            obs.configure(tele)
        except Exception:
            pass  # telemetry must never block the job
    obs.counter("launcher_runs_total", "train runs started").inc()
    board = (ConsoleBoard(fsio.join(out_dir, "console.board")) if chief
             else _SilentBoard())
    devices = mesh.size if mesh is not None else 1
    choice = distributed.backend_choice()
    board(f"shifu_tpu_torch train: {job.runtime.app_name} device={dev} "
          f"devices={devices} "
          f"mesh={mesh.shape if mesh is not None else None} "
          f"model={job.model.model_type} epochs={job.train.epochs} "
          f"batch={job.data.batch_size}"
          + (f" backend={choice['backend']} ({choice['reason']})"
             if choice else ""))
    obs.gauge("launcher_devices_in_use",
              "devices this run trains on").set(devices)
    obs.event("run_start", command="train", app_name=job.runtime.app_name,
              devices=devices,
              mesh=mesh.shape if mesh is not None else None,
              model=job.model.model_type,
              epochs=job.train.epochs, batch_size=job.data.batch_size,
              processes=distributed.process_count())

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
                       device=dev, mesh=mesh)
    except TimeoutError:
        board.close()
        return _finish(EXIT_TIMEOUT)
    except Exception as e:  # noqa: BLE001 - job boundary
        board(f"training failed: {type(e).__name__}: {e}")
        obs.event("run_error", error=f"{type(e).__name__}: {e}"[:500])
        board.close()
        return _finish(EXIT_FAIL)

    from ..train.loop import gathered_model
    model = gathered_model(result.state, job)  # collective when sharded
    if chief:
        aot_pack, aot_buckets = _export_aot_opts(args)
        _export_and_pack(model, job, job.runtime.final_model_path, board,
                         baseline_profile=result.baseline_profile,
                         aot_pack=aot_pack, aot_buckets=aot_buckets,
                         device=dev)
        _write_metrics_jsonl(result, fsio.join(out_dir, "metrics.jsonl"))
        if result.history:
            last = result.history[-1]
            board(f"final: valid_error={last.valid_error:.6f} "
                  f"valid_auc={last.valid_auc:.4f}")
    distributed.barrier("export_done")
    board.close()
    return _finish(EXIT_OK)


class _SilentBoard:
    """The console board of a rank that is not the chief: it trains
    silently, as the JAX package's non-chief processes do."""

    def __call__(self, _line: str) -> None:
        pass

    def close(self) -> None:
        pass


def _export_aot_opts(args) -> tuple:
    """(aot_pack, aot_buckets) for the export sequence: opt-in through the
    `shifu.serving.aot-pack` key of --globalconfig or the export command's
    --aot-pack flag; the rung grid comes from the same XML's serving
    ladder keys, so the pack matches what the daemons will serve."""
    from ..utils import xmlconfig

    cfg = None
    if getattr(args, "globalconfig", None):
        try:
            conf = xmlconfig.parse_configuration_xml(args.globalconfig)
            cfg = xmlconfig.serving_config_from_conf(conf)
        except Exception:
            cfg = None
    if not (getattr(args, "aot_pack", False) or (cfg and cfg.aot_pack)):
        return False, None
    from ..config.schema import ServingConfig
    from ..runtime.serve import bucket_ladder

    sc = cfg or ServingConfig()
    return True, bucket_ladder(sc.min_batch_bucket, sc.max_batch)


def _export_and_pack(model, job, dest: str, console,
                     baseline_profile=None, aot_pack: bool = False,
                     aot_buckets=None, device=None) -> str:
    """The one export sequence, shared by the train tail and the export
    command: the artifact at `dest` (with `scoring.pt2`, and the AOT pack
    for `device` when asked), then `model.bin` for the native engine,
    best-effort as in JAX.  A remote destination is built in a local
    temporary directory and uploaded through fsio."""
    from .. import obs
    from ..export.artifact import save_artifact
    from ..runtime.native_scorer import pack_native

    with obs.span("export", journal=False):
        remote = fsio.is_remote(dest)
        local_dir = (tempfile.mkdtemp(prefix="shifu_tpu_torch_export_")
                     if remote else dest)
        try:
            save_artifact(model, job.model, job.schema, local_dir,
                          baseline_profile=baseline_profile,
                          aot_pack=aot_pack, aot_buckets=aot_buckets,
                          aot_device=device)
            try:
                pack_native(local_dir)
            except Exception as e:  # the native pack is best-effort
                console(f"native pack skipped: {e}")
            if remote:
                fsio.upload_dir(local_dir, dest)
        finally:
            if remote:
                shutil.rmtree(local_dir, ignore_errors=True)
    obs.event("export", dest=dest)
    console(f"model exported to {dest}")
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


def _kerberos_from_xml(globalconfig) -> int:
    """Acquire a Kerberos ticket for score/eval when --globalconfig carries
    shifu.security.kerberos.* keys (the train command's fail-fast);
    returns an exit code (EXIT_OK to proceed)."""
    if not globalconfig:
        return EXIT_OK
    from ..utils import xmlconfig
    from .security import KerberosError, ensure_kerberos_ticket

    conf = xmlconfig.parse_configuration_xml(globalconfig)
    try:
        ensure_kerberos_ticket(conf.get(xmlconfig.KEY_KERBEROS_PRINCIPAL, ""),
                               conf.get(xmlconfig.KEY_KERBEROS_KEYTAB, ""))
    except KerberosError as e:
        print(f"kerberos auth failed: {e}", file=sys.stderr, flush=True)
        return EXIT_FAIL
    return EXIT_OK


def _load_scorer(model_dir: str, native: bool, engine: str = "auto",
                 device=None):
    """The engine for score and eval: `--native` or `--engine native` is
    the C++ engine, another name that tier of runtime/serve.load_engine,
    on `device` for the torch tiers.  Raises ValueError on contradictory
    flags or a tier the artifact cannot serve."""
    if native and engine not in ("auto", "native"):
        raise ValueError(
            f"--native contradicts --engine {engine}; drop one of them")
    from ..runtime.serve import load_engine
    return load_engine(model_dir, "native" if native else engine,
                       device=device)


def _project_features(rows, model_dir: str, scorer):
    """The artifact's feature columns of raw normalized rows: its
    `topology.json` selected_indices decide (the ColumnConfig on disk may
    have changed since training); full-width inputs pass through, and
    NaNs impute to 0 as in training."""
    import numpy as np

    n_feat = getattr(scorer, "num_features", None) or rows.shape[1]
    if rows.shape[1] != n_feat:
        sel = None
        try:
            with open(os.path.join(model_dir, "topology.json")) as f:
                sel = json.load(f).get("selected_indices")
        except (OSError, ValueError):
            pass
        if sel and rows.shape[1] > max(sel):
            rows = rows[:, sel]
        else:
            rows = rows[:, :n_feat]
    return np.nan_to_num(rows, nan=0.0)


def run_score(args) -> int:
    """`score`: rows of a file through one engine, one line of scores a
    row ('|'-joined heads, 6 decimals), as the JAX command writes them."""
    from .. import obs
    from ..data import reader

    obs.configure_from_env()
    rc = _kerberos_from_xml(args.globalconfig)
    if rc != EXIT_OK:
        return rc
    rows = reader.read_file(args.input)
    try:
        scorer = _load_scorer(args.model, args.native, args.engine,
                              args.device)
    except (ValueError, OSError, KeyError, RuntimeError) as e:
        # a tier the artifact cannot serve, or contradictory flags
        print(f"scorer: {e}", file=sys.stderr, flush=True)
        return EXIT_FAIL
    feats = _project_features(rows, args.model, scorer)
    out = sys.stdout if args.output == "-" else open(args.output, "w")
    try:
        # chunks bound the memory by the chunk, not the input
        chunk = 65536
        for lo in range(0, feats.shape[0], chunk):
            for row in scorer.compute_batch(feats[lo:lo + chunk]):
                out.write("|".join(f"{v:.6f}" for v in row) + "\n")
    finally:
        if out is not sys.stdout:
            out.close()
    obs.event("score_run", rows=int(feats.shape[0]), model=args.model)
    obs.flush()
    return EXIT_OK


def run_eval(args) -> int:
    """`eval`: score labelled normalized rows file by file and print one
    JSON summary (rows, AUC, weighted error, mean score, positive rate,
    and per head for a multi-head artifact), the Shifu eval step against
    the port's artifacts."""
    from .. import obs
    from ..config.shifu_compat import load_json, parse_column_config
    from ..data import reader
    from ..ops.metrics import StreamingMetrics

    obs.configure_from_env()
    rc = _kerberos_from_xml(args.globalconfig)
    if rc != EXIT_OK:
        return rc
    target_name = weight_name = multi_targets = None
    if args.modelconfig:
        dataset = load_json(args.modelconfig).get("dataSet", {}) or {}
        target_name = dataset.get("targetColumnName")
        weight_name = dataset.get("weightColumnName")
        multi_targets = dataset.get("multiTargetColumnNames")
    schema = parse_column_config(load_json(args.columnconfig),
                                 target_column_name=target_name,
                                 weight_column_name=weight_name,
                                 multi_target_names=multi_targets)
    paths: list[str] = []
    for p in args.data:
        paths.extend(reader.list_data_files(p))
    if not paths:
        print("eval: no data files found", file=sys.stderr)
        return EXIT_FAIL
    try:
        scorer = _load_scorer(args.model, args.native, args.engine,
                              args.device)
    except (ValueError, OSError, KeyError, RuntimeError) as e:
        print(f"scorer: {e}", file=sys.stderr, flush=True)
        return EXIT_FAIL
    # file by file: the metrics accumulate out of core (exact weighted
    # error, binned weighted AUC)
    accs: list = []
    n_heads = 0
    score_sum = 0.0
    pos_count = 0
    scores_out = None  # opened lazily: a failure leaves no stray file
    try:
        for p in sorted(paths):
            raw = reader.read_file(p)
            if raw.shape[0] == 0:
                continue
            if args.scores_output and scores_out is None:
                scores_out = open(args.scores_output, "w")
            cols = reader.project_columns(raw, schema)
            scores = scorer.compute_batch(
                _project_features(raw, args.model, scorer))
            labels_m, weights = cols["target"], cols["weight"][:, 0]
            if not accs:
                if scores.shape[1] != labels_m.shape[1]:
                    print(f"eval: artifact has {scores.shape[1]} heads but "
                          f"{labels_m.shape[1]} target columns resolved "
                          "from the configs — reporting the overlap only",
                          file=sys.stderr)
                n_heads = min(scores.shape[1], labels_m.shape[1])
                accs = [StreamingMetrics() for _ in range(n_heads)]
            for h in range(n_heads):
                accs[h].update(scores[:, h], labels_m[:, h], weights)
            score_sum += float(scores[:, 0].sum())
            pos_count += int((labels_m[:, 0] > 0.5).sum())
            if scores_out is not None:
                for row in scores:
                    scores_out.write(
                        "|".join(f"{v:.6f}" for v in row) + "\n")
    finally:
        if scores_out is not None:
            scores_out.close()
    if not accs:
        print("eval: no data rows found", file=sys.stderr)
        return EXIT_FAIL

    def _round_finite(v: float, nd: int = 6):
        # NaN (a single-class AUC) is not valid JSON: null instead
        return round(float(v), nd) if math.isfinite(float(v)) else None

    # head names from the schema's resolved target columns, in
    # target-index order
    name_by_index = {c.index: c.name for c in schema.columns}
    resolved = [name_by_index.get(i, f"head_{h}")
                for h, i in enumerate(schema.all_target_indices)]
    rows = accs[0].rows
    heads = [{"name": resolved[h] if h < len(resolved) else f"head_{h}",
              "auc": _round_finite(accs[h].auc()),
              "weighted_error": _round_finite(accs[h].weighted_error())}
             for h in range(n_heads)]
    summary = {
        "rows": int(rows),
        "auc": heads[0]["auc"],
        "weighted_error": heads[0]["weighted_error"],
        "mean_score": _round_finite(score_sum / max(rows, 1)),
        "positive_rate": _round_finite(pos_count / max(rows, 1)),
    }
    if n_heads > 1:
        summary["heads"] = heads
    print(json.dumps(summary))
    obs.event("eval_run", rows=int(rows), auc=summary["auc"],
              weighted_error=summary["weighted_error"], model=args.model)
    obs.flush()
    return EXIT_OK


def run_export(args) -> int:
    """`export`: rebuild the scoring artifact from the newest checkpoint
    (the recovery path when a job trained but died before or during its
    export), through the train command's export sequence."""
    from ..config import job_config_from_shifu
    from ..device import resolve_device
    from ..train import checkpoint as ckpt_lib
    from ..train.loop import init_state, restore_latest_any_layout
    from ..utils import xmlconfig

    job = job_config_from_shifu(args.modelconfig, args.columnconfig)
    if args.globalconfig:
        job = xmlconfig.apply_to_job(
            job, xmlconfig.parse_configuration_xml(args.globalconfig))
    if not (fsio.is_remote(args.checkpoint_dir)
            or os.path.isdir(args.checkpoint_dir)):
        # restore only: never create a tree at a mistyped location
        print(f"no checkpoint directory: {args.checkpoint_dir}",
              file=sys.stderr, flush=True)
        return EXIT_FAIL
    aot_pack, aot_buckets = _export_aot_opts(args)
    dev = resolve_device(args.device) if aot_pack else None
    state = init_state(job, job.schema.feature_count, "cpu")
    restored = restore_latest_any_layout(
        ckpt_lib.make_manager(args.checkpoint_dir), state, job,
        lambda m: print(m, flush=True))
    if restored is None:
        print(f"no checkpoint found under {args.checkpoint_dir}",
              file=sys.stderr, flush=True)
        return EXIT_FAIL
    _, extra, step = restored
    print(f"exporting checkpoint step {step} "
          f"(epoch {(extra or {}).get('epoch', '?')})", flush=True)
    _export_and_pack(state.model, job, args.output,
                     lambda m: print(m, flush=True),
                     aot_pack=aot_pack, aot_buckets=aot_buckets, device=dev)
    return EXIT_OK


def _serving_config(args):
    """ServingConfig from the `shifu.serving.*` keys of --globalconfig
    with the flags as the top layer (the train command's layering)."""
    from ..config.schema import ServingConfig
    from ..utils import xmlconfig

    cfg = ServingConfig()
    if getattr(args, "globalconfig", None):
        conf = xmlconfig.parse_configuration_xml(args.globalconfig)
        cfg = xmlconfig.serving_config_from_conf(conf, cfg)
    kw = {}
    if getattr(args, "engine", None):
        kw["engine"] = args.engine
    if getattr(args, "port", -1) >= 0:
        kw["port"] = args.port
    if getattr(args, "host", None):
        kw["host"] = args.host
    if getattr(args, "budget_ms", 0):
        kw["latency_budget_ms"] = args.budget_ms
    if getattr(args, "max_batch", 0):
        kw["max_batch"] = args.max_batch
    if getattr(args, "workers", 0):
        kw["workers"] = args.workers
    if kw:
        cfg = dataclasses.replace(cfg, **kw)
    cfg.validate()
    return cfg


def run_serve(args) -> int:
    """`serve <artifact>`: the scoring daemon behind the wire server
    (runtime/serve.serve_forever) until SIGINT or SIGTERM.  Telemetry
    lands like a train job's: SHIFU_TPU_METRICS_DIR wins, else
    <artifact>/telemetry."""
    from .. import chaos, obs
    from ..config.schema import ConfigError
    from ..runtime.serve import serve_forever

    if args.chaos_plan:
        try:
            base = chaos.load_plan(args.chaos_plan.strip())
            os.environ[chaos.ENV_CHAOS_PLAN] = base.to_json(indent=None)
            chaos.reload_from_env()
        except chaos.ChaosPlanError as e:
            print(f"chaos plan: {e}", file=sys.stderr, flush=True)
            return EXIT_FAIL
    try:
        config = _serving_config(args)
    except (ConfigError, ValueError) as e:
        print(f"serve: {e}", file=sys.stderr, flush=True)
        return EXIT_FAIL
    try:
        obs.configure(obs.resolve_metrics_dir()
                      or fsio.join(args.model, "telemetry"))
    except Exception:
        pass  # telemetry must never block serving
    try:
        rc = serve_forever(args.model, config,
                           echo=lambda m: print(m, flush=True),
                           allow_swap=True if args.allow_swap else None,
                           device=args.device,
                           heartbeat_every_s=args.heartbeat_s or 0.0,
                           heartbeat_misses=args.heartbeat_misses)
    except (ValueError, OSError, KeyError, RuntimeError) as e:
        print(f"serve: {e}", file=sys.stderr, flush=True)
        return EXIT_FAIL
    obs.flush()
    return rc


def run_fleet(args) -> int:
    """`fleet <artifact>`: N scoring daemons and hot standbys under
    heartbeat supervision behind the hedging router's wire face
    (runtime/fleet.fleet_forever), the members on `--device` (default
    `cuda:0`, which must exist)."""
    from .. import chaos, obs
    from ..config.schema import ConfigError, FleetConfig
    from ..device import resolve_device
    from ..runtime.fleet import fleet_forever
    from ..utils import xmlconfig

    if args.chaos_plan:
        try:
            base = chaos.load_plan(args.chaos_plan.strip())
            os.environ[chaos.ENV_CHAOS_PLAN] = base.to_json(indent=None)
            chaos.reload_from_env()
        except chaos.ChaosPlanError as e:
            print(f"chaos plan: {e}", file=sys.stderr, flush=True)
            return EXIT_FAIL
    fleet_cfg = FleetConfig()
    if args.globalconfig:
        conf = xmlconfig.parse_configuration_xml(args.globalconfig)
        fleet_cfg = xmlconfig.fleet_config_from_conf(conf, fleet_cfg)
    kw = {}
    if args.n_daemons > 0:
        kw["n_daemons"] = args.n_daemons
    if args.standbys >= 0:
        kw["standbys"] = args.standbys
    if args.heartbeat_s > 0:
        kw["heartbeat_every_s"] = args.heartbeat_s
    if args.heartbeat_misses > 0:
        kw["heartbeat_misses"] = args.heartbeat_misses
    if args.scale_every_s >= 0:
        kw["scale_every_s"] = args.scale_every_s
    if args.hosts is not None:
        kw["hosts"] = args.hosts
    if args.member_mode is not None:
        kw["member_mode"] = args.member_mode
    if kw:
        fleet_cfg = dataclasses.replace(fleet_cfg, **kw)
    try:
        fleet_cfg.validate()
        serving = _serving_config(args)
        device = str(resolve_device(args.device))
    except (ConfigError, ValueError, RuntimeError) as e:
        print(f"fleet: {e}", file=sys.stderr, flush=True)
        return EXIT_FAIL
    try:
        obs.configure(obs.resolve_metrics_dir()
                      or fsio.join(args.model, "telemetry"))
    except Exception:
        pass  # telemetry must never block serving
    root_dir = args.root_dir or fsio.join(args.model, "fleet")
    try:
        rc = fleet_forever(args.model, fleet=fleet_cfg, serving=serving,
                           router_host=args.host, router_port=args.port,
                           root_dir=root_dir, device=device,
                           echo=lambda m: print(m, flush=True))
    except (ValueError, OSError, KeyError, RuntimeError) as e:
        print(f"fleet: {e}", file=sys.stderr, flush=True)
        return EXIT_FAIL
    obs.flush()
    return rc


def run_loadtest(args) -> int:
    """`loadtest`: the open-loop Poisson harness (runtime/loadtest.py)
    against an artifact in process (--model, on --device) or a running
    `serve` daemon (--connect)."""
    from .. import obs
    from ..config.schema import ServingConfig
    from ..runtime import loadtest as lt

    if bool(args.model) == bool(args.connect):
        print("loadtest: exactly one of --model / --connect",
              file=sys.stderr, flush=True)
        return EXIT_FAIL
    obs.configure_from_env()
    config = None
    if args.budget_ms:
        config = ServingConfig(engine=args.engine,
                               latency_budget_ms=args.budget_ms,
                               report_every_s=0.0)
    try:
        if args.capacity:
            if not args.model:
                print("loadtest: --capacity needs --model",
                      file=sys.stderr, flush=True)
                return EXIT_FAIL
            report = lt.find_capacity(args.model, engine=args.engine,
                                      device=args.device,
                                      p99_target_ms=args.p99_target_ms,
                                      senders=args.senders, config=config)
        else:
            feats = args.drift_features
            if feats:
                feats = [int(v) for v in str(feats).split(",") if v]
            report = lt.run_loadtest(
                args.model, connect=args.connect, engine=args.engine,
                device=args.device, rate=args.rate,
                duration=args.duration, senders=args.senders,
                config=config, trace_sample=args.trace_sample,
                trace_exemplars=args.trace_exemplars,
                drift_after=args.drift_after, drift_shift=args.drift_shift,
                drift_features=feats, feedback=args.feedback)
    except (ValueError, OSError, KeyError, RuntimeError) as e:
        print(f"loadtest: {e}", file=sys.stderr, flush=True)
        return EXIT_FAIL
    print(json.dumps(report) if args.json else lt.render_report(report))
    obs.flush()
    return EXIT_OK if report.get("completed") \
        or report.get("capacity_scores_per_sec") else EXIT_FAIL


# -- the operator's views: journal and scrape reads, no torch import ---------

_NO_JOURNAL_HINT = ("(expected <job_dir>/telemetry/journal.jsonl — run with "
                    "SHIFU_TPU_METRICS_DIR or a CLI train job)")


def _render_view(name: str, args, summarize, render) -> int:
    """One view: `summarize(args.job_dir)` printed as JSON (--json) or as
    `render`'s text; exit 1 where no journal resolves."""
    try:
        summary = summarize(args.job_dir)
    except Exception as e:  # noqa: BLE001 — a view reports, never raises
        print(f"{name}: {e}", file=sys.stderr, flush=True)
        return EXIT_FAIL
    if summary is None:
        print(f"no telemetry journal found under {args.job_dir} "
              f"{_NO_JOURNAL_HINT}", file=sys.stderr, flush=True)
        return EXIT_FAIL
    print(json.dumps(summary) if args.json else render(summary))
    return EXIT_OK


def run_metrics(args) -> int:
    """`metrics <dir>`: the run journal and the registry scrape of a
    running or finished job (--follow streams the journal as JSONL)."""
    from ..obs import journal as journal_mod
    from ..obs import render as obs_render

    if args.follow:
        jpath = obs_render.find_journal(args.job_dir)
        if jpath is None:
            print(f"no telemetry journal found under {args.job_dir}",
                  file=sys.stderr, flush=True)
            return EXIT_FAIL
        try:
            for rec in journal_mod.tail_journal(jpath):
                print(json.dumps(rec), flush=True)
        except KeyboardInterrupt:
            pass
        return EXIT_OK
    return _render_view("metrics", args, obs_render.summarize,
                        obs_render.render_text)


def run_profile(args) -> int:
    """`profile <dir>`: where the wall time went, epoch by epoch, from the
    `goodput` events, with the flight recorder's top kernels."""
    from ..obs import render as obs_render
    return _render_view("profile", args, obs_render.profile_summary,
                        obs_render.render_profile_text)


def run_trace(args) -> int:
    """`trace <dir>`: the device flight recorder: which kernels own the
    device time, the anomaly log, the HBM watermarks (obs/devprof.py's
    `device_profile` / `anomaly` / `hbm_watermark` events)."""
    from ..obs import render as obs_render
    return _render_view("trace", args, obs_render.trace_summary,
                        obs_render.render_trace_text)


def run_drift(args) -> int:
    """`drift <dir>`: per-feature PSI against the frozen baseline, the
    score divergence and the live AUC from labelled feedback."""
    from ..obs import render as obs_render

    def summarize(path):
        return obs_render.drift_summary(path, model=args.model,
                                        feature=args.feature)
    return _render_view("drift", args, summarize,
                        obs_render.render_drift_text)


def run_top(args) -> int:
    """`top <dir> [...]`: the live view of a serving daemon (rate, p50,
    p99, queue depth, the lifecycle stages, the SLO alerts) or of a train
    job (epoch progress, goodput, the embedding tier); several dirs render
    the fleet rollup.  A frame every --interval seconds until ^C, one with
    --once."""
    from ..obs import aggregate as obs_aggregate
    from ..obs import render as obs_render

    def frame() -> tuple:
        if len(args.job_dirs) > 1:
            rollup = obs_aggregate.serving_rollup(
                args.job_dirs, stale_after_s=args.stale_after)
            return rollup, obs_render.render_top_fleet_text(rollup)
        summary = obs_render.top_summary(args.job_dirs[0],
                                         stale_after_s=args.stale_after)
        if summary is None:
            return None, None
        return summary, obs_render.render_top_text(summary)

    try:
        while True:
            data, text = frame()
            if data is None:
                print(f"no telemetry journal found under "
                      f"{args.job_dirs[0]} (expected <dir>/telemetry/"
                      f"journal.jsonl — a `serve`/train job writes one)",
                      file=sys.stderr, flush=True)
                return EXIT_FAIL
            if args.json:
                print(json.dumps(data), flush=True)
            else:
                if not args.once:
                    print("\x1b[2J\x1b[H", end="")  # a frame, not a log
                print(text, flush=True)
            if args.once:
                return EXIT_OK
            time.sleep(max(args.interval, 0.1))
    except KeyboardInterrupt:
        return EXIT_OK


def run_timeline(args) -> int:
    """`timeline <dir>`: the merged, skew-corrected journals, the incident
    records and the sampled request traces (obs/timeline.py)."""
    from ..obs import timeline as timeline_mod

    summary = timeline_mod.timeline_summary(
        args.job_dir, trace_id=args.trace_id,
        incidents_only=args.incident,
        skew_correct=not args.no_skew_correct)
    if summary is None:
        print(f"no telemetry journal found under {args.job_dir}",
              file=sys.stderr, flush=True)
        return EXIT_FAIL
    print(json.dumps(summary) if args.json
          else timeline_mod.render_timeline_text(summary))
    return EXIT_OK


def run_fleet_verify(args) -> int:
    """`fleet-verify <dir>`: audit a fleet run's journals against the
    fleet's lifecycle invariants (runtime/fleet.fleet_verify_events).
    Process-mode members journal into their own dirs on their own
    clocks, so the audit reads the skew-corrected merged timeline
    (obs/timeline.py).  Exit 0 when every check holds."""
    from ..obs import timeline as timeline_mod
    from ..runtime.fleet import fleet_verify_events

    merged = timeline_mod.load_merged(args.job_dir, tail_bytes=None)
    if merged is None:
        print(f"no telemetry journal found under {args.job_dir}",
              file=sys.stderr, flush=True)
        return EXIT_FAIL
    report = fleet_verify_events(merged["events"])
    report["journal"] = merged["journals"][0]
    report["journals"] = merged["journals"]
    report["skew_correct"] = merged["skew_correct"]
    if args.json:
        print(json.dumps(report))
    else:
        counts = report["counts"]
        print(f"fleet-verify: {report['verdict']} — "
              f"{counts['failovers']} failover(s), "
              f"{counts['swaps']} fleet swap(s), "
              f"{counts['member_swaps']} member application(s), "
              f"{counts['rejoins']} rejoin(s), "
              f"{counts['degraded']} degraded, "
              f"{counts['syncs']} host sync(s)")
        for c in report["checks"]:
            mark = "ok " if c["ok"] else "FAIL"
            print(f"  [{mark}] {c['check']}: {c['detail']}")
    return EXIT_OK if report["verdict"] == "PASS" else EXIT_FAIL


# the journal events that count as recovery in a chaos drill's audit
_RECOVERY_KINDS = ("supervisor_restart", "supervisor_done",
                   "checkpoint_fallback", "checkpoint_fallback_resolved",
                   "train_resume", "preemption_grace",
                   "supervisor_liveness_kill", "chaos_corrupt")


def run_pod_verify(args) -> int:
    """`pod-verify <dir>`: audit a pod run's merged per-rank journals
    (launcher/pod.pod_verify_events); exit 0 when every check holds.
    Journal reads only: no torch."""
    from ..obs import timeline as timeline_mod
    from .pod import pod_verify_events

    merged = timeline_mod.load_merged(args.job_dir, tail_bytes=None)
    if merged is None:
        print(f"no telemetry journal found under {args.job_dir}",
              file=sys.stderr, flush=True)
        return EXIT_FAIL
    report = pod_verify_events(merged["events"],
                               balance_limit=args.balance_limit)
    report["journals"] = merged["journals"]
    if args.json:
        print(json.dumps(report))
    else:
        counts = report["counts"]
        print(f"pod-verify: {report['verdict']} — "
              f"{counts['epochs']} epoch(s), "
              f"{counts['close_rows']} close row(s) from "
              f"{counts['ranks']} rank(s), "
              f"{counts['injections']} injection(s)")
        for c in report["checks"]:
            mark = "ok " if c["ok"] else "FAIL"
            print(f"  [{mark}] {c['check']}: {c['detail']}")
    return EXIT_OK if report["verdict"] == "PASS" else EXIT_FAIL


def _dryrun_progress_start(prog_dir: str, num_hosts: int) -> int:
    """The first epoch this attempt runs: the least epoch the current
    gang's ranks all completed, plus one (a rank with no file completed
    nothing), so that a restart re-runs every epoch a killed rank never
    closed and the journal ends with complete cohorts."""
    start = None
    for rank in range(num_hosts):
        p = os.path.join(prog_dir, f"rank-{rank}.json")
        try:
            with open(p) as f:
                done = int(json.load(f).get("epoch", -1))
        except (OSError, ValueError):
            done = -1
        start = done if start is None else min(start, done)
    return (start if start is not None else -1) + 1


def _dryrun_progress_mark(prog_dir: str, rank: int, epoch: int) -> None:
    os.makedirs(prog_dir, exist_ok=True)
    tmp = os.path.join(prog_dir, f".rank-{rank}.tmp")
    with open(tmp, "w") as f:
        json.dump({"epoch": int(epoch)}, f)
    os.replace(tmp, os.path.join(prog_dir, f"rank-{rank}.json"))


def run_data_dryrun(args) -> int:
    """`data-dryrun`: one rank of the pod's data plane: the shard-local
    ingest of this host's slice, the per-epoch order and shard digests,
    one `pod_epoch_close` row per epoch, and no training and no
    collectives.  The rank comes from the pod's contract, which
    `supervise_pod` derives anew each attempt, so a reshape rebalances
    the shards.  The digests are pure functions of (seed, epoch, width),
    and the drill's equal part files give every rank the same rows, so the
    cohorts must agree: what `pod-verify` audits."""
    from .. import chaos, obs
    from ..config.schema import DataConfig
    from ..data import pipeline as pipe
    from ..data import synthetic

    try:
        rank = int(os.environ.get("SHIFU_TPU_PROCESS_ID", "0") or 0)
        nproc = int(os.environ.get("SHIFU_TPU_NUM_PROCESSES", "1") or 1)
    except ValueError:
        rank, nproc = 0, 1
    chaos.reload_from_env()
    out = args.out
    obs.configure(os.path.join(out, "telemetry") if rank == 0
                  else os.path.join(out, "telemetry", f"rank-{rank}"))
    schema = synthetic.make_schema(num_features=args.features)
    # valid_ratio 0: the agreement needs every rank's train rows equal,
    # which the hash split would skew per shard
    data = DataConfig(paths=(args.data,), delimiter=args.delimiter,
                      batch_size=int(args.batch_size), valid_ratio=0.0,
                      shuffle_seed=int(args.seed),
                      host_shard=args.host_shard)
    data.validate()
    prog_dir = os.path.join(out, "data_progress")
    start = _dryrun_progress_start(prog_dir, nproc)
    obs.event("pod_data_dryrun_start", rank=rank, hosts=nproc,
              epoch_start=start, epochs=int(args.epochs),
              host_shard=args.host_shard)
    n_files = pipe.count_source_files(data)
    reg = obs.default_registry()
    train_rows = None
    for ep in range(start, int(args.epochs)):
        # the `data.host_shard` chaos probe, with the epoch: the elastic
        # drill's kill lands here
        mine = pipe.host_file_shard(data, rank, nproc, epoch=ep)
        if train_rows is None:
            train_ds, _valid = pipe.load_datasets(schema, data, rank, nproc)
            train_rows = int(train_ds.num_rows)
        if args.epoch_seconds > 0:
            time.sleep(float(args.epoch_seconds))
        order_digest = pipe.epoch_order_digest(
            "batch", train_rows, int(args.batch_size), shuffle=True,
            seed=int(args.seed), epoch=ep)
        shard_digest = pipe.shard_assignment_digest(
            n_files, nproc, seed=int(args.seed), epoch=ep,
            mode=args.host_shard)
        obs.event(
            "pod_epoch_close", epoch=ep, rank=rank, hosts=nproc,
            files=len(mine), rows=train_rows,
            order_digest=order_digest, shard_digest=shard_digest,
            ingest_bytes=int(
                reg.counter("ingest_source_bytes_total").total()),
            ingest_s=round(
                reg.counter("ingest_seconds_total").total(), 6))
        obs.flush()
        _dryrun_progress_mark(prog_dir, rank, ep)
        print(f"data-dryrun rank {rank}/{nproc}: epoch {ep} "
              f"files={len(mine)} rows={train_rows}", flush=True)
    obs.event("pod_data_dryrun_done", rank=rank, hosts=nproc,
              epochs=int(args.epochs))
    obs.flush()
    return EXIT_OK


def run_chaos_verify(args) -> int:
    """`chaos-verify <job_dir>`: replay the recorded plan (default: the
    `chaos_plan.json` the launcher keeps beside the job) against the run
    journal.  Exit 0 (PASS) when the run completed (a `supervisor_done`,
    or a last `run_end` with exit 0) and every planned site injected at
    least once; else 1 (SILENT_SITES, or INCOMPLETE)."""
    import fnmatch

    from .. import chaos
    from ..obs import journal as journal_mod
    from ..obs import render as obs_render

    jpath = obs_render.find_journal(args.job_dir)
    if jpath is None:
        print(f"no telemetry journal found under {args.job_dir}",
              file=sys.stderr, flush=True)
        return EXIT_FAIL
    events = journal_mod.read_journal(jpath)
    plan = None
    plan_src = args.plan
    if not plan_src:
        cand = fsio.join(args.job_dir, "chaos_plan.json")
        if os.path.exists(cand) or (fsio.is_remote(cand)
                                    and obs_render._exists(cand)):
            plan_src = cand
    if plan_src:
        try:
            plan = chaos.load_plan(plan_src)
        except chaos.ChaosPlanError as e:
            print(f"chaos plan: {e}", file=sys.stderr, flush=True)
            return EXIT_FAIL

    injected: dict[str, int] = {}
    recovered: dict[str, int] = {}
    run_exits: list[int] = []
    for rec in events:
        kind = rec.get("kind")
        if kind == "chaos_inject":
            site = str(rec.get("site", "?"))
            injected[site] = injected.get(site, 0) + 1
        elif kind in _RECOVERY_KINDS:
            recovered[kind] = recovered.get(kind, 0) + 1
        elif kind == "run_end":
            try:
                run_exits.append(int(rec.get("exit")))
            except (TypeError, ValueError):
                pass
    planned_sites = sorted({f.site for f in plan.faults}) if plan else []
    # a glob site ("fsio.*") fired when any injected site matches it
    silent = [s for s in planned_sites
              if not any(i == s or fnmatch.fnmatchcase(i, s)
                         for i in injected)]
    completed = (recovered.get("supervisor_done", 0) > 0
                 or (run_exits and run_exits[-1] == 0))
    report = {
        "journal": jpath,
        "plan": plan_src,
        "planned_sites": planned_sites,
        "injected": dict(sorted(injected.items())),
        "injected_total": sum(injected.values()),
        "silent_sites": silent,
        "recovered": dict(sorted(recovered.items())),
        "final_run_exit": run_exits[-1] if run_exits else None,
        "completed": bool(completed),
        "verdict": ("PASS" if completed and not silent
                    else "INCOMPLETE" if not completed else "SILENT_SITES"),
    }
    if args.json:
        print(json.dumps(report))
    else:
        print(f"chaos-verify: {report['verdict']} — "
              f"{report['injected_total']} injection(s) across "
              f"{len(injected)} site(s), final exit "
              f"{report['final_run_exit']}")
        if planned_sites:
            print(f"  planned sites: {', '.join(planned_sites)}")
        for site, n in sorted(injected.items()):
            print(f"  injected  {site}: {n}")
        for kind, n in sorted(recovered.items()):
            print(f"  recovered {kind}: {n}")
        if silent:
            print(f"  NEVER FIRED: {', '.join(silent)} (trigger never "
                  "matched — check at_call/at_epoch/rank against the run)")
    return EXIT_OK if report["verdict"] == "PASS" else EXIT_FAIL


def run_status(args) -> int:
    from . import detach as detach_lib
    return detach_lib.run_status(args.job_dir)


def run_attach(args) -> int:
    from . import detach as detach_lib
    return detach_lib.attach(args.job_dir, from_start=not args.tail)


def run_kill(args) -> int:
    from . import detach as detach_lib
    return detach_lib.kill(args.job_dir, force=args.force)


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


_COMMANDS = {"train": run_train, "cache": run_cache, "score": run_score,
             "eval": run_eval, "export": run_export, "serve": run_serve,
             "loadtest": run_loadtest, "metrics": run_metrics,
             "profile": run_profile, "trace": run_trace, "top": run_top,
             "drift": run_drift, "timeline": run_timeline,
             "chaos-verify": run_chaos_verify, "status": run_status,
             "attach": run_attach, "kill": run_kill, "fleet": run_fleet,
             "fleet-verify": run_fleet_verify, "provision": run_provision,
             "pod-verify": run_pod_verify, "data-dryrun": run_data_dryrun}


def main(argv: Optional[Sequence[str]] = None) -> int:
    _arm_pdeathsig()
    args = build_parser().parse_args(argv)
    if args.command != "train":
        return _COMMANDS[args.command](args)
    # the daemonized dispatcher of a `train --detach` records the job's
    # end for `status`, also when the run unwinds through SystemExit
    from . import detach as detach_lib
    detached_dir = os.environ.get(detach_lib.ENV_DETACHED)

    def record(rc: int) -> None:
        if detached_dir and not args.detach:
            detach_lib.write_status(detached_dir, rc)

    try:
        rc = run_train(args)
    except SystemExit as e:
        record(e.code if isinstance(e.code, int) else 1)
        raise
    record(rc)
    return rc


if __name__ == "__main__":
    sys.exit(main())
