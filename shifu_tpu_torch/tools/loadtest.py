"""Open-loop (Poisson-arrival) load harness for the serving plane: the
standalone spelling of `shifu-tpu-torch loadtest` (the port of the repo's
`tools/loadtest.py`, same flags, report and exit codes).

Drives either an in-process ScoringDaemon built from an export artifact
(`--model`, the capacity-measurement mode, scoring on `--device`) or a
running `shifu-tpu-torch serve` daemon over the wire (`--connect
host:port`), and reports scores/s plus EXACT p50/p99 latency charged from
each request's scheduled Poisson arrival (open-loop: a saturated server
cannot slow the arrival process down and hide its queueing delay).

Usage:
    python -m shifu_tpu_torch.tools.loadtest --model <export_dir> \\
        --rate 200000 --duration 5
    python -m shifu_tpu_torch.tools.loadtest --model <export_dir> --capacity
    python -m shifu_tpu_torch.tools.loadtest --connect 127.0.0.1:8571 \\
        --rate 2000

`--engine` takes the port's tiers (runtime/serve.load_engine); the JAX
package's "jax" and "stablehlo" are refused with the port's counterparts
("torch" and "export") named, as the port's CLI refuses them.  The
daemon scores on `--device` (default cuda:0; without CUDA that raises
unless `--device cpu` is passed).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="loadtest",
        description="open-loop Poisson load harness for the scoring "
                    "daemon; reports scores/s and p50/p99 latency")
    p.add_argument("--model", default=None, help="export artifact dir "
                   "(in-process mode)")
    p.add_argument("--connect", default=None,
                   help="host:port of a running daemon (socket mode)")
    p.add_argument("--rate", type=float, default=50_000,
                   help="offered requests/s (Poisson; default 50000)")
    p.add_argument("--duration", type=float, default=5.0,
                   help="seconds of offered load (default 5)")
    # the port CLI's engine names, the JAX package's "jax" and
    # "stablehlo" among them so that they fail with the port's
    # counterparts named
    from ..launcher.cli import _ENGINE_CHOICES
    p.add_argument("--engine", default="auto", choices=_ENGINE_CHOICES)
    p.add_argument("--senders", type=int, default=2,
                   help="sender threads striping the arrival stream")
    p.add_argument("--budget-ms", type=float, default=0,
                   help="daemon latency budget (in-process mode)")
    p.add_argument("--capacity", action="store_true",
                   help="ramp the rate to the highest one meeting the "
                        "p99 target instead of one fixed-rate run")
    p.add_argument("--p99-target-ms", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="device the in-process daemon's torch tiers score "
                        "on (default cuda:0; 'cpu' only when asked)")
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)

    if bool(args.model) == bool(args.connect):
        p.error("exactly one of --model / --connect")
    if args.capacity and not args.model:
        p.error("--capacity needs --model (in-process mode)")
    from ..runtime import loadtest as lt
    return lt.run_command(
        args.model, connect=args.connect, capacity=args.capacity,
        engine=args.engine, device=args.device, rate=args.rate,
        duration=args.duration, senders=args.senders,
        budget_ms=args.budget_ms, p99_target_ms=args.p99_target_ms,
        seed=args.seed, as_json=args.json)


if __name__ == "__main__":
    sys.exit(main())
