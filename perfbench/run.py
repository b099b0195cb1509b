"""Run one cell of BENCHMARK.json on the card and print its result.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout holding `shifu_tpu_torch`.  Inputs and
weights come from `--seed`; the cell's driver (`drivers/<driver>.py`, as
its traffic file names it) sets up, warms the shapes it uses, measures for
`--seconds`, with `--trace 1` traces a segment after the window, and
compares what the timed path produced with the plain reference.  The
last line of standard output is one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1`
its per-layer ones), `device`, with `--trace 1` `breakdown`, and last
`checks`, each number compared with its limit; the checks are also the
last lines of standard error.

Exit codes: 0 a result was printed (correct or not); 1 the run failed;
3 no card, or fewer than the cell asks for; 4 JAX or the JAX package was
loaded; 5 an end-to-end metric could not be read.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")
# the program's build and kernel caches, at fixed paths inside the
# checkout (the fused kernels build into shifu_tpu_torch/_build)
CACHE_ENV = {"TRITON_CACHE_DIR": "triton",
             "TORCHINDUCTOR_CACHE_DIR": "inductor",
             "TORCH_EXTENSIONS_DIR": "torch_extensions"}
FORBIDDEN = ("jax", "jaxlib", "flax", "shifu_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (`shifu_tpu_torch` is not `shifu_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _finite(v: float):
    return v if math.isfinite(v) else str(v)


def execute(cell: str, seed: int, seconds: float, trace: bool, device,
            overrides: dict | None = None, manifest_path: str | None = None,
            base: str | None = None, t_start: float | None = None) -> dict:
    """One run of `cell` on `device`; returns the result object, with
    `run` (the driver's record) and `missing` (the metrics whose reader
    found nothing), which `main` does not print.  `overrides`
    replace traffic parameters; `manifest_path` and `base` (the directory
    of the cells', configurations', traffic and metric files) default to
    the checkout's."""
    import torch

    from perfbench.core import manifest
    from perfbench.core.session import Session

    base = base or manifest.HERE
    m = manifest.load(manifest_path or manifest.MANIFEST)
    entry = manifest.cell(m, cell, base)
    traffic = dict(entry["traffic_file"], **(overrides or {}))
    tmpdir = tempfile.mkdtemp(prefix="perfbench-")
    s = Session(cell=cell, seed=int(seed), seconds=float(seconds),
                trace=bool(trace), device=torch.device(device),
                config=entry["config_file"], traffic=traffic,
                t_start=T_START if t_start is None else t_start,
                tmpdir=tmpdir)
    try:
        record = manifest.driver(traffic["driver"]).run(s)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    record["config"], record["traffic"] = s.config, s.traffic
    record["setup_marks"] = s.marks

    wanted = (manifest.per_layer(m, cell) if trace
              else manifest.end_to_end(m, cell))
    metrics, missing = {}, []
    for spec in wanted:
        value = manifest.metric_reader(spec["name"], base).read(record)
        if value is None:
            missing.append(spec["name"])
            continue
        metrics[spec["name"]] = {"value": float(value), "unit": spec["unit"]}

    limits = entry["workload"]["limits"]
    checks = {k: {"value": _finite(float(record["readings"][k])),
                  "limit": float(lim)} for k, lim in limits.items()}
    ok = all(isinstance(c["value"], float) and c["value"] <= c["limit"]
             for c in checks.values())
    device_info = {"platform": "gpu" if s.device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(s.device)
                            if s.device.type == "cuda" else "cpu"),
                   "count": int(entry["chips"]),
                   "memory_peak_bytes": int(record["memory_peak_bytes"])}
    result = {"correct": bool(ok and record["failed"] == 0
                              and record["attempted"] > 0),
              "attempted": int(record["attempted"]),
              "failed": int(record["failed"]),
              "metrics": metrics, "device": device_info}
    if trace and record.get("trace"):
        device_info["busy_s"] = record["trace"]["busy_s"]
        device_info["window_s"] = record["trace"]["window_s"]
        result["breakdown"] = record["trace"]["breakdown"]
    result["checks"] = checks
    result["run"] = record
    result["missing"] = missing
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for var, sub in CACHE_ENV.items():
        os.environ[var] = os.path.join(CACHE, sub)
    sys.path.insert(0, ROOT)

    from perfbench.core import manifest
    chips = manifest.cell(manifest.load(), args.workload)["chips"]
    import torch
    if not torch.cuda.is_available():
        print("perfbench: no CUDA device", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    torch.set_num_threads(4)

    result = execute(args.workload, args.seed, args.seconds,
                     bool(args.trace), "cuda:0")
    loaded = forbidden_modules()
    if loaded:
        print(f"perfbench: loaded {', '.join(loaded)}, which the port must "
              "not load", file=sys.stderr)
        return 4
    missing = result.pop("missing")
    if missing and not args.trace:
        print(f"perfbench: no reading for {missing}", file=sys.stderr)
        return 5
    record = result.pop("run")
    print(json.dumps({"setup_marks": record["setup_marks"],
                      "readings": record["readings"]}), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
