"""The readings that a cell's correctness limits are set from, on the card.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--out FILE]

For each seed, in one process, the cell's driver builds its set-up as a
run does and calls its `readings`: the program's numbers on the timed path
(training: the checked steps; scoring: every row of the pool through the
daemon), the control's (the reference in fp8 in the program's place) and,
for training, the half-batch fault's, each against the float32 reference.
One JSON line a seed goes to standard output and to FILE.  No window is
measured, so set-up is paid once for the process's imports and builds.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from perfbench import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    for var, sub in run.CACHE_ENV.items():
        os.environ[var] = os.path.join(run.CACHE, sub)

    import torch

    from perfbench.core import manifest
    from perfbench.core.session import Session

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    torch.set_num_threads(4)
    entry = manifest.cell(manifest.load(), args.workload)
    drv = manifest.driver(entry["traffic_file"]["driver"])
    out = open(args.out, "a") if args.out else None
    try:
        for seed in (int(x) for x in args.seeds.split(",")):
            tmpdir = tempfile.mkdtemp(prefix="perfbench-cal-")
            s = Session(cell=args.workload, seed=seed, seconds=0.0,
                        trace=False, device=torch.device("cuda:0"),
                        config=entry["config_file"],
                        traffic=dict(entry["traffic_file"]),
                        t_start=time.perf_counter(), tmpdir=tmpdir)
            t0 = time.perf_counter()
            try:
                line = {"workload": args.workload, "seed": seed,
                        "readings": drv.readings(s)}
            except Exception as e:  # one seed's failure is its reading
                line = {"workload": args.workload, "seed": seed,
                        "error": f"{type(e).__name__}: {e}"}
            finally:
                shutil.rmtree(tmpdir, ignore_errors=True)
                s.free()
            line["seconds"] = time.perf_counter() - t0
            text = json.dumps(line)
            print(text, flush=True)
            if out:
                out.write(text + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
