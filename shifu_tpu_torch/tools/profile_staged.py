"""Profiler of the staged input tier on the card (the port of the repo's
`tools/profile_staged.py`).

    python -m shifu_tpu_torch.tools.profile_staged [--device cuda:0]

For each wire format (bf16, int8, int8 with the compact target/weight
columns) it trains the headline MLP (30 features, hidden (100, 100, 100)
relu, bf16 compute, weighted_mse, Adadelta at 0.003, batch 98,304) on
about six bf16 chunks of synthetic rows through the port's own staged
tier: `data/pipeline.staged_epoch_blocks` for the blocks,
`pipeline.wire_cast_fn` for the cast, `train/loop.make_placer` for the
placement and `train/step.make_epoch_scan_step` for the step.  On both
int8 wires layer 0 runs the int8 kernel (`ops/int8_matmul`, the
hand-written `csrc/int8_matmul.cu` on the card); on the bf16 wire it is
the plain layer.

Each wire runs a warm epoch (the first dispatch of each step signature
is counted by obs/flops), then one INLINE epoch, whose producer runs on
the calling thread so that each chunk's time splits cleanly into:

- assemble: `next()` of the block generator (the gather of the chunk's
  batches in the epoch's order) and the host-side cast (int8 features
  are pre-encoded, as the loader stores them; the compact wire's per-block
  target/weight detection runs here);
- put: the placer's `put` (each array copied into a pinned host buffer,
  then to the card on the placing thread's own stream) up to the
  completion of those copies on the card (their event is synchronized);
  on the CPU the plain `to_device`;
- dispatch: the scan step's call on the placed block: the Python
  dispatch of every batch's forward, backward and update, which returns
  once the work is queued on the card;
- sync: once per epoch, reading the epoch's summed loss back, which waits
  for the queued work.

then three epochs with the producer (cast and put) on a prefetch thread
two chunks ahead (`pipeline.prefetch_to_device`), as the product's staged
tier overlaps it; the best of their walls gives the prefetched rows/s.

A two-point host-to-card probe, run before and after the wires, times a
small (8 MiB) and a large (32 MiB and up, until it takes twice the small
one) copy from pinned host memory of an int8-like payload (clipped
normal values on the int8 wire's grid) and fits the bytes over the time
difference.

Events, with the JAX tool's names and fields: `h2d_probe` (before and
after, `mb_per_sec`), one `goodput` per wire (`source="profile_staged"`;
the inline epoch's assemble + put as the `input` bucket, dispatch + sync
as `step`, the rest of its wall as `other`; with the per-wire numbers
beside them) and one `staged_roofline` per wire (prefetched bytes/s over
each probe).  With SHIFU_TPU_METRICS_DIR set they go to its journal,
which `shifu-tpu-torch profile` renders; otherwise they print as JSONL on
stdout at the end.

The card is the default device; without CUDA it raises unless
`--device cpu` is passed (the tests run it on the CPU at small sizes,
where the probe times a host copy).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

NUM_FEATURES = 30
BATCH_SIZE = 98_304
CHUNK_BYTES = 32 << 20       # the bench's staged chunk: 32 MiB of wire
BF16_CHUNKS = 6              # rows: this many bf16 chunks of batches
PREFETCHED_EPOCHS = 3
# (name, wire_dtype, compact)
WIRES = (("bf16", "auto", False), ("int8", "int8", False),
         ("int8c", "int8", True))
PROBE_SMALL_BYTES = 8 << 20
PROBE_LARGE_BYTES = 32 << 20
PROBE_MAX_BYTES = 512 << 20


def make_job(wire: str, batch_size: int = BATCH_SIZE):
    """The headline MLP's job on one wire."""
    from ..config import (DataConfig, JobConfig, ModelSpec,
                          OptimizerConfig, TrainConfig)
    from ..data import synthetic
    return JobConfig(
        schema=synthetic.make_schema(num_features=NUM_FEATURES),
        data=DataConfig(batch_size=batch_size, wire_dtype=wire),
        model=ModelSpec(model_type="mlp", hidden_nodes=(100, 100, 100),
                        activations=("relu",) * 3,
                        compute_dtype="bfloat16"),
        train=TrainConfig(epochs=1, loss="weighted_mse",
                          optimizer=OptimizerConfig(
                              name="adadelta", learning_rate=0.003)),
    ).validate()


def chunk_batches(row_bytes: int, batch_size: int,
                  chunk_bytes: int = CHUNK_BYTES) -> int:
    """Batches in one staged chunk of `chunk_bytes` on the wire."""
    return max(1, chunk_bytes // (batch_size * row_bytes))


def dataset_rows(batch_size: int = BATCH_SIZE,
                 chunk_bytes: int = CHUNK_BYTES) -> int:
    """BF16_CHUNKS bf16 chunks worth of rows (the bench's sizing: a bf16
    row is two bytes a feature and a 4-byte target and weight)."""
    chunk_bf = chunk_batches(NUM_FEATURES * 2 + 8, batch_size, chunk_bytes)
    return BF16_CHUNKS * chunk_bf * batch_size


def make_dataset(rows: int, seed: int = 0):
    """Synthetic f32 rows: normal features, coin-flip targets, unit
    weights."""
    from ..data import pipeline as pipe
    rng = np.random.default_rng(seed)
    return pipe.TabularDataset(
        rng.standard_normal((rows, NUM_FEATURES)).astype(np.float32),
        (rng.random((rows, 1)) < 0.5).astype(np.float32),
        np.ones((rows, 1), np.float32))


def _payload(nbytes: int, rng: np.random.Generator) -> np.ndarray:
    """An int8 buffer with the int8 wire's value distribution (clipped
    normals on a 1/15.875 grid), made 64 MiB at a time."""
    out = np.empty(nbytes, np.int8)
    step = 64 << 20
    for lo in range(0, nbytes, step):
        n = min(step, nbytes - lo)
        x = rng.standard_normal(n, dtype=np.float32)
        np.clip(np.rint(x * 15.875, out=x), -127, 127, out=x)
        out[lo:lo + n] = x.astype(np.int8)
    return out


def _host_buffer(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    host = torch.from_numpy(arr)
    if device.type != "cuda":
        return host
    pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
    pinned.copy_(host)
    return pinned


def h2d_bytes_per_sec(device: torch.device, trials: int = 3,
                      small_bytes: int = PROBE_SMALL_BYTES,
                      large_bytes: int = PROBE_LARGE_BYTES,
                      max_bytes: int = PROBE_MAX_BYTES) -> float:
    """Host-to-card bytes/s by a two-point fit: the best of `trials`
    copies of a small and of a large pinned buffer, the large one grown
    4x at a time until it takes twice the small one (or reaches
    `max_bytes`); the fit (large - small bytes over the time difference)
    clamped to [the large copy's plain rate, 10x it].  On the CPU it times
    a host copy (`clone`)."""
    rng = np.random.default_rng(12345)
    cuda = device.type == "cuda"

    def t_of(buf: torch.Tensor) -> float:
        best = None
        for _ in range(trials):
            t0 = time.perf_counter()
            if cuda:
                buf.to(device, non_blocking=True)
                torch.cuda.synchronize(device)
            else:
                buf.clone()
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        return best

    small = _host_buffer(_payload(small_bytes, rng), device)
    t_of(small)  # warm the allocation path
    t_small = t_of(small)
    while True:
        t_large = t_of(_host_buffer(_payload(large_bytes, rng), device))
        if t_large >= 2.0 * t_small or large_bytes >= max_bytes:
            break
        large_bytes *= 4
    naive = float(large_bytes) / max(t_large, 1e-9)
    if t_large <= t_small:  # noise swamped the fit
        return naive
    fit = float(large_bytes - small_bytes) / (t_large - t_small)
    return min(max(fit, naive), 10.0 * naive)


def profile_wire(name: str, wire: str, compact: bool, ds, device,
                 *, batch_size: int = BATCH_SIZE,
                 chunk_bytes: int = CHUNK_BYTES,
                 init_fn: Optional[Callable] = None) -> tuple[dict, dict]:
    """One wire's split: (its results, the inline epoch's outcome:
    {"loss": its summed loss, "block_losses": each block's loss in the
    order trained, "params": the parameters after it}).
    `ds` holds f32 features, pre-encoded here as the loader stores them
    (int8 on the wire grid, or bf16 bits); `init_fn(job, num_features,
    device)` builds each state (default `train/loop.init_state`)."""
    from .. import obs
    from ..data import pipeline as pipe
    from ..train.loop import init_state, make_placer
    from ..train.step import make_epoch_scan_step

    num_features = ds.features.shape[1]
    job = make_job(wire, batch_size)
    schema, cdt = job.schema, job.model.compute_dtype
    wcast_feat = pipe.wire_cast_fn(schema, job.data, cdt)
    if wcast_feat is not None:  # int8: quantized once, at "parse" time
        feats = wcast_feat({"features": ds.features})["features"]
    else:
        feats = pipe.bf16_bits(ds.features)
    dsw = pipe.TabularDataset(feats, ds.target, ds.weight)
    cast = (pipe.wire_cast_fn(schema, job.data, cdt, compact=True)
            if compact else wcast_feat)
    row_b = pipe.wire_row_bytes(schema, job.data, cdt, compact=compact)
    chunk = chunk_batches(row_b, batch_size, chunk_bytes)
    rows = dsw.num_rows
    scan = make_epoch_scan_step(job, None)
    init = init_fn or init_state
    state = init(job, num_features, device)
    put, ready = make_placer(job, device)
    cuda = device.type == "cuda"

    def place(b: dict):
        item = put(b)
        if cuda:
            item.event.synchronize()  # the copies have landed on the card
        return item

    phase = {"assemble": [], "put": [], "dispatch": [], "sync": []}

    def epoch(e: int, record: bool = True) -> list:
        nonlocal state
        acc, lasts = None, []
        gen = pipe.staged_epoch_blocks(dsw, batch_size, epoch=e,
                                       block_batches=chunk)
        while True:
            t0 = time.perf_counter()
            blk = next(gen, None)
            if blk is None:
                break
            blk = cast(blk) if cast else blk
            t1 = time.perf_counter()
            item = place(blk)
            t2 = time.perf_counter()
            state, last = scan(state, ready(item))
            acc = last if acc is None else acc + last
            lasts.append(last)
            t3 = time.perf_counter()
            if record:
                phase["assemble"].append(t1 - t0)
                phase["put"].append(t2 - t1)
                phase["dispatch"].append(t3 - t2)
        t0 = time.perf_counter()
        float(acc)
        if record:
            phase["sync"].append(time.perf_counter() - t0)
        return lasts

    epoch(0, record=False)  # the first dispatch of each signature
    t0 = time.perf_counter()
    lasts = epoch(1)
    wall_inline = time.perf_counter() - t0
    # read back after the timed wall: the losses have landed at its sync
    block_losses = [float(v) for v in lasts]
    inline = {"loss": float(sum(block_losses)), "block_losses": block_losses,
              "params": {k: v.detach().float().cpu().numpy()
                         for k, v in state.model.state_dict().items()}}

    def put_fn(b: dict):
        return put(cast(b) if cast else b)

    st2 = init(job, num_features, device)

    def epoch_pref(e: int) -> None:
        nonlocal st2
        acc = None
        for item in pipe.prefetch_to_device(
                pipe.staged_epoch_blocks(dsw, batch_size, epoch=e,
                                         block_batches=chunk),
                put_fn, size=2):
            st2, last = scan(st2, ready(item))
            acc = last if acc is None else acc + last
        float(acc)

    epoch_pref(0)
    walls = []
    for e in range(1, PREFETCHED_EPOCHS + 1):
        t0 = time.perf_counter()
        epoch_pref(e)
        walls.append(time.perf_counter() - t0)
    wire_bytes_epoch = (rows // batch_size) * batch_size * row_b
    best = min(walls)
    results = {
        "row_bytes": row_b, "chunk_batches": chunk,
        "n_chunks": -(-(rows // batch_size) // chunk),
        "assemble_s": round(sum(phase["assemble"]), 3),
        "put_s": round(sum(phase["put"]), 3),
        "dispatch_s": round(sum(phase["dispatch"]), 3),
        "sync_s": round(sum(phase["sync"]), 3),
        "put_mb_per_s": round(
            wire_bytes_epoch / max(sum(phase["put"]), 1e-9) / 1e6, 1),
        "wall_inline_s": round(wall_inline, 3),
        "wall_prefetch_s": [round(w, 3) for w in walls],
        "rate_prefetch": round(rows / best, 1),
    }
    # the inline epoch's phases on the goodput ledger's buckets
    # (obs/goodput.py): assemble + put are host input work the card
    # waited on (the inline producer runs serially by design), dispatch +
    # sync the step
    input_s = sum(phase["assemble"]) + sum(phase["put"])
    step_s = sum(phase["dispatch"]) + sum(phase["sync"])
    obs.event(
        "goodput", source="profile_staged", wire=name,
        wall_s=round(wall_inline, 6),
        buckets={"compile": 0.0, "input": round(input_s, 6),
                 "step": round(step_s, 6), "checkpoint": 0.0,
                 "restore": 0.0, "eval": 0.0,
                 "other": round(max(wall_inline - input_s - step_s,
                                    0.0), 6)},
        goodput_fraction=(round(step_s / wall_inline, 4)
                          if wall_inline > 0 else None),
        mfu=None, **results)
    return results, inline


def profile(device=None, *, wires: Sequence[tuple] = WIRES, ds=None,
            batch_size: int = BATCH_SIZE, chunk_bytes: int = CHUNK_BYTES,
            probe: Optional[dict] = None,
            init_fn: Optional[Callable] = None) -> dict:
    """Probe, profile each of `wires`, probe again, and journal the
    `staged_roofline` events.  Returns {"results": {wire: results},
    "inline": {wire: the inline epoch's outcome (`profile_wire`)},
    "h2d_before", "h2d_after": bytes/s}.  `ds` (f32 rows) defaults to
    `make_dataset(dataset_rows(batch_size, chunk_bytes))`; `probe` passes
    keyword arguments to `h2d_bytes_per_sec`; `batch_size`, `chunk_bytes`,
    `probe` and `init_fn` are there to run it small."""
    from .. import obs
    from ..device import resolve_device

    dev = resolve_device(device)
    if ds is None:
        ds = make_dataset(dataset_rows(batch_size, chunk_bytes))
    probe = probe or {}
    h2d0 = h2d_bytes_per_sec(dev, **probe)
    obs.event("h2d_probe", when="before", mb_per_sec=round(h2d0 / 1e6, 1))
    results, inline = {}, {}
    for name, wire, compact in wires:
        results[name], inline[name] = profile_wire(
            name, wire, compact, ds, dev, batch_size=batch_size,
            chunk_bytes=chunk_bytes, init_fn=init_fn)
    h2d1 = h2d_bytes_per_sec(dev, **probe)
    obs.event("h2d_probe", when="after", mb_per_sec=round(h2d1 / 1e6, 1))
    for name, r in results.items():
        # explicit before/after keys: probe-derived key names would
        # collide whenever the two probes round to the same MB/s
        def frac(h2d: float, r: dict = r):
            return (round(r["rate_prefetch"] * r["row_bytes"] / h2d, 3)
                    if h2d > 0 else None)
        obs.event("staged_roofline", wire=name,
                  fraction_at_before_probe=frac(h2d0),
                  fraction_at_after_probe=frac(h2d1),
                  before_mb_per_sec=round(h2d0 / 1e6, 1),
                  after_mb_per_sec=round(h2d1 / 1e6, 1))
    obs.flush()
    return {"results": results, "inline": inline, "h2d_before": h2d0,
            "h2d_after": h2d1}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="profile_staged",
        description="per-chunk assemble/put/dispatch split of the staged "
                    "input tier per wire format, prefetched epoch walls "
                    "and a host-to-card probe")
    p.add_argument("--device", default=None,
                   help="device to profile (default cuda:0; 'cpu' only "
                        "when asked)")
    args = p.parse_args(argv)

    # telemetry sinks: SHIFU_TPU_METRICS_DIR when set (journal + scrape on
    # disk, like a training job), else an in-memory journal whose records
    # print as JSONL at the end
    from .. import obs
    metrics_dir = obs.resolve_metrics_dir()
    if metrics_dir:
        obs.configure(metrics_dir)
    else:
        obs.set_journal(obs.RunJournal(None))
    profile(args.device)
    j = obs.get_journal()
    if j is not None and j.path is None:
        for rec in j.records:  # no metrics dir: the JSONL goes to stdout
            print(json.dumps(rec), flush=True)
    elif j is not None:
        print(f"telemetry written to {j.path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
