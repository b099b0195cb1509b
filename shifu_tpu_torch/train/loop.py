"""The training loop on one device (port of the single-host path of
shifu_tpu/train/loop.py).

`train(job, ...)` builds the model and optimizer, resumes from the newest
checkpoint when `runtime.checkpoint.directory` is set, and runs the epochs
on one of three input tiers, chosen by the JAX package's rule: the
device-resident tier when the training partition, in its in-card format
(int8 features on the wire grid, u8 targets, the weight column elided when
all ones), fits `data.device_resident_bytes`; else the staged tier, host-fed
(nb, B, ...) blocks when `data.staged` and `data.drop_remainder` are set;
else the per-batch tier.  A job given files streams its first epoch from
the parse (`data.stream_first_epoch`) and loads the retained dataset for
the later epochs, unless the projected cache is hot for every file
(`pipeline.projected_cache_complete`): then it loads at once, as the JAX
loop does.  `data.out_of_core` trains from memory-mapped consolidated
arrays (`data/outofcore.py`) on the staged tier.

With `data.overlap_epochs` one persistent `EpochFeeder` feeds the staged
and per-batch tiers: its assembly thread gathers, dedups (under a sparse
plan, unless `embed.dedup` is "off") and casts; its placement thread copies
from pinned host buffers to the card on a CUDA stream of its own, and the
compute stream waits on an event before it reads a placed item.  Off, a
per-epoch producer thread does the same work for that epoch only.  Batch
order is a pure function of (seed, epoch) either way.

Every epoch ends with a full evaluation of the valid set (zero-weight tail
padding) every `eval_every_epochs`, the console line of `EpochMetrics`, the
early-stopping bookkeeping, the epoch's checkpoint, a SIGTERM drain point,
and its telemetry: the journal's `epoch`, `goodput` and `overlap_report`
events, spans, `StepTimer` histograms and the metrics scrape file.  Chunk
boundaries are save points too (`save_every_seconds`, and the SIGTERM
drain: save, then `SystemExit(75)`).

The device flight recorder (obs/devprof.py) rides the loop as in the JAX
package: scheduled torch.profiler windows (`obs.trace_epochs`) rolled into
`device_profile` events, the per-chunk anomaly ring fed through
StepTimer's hook, and an `hbm_watermark` at every epoch boundary (on the
CPU, the training state's and resident batches' bytes).  The legacy
SHIFU_TPU_PROFILE_DIR dump takes the first epoch's capture over the
schedule, and says so.  The profiler never stays open, however the loop
exits.

The chaos sites `train.epoch_start` (each epoch's boundary, before any
work) and `train.chunk` (each chunk's save point) sit where the JAX
loop's do.  Every evaluated epoch also sketches the valid scores and (once)
the training features on the int8 wire grid, and journals the frozen drift
baseline as a `baseline_profile` event; the last one rides
`TrainResult.baseline_profile` into the artifact (obs/sketch.py).  The
multi-host paths are ROADMAP.md queue A item (f).
"""

from __future__ import annotations

import dataclasses
import os
import signal
import threading
import time
from collections import deque
from typing import Any, Callable, Optional

import numpy as np
import torch

from .. import chaos, obs
from ..config.schema import JobConfig
from ..data import pipeline as pipe
from ..device import DeviceLike, resolve_device
from ..embed.dedup import attach_dedup
from ..models.registry import build_model
from ..ops import metrics as metrics_lib
from . import checkpoint as ckpt_lib
from . import profiler as prof_lib
from . import sparse_embed
from .optimizers import Optimizer
from .step import (make_device_epoch_step, make_epoch_scan_step,
                   make_eval_step, make_train_step, wire_fused_into_model,
                   wire_grid)
from .train_state import TrainState

Console = Callable[[str], None]

_TRAINABLE = ("mlp", "ft_transformer", "wide_deep", "deepfm", "multitask",
              "moe_mlp")

# the exit code of a SIGTERM drain (EX_TEMPFAIL: restart the job)
PREEMPTED_EXIT = 75


@dataclasses.dataclass
class EpochMetrics:
    epoch: int
    train_error: float
    valid_error: float
    valid_auc: float
    epoch_time: float
    valid_time: float

    def console_line(self, total_epochs: int = 0) -> str:
        progress = (f" progress={100.0 * (self.epoch + 1) / total_epochs:.0f}%"
                    if total_epochs > 0 else "")
        return (f"Epoch {self.epoch}: train_error={self.train_error:.6f} "
                f"valid_error={self.valid_error:.6f} valid_auc={self.valid_auc:.4f} "
                f"time={self.epoch_time:.2f}s valid_time={self.valid_time:.2f}s"
                f"{progress}")


@dataclasses.dataclass
class TrainResult:
    state: TrainState
    history: list[EpochMetrics]
    job: JobConfig
    # input tier of the loaded epochs: "resident", "staged" or "batch";
    # "stream" when only the streamed first epoch ran
    tier: str = ""
    # the per-batch dedup's counts (embed/dedup `dedup_state`: batches,
    # unique rows, raw id cells), or None when no batch was compacted
    dedup: Optional[dict] = None
    # the epoch the run resumed at (0 for a fresh run)
    resumed_from_epoch: int = 0
    # the frozen stats epoch (obs/sketch.build_profile): the training
    # features' and the last evaluated epoch's score sketches, which
    # save_artifact writes as baseline_profile.json; None when the run
    # never evaluated or its features were not held
    baseline_profile: Optional[dict] = None


def init_state(job: JobConfig, num_features: int,
               device: DeviceLike = None) -> TrainState:
    """Build the model in training mode and its optimizer.  Weights are
    drawn from a `torch.Generator` seeded with `train.seed` (other numbers
    than the JAX package's init from the same seed).  When int8 features
    reach the model natively its layer 0 carries the wire grid.  Under a
    sparse embedding plan the optimizer leaves the embedding tables out and
    their slots go on `table_slots`.  Every model of the JAX ladder
    trains."""
    if job.model.model_type not in _TRAINABLE:
        raise KeyError(f"unknown model_type {job.model.model_type!r}; the "
                       "port trains " + ", ".join(_TRAINABLE))
    if num_features != job.schema.feature_count:
        raise ValueError(f"dataset has {num_features} features, the schema "
                         f"selects {job.schema.feature_count}")
    wire = wire_grid(job) if wire_fused_into_model(job) else None
    model = build_model(job.model, job.schema, device,
                        generator=torch.Generator().manual_seed(
                            job.train.seed),
                        wire=wire, train=True)
    plan = sparse_embed.resolve_plan(job)
    tables = set(sparse_embed.table_names(model, plan)) if plan else set()
    dense = [p for n, p in model.named_parameters() if n not in tables]
    return TrainState(
        model=model, optimizer=Optimizer(dense, job.train.optimizer),
        table_slots=(sparse_embed.init_table_slots(model, plan)
                     if tables else None))


def _tensor_bytes(obj) -> int:
    """Bytes of the tensors in nested dicts, lists and tuples."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, dict):
        return sum(_tensor_bytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_tensor_bytes(v) for v in obj)
    return 0


def _bf16_wire(job: JobConfig) -> bool:
    return pipe.wire_mode(job.schema, job.data,
                          job.model.compute_dtype) == "bfloat16"


def _host_tensor(v: np.ndarray) -> torch.Tensor:
    """A host array as a tensor; uint16 (the bf16 bits the loader stores)
    travels as int16 and is viewed as bfloat16 where it lands."""
    v = np.ascontiguousarray(v)
    if v.dtype == np.uint16:
        return torch.from_numpy(v.view(np.int16))
    return torch.from_numpy(v)


def _features_dtype(out: dict, bf16: bool, bits: bool) -> None:
    """bf16 bits viewed back as bfloat16; f32 features under a bf16 wire
    cast on the card (round to nearest even, as the JAX host cast)."""
    f = out.get("features")
    if f is None:
        return
    if bits:
        out["features"] = f.view(torch.bfloat16)
    elif f.dtype == torch.float32 and bf16:
        out["features"] = f.to(torch.bfloat16)


def to_device(batch: dict[str, np.ndarray], job: JobConfig,
              device: torch.device) -> dict[str, torch.Tensor]:
    """Host arrays -> tensors on `device`.  A bfloat16 wire casts f32
    features on the card (numpy has no bfloat16); bf16 bits (uint16) are
    viewed as bfloat16."""
    out = {k: _host_tensor(v).to(device) for k, v in batch.items()}
    f = batch.get("features")
    _features_dtype(out, _bf16_wire(job),
                    f is not None and f.dtype == np.uint16)
    return out


class _Placed:
    """Tensors copied to the card on a side stream, and the event that
    marks the end of their copies."""

    __slots__ = ("tensors", "event")

    def __init__(self, tensors: dict, event):
        self.tensors = tensors
        self.event = event


def make_placer(job: JobConfig, device: torch.device):
    """(put, ready): `put(host dict)` places a batch or block on `device`;
    `ready(item)` returns its tensors for the compute stream.

    On the card, `put` runs on the producer's thread: it sets the device,
    copies each array into a pinned host buffer and from there to the card
    on a CUDA stream of that thread's own, and records an event.  `ready`
    makes the compute stream wait on that event and marks each tensor as
    used by the compute stream (`record_stream`), so the caching allocator
    cannot hand its memory to a later item while the step still reads it.
    The pinned buffers come from PyTorch's caching host allocator, which
    reuses a buffer only once the copy out of it has completed.  On the
    CPU, `put` is `to_device` and `ready` the identity."""
    if device.type != "cuda":
        return (lambda b: to_device(b, job, device)), (lambda item: item)
    local = threading.local()
    bf16 = _bf16_wire(job)

    def put(batch: dict) -> _Placed:
        stream = getattr(local, "stream", None)
        if stream is None:
            torch.cuda.set_device(device)
            stream = local.stream = torch.cuda.Stream(device)
        out = {}
        with torch.cuda.stream(stream):
            for k, v in batch.items():
                host = _host_tensor(v)
                pinned = torch.empty(host.shape, dtype=host.dtype,
                                     pin_memory=True)
                pinned.copy_(host)
                out[k] = pinned.to(device, non_blocking=True)
            f = batch.get("features")
            _features_dtype(out, bf16, f is not None and f.dtype == np.uint16)
            event = torch.cuda.Event()
            event.record(stream)
        return _Placed(out, event)

    def ready(item):
        if not isinstance(item, _Placed):
            return item
        cur = torch.cuda.current_stream(device)
        cur.wait_event(item.event)
        for t in item.tensors.values():
            t.record_stream(cur)
        return item.tensors

    return put, ready


def eval_batch_size(job: JobConfig, num_rows: int) -> int:
    """Rows per eval batch: max(batch_size, 4096), but for a valid set
    smaller than that the set rounded up to a multiple of 4096."""
    bs = max(job.data.batch_size, 4096)
    if num_rows < bs:
        bs = max(-(-num_rows // 4096) * 4096, 4096)
    return bs


def evaluate(state: TrainState, ds: pipe.TabularDataset, job: JobConfig,
             eval_step, device: torch.device,
             batch_size: Optional[int] = None,
             score_sink: Optional[Callable[[np.ndarray], None]] = None
             ) -> tuple[float, float]:
    """(weighted_error, auc) over the whole dataset: every row counted, the
    last batch padded with zero-weight rows.  A multi-head model is scored
    on head 0 against target column 0, as in the JAX package.  Scores are
    fetched a window of 8 batches behind the launches, so the card is not
    drained after every batch.  `score_sink` gets each batch's head-0
    scores of the rows with nonzero weight (the baseline score sketch)."""
    if ds.num_rows == 0:
        return float("nan"), float("nan")
    bs = batch_size or eval_batch_size(job, ds.num_rows)
    wcast = pipe.wire_cast_fn(job.schema, job.data, job.model.compute_dtype)
    sm = metrics_lib.StreamingMetrics()
    lat = obs.histogram("eval_batch_seconds",
                        "eval batch score+gather latency")
    rows = obs.counter("eval_rows_total", "rows evaluated (nonzero weight)")
    pend: deque = deque()
    t0 = [time.perf_counter()]

    def fetch(entry) -> None:
        s, n, tgt, wgt = entry
        scores = s.cpu().numpy()[:n, 0]
        sm.update(scores, tgt, wgt)
        if score_sink is not None:
            score_sink(scores[np.asarray(wgt) > 0])
        lat.observe(time.perf_counter() - t0[0])
        rows.inc(int(np.count_nonzero(wgt)))
        t0[0] = time.perf_counter()

    for batch in pipe.batch_iterator(ds, bs, shuffle=False,
                                     drop_remainder=False):
        padded, mask = pipe.pad_to_batch(batch, bs)
        if wcast is not None:
            padded = wcast(padded)
        pend.append((eval_step(state, to_device(padded, job, device)),
                     int(mask.sum()), batch["target"][:, 0],
                     batch["weight"][:, 0]))
        if len(pend) >= 8:
            fetch(pend.popleft())
    while pend:
        fetch(pend.popleft())
    return sm.weighted_error(), sm.auc()


def _baseline_feature_sketch(job: JobConfig, ds, cap: int = 1 << 18):
    """FeatureSketch of the training partition on the int8 wire grid: the
    feature half of the frozen baseline profile, stride-sampled to at most
    `cap` rows.  bf16 features (uint16 bits) widen to f32 first.  None
    when the features are not held (a streamed epoch)."""
    feats = getattr(ds, "features", None)
    if feats is None or feats.shape[0] == 0:
        return None
    scale, offset = pipe.wire_params(job.schema, job.data)
    sk = obs.sketch.FeatureSketch(feats.shape[1], scale=scale, offset=offset)
    step = max(1, -(-int(feats.shape[0]) // int(cap)))
    sample = np.asarray(feats[::step][:cap])
    sk.update(sample if sample.dtype == np.int8
              else pipe.features_f32(sample))
    return sk


def _baseline_feature_names(schema, num_features: int):
    """Selected-column names for the profile (None when the schema does
    not name every selected column)."""
    by_index = {c.index: c.name for c in schema.columns}
    names = [by_index.get(i, f"f{i}") for i in schema.selected_indices]
    return names if len(names) == num_features else None


def _stack_blocks(ds: pipe.TabularDataset, nb: int, bs: int) -> dict:
    def stack(arr):
        return arr[:nb * bs].reshape(nb, bs, *arr.shape[1:])
    return {"features": stack(ds.features), "target": stack(ds.target),
            "weight": stack(ds.weight)}


def _resume(job: JobConfig, state: TrainState, console: Console):
    """The checkpoint manager (None without a directory) and the epoch to
    start at, after restoring the newest usable checkpoint into `state`."""
    ck = job.runtime.checkpoint
    if not ck.directory:
        return None, 0
    manager = ckpt_lib.make_manager(ck.directory, ck.max_to_keep)
    if not ck.resume:
        return manager, 0
    fresh_opt = state.optimizer.state_dict()  # before the restore replaces it
    restored = ckpt_lib.restore_latest(manager, state, with_extra=True)
    if restored is None:
        return manager, 0
    _, extra, step = restored
    start_epoch = int((extra or {}).get("epoch", 0))
    console(f"Resumed from checkpoint step {step} (epoch {start_epoch})")
    obs.event("train_resume", step=int(step), epoch=start_epoch)
    if (extra or {}).get("best_restored") and start_epoch < job.train.epochs:
        # the terminal checkpoint's params were rolled back to the best
        # epoch, but its optimizer moments belong to the last trajectory:
        # continuing with that pairing would apply mismatched updates
        state.optimizer.load_state_dict(fresh_opt)
        console("Resuming past a best-params terminal checkpoint: "
                "optimizer state reinitialized")
    return manager, start_epoch


def train(job: JobConfig,
          train_ds: Optional[pipe.TabularDataset] = None,
          valid_ds: Optional[pipe.TabularDataset] = None,
          console: Optional[Console] = None,
          epoch_callback: Optional[Callable[[EpochMetrics], None]] = None,
          device: DeviceLike = None) -> TrainResult:
    """Run the training job on `device` (default `cuda:0`; the CPU only
    when asked); returns the final state and the per-epoch history.
    Datasets may be passed in, else they are loaded (or the first epoch
    streamed) from job.data.paths.  SIGTERM (main thread only) saves at
    the next chunk boundary and raises SystemExit(75)."""
    job = job.validate()
    console = console or (lambda s: print(s, flush=True))
    dev = resolve_device(device)
    # the JAX loop's refusal: it takes the resident or the staged tier
    # exactly when data.staged and data.drop_remainder are both set
    if job.train.local_sgd_window > 0 and not (job.data.staged
                                               and job.data.drop_remainder):
        raise ValueError(
            "local_sgd_window (SAGN mode) needs the staged or "
            "device-resident input tier: set data.staged=True and "
            "data.drop_remainder=True (local replicas are synchronized "
            "by epoch scans, not per-batch dispatches)")
    # a bare SHIFU_TPU_METRICS_DIR is enough for a library caller
    obs.configure_from_env()
    obs.event("train_start", model=job.model.model_type,
              epochs=job.train.epochs, batch_size=job.data.batch_size,
              processes=1, devices=1)
    cdt = job.model.compute_dtype
    wmode = pipe.wire_mode(job.schema, job.data, cdt)
    # the streamed epoch's cast detects the compact target/weight per
    # block (content-driven, so a resume replays identical formats)
    wcast_stream = pipe.wire_cast_fn(job.schema, job.data, cdt, compact=True)
    # the loaders store the features in the wire dtype; the int8 grid's
    # clip rides in the cache key, so a changed grid never reuses entries
    feature_dtype = {"int8": f"int8c{job.data.wire_int8_clip:g}",
                     "bfloat16": "bfloat16"}.get(wmode, "float32")

    # streamed first epoch: train on parsed blocks while the rest of the
    # files parse in the background
    stream_loader = None
    pending_ingest_s = 0.0  # blocking pre-loop ingest, charged to epoch 1
    rate = job.train.bagging_sample_rate
    if train_ds is None:
        want_stream = (job.data.stream_first_epoch
                       and not job.data.out_of_core
                       and job.data.staged and job.data.drop_remainder
                       and not (0.0 < rate < 1.0))
        if want_stream and pipe.projected_cache_complete(
                job.schema, job.data, feature_dtype):
            # a hot cache loads at np.load speed: no parse left to hide,
            # and the loaded tiers beat training in file order
            console("Projected cache is hot for every input file: "
                    "skipping the streamed first epoch")
            want_stream = False
        if want_stream:
            stream_loader = pipe.StreamingLoader(job.schema, job.data,
                                                 feature_dtype)
        else:
            # blocking ingest (hot cache, loaded tiers, out of core),
            # charged to the first epoch's input bucket below
            t_ingest = time.perf_counter()
            train_ds, valid_ds = pipe.load_datasets(
                job.schema, job.data, feature_dtype=feature_dtype)
            pending_ingest_s = time.perf_counter() - t_ingest
    if valid_ds is None and stream_loader is None:
        raise ValueError("train() needs valid_ds when train_ds is given")

    if train_ds is not None and 0.0 < rate < 1.0 and train_ds.num_rows > 0:
        from ..data.split import bagging_mask
        keep = np.nonzero(bagging_mask(
            np.arange(train_ds.num_rows, dtype=np.uint64),
            rate, seed=job.train.seed))[0]
        console(f"Bagging: {len(keep)}/{train_ds.num_rows} train rows "
                f"(baggingSampleRate={rate:g})")
        train_ds = train_ds.take(keep)

    num_features = ((train_ds.num_features if train_ds is not None else 0)
                    or job.schema.feature_count)
    state = init_state(job, num_features, dev)
    manager, start_epoch = _resume(job, state, console)

    # streaming serves only the first epoch of a fresh run: a resumed
    # epoch must replay the shuffled epoch an unbroken run trains
    if stream_loader is not None and start_epoch > 0:
        train_ds, valid_ds = stream_loader.datasets()
        stream_loader = None

    epoch_scan_step = make_epoch_scan_step(job)
    # chunks of ~32 MB of wire bytes, so a copy stays short and overlaps
    # compute; by bytes, not rows (the int8 wire carries 4x the rows)
    row_wire_b = pipe.wire_row_bytes(job.schema, job.data, cdt)
    chunk_cap = max(1, (32 << 20) // max(job.data.batch_size * row_wire_b, 1))
    staged_block_batches = max(1, min(job.data.block_batches, chunk_cap))
    put, ready = make_placer(job, dev)

    # tier plumbing, resolved by _prepare_tiers once train_ds exists
    bs = job.data.batch_size
    use_resident = use_staged = False
    resident_blocks = None
    device_epoch_step = None
    train_step = None
    wcast = None
    bcast = None
    dedup = None
    prepared = False

    use_overlap = job.data.overlap_epochs
    feeder: Optional[pipe.EpochFeeder] = None
    feeder_host_depth = job.data.prefetch_depth or 4
    feeder_dev_depth = job.data.prefetch if job.data.prefetch_depth else 2

    def _staged_host_blocks(ep: int):
        """The staged epoch's blocks, wire-cast on the producing thread."""
        for b in pipe.staged_epoch_blocks(
                train_ds, bs, shuffle=job.data.shuffle,
                seed=job.data.shuffle_seed, epoch=ep,
                block_batches=staged_block_batches):
            yield wcast(b) if wcast is not None else b

    def _perbatch_host_batches(ep: int):
        """The epoch's batches, deduped and wire-cast on the producing
        thread (the feeder's assembly thread when the overlap is on)."""
        for b in pipe.batch_iterator(
                train_ds, bs, shuffle=job.data.shuffle,
                seed=job.data.shuffle_seed, epoch=ep,
                drop_remainder=job.data.drop_remainder):
            yield bcast(b) if bcast is not None else b

    def _prepare_tiers():
        nonlocal bs, use_resident, use_staged, resident_blocks, \
            device_epoch_step, train_step, wcast, bcast, dedup, prepared
        prepared = True
        # compact target/weight wire, decided once over the whole partition
        label_ok = (job.data.wire_label_dtype in ("auto", "uint8")
                    and pipe.target_u8_exact(train_ds.target))
        weight_ok = (job.data.wire_weight_mode in ("auto", "elide")
                     and pipe.weight_all_ones(train_ds.weight))
        if job.data.wire_label_dtype == "uint8" and not label_ok:
            raise ValueError("wire_label_dtype=uint8 but targets are not "
                             "integers in [0, 255] — use "
                             "wire_label_dtype=auto or float32")
        if job.data.wire_weight_mode == "elide" and not weight_ok:
            raise ValueError("wire_weight_mode=elide but weights are not "
                             "all 1.0 — use wire_weight_mode=auto or "
                             "float32")
        wcast = pipe.wire_cast_fn(job.schema, job.data, cdt,
                                  compact=(label_ok, weight_ok))
        if train_ds.num_rows == 0:
            raise ValueError("training dataset has 0 rows — nothing to "
                             "train on")
        bs = job.data.batch_size
        if bs > train_ds.num_rows and job.data.drop_remainder:
            bs = train_ds.num_rows
            console(f"batch_size {job.data.batch_size} > {train_ds.num_rows} "
                    f"usable rows; clamped to {bs}")
        # the tier rule: bytes of the partition in its in-card format
        # against the resident budget
        rfmt = pipe.resident_feature_format(job.schema, job.data, cdt)
        n = train_ds.num_rows
        feat_row_bytes = train_ds.features.nbytes // max(n, 1)
        if train_ds.features.dtype == np.float32:
            if rfmt == "int8":
                feat_row_bytes //= 4
            elif rfmt == "bfloat16":
                feat_row_bytes //= 2
        elif train_ds.features.dtype == np.uint16 and rfmt == "int8":
            feat_row_bytes //= 2
        tgt_row_bytes = train_ds.target.nbytes // max(n, 1)
        if label_ok:
            tgt_row_bytes //= 4
        wgt_row_bytes = 0 if weight_ok else train_ds.weight.nbytes // max(n, 1)
        ds_bytes = (feat_row_bytes + tgt_row_bytes + wgt_row_bytes) * n
        use_resident = (job.data.staged and job.data.drop_remainder
                        and 0 < ds_bytes <= job.data.device_resident_bytes
                        and n // bs > 0)
        use_staged = (job.data.staged and job.data.drop_remainder
                      and not use_resident)
        if use_resident:
            nb_total = n // bs
            host_blocks = _stack_blocks(train_ds, nb_total, bs)
            raw_features = host_blocks["features"]
            if wcast is not None:
                host_blocks = wcast(host_blocks)
            if rfmt == "int8" and host_blocks["features"].dtype != np.int8:
                # forced int8 residency under a wider wire: quantize the
                # raw features once on the same static grid
                scale, offset = pipe.wire_params(job.schema, job.data)
                host_blocks = dict(host_blocks)
                host_blocks["features"] = pipe.wire_quantize(
                    pipe.features_f32(raw_features), scale, offset)
            resident_blocks = to_device(host_blocks, job, dev)
            device_epoch_step = make_device_epoch_step(job)
        elif not use_staged:
            train_step = make_train_step(job)
            plan = (sparse_embed.resolve_plan(job)
                    if job.embed.dedup != "off" else None)
            bcast = wcast
            if plan is not None:
                # dedup reads the f32 features: it runs before the cast
                dedup = attach_dedup(plan.layout, plan.max_vocab)
                bcast = (dedup if wcast is None
                         else (lambda b, _c=wcast: _c(dedup(b))))

    if train_ds is not None:
        _prepare_tiers()
    eval_step = make_eval_step(job)
    profile_dir = os.environ.get("SHIFU_TPU_PROFILE_DIR")

    def state_bytes() -> int:
        """The CPU watermark: parameters, optimizer and table slots, and
        the resident batches (obs/devprof.py)."""
        return (_tensor_bytes(state.model.state_dict())
                + _tensor_bytes(state.optimizer.state_dict())
                + _tensor_bytes(state.table_slots)
                + _tensor_bytes(resident_blocks))

    # device flight recorder: scheduled trace windows, the anomaly ring and
    # the epoch-boundary watermarks
    devprof = obs.devprof.DeviceProfiler(job.obs, start_epoch=start_epoch,
                                         state_bytes=state_bytes)
    timing_on = (bool(os.environ.get("SHIFU_TPU_TIMING"))
                 or job.train.log_every_steps > 0)

    # preemption: on SIGTERM, save at the next chunk boundary and exit 75.
    # The handler only sets a flag; signal.signal raises off the main
    # thread, and then no handler is installed, as in the JAX loop
    term_flag = {"hit": False}
    old_term = None
    try:
        old_term = signal.signal(signal.SIGTERM,
                                 lambda *_: term_flag.update(hit=True))
    except ValueError:
        pass  # not the main thread

    save_secs = job.runtime.checkpoint.save_every_seconds
    last_save = time.monotonic()

    def maybe_midtrain_save(epoch: int) -> None:
        """A chunk-boundary save point: the time cadence and the SIGTERM
        drain.  A mid-epoch save records the current epoch, so a resume
        replays that epoch from its start."""
        nonlocal last_save
        # chaos site "train.chunk": dying between a chunk's compute and
        # its save
        chaos.maybe_fail("train.chunk", echo=console, epoch=epoch)
        if term_flag["hit"]:
            if manager is not None:
                cur = int(state.step)
                saved = False
                if (ckpt_lib.latest_step(manager) or -1) < cur:
                    ckpt_lib.save(manager, cur, state,
                                  extra={"epoch": epoch}, block=True)
                    saved = True
                ckpt_lib.finalize(manager)
                obs.event("preemption_grace", epoch=int(epoch), step=cur,
                          saved=saved)
                obs.flush()
                console("SIGTERM: checkpoint saved, exiting for restart")
            else:
                console("SIGTERM: exiting (no checkpoint directory)")
            raise SystemExit(PREEMPTED_EXIT)
        if manager is None or save_secs <= 0:
            return
        if time.monotonic() - last_save >= save_secs:
            cur = int(state.step)
            # `<`: a collision-bumped key can sit above the raw step, and
            # that still means this step's state is durable
            if (ckpt_lib.latest_step(manager) or -1) < cur:
                ckpt_lib.save(manager, cur, state, extra={"epoch": epoch},
                              block=True)
            last_save = time.monotonic()

    def run_chunks(items, step_fn, epoch: int, timer, count) -> tuple:
        """Train on `items` (placed batches or blocks) with `step_fn`;
        returns (loss sum on the card, batches)."""
        nonlocal state
        acc, n = None, 0
        for item in items:
            timer.mark_input_ready()
            xs = ready(item)
            state, loss = step_fn(state, xs)
            acc = loss if acc is None else acc + loss
            n += count(xs)
            timer.mark_step_done()
            maybe_midtrain_save(epoch)
        return acc, n

    def batch_step(st, batch):
        st, m = train_step(st, batch)
        return st, m["loss"]

    def block_batches(xs) -> int:
        return xs["features"].shape[0]

    history: list[EpochMetrics] = []
    # the drift baseline: the feature sketch is built once, the score
    # sketch at every evaluated epoch
    feat_sketch = None
    baseline_profile: Optional[dict] = None
    best_valid = float("inf")
    evals_since_best = 0
    best_params: Optional[dict[str, Any]] = None
    pending_loader = None  # streamed loader whose train set is not built
    pending_thread = None  # background assembly of the retained dataset
    pending_assembly: dict = {}
    try:
        for epoch in range(start_epoch, job.train.epochs):
            # chaos site "train.epoch_start": the epoch boundary before any
            # work (the previous epoch's save has landed); distinct from
            # the CLI's post-epoch "train.epoch"
            chaos.maybe_fail("train.epoch_start", echo=console, epoch=epoch)
            t0 = time.perf_counter()
            led_open = obs.goodput.begin_epoch()
            # the blocking load before the loop is charged to the first
            # epoch: its input bucket, and its wall extends the epoch's
            ingest_wall_s, pending_ingest_s = pending_ingest_s, 0.0
            if ingest_wall_s > 0:
                led_open.add("input", ingest_wall_s)
            if pending_loader is not None and epoch > start_epoch:
                # the first epoch after the streamed one: the retained
                # dataset, assembled in the background behind that epoch's
                # eval (overlap on) or here
                if pending_thread is not None:
                    pending_thread.join()
                    pending_thread = None
                    if "error" in pending_assembly:
                        raise pending_assembly["error"]
                    train_ds = pending_assembly.pop("train_ds")
                else:
                    train_ds = pending_loader.train_dataset()
                pending_loader = None
                _prepare_tiers()
            loss_acc, loss_n = None, 0
            timer = prof_lib.StepTimer(on_chunk=devprof.chunk_hook(epoch))
            timer.start()
            # the legacy SHIFU_TPU_PROFILE_DIR first-epoch dump keeps its
            # raw-trace semantics; otherwise the recorder's schedule
            # decides (a scheduled epoch closes into a device_profile)
            if profile_dir and epoch == start_epoch:
                devprof.note_superseded(epoch)
                trace_ctx = prof_lib.trace(profile_dir)
            else:
                trace_ctx = devprof.epoch_capture(epoch)
            with trace_ctx, obs.span("epoch/train", epoch=epoch):
                streamed_this_epoch = False
                if stream_loader is not None and epoch == start_epoch:
                    stream_bs = bs
                    console(f"Streaming first epoch: training overlaps the "
                            f"background parse (batch {stream_bs}, "
                            f"{staged_block_batches} batches/chunk)")
                    # zero-weight tail padding is exact only for the
                    # weight-gated losses without an L2 term
                    pad_tail = (job.train.loss in ("weighted_mse",
                                                   "weighted_bce")
                                and job.model.l2_scale <= 0)
                    blocks = (wcast_stream(b) for b in
                              stream_loader.first_epoch_blocks(
                                  stream_bs, staged_block_batches,
                                  pad_tail=pad_tail))
                    loss_acc, _ = run_chunks(
                        pipe.prefetch_to_device(blocks, put,
                                                size=job.data.prefetch),
                        epoch_scan_step, epoch, timer, block_batches)
                    # the denominator: batches holding at least one real
                    # row (pad-only batches add zero loss)
                    loss_n = stream_loader.real_batches
                    valid_ds = stream_loader.valid_dataset()
                    pending_loader, stream_loader = stream_loader, None
                    streamed_this_epoch = loss_n > 0
                    if (streamed_this_epoch and use_overlap
                            and epoch + 1 < job.train.epochs):
                        # assemble and shuffle the retained dataset behind
                        # this epoch's eval
                        def _assemble_retained(loader=pending_loader,
                                               box=pending_assembly):
                            try:
                                box["train_ds"] = loader.train_dataset()
                            except BaseException as e:  # raised at the join
                                box["error"] = e

                        pending_thread = threading.Thread(
                            target=_assemble_retained, daemon=True,
                            name="shifu-retained-assembly")
                        pending_thread.start()
                    if not streamed_this_epoch:
                        # no full batch streamed: assemble now and rerun
                        # the epoch on the loaded tiers
                        train_ds = pending_loader.train_dataset()
                        pending_loader = None
                        _prepare_tiers()
                        console(f"streamed first epoch had no full batch "
                                f"of {stream_bs}; re-running epoch {epoch} "
                                f"with batch {bs}")
                if streamed_this_epoch:
                    pass
                elif use_resident:
                    nb_total = resident_blocks["features"].shape[0]
                    order = pipe.epoch_permutation(
                        nb_total, shuffle=job.data.shuffle,
                        seed=job.data.shuffle_seed, epoch=epoch)
                    timer.mark_input_ready()
                    state, loss_acc = device_epoch_step(
                        state, resident_blocks, order)
                    loss_n = nb_total
                    timer.mark_step_done()
                else:
                    source = (_staged_host_blocks if use_staged
                              else _perbatch_host_batches)
                    if use_overlap:
                        if feeder is None:
                            feeder = pipe.EpochFeeder(
                                source, put, range(epoch, job.train.epochs),
                                depth=feeder_dev_depth,
                                host_depth=feeder_host_depth)
                        items = feeder.epoch(epoch)
                    else:
                        items = pipe.prefetch_to_device(
                            source(epoch), put, size=job.data.prefetch)
                    if use_staged:
                        loss_acc, loss_n = run_chunks(
                            items, epoch_scan_step, epoch, timer,
                            block_batches)
                    else:
                        loss_acc, loss_n = run_chunks(
                            items, batch_step, epoch, timer, lambda xs: 1)
            if loss_n == 0:
                raise ValueError(
                    f"epoch {epoch} produced 0 batches "
                    f"({train_ds.num_rows} rows, batch_size {bs}, "
                    f"drop_remainder={job.data.drop_remainder})")
            loss_sum = float(loss_acc)  # the epoch's one wait on the card
            epoch_time = time.perf_counter() - t0

            tv0 = time.perf_counter()
            if (epoch % job.train.eval_every_epochs == 0
                    or epoch == job.train.epochs - 1):
                score_sketch = obs.sketch.ScoreSketch()
                with obs.span("epoch/eval", epoch=epoch):
                    valid_error, valid_auc = evaluate(
                        state, valid_ds, job, eval_step, dev,
                        score_sink=score_sketch.update)
            else:
                score_sketch = None
                valid_error, valid_auc = float("nan"), float("nan")
            valid_time = time.perf_counter() - tv0

            m = EpochMetrics(epoch=epoch,
                             train_error=loss_sum / max(loss_n, 1),
                             valid_error=valid_error, valid_auc=valid_auc,
                             epoch_time=epoch_time, valid_time=valid_time)
            history.append(m)
            console(m.console_line(job.train.epochs))
            timer.emit()
            obs.counter("train_epochs_total", "completed training epochs").inc()
            obs.counter("train_batches_total",
                        "train batches consumed (scan tiers count batches "
                        "inside each chunk)").inc(loss_n)
            obs.gauge("train_error", "last epoch's weighted train error").set(
                m.train_error)
            if valid_error == valid_error:  # evaluated this epoch, not NaN
                obs.gauge("valid_error",
                          "last evaluated weighted valid error").set(
                    valid_error)
            if valid_auc == valid_auc:
                obs.gauge("valid_auc", "last evaluated valid AUC").set(
                    valid_auc)
            obs.event("epoch", **dataclasses.asdict(m))
            if score_sketch is not None and score_sketch.n > 0:
                # the frozen stats epoch: a summary every evaluated epoch;
                # the last one rides the artifact (obs/drift.py diffs live
                # traffic against it)
                if feat_sketch is None:
                    feat_sketch = _baseline_feature_sketch(job, train_ds)
                if feat_sketch is not None:
                    baseline_profile = obs.sketch.build_profile(
                        feat_sketch, score_sketch,
                        feature_names=_baseline_feature_names(
                            job.schema, feat_sketch.num_features),
                        train_auc=valid_auc, train_error=m.train_error,
                        epoch=epoch)
                    obs.event("baseline_profile",
                              **obs.sketch.profile_summary(baseline_profile))
            obs.flush()
            if timing_on:
                console(timer.console_line())
            tier = ("stream" if streamed_this_epoch else
                    "resident" if use_resident else
                    "staged" if use_staged else "batch")
            order_digest = pipe.epoch_order_digest(
                tier, train_ds.num_rows if train_ds is not None else 0, bs,
                shuffle=job.data.shuffle, seed=job.data.shuffle_seed,
                epoch=epoch)

            # early stopping runs before the terminal save, so that the
            # checkpoint holds the best params the returned state holds
            patience = job.train.early_stop_patience
            early_stop_now = False
            if patience > 0 and valid_error == valid_error:
                if valid_error < best_valid - job.train.early_stop_min_delta:
                    best_valid = valid_error
                    evals_since_best = 0
                    best_params = {k: v.detach().cpu().clone() for k, v in
                                   state.model.state_dict().items()}
                else:
                    evals_since_best += 1
                    if evals_since_best >= patience:
                        early_stop_now = True
                        console(f"Early stop at epoch {epoch}: no "
                                f"valid_error improvement > "
                                f"{job.train.early_stop_min_delta:g} in "
                                f"{patience} evaluated epochs "
                                f"(best {best_valid:.6f})")
            terminal = early_stop_now or epoch == job.train.epochs - 1
            best_restored = False
            if (terminal and best_params is not None
                    and best_valid < float("inf")):
                best_restored = True
                # the terminal checkpoint records epoch=epochs: rolled-back
                # params with the last trajectory's moments resume as done
                state.model.load_state_dict(best_params)

            # save before the callback, so an external kill never loses
            # the completed epoch (async_save trades that for overlap)
            if manager is not None and (
                    terminal or (epoch + 1)
                    % job.runtime.checkpoint.save_every_epochs == 0):
                extra = {"epoch": (job.train.epochs if terminal
                                   else epoch + 1)}
                if best_restored:
                    extra["best_restored"] = True
                ckpt_lib.save(manager, int(state.step), state, extra=extra,
                              block=(early_stop_now
                                     or not job.runtime.checkpoint.async_save))
                last_save = time.monotonic()
            # the epoch boundary: the resident tier's drain point
            maybe_midtrain_save(epoch + 1)

            # close the goodput ledger over the whole epoch wall
            led = obs.goodput.current()
            if led is not None:
                led.add("input", sum(timer.input_times))
                led.add("step", sum(timer.step_times))
                led.add("eval", valid_time)
                obs.goodput.end_epoch(
                    epoch, time.perf_counter() - t0 + ingest_wall_s)
            # close a one-shot anomaly capture still open and journal the
            # watermark beside the goodput record
            devprof.end_epoch(epoch)

            # overlap report: the input wait the card still saw (exposed)
            # against the host seconds the epoch's items cost (production)
            exposed_s = sum(timer.input_times)
            prod_s = (feeder.production_seconds(epoch) if feeder is not None
                      else exposed_s)
            hidden_s = max(prod_s - exposed_s, 0.0)
            eff = (hidden_s / (hidden_s + exposed_s)
                   if hidden_s + exposed_s > 0 else None)
            obs.event("overlap_report", epoch=epoch, tier=tier,
                      overlap=feeder is not None,
                      prefetch_depth=(feeder.depth if feeder is not None
                                      else job.data.prefetch),
                      input_exposed_s=round(exposed_s, 6),
                      input_production_s=round(prod_s, 6),
                      input_hidden_s=round(hidden_s, 6),
                      eval_s=round(valid_time, 6),
                      prefetched_chunks=(feeder.ready_ahead()
                                         if feeder is not None else 0),
                      overlap_efficiency=(round(eff, 4) if eff is not None
                                          else None),
                      order_digest=order_digest,
                      resident_format=(
                          pipe.resident_feature_format(job.schema, job.data,
                                                       cdt)
                          if use_resident else None))
            obs.counter("overlap_hidden_seconds_total",
                        "input seconds hidden behind device compute by "
                        "the overlap engine").inc(hidden_s, kind="input")
            exp_c = obs.counter("overlap_exposed_seconds_total",
                                "epoch-boundary seconds still exposed on "
                                "the critical path (device idle)")
            exp_c.inc(exposed_s, kind="input")
            exp_c.inc(valid_time, kind="eval")
            if eff is not None:
                obs.gauge("overlap_efficiency",
                          "last epoch's hidden / (hidden + exposed) input "
                          "fraction").set(round(eff, 4))
            wall_now = time.perf_counter() - t0
            if (feeder is not None and job.data.prefetch_depth == 0
                    and wall_now > 0):
                # auto mode: one depth step per epoch
                feeder.set_depth(pipe.next_prefetch_depth(
                    feeder.depth, exposed_s / wall_now))

            if epoch_callback is not None:
                epoch_callback(m)
            if early_stop_now:
                break
    finally:
        # never leave torch.profiler capturing, however the loop exits
        devprof.close()
        if feeder is not None:
            # however the loop exits: abort the feeder, drop its run-ahead
            feeder.close()
        if pending_thread is not None:
            # a short courtesy join only: nobody will use an unconsumed
            # background assembly, and the preemption grace is short
            pending_thread.join(timeout=1.0)
        if old_term is not None:
            signal.signal(signal.SIGTERM, old_term)
        if manager is not None:
            # an in-flight async save becomes durable however the loop exits
            ckpt_lib.finalize(manager)
        obs.event("train_end", epochs_completed=len(history))
        obs.flush()
    return TrainResult(state=state, history=history, job=job,
                       tier=("stream" if not prepared else
                             "resident" if use_resident else
                             "staged" if use_staged else "batch"),
                       dedup=dict(dedup.dedup_state) if dedup else None,
                       resumed_from_epoch=start_epoch,
                       baseline_profile=baseline_profile)
