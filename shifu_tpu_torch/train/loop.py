"""The training loop (port of the single-host path of
shifu_tpu/train/loop.py), on one device or on a mesh of ranks.

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
`TrainResult.baseline_profile` into the artifact (obs/sketch.py).

`train(..., mesh=)` runs the same loop on every rank of a mesh
(parallel/mesh.py), even a mesh of one: each rank holds the whole dataset
and feeds the global batches to its device, and the steps train its rows
(train/step.py).  Global batch sizes round up to a multiple of the mesh's
size, for training and for evaluation, whose scores are gathered over the
data group so that every rank computes world 1's metrics.  Init draws the
full state from `train.seed` on every rank, which then keeps its blocks.
Only the chief (rank 0) journals, prints and writes checkpoints, which
hold full, gathered tensors; every rank restores from them onto its own
blocks, so a checkpoint resumes on any mesh.  The chief's clock and its
SIGTERM decide the mid-epoch save points, agreed over the mesh's gloo
group.  The placements are the JAX package's (parallel/sharding.
sharding_rules): `shifu.sharding.rules`, vocab-sharded sparse tables, the
field axis of embedding tables, MoE experts over `model`, a pipelined
trunk's stages over `pipe`; ring and Ulysses attention use the `seq` axis.
A per-block FT checkpoint resumes into a stacked trunk and back
(`restore_latest_any_layout`).

Under a pod (more than one host, parallel/distributed.pod_contract) each
host loads only its file shard, and a rank is fed only its own rows of
its host's slice of every global batch (the JAX package's process-local
data): the hosts agree (MIN over the control group) on streaming or
loading, on the compact wire, on min_host_rows, which sizes the epochs
(global batch B, B / hosts a host), and on each epoch's file listing;
the first epoch streams in agreed rounds.  Every epoch ends with the
straggler line and its `host_skew` row (obs/aggregate.epoch_skew: each
host's input seconds, ingest, order and shard digests) and a
`dcn_placement` row.  A pod rank catches no SIGTERM and has no mid-epoch
save point, as in the JAX package: the gang's teardown is immediate and
the epoch saves keep the progress.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import signal
import threading
import time
from collections import deque
from typing import Any, Callable, Optional

import numpy as np
import torch

from .. import chaos, obs
from ..config.schema import ConfigError, JobConfig
from ..data import pipeline as pipe
from ..device import DeviceLike, resolve_device
from ..embed.dedup import attach_dedup
from ..models.registry import build_model
from ..ops import metrics as metrics_lib
from ..parallel import distributed
from ..parallel import mesh as mesh_lib
from ..parallel.mesh import DATA_AXIS, PIPE_AXIS
from ..parallel.pipeline import n_microbatches
from ..parallel.sharding import (place_model, shard_batch,
                                 shard_batch_process_local,
                                 shard_blocks_process_local, sharding_rules)
from . import checkpoint as ckpt_lib
from . import profiler as prof_lib
from . import sparse_embed
from .optimizers import Optimizer
from .sparse_embed import on_mesh
from .step import (make_device_epoch_step, make_epoch_scan_step,
                   make_eval_step, make_local_sgd_epoch_step,
                   make_train_step, wire_fused_into_model, wire_grid)
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


def check_pipeline(job: JobConfig, mesh) -> None:
    """The JAX init_state's checks of a pipelined trunk: the mesh's pipe
    axis, when above 1, must equal `pipeline_stages`, and the batch must
    split into microbatches x the data axis."""
    n_pipe = mesh.axis_size(PIPE_AXIS) if mesh is not None else 1
    if job.model.pipeline_stages > 1 and n_pipe > 1 \
            and n_pipe != job.model.pipeline_stages:
        raise ConfigError(
            f"mesh pipe axis ({n_pipe}) must equal model.pipeline_stages "
            f"({job.model.pipeline_stages})")
    if job.model.pipeline_stages > 1:
        n_micro = n_microbatches(job.model)
        n_data = mesh.axis_size(DATA_AXIS) if mesh is not None else 1
        bs = job.data.batch_size
        if bs % n_micro != 0 or (bs // n_micro) % n_data != 0:
            raise ConfigError(
                f"batch_size ({bs}) must be divisible by pipeline "
                f"microbatches ({n_micro}) x data axis ({n_data}); "
                f"use a multiple of {n_micro * n_data}")


def init_state(job: JobConfig, num_features: int,
               device: DeviceLike = None, mesh=None) -> TrainState:
    """Build the model in training mode and its optimizer.  Weights are
    drawn from a `torch.Generator` seeded with `train.seed` (other numbers
    than the JAX package's init from the same seed).  When int8 features
    reach the model natively its layer 0 carries the wire grid.  Under a
    sparse embedding plan the optimizer leaves the embedding tables out and
    their slots go on `table_slots`.  Every model of the JAX ladder
    trains.  On a mesh every rank draws the full state and keeps its
    blocks by the JAX package's rules (parallel/sharding.sharding_rules),
    the rest replicated; the optimizer and the table slots are built on
    the blocks, so they follow them."""
    job = on_mesh(job, mesh)
    if job.model.model_type not in _TRAINABLE:
        raise KeyError(f"unknown model_type {job.model.model_type!r}; the "
                       "port trains " + ", ".join(_TRAINABLE))
    if num_features != job.schema.feature_count:
        raise ValueError(f"dataset has {num_features} features, the schema "
                         f"selects {job.schema.feature_count}")
    check_pipeline(job, mesh)
    wire = wire_grid(job) if wire_fused_into_model(job) else None
    model = build_model(job.model, job.schema, device,
                        generator=torch.Generator().manual_seed(
                            job.train.seed),
                        wire=wire, train=True, mesh=mesh)
    plan = sparse_embed.resolve_plan(job)
    shardings = {}
    if mesh is not None:
        shardings = place_model(model, mesh,
                                sharding_rules(job, mesh, plan))
    tables = sparse_embed.table_names(model, plan) if plan else []
    dense = [(n, p) for n, p in model.named_parameters() if n not in tables]
    optimizer = Optimizer([p for _, p in dense], job.train.optimizer)
    if shardings:
        optimizer.set_split_groups([shardings[n].groups() if n in shardings
                                    else () for n, _ in dense])
    return TrainState(
        model=model, optimizer=optimizer,
        table_slots=(sparse_embed.init_table_slots(model, plan)
                     if tables else None),
        mesh=mesh, shardings=shardings)


def gathered_model(state: TrainState, job: JobConfig) -> torch.nn.Module:
    """The state's model with whole parameters, for the artifact: the
    model itself, or on a mesh with split leaves a fresh model of the same
    build (no mesh) holding the gathered parameters (a collective: every
    rank calls it).  A world-1 run writes the same artifact."""
    if not state.shardings:
        return state.model
    full = ckpt_lib.full_payload(state)["model"]
    dev = next(state.model.parameters()).device
    model = build_model(job.model, job.schema, dev)
    model.load_state_dict(full)
    return model


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
             score_sink: Optional[Callable[[np.ndarray], None]] = None,
             mesh=None) -> tuple[float, float]:
    """(weighted_error, auc) over the whole dataset: every row counted, the
    last batch padded with zero-weight rows.  A multi-head model is scored
    on head 0 against target column 0, as in the JAX package.  Scores are
    fetched a window of 8 batches behind the launches, so the card is not
    drained after every batch.  `score_sink` gets each batch's head-0
    scores of the rows with nonzero weight (the baseline score sketch).
    On a mesh the batch rounds up to a multiple of its size, each rank
    scores its rows and the scores are gathered over the data group: every
    rank gets the metrics of one device.  Under a pod `ds` is this host's
    shard: every host feeds its rows to the same number of global batches
    (agreed over the mesh; a short host feeds zero-weight rows), and the
    gathered scores give every rank the global metrics."""
    multihost = mesh is not None and mesh_lib.host_shard_info(mesh)[1] > 1
    if ds.num_rows == 0 and not multihost:
        return float("nan"), float("nan")
    bs = batch_size or (max(job.data.batch_size, 4096) if multihost
                        else eval_batch_size(job, ds.num_rows))
    if mesh is not None:
        bs = -(-bs // mesh.size) * mesh.size
    if job.model.pipeline_stages > 1:
        # the pipelined trunk splits every batch into microbatches
        quantum = n_microbatches(job.model) * (mesh.size if mesh else 1)
        bs = -(-bs // quantum) * quantum

    if multihost:
        return _evaluate_pod(state, ds, job, eval_step, device, bs,
                             score_sink, mesh)

    def score(padded: dict) -> torch.Tensor:
        if mesh is None:
            return eval_step(state, to_device(padded, job, device))
        local = eval_step(state, to_device(shard_batch(padded, mesh), job,
                                           device))
        return distributed.all_gather(local, mesh.group(DATA_AXIS), 0)
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
        pend.append((score(padded), int(mask.sum()), batch["target"][:, 0],
                     batch["weight"][:, 0]))
        if len(pend) >= 8:
            fetch(pend.popleft())
    while pend:
        fetch(pend.popleft())
    return sm.weighted_error(), sm.auc()


def _evaluate_pod(state: TrainState, ds: pipe.TabularDataset, job: JobConfig,
                  eval_step, device: torch.device, bs: int, score_sink,
                  mesh) -> tuple[float, float]:
    """`evaluate` under a pod: global batch i is every host's rows [i * bs
    / H, (i + 1) * bs / H) of its shard, zero-weight padded; the step count
    is the largest host's (a MAX over the control group); scores, targets
    and weights are gathered over the data group in global row order."""
    _, n_hosts = mesh_lib.host_shard_info(mesh)
    local_bs = bs // n_hosts
    steps = torch.tensor([-(-ds.num_rows // local_bs)], dtype=torch.int64)
    n_steps = int(distributed.all_reduce(steps, mesh.control, "max")[0])
    if n_steps == 0:
        return float("nan"), float("nan")
    wcast = pipe.wire_cast_fn(job.schema, job.data, job.model.compute_dtype)
    group = mesh.group(DATA_AXIS)
    sm = metrics_lib.StreamingMetrics()
    for i in range(n_steps):
        lo = min(i * local_bs, ds.num_rows)
        hi = min(lo + local_bs, ds.num_rows)
        local, _ = pipe.pad_to_batch(
            {"features": ds.features[lo:hi], "target": ds.target[lo:hi],
             "weight": ds.weight[lo:hi]}, local_bs)
        mine = shard_batch_process_local(local, mesh)
        tw = torch.from_numpy(np.stack(
            [mine["target"][:, 0], mine["weight"][:, 0]], axis=1)
            .astype(np.float32)).to(device)
        if wcast is not None:
            mine = wcast(mine)
        s = eval_step(state, to_device(mine, job, device))[:, :1]
        out = distributed.all_gather(torch.cat([s.float(), tw], 1), group,
                                     0).cpu().numpy()
        scores, tgt, wgt = out[:, 0], out[:, 1], out[:, 2]
        sm.update(scores, tgt, wgt)
        if score_sink is not None:
            score_sink(scores[wgt > 0])
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


def restore_latest_any_layout(manager, state: TrainState, job: JobConfig,
                              console: Console):
    """`checkpoint.restore_latest` with the FT trunk-layout fallback:
    (state, extra, step), or None when there is no checkpoint.  A
    checkpoint that does not fit `state` is tried in the other trunk
    layout (per-block or stacked); the original error re-raises when it
    fits neither.  The train loop's resume and the export command's
    recovery path share it."""
    try:
        return ckpt_lib.restore_latest(manager, state, with_extra=True)
    except Exception:
        restored = _restore_across_trunk_layout(manager, state, job, console)
        if restored is None:
            raise
        return restored


def _restore_across_trunk_layout(manager, state: TrainState, job: JobConfig,
                                 console: Console):
    """Resume an FT-Transformer from a checkpoint of the OTHER trunk layout
    (per-block or stacked: `pipeline_stages` is a layout, not part of the
    model).  The weights convert exactly (models/ft_transformer.
    canonicalize_params / stack_block_params); the optimizer slots
    restart, which the console says.  (state, extra, step) or None."""
    if job.model.model_type != "ft_transformer":
        return None
    from ..models import ft_transformer as ftt

    cur = job.model
    if cur.pipeline_stages > 1:
        alt = dataclasses.replace(cur, pipeline_stages=1,
                                  pipeline_microbatches=0)
        convert = ftt.stack_block_params
    else:
        stages = next((s for s in range(2, cur.num_layers + 1)
                       if cur.num_layers % s == 0), 1)
        if stages == 1:
            return None  # one layer: only one layout exists
        alt = dataclasses.replace(cur, pipeline_stages=stages,
                                  pipeline_microbatches=0)
        convert = ftt.canonicalize_params
    try:
        alt_job = job.replace(model=alt, data=dataclasses.replace(
            job.data, batch_size=job.data.batch_size * alt.pipeline_stages))
        template = init_state(alt_job, job.schema.feature_count, "cpu")
        restored = ckpt_lib.restore_latest(manager, template,
                                           with_extra=True)
    except Exception:  # noqa: BLE001 - not the other layout either
        return None
    if restored is None:
        return None
    alt_state, extra, step = restored
    full = convert(dict(alt_state.model.state_dict()), cur)
    own = dict(state.model.named_parameters())
    with torch.no_grad():
        for name, t in full.items():
            sh = state.shardings.get(name)
            own[name].copy_(sh.local(t) if sh is not None else t)
    state.step = alt_state.step
    direction = ("stacked -> per-block" if cur.pipeline_stages == 1
                 else "per-block -> stacked")
    console(f"Resuming across a trunk-layout change ({direction}): weights "
            "converted exactly, optimizer slots reinitialized")
    return state, extra, step


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
    restored = restore_latest_any_layout(manager, state, job, console)
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
          device: DeviceLike = None, mesh=None) -> TrainResult:
    """Run the training job on `device` (default `cuda:0`; the CPU only
    when asked); returns the final state and the per-epoch history.
    Datasets may be passed in, else they are loaded (or the first epoch
    streamed) from job.data.paths.  SIGTERM (main thread only) saves at
    the next chunk boundary and raises SystemExit(75).  With `mesh` this
    rank trains its part of the mesh's run (module docstring); the
    returned state holds its blocks."""
    job = on_mesh(job.validate(), mesh)
    chief = mesh is None or mesh.rank == 0
    console = console or (lambda s: print(s, flush=True))
    if not chief:
        console = lambda s: None  # noqa: E731 - the chief speaks for all
    dev = resolve_device(device)
    # init_state and the make_*_step functions take the mesh only when
    # there is one (a caller may wrap them with the one-device signature)
    on = {} if mesh is None else {"mesh": mesh}
    # a pod: each host holds its own file shard, and each rank is fed only
    # its rows (module docstring)
    host, nhosts = (mesh_lib.host_shard_info(mesh) if mesh is not None
                    else (0, 1))
    multihost = nhosts > 1
    step_on = dict(on, process_local=True) if multihost else on
    control = mesh.control if mesh is not None else None

    def agree_min(*vals: int) -> list[int]:
        """The smallest of each value over the ranks (itself alone)."""
        if control is None:
            return [int(v) for v in vals]
        t = torch.tensor([int(v) for v in vals], dtype=torch.int64)
        return [int(v) for v in
                distributed.all_reduce(t, control, "min").tolist()]
    # the JAX loop's refusal: it takes the resident or the staged tier
    # exactly when data.staged and data.drop_remainder are both set
    if job.train.local_sgd_window > 0 and not (job.data.staged
                                               and job.data.drop_remainder):
        raise ValueError(
            "local_sgd_window (SAGN mode) needs the staged or "
            "device-resident input tier: set data.staged=True and "
            "data.drop_remainder=True (local replicas are synchronized "
            "by epoch scans, not per-batch dispatches)")
    # a bare SHIFU_TPU_METRICS_DIR is enough for a library caller; the
    # other ranks journal nothing
    if chief:
        obs.configure_from_env()
    obs.event("train_start", model=job.model.model_type,
              epochs=job.train.epochs, batch_size=job.data.batch_size,
              processes=distributed.process_count() if mesh else 1,
              devices=mesh.size if mesh else 1)
    cdt = job.model.compute_dtype
    wmode = pipe.wire_mode(job.schema, job.data, cdt)
    # the streamed epoch's cast detects the compact target/weight per
    # block (content-driven, so a resume replays identical formats); a
    # pod's hosts keep the wide wire, as the JAX package's do
    wcast_stream = pipe.wire_cast_fn(job.schema, job.data, cdt,
                                     compact=not multihost)
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
        if want_stream:
            cache_hot = pipe.projected_cache_complete(
                job.schema, job.data, feature_dtype, host_index=host,
                num_hosts=nhosts)
            if multihost:
                # streaming or loading is collective: every host agrees
                (cache_hot,) = agree_min(cache_hot)
            if cache_hot:
                # a hot cache loads at np.load speed: no parse left to
                # hide, and the loaded tiers beat training in file order
                console("Projected cache is hot for every input file: "
                        "skipping the streamed first epoch")
                want_stream = False
        if want_stream:
            stream_loader = pipe.StreamingLoader(
                job.schema, job.data, feature_dtype, host_index=host,
                num_hosts=nhosts)
        else:
            # blocking ingest (hot cache, loaded tiers, out of core),
            # charged to the first epoch's input bucket below
            t_ingest = time.perf_counter()
            train_ds, valid_ds = pipe.load_datasets(
                job.schema, job.data, host, nhosts,
                feature_dtype=feature_dtype)
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
    state = init_state(job, num_features, dev, **on)
    manager, start_epoch = _resume(job, state, console)

    # streaming serves only the first epoch of a fresh run: a resumed
    # epoch must replay the shuffled epoch an unbroken run trains
    if stream_loader is not None and start_epoch > 0:
        train_ds, valid_ds = stream_loader.datasets()
        stream_loader = None

    local_sgd = job.train.local_sgd_window > 0
    k_win = max(job.train.local_sgd_window, 1)
    epoch_scan_step = (make_local_sgd_epoch_step(job, mesh,
                                                 process_local=multihost)
                       if local_sgd else make_epoch_scan_step(job, **step_on))
    # chunks of ~32 MB of wire bytes, so a copy stays short and overlaps
    # compute; by bytes, not rows (the int8 wire carries 4x the rows).
    # Local SGD keeps them a multiple of its window, so that no window is
    # cut by a chunk's closing average
    row_wire_b = pipe.wire_row_bytes(job.schema, job.data, cdt)
    chunk_cap = max(1, (32 << 20) // max(job.data.batch_size * row_wire_b, 1))
    block_batches = -(-job.data.block_batches // k_win) * k_win
    if local_sgd:
        chunk_cap = max(k_win, (chunk_cap // k_win) * k_win)
    staged_block_batches = max(1, min(block_batches, chunk_cap))
    put, ready = make_placer(job, dev)

    # tier plumbing, resolved by _prepare_tiers once train_ds exists; under
    # a pod every sizing below derives from numbers the hosts agreed on
    min_host_rows = 0
    local_bs = job.data.batch_size
    steps_per_epoch = None
    host_input_times: list[float] = []
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

    def _timed(items):
        """`items`, each pull's host seconds recorded (the pod's straggler
        line reads them)."""
        it = iter(items)
        while True:
            t_in = time.perf_counter()
            try:
                b = next(it)
            except StopIteration:
                return
            host_input_times.append(time.perf_counter() - t_in)
            yield b

    def staged_source(ep: int) -> pipe.TabularDataset:
        """This host's rows for one staged epoch: under a pod exactly
        min_host_rows (agreed block counts), a host with more drawing an
        epoch-seeded subset, so that its tail rows still train."""
        if not multihost or train_ds.num_rows <= min_host_rows:
            return train_ds
        if job.data.shuffle:
            rng = np.random.default_rng(
                np.random.PCG64(job.data.shuffle_seed * 9176 + ep))
            keep = np.sort(rng.permutation(train_ds.num_rows)[:min_host_rows])
        else:
            keep = np.arange(min_host_rows)
        return train_ds.take(keep)

    def _staged_host_blocks(ep: int):
        """The staged epoch's blocks, wire-cast on the producing thread
        (under a pod, this rank's rows of its host's blocks)."""
        for b in pipe.staged_epoch_blocks(
                staged_source(ep), local_bs, shuffle=job.data.shuffle,
                seed=job.data.shuffle_seed, epoch=ep,
                block_batches=staged_block_batches):
            b = wcast(b) if wcast is not None else b
            yield shard_blocks_process_local(b, mesh) if multihost else b

    def _perbatch_host_batches(ep: int):
        """The epoch's batches, deduped and wire-cast on the producing
        thread (the feeder's assembly thread when the overlap is on);
        under a pod the agreed number of this rank's rows."""
        hb = pipe.batch_iterator(
            train_ds, local_bs, shuffle=job.data.shuffle,
            seed=job.data.shuffle_seed, epoch=ep,
            drop_remainder=job.data.drop_remainder or multihost)
        if multihost:
            hb = itertools.islice(hb, steps_per_epoch)
        for b in hb:
            b = bcast(b) if bcast is not None else b
            yield shard_batch_process_local(b, mesh) if multihost else b

    def _prepare_tiers():
        nonlocal bs, use_resident, use_staged, resident_blocks, \
            device_epoch_step, train_step, wcast, bcast, dedup, prepared, \
            min_host_rows, local_bs, steps_per_epoch
        prepared = True
        # compact target/weight wire, decided once over the whole partition
        # (under a pod, over every host's shard)
        label_ok = (job.data.wire_label_dtype in ("auto", "uint8")
                    and pipe.target_u8_exact(train_ds.target))
        weight_ok = (job.data.wire_weight_mode in ("auto", "elide")
                     and pipe.weight_all_ones(train_ds.weight))
        min_host_rows, label_ok, weight_ok = agree_min(
            train_ds.num_rows, label_ok, weight_ok)
        if job.data.wire_label_dtype == "uint8" and not label_ok:
            raise ValueError("wire_label_dtype=uint8 but targets are not "
                             "integers in [0, 255] — use "
                             "wire_label_dtype=auto or float32")
        if job.data.wire_weight_mode == "elide" and not weight_ok:
            raise ValueError("wire_weight_mode=elide but weights are not "
                             "all 1.0 — use wire_weight_mode=auto or "
                             "float32")
        wcast = pipe.wire_cast_fn(job.schema, job.data, cdt,
                                  compact=(bool(label_ok), bool(weight_ok)))
        if min_host_rows == 0:
            raise ValueError("a training data shard has 0 rows — nothing "
                             "to train on" if multihost else
                             "training dataset has 0 rows — nothing to "
                             "train on")
        bs = job.data.batch_size
        quantum = mesh.size if mesh is not None else 1
        capacity = min_host_rows * nhosts  # rows every host can cover
        if bs > capacity and job.data.drop_remainder:
            bs = max((capacity // quantum) * quantum, quantum)
            console(f"batch_size {job.data.batch_size} > {capacity} "
                    f"usable rows; clamped to {bs}")
        # each rank trains an equal share of every global batch
        bs = -(-bs // quantum) * quantum
        local_bs = bs // nhosts
        steps_per_epoch = None
        if multihost:
            steps_per_epoch = min_host_rows // local_bs
            if steps_per_epoch == 0:
                raise ValueError(
                    f"a host has < {local_bs} rows (global batch {bs} / "
                    f"{nhosts} hosts) — lower the batch size or rebalance "
                    "file shards")
        # the tier rule: bytes of the partition in its in-card format
        # against the resident budget
        rfmt = pipe.resident_feature_format(job.schema, job.data, cdt)
        n = min_host_rows
        feat_row_bytes = train_ds.features.nbytes // max(train_ds.num_rows, 1)
        if train_ds.features.dtype == np.float32:
            if rfmt == "int8":
                feat_row_bytes //= 4
            elif rfmt == "bfloat16":
                feat_row_bytes //= 2
        elif train_ds.features.dtype == np.uint16 and rfmt == "int8":
            feat_row_bytes //= 2
        tgt_row_bytes = train_ds.target.nbytes // max(train_ds.num_rows, 1)
        if label_ok:
            tgt_row_bytes //= 4
        wgt_row_bytes = (0 if weight_ok else train_ds.weight.nbytes
                         // max(train_ds.num_rows, 1))
        ds_bytes = (feat_row_bytes + tgt_row_bytes + wgt_row_bytes) * n
        use_resident = (job.data.staged and job.data.drop_remainder
                        and 0 < ds_bytes <= job.data.device_resident_bytes
                        and n // local_bs > 0)
        use_staged = (job.data.staged and job.data.drop_remainder
                      and not use_resident)
        if use_resident:
            nb_total = n // local_bs
            host_blocks = _stack_blocks(train_ds, nb_total, local_bs)
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
            if multihost:
                host_blocks = shard_blocks_process_local(host_blocks, mesh)
            resident_blocks = to_device(host_blocks, job, dev)
            device_epoch_step = (
                make_local_sgd_epoch_step(job, mesh, with_order=True,
                                          process_local=multihost)
                if local_sgd else make_device_epoch_step(job, **step_on))
        elif not use_staged:
            train_step = make_train_step(job, **step_on)
            # the dedup's unique ids are a global batch's: a pod's hosts
            # each see only theirs, so there the update extracts the ids
            plan = (sparse_embed.resolve_plan(job)
                    if job.embed.dedup != "off" and not multihost else None)
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
    # the epoch-boundary watermarks (the chief's)
    devprof = obs.devprof.DeviceProfiler(
        job.obs if chief else dataclasses.replace(job.obs,
                                                  trace_epochs="off"),
        start_epoch=start_epoch, state_bytes=state_bytes)
    timing_on = (bool(os.environ.get("SHIFU_TPU_TIMING"))
                 or job.train.log_every_steps > 0)

    # preemption: on SIGTERM, save at the next chunk boundary and exit 75.
    # The handler only sets a flag; signal.signal raises off the main
    # thread, and then no handler is installed, as in the JAX loop
    # A pod rank does not catch SIGTERM, as the JAX package's multi-host
    # ranks do not: a host draining while its peers run collectives
    # would deadlock the step; the gang's teardown is immediate and the
    # checkpoint cadence keeps the progress (launcher/pod.py)
    term_flag = {"hit": False}
    old_term = None
    if not multihost:
        try:
            old_term = signal.signal(signal.SIGTERM,
                                     lambda *_: term_flag.update(hit=True))
        except ValueError:
            pass  # not the main thread

    save_secs = job.runtime.checkpoint.save_every_seconds
    last_save = time.monotonic()

    def agree(*flags: bool) -> list[bool]:
        """Each flag set on any rank, on every rank (one gloo all-reduce
        over the mesh; the flags themselves alone)."""
        if control is None:
            return list(flags)
        t = torch.tensor([int(f) for f in flags], dtype=torch.int32)
        distributed.all_reduce(t, control, "max")
        return [bool(v) for v in t.tolist()]

    def save_state(step: int, extra: dict, block: bool) -> None:
        """Save through the chief: sharded blocks are gathered first, on
        every rank (a collective), so the checkpoint holds full tensors."""
        payload = ckpt_lib.full_payload(state)
        if chief:
            ckpt_lib.save(manager, step, state, extra=extra, block=block,
                          payload=payload)

    def maybe_midtrain_save(epoch: int) -> None:
        """A chunk-boundary save point: the time cadence and the SIGTERM
        drain.  A mid-epoch save records the current epoch, so a resume
        replays that epoch from its start.  On a mesh the ranks agree:
        any rank's SIGTERM drains them all, the chief's clock times the
        cadence.  A pod has no mid-epoch save point, as in the JAX
        package: its epochs end on the epoch boundary's save."""
        nonlocal last_save
        if multihost:
            return
        # chaos site "train.chunk": dying between a chunk's compute and
        # its save
        chaos.maybe_fail("train.chunk", echo=console, epoch=epoch)
        due = (chief and manager is not None and save_secs > 0
               and time.monotonic() - last_save >= save_secs)
        term, due = agree(term_flag["hit"], due)
        if not (term or due):
            return
        cur = int(state.step)
        # `<`: a collision-bumped key can sit above the raw step, and that
        # still means this step's state is durable
        (fresh,) = agree(chief and manager is not None
                         and (ckpt_lib.latest_step(manager) or -1) < cur)
        if fresh:
            save_state(cur, {"epoch": epoch}, True)
        if term:
            if manager is not None:
                ckpt_lib.finalize(manager)
                obs.event("preemption_grace", epoch=int(epoch), step=cur,
                          saved=fresh)
                obs.flush()
                console("SIGTERM: checkpoint saved, exiting for restart")
            else:
                console("SIGTERM: exiting (no checkpoint directory)")
            raise SystemExit(PREEMPTED_EXIT)
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

    def _stream_pod_rounds(loader, local_stream_bs: int) -> tuple:
        """The pod's streamed first epoch, in rounds: each host pulls one
        block of its own shard (blocking, so "none" means its stream
        ended) and the hosts agree (a MIN over the control group) that all
        have one; the first dry host ends the epoch for all.  No tail
        padding: a partial block's rows train in the later epochs.  The
        pull and the placement run one round ahead, on the producer
        thread."""
        nonlocal state
        end = object()
        it = pipe.prefetch_to_device(
            (shard_blocks_process_local(
                wcast_stream(b) if wcast_stream is not None else b, mesh)
             for b in loader.first_epoch_blocks(
                 local_stream_bs, staged_block_batches, pad_tail=False)),
            put, size=1)
        acc, n = None, 0
        while True:
            t_in = time.perf_counter()
            pending = next(it, end)
            host_input_times.append(time.perf_counter() - t_in)
            (have,) = agree_min(pending is not end)
            if not have:
                # a peer ran dry: stop the producer before the loader is
                # touched again
                loader.abort_blocks()
                for _ in it:
                    pass
                return acc, n
            timer.mark_input_ready()
            xs = ready(pending)
            state, loss = epoch_scan_step(state, xs)
            acc = loss if acc is None else acc + loss
            n += block_batches(xs)
            timer.mark_step_done()

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
            if multihost:
                # the epoch's shard view (chaos site `data.host_shard`, with
                # the epoch): the hosts agree that they list the same files
                pipe.host_file_shard(job.data, host, nhosts, epoch=epoch)
                n_files = pipe.count_source_files(job.data)
                least, most = agree_min(n_files, -n_files)
                if least != -most:
                    raise ValueError(
                        f"epoch {epoch}: the hosts list between {least} and "
                        f"{-most} source files; every host must see the "
                        "same files")
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
            host_input_times.clear()
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
                    if mesh is not None:
                        stream_bs = -(-stream_bs // mesh.size) * mesh.size
                    console(f"Streaming first epoch: training overlaps the "
                            f"background parse (batch {stream_bs}, "
                            f"{staged_block_batches} batches/chunk)")
                    if multihost:
                        loss_acc, loss_n = _stream_pod_rounds(
                            stream_loader, stream_bs // nhosts)
                    else:
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
                        # the denominator: batches holding at least one
                        # real row (pad-only batches add zero loss)
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
                        src = source(epoch)
                        items = pipe.prefetch_to_device(
                            _timed(src) if multihost else src, put,
                            size=job.data.prefetch)
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
                        score_sink=score_sketch.update, **on)
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
            digest_rows = 0
            if train_ds is not None:
                digest_rows = (min_host_rows
                               if multihost and tier in ("staged", "resident")
                               else train_ds.num_rows)
            order_digest = pipe.epoch_order_digest(
                tier, digest_rows, local_bs, shuffle=job.data.shuffle,
                seed=job.data.shuffle_seed, epoch=epoch)
            if multihost:
                # the slowest-first per-host line on the chief, and its
                # host_skew row: each host's input seconds (the producer's
                # when one timed it), cumulative source ingest, and the
                # digests whose agreement pod-verify audits
                if feeder is not None:
                    input_s = feeder.production_seconds(epoch)
                elif host_input_times:
                    input_s = sum(host_input_times)
                else:
                    input_s = sum(timer.input_times)
                reg = obs.default_registry()
                try:
                    shard_digest = pipe.shard_assignment_digest(
                        pipe.count_source_files(job.data), nhosts,
                        seed=job.data.shuffle_seed, epoch=epoch,
                        mode=job.data.host_shard)
                except OSError:
                    shard_digest = None  # the sources went away mid-run
                prof_lib.straggler_line(
                    epoch, epoch_time, valid_time, input_s, console,
                    extra={
                        "ingest_bytes": int(reg.counter(
                            "ingest_source_bytes_total").total()),
                        "ingest_s": round(reg.counter(
                            "ingest_seconds_total").total(), 3),
                        "order_digest": order_digest,
                        "shard_digest": shard_digest,
                    }, group=control)

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
                save_state(int(state.step), extra,
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
                      else sum(host_input_times) if host_input_times
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
            if multihost:
                # the input placement ledger: each host's rows go to its
                # own ranks, so no input byte crosses between hosts; a
                # replicated input plane would ship (hosts - 1) x the
                # local bytes.  Local SGD skips the per-step syncs
                topo = mesh_lib.dcn_topology(mesh)
                local_input_b = int(digest_rows) * int(row_wire_b)
                spe = int(steps_per_epoch or 0)
                k_now = int(job.train.local_sgd_window)
                sync_rounds = spe // k_now if k_now > 0 else spe
                sync_skipped = max(spe - sync_rounds, 0) if k_now > 0 else 0
                param_b = sum(t.numel() * t.element_size()
                              for t in state.model.parameters())
                obs.event("dcn_placement", epoch=epoch, tier=tier,
                          hosts=topo["processes"], slices=topo["slices"],
                          local_devices=topo["local_devices"],
                          input_local_bytes=local_input_b,
                          input_dcn_bytes=0,
                          input_dcn_saved_bytes=(
                              (topo["processes"] - 1) * local_input_b),
                          local_sgd_window=k_now,
                          sync_rounds=sync_rounds,
                          sync_rounds_skipped=sync_skipped,
                          dcn_sync_saved_bytes=sync_skipped * param_b,
                          ranks=topo["ranks"], backend=topo["backend"])
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
        if dedup is not None:
            # the tail embed_dedup_report, however the loop exits
            dedup.finalize()
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
