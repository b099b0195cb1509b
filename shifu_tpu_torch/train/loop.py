"""The training loop on one device (port of the single-host path of
shifu_tpu/train/loop.py).

`train(job, ...)` loads the datasets (or takes them), builds the model and
optimizer, and runs the epochs on one of two input tiers, chosen by the
JAX package's rule: the device-resident tier when the training partition,
in its in-card format (int8 features on the wire grid, u8 targets, the
weight column elided when all ones), fits `data.device_resident_bytes`;
otherwise the per-batch tier, which casts each batch on the host and copies
it to the card.  Under a sparse embedding plan (train/sparse_embed.py) the
per-batch tier compacts each batch's ids first (embed/dedup, unless
`embed.dedup` is "off"); the resident tier updates from the raw ids, as in
the JAX package.  Every epoch ends with a full evaluation of the valid set
(zero-weight tail padding) every `eval_every_epochs`, the console line of
`EpochMetrics`, and the early-stopping bookkeeping.

Differences from the JAX package, kept on purpose until later slices
(ROADMAP.md): a job that loads its files loads them first, where the JAX
package would stream its first epoch (`stream_first_epoch`) unless its
cache is hot; where the JAX package would run the staged tier, the port
runs the per-batch tier (same batches per epoch, other order); there is
no checkpoint (a configured checkpoint directory raises), no telemetry, no
overlap feeder, no chaos sites and no preemption handling.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..config.schema import JobConfig
from ..data import pipeline as pipe
from ..device import DeviceLike, resolve_device
from ..embed.dedup import attach_dedup
from ..models.registry import build_model
from ..ops import metrics as metrics_lib
from . import sparse_embed
from .optimizers import Optimizer
from .step import (make_device_epoch_step, make_eval_step, make_train_step,
                   wire_fused_into_model, wire_grid)
from .train_state import TrainState

Console = Callable[[str], None]

_TRAINABLE = ("mlp", "ft_transformer", "wide_deep", "deepfm")


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
    # input tier that trained the epochs: "resident" or "batch"
    tier: str = ""
    # the per-batch dedup's counts (embed/dedup `dedup_state`: batches,
    # unique rows, raw id cells), or None when no batch was compacted
    dedup: Optional[dict] = None


def init_state(job: JobConfig, num_features: int,
               device: DeviceLike = None) -> TrainState:
    """Build the model in training mode and its optimizer.  Weights are
    drawn from a `torch.Generator` seeded with `train.seed` (other numbers
    than the JAX package's init from the same seed).  When int8 features
    reach the model natively its layer 0 carries the wire grid.  Under a
    sparse embedding plan the optimizer leaves the embedding tables out and
    their slots go on `table_slots`.  The MLP, the FT-Transformer,
    Wide&Deep and DeepFM train; multitask and moe_mlp wait for a later
    slice (ROADMAP.md queue A item (e))."""
    if job.model.model_type not in _TRAINABLE:
        raise NotImplementedError(
            f"training model_type {job.model.model_type!r} is not ported "
            "yet (ROADMAP.md queue A item (e)); the port trains "
            + ", ".join(_TRAINABLE))
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


def to_device(batch: dict[str, np.ndarray], job: JobConfig,
              device: torch.device) -> dict[str, torch.Tensor]:
    """Host arrays -> tensors on `device`.  A bfloat16 wire casts the f32
    features on the card (numpy has no bfloat16; round to nearest even, as
    the JAX package's host cast)."""
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
           for k, v in batch.items()}
    f = out.get("features")
    if (f is not None and f.dtype == torch.float32
            and pipe.wire_mode(job.schema, job.data,
                               job.model.compute_dtype) == "bfloat16"):
        out["features"] = f.to(torch.bfloat16)
    return out


def eval_batch_size(job: JobConfig, num_rows: int) -> int:
    """Rows per eval batch: max(batch_size, 4096), but for a valid set
    smaller than that the set rounded up to a multiple of 4096."""
    bs = max(job.data.batch_size, 4096)
    if num_rows < bs:
        bs = max(-(-num_rows // 4096) * 4096, 4096)
    return bs


def evaluate(state: TrainState, ds: pipe.TabularDataset, job: JobConfig,
             eval_step, device: torch.device,
             batch_size: Optional[int] = None) -> tuple[float, float]:
    """(weighted_error, auc) over the whole dataset: every row counted, the
    last batch padded with zero-weight rows.  Scores are fetched a window
    of 8 batches behind the launches, so the card is not drained after
    every batch."""
    if ds.num_rows == 0:
        return float("nan"), float("nan")
    bs = batch_size or eval_batch_size(job, ds.num_rows)
    wcast = pipe.wire_cast_fn(job.schema, job.data, job.model.compute_dtype)
    sm = metrics_lib.StreamingMetrics()
    pend: deque = deque()

    def fetch(entry) -> None:
        s, n, tgt, wgt = entry
        sm.update(s.cpu().numpy()[:n, 0], tgt, wgt)

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


def _stack_blocks(ds: pipe.TabularDataset, nb: int, bs: int) -> dict:
    def stack(arr):
        return arr[:nb * bs].reshape(nb, bs, *arr.shape[1:])
    return {"features": stack(ds.features), "target": stack(ds.target),
            "weight": stack(ds.weight)}


def train(job: JobConfig,
          train_ds: Optional[pipe.TabularDataset] = None,
          valid_ds: Optional[pipe.TabularDataset] = None,
          console: Optional[Console] = None,
          epoch_callback: Optional[Callable[[EpochMetrics], None]] = None,
          device: DeviceLike = None) -> TrainResult:
    """Run the training job on `device` (default `cuda:0`; the CPU only
    when asked); returns the final state and the per-epoch history.
    Datasets may be passed in, else they are loaded from job.data.paths."""
    job = job.validate()
    console = console or (lambda s: print(s, flush=True))
    dev = resolve_device(device)
    if job.runtime.checkpoint.directory:
        raise NotImplementedError(
            "runtime.checkpoint.directory is set, but the port has no "
            "checkpoint yet (train/checkpoint.py: ROADMAP.md queue A, the "
            "first item); unset it to train without one")
    # the JAX loop's refusal: it takes the resident or the staged tier
    # exactly when data.staged and data.drop_remainder are both set (where
    # it would stage, the port runs the per-batch tier and trains)
    if job.train.local_sgd_window > 0 and not (job.data.staged
                                               and job.data.drop_remainder):
        raise ValueError(
            "local_sgd_window (SAGN mode) needs the staged or "
            "device-resident input tier: set data.staged=True and "
            "data.drop_remainder=True (local replicas are synchronized "
            "by epoch scans, not per-batch dispatches)")
    cdt = job.model.compute_dtype
    wmode = pipe.wire_mode(job.schema, job.data, cdt)
    if train_ds is None:
        feature_dtype = (f"int8c{job.data.wire_int8_clip:g}"
                         if wmode == "int8" else "float32")
        train_ds, valid_ds = pipe.load_datasets(job.schema, job.data,
                                                feature_dtype=feature_dtype)
    if valid_ds is None:
        raise ValueError("train() needs valid_ds when train_ds is given")

    rate = job.train.bagging_sample_rate
    if 0.0 < rate < 1.0 and train_ds.num_rows > 0:
        from ..data.split import bagging_mask
        keep = np.nonzero(bagging_mask(
            np.arange(train_ds.num_rows, dtype=np.uint64),
            rate, seed=job.train.seed))[0]
        console(f"Bagging: {len(keep)}/{train_ds.num_rows} train rows "
                f"(baggingSampleRate={rate:g})")
        train_ds = train_ds.take(keep)

    state = init_state(job, train_ds.num_features or job.schema.feature_count,
                       dev)

    # compact target/weight wire, decided once over the whole partition
    label_ok = (job.data.wire_label_dtype in ("auto", "uint8")
                and pipe.target_u8_exact(train_ds.target))
    weight_ok = (job.data.wire_weight_mode in ("auto", "elide")
                 and pipe.weight_all_ones(train_ds.weight))
    if job.data.wire_label_dtype == "uint8" and not label_ok:
        raise ValueError("wire_label_dtype=uint8 but targets are not "
                         "integers in [0, 255] — use wire_label_dtype=auto "
                         "or float32")
    if job.data.wire_weight_mode == "elide" and not weight_ok:
        raise ValueError("wire_weight_mode=elide but weights are not all "
                         "1.0 — use wire_weight_mode=auto or float32")
    wcast = pipe.wire_cast_fn(job.schema, job.data, cdt,
                              compact=(label_ok, weight_ok))
    dedup = None
    if train_ds.num_rows == 0:
        raise ValueError("training dataset has 0 rows — nothing to train on")
    bs = job.data.batch_size
    if bs > train_ds.num_rows and job.data.drop_remainder:
        bs = train_ds.num_rows
        console(f"batch_size {job.data.batch_size} > {train_ds.num_rows} "
                f"usable rows; clamped to {bs}")

    # tier rule of the JAX loop: bytes of the partition in its in-card
    # format against the resident budget
    rfmt = pipe.resident_feature_format(job.schema, job.data, cdt)
    feat_row_bytes = train_ds.features.nbytes // max(train_ds.num_rows, 1)
    if train_ds.features.dtype == np.float32:
        if rfmt == "int8":
            feat_row_bytes //= 4
        elif rfmt == "bfloat16":
            feat_row_bytes //= 2
    tgt_row_bytes = train_ds.target.nbytes // max(train_ds.num_rows, 1)
    if label_ok:
        tgt_row_bytes //= 4
    wgt_row_bytes = (0 if weight_ok else
                     train_ds.weight.nbytes // max(train_ds.num_rows, 1))
    ds_bytes = (feat_row_bytes + tgt_row_bytes + wgt_row_bytes) \
        * train_ds.num_rows
    use_resident = (job.data.staged and job.data.drop_remainder
                    and 0 < ds_bytes <= job.data.device_resident_bytes
                    and train_ds.num_rows // bs > 0)
    resident_blocks = None
    if use_resident:
        nb_total = train_ds.num_rows // bs
        host_blocks = _stack_blocks(train_ds, nb_total, bs)
        raw_features = host_blocks["features"]
        if wcast is not None:
            host_blocks = wcast(host_blocks)
        if rfmt == "int8" and host_blocks["features"].dtype != np.int8:
            # forced int8 residency under a wider wire: quantize the raw
            # features once on the same static grid
            scale, offset = pipe.wire_params(job.schema, job.data)
            host_blocks = dict(host_blocks)
            host_blocks["features"] = pipe.wire_quantize(raw_features, scale,
                                                         offset)
        resident_blocks = to_device(host_blocks, job, dev)
        device_epoch_step = make_device_epoch_step(job)
    else:
        train_step = make_train_step(job)
        plan = (sparse_embed.resolve_plan(job)
                if job.embed.dedup != "off" else None)
        if plan is not None:
            # dedup reads the f32 features, so it runs before the wire cast
            dedup = attach_dedup(plan.layout, plan.max_vocab)
            bcast = (dedup if wcast is None
                     else (lambda b, _c=wcast: _c(dedup(b))))
        else:
            bcast = wcast
    eval_step = make_eval_step(job)

    history: list[EpochMetrics] = []
    best_valid = float("inf")
    evals_since_best = 0
    best_params: Optional[dict[str, Any]] = None
    for epoch in range(job.train.epochs):
        t0 = time.perf_counter()
        if use_resident:
            order = pipe.epoch_permutation(
                nb_total, shuffle=job.data.shuffle,
                seed=job.data.shuffle_seed, epoch=epoch)
            state, loss_acc = device_epoch_step(state, resident_blocks, order)
            loss_n = nb_total
        else:
            loss_acc, loss_n = None, 0
            for batch in pipe.batch_iterator(
                    train_ds, bs, shuffle=job.data.shuffle,
                    seed=job.data.shuffle_seed, epoch=epoch,
                    drop_remainder=job.data.drop_remainder):
                if bcast is not None:
                    batch = bcast(batch)
                state, m = train_step(state, to_device(batch, job, dev))
                loss_acc = m["loss"] if loss_acc is None \
                    else loss_acc + m["loss"]
                loss_n += 1
        if loss_n == 0:
            raise ValueError(
                f"epoch {epoch} produced 0 batches ({train_ds.num_rows} "
                f"rows, batch_size {bs}, drop_remainder="
                f"{job.data.drop_remainder})")
        loss_sum = float(loss_acc)  # the epoch's one wait on the card
        epoch_time = time.perf_counter() - t0

        tv0 = time.perf_counter()
        if (epoch % job.train.eval_every_epochs == 0
                or epoch == job.train.epochs - 1):
            valid_error, valid_auc = evaluate(state, valid_ds, job,
                                              eval_step, dev)
        else:
            valid_error, valid_auc = float("nan"), float("nan")
        valid_time = time.perf_counter() - tv0

        m = EpochMetrics(epoch=epoch, train_error=loss_sum / max(loss_n, 1),
                         valid_error=valid_error, valid_auc=valid_auc,
                         epoch_time=epoch_time, valid_time=valid_time)
        history.append(m)
        console(m.console_line(job.train.epochs))

        # early stopping: the best-measured params are kept on the host
        # and restored at the end, so the returned model is the best one
        patience = job.train.early_stop_patience
        early_stop_now = False
        if patience > 0 and valid_error == valid_error:  # evaluated
            if valid_error < best_valid - job.train.early_stop_min_delta:
                best_valid = valid_error
                evals_since_best = 0
                best_params = {k: v.detach().cpu().clone() for k, v in
                               state.model.state_dict().items()}
            else:
                evals_since_best += 1
                if evals_since_best >= patience:
                    early_stop_now = True
                    console(f"Early stop at epoch {epoch}: no valid_error "
                            f"improvement > {job.train.early_stop_min_delta:g} "
                            f"in {patience} evaluated epochs "
                            f"(best {best_valid:.6f})")
        terminal = early_stop_now or epoch == job.train.epochs - 1
        if terminal and best_params is not None:
            state.model.load_state_dict(best_params)
        if epoch_callback is not None:
            epoch_callback(m)
        if early_stop_now:
            break
    return TrainResult(state=state, history=history, job=job,
                       tier="resident" if use_resident else "batch",
                       dedup=dict(dedup.dedup_state) if dedup else None)
