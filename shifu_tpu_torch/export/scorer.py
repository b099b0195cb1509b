"""Scoring engines (port of shifu_tpu/export/scorer.py): the `BatchScorer`
seam the serving daemon wraps, the port's `TorchScorer` (the `JaxScorer`
role: the model rebuilt from the artifact, scoring on the card or, when
asked, the CPU), `ExportScorer` (the `StableHloScorer` role: the
artifact's `scoring.pt2`, no model classes needed), the numpy `Scorer`,
which interprets the artifact's op-list program (export/program.py) on the
host with no torch at score time, and `load_scorer`, the `auto` order.
The native C++ engine is runtime/native_scorer.py, the AOT pack
export/aot.py.

Every engine reports one telemetry write per scored batch
(`observe_scoring`): `score_rows_total` and the `score_latency_seconds`
histogram on the serving bucket table `SCORE_LATENCY_BUCKETS`, the schema
the serving daemon's per-request latencies share
(`observe_request_latencies`).
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .artifact import (SIDE_CAR, TOPOLOGY, WEIGHTS, load_artifact,
                       params_from_jax)


# Serving-grade latency buckets (seconds): 50us floor, single-digit-ms
# resolution through the 10ms p99 budget.  The registry's DEFAULT_BUCKETS
# start at 500us — too coarse to tell a 2ms p99 from an 8ms one, which is
# exactly the band the serving daemon's budget lives in.  One bucket table
# shared by library calls and the daemon so their percentiles merge.
SCORE_LATENCY_BUCKETS = (
    0.00005, 0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
    0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 10.0)


def observe_scoring(engine: str, n_rows: int, seconds: float) -> None:
    """One telemetry write per scored batch, shared by every engine (and
    the serving daemon through `observe_request_latencies`): rows counter
    + per-call latency histograms, labeled by engine.
    `score_latency_seconds` is the one latency schema daemon p99 and
    library-call scoring share: same name, same buckets, distinguished
    only by the engine label."""
    from .. import obs

    obs.counter("score_rows_total", "rows scored").inc(
        max(int(n_rows), 0), engine=engine)
    obs.histogram("score_batch_seconds",
                  "batch scoring latency by engine").observe(
        seconds, engine=engine)
    obs.histogram("score_latency_seconds",
                  "per-call scoring latency by engine (shared schema: "
                  "library batches and serving-daemon requests)",
                  buckets=SCORE_LATENCY_BUCKETS).observe(
        seconds, engine=engine)


_LATENCY_BOUNDS = np.asarray(SCORE_LATENCY_BUCKETS, np.float64)


def observe_request_latencies(engine: str, latencies) -> None:
    """Bulk write of per-REQUEST latencies into the shared
    `score_latency_seconds` schema — the serving daemon records one value
    per admitted request (admission -> response).  Binning is vectorized
    here (searchsorted == the histogram's bisect_left rule) and merged
    under ONE lock, so a 4k-row dispatch costs microseconds, not a
    4k-iteration Python loop on the dispatch thread."""
    from .. import obs

    lat = np.asarray(latencies, np.float64)
    if lat.size == 0:
        return
    idx = np.searchsorted(_LATENCY_BOUNDS, lat, side="left")
    counts = np.bincount(idx, minlength=len(SCORE_LATENCY_BUCKETS) + 1)
    obs.histogram("score_latency_seconds",
                  "per-call scoring latency by engine (shared schema: "
                  "library batches and serving-daemon requests)",
                  buckets=SCORE_LATENCY_BUCKETS).merge_counts(
        counts.tolist(), float(lat.sum()), int(lat.size), engine=engine)

_LEAKY_ALPHA = 0.2  # keep in sync with ops/activations.py
_LN_EPS = 1e-6      # flax nn.LayerNorm default


def _act(name: str, x: np.ndarray) -> np.ndarray:
    if name == "sigmoid":
        # numerically stable piecewise sigmoid
        out = np.empty_like(x)
        pos = x >= 0
        out[pos] = 1.0 / (1.0 + np.exp(-x[pos]))
        ex = np.exp(x[~pos])
        out[~pos] = ex / (1.0 + ex)
        return out
    if name == "tanh":
        return np.tanh(x)
    if name == "relu":
        return np.maximum(x, 0.0)
    if name == "leakyrelu":
        return np.where(x >= 0, x, _LEAKY_ALPHA * x)
    if name == "gelu":
        # tanh approximation — flax nn.gelu default (approximate=True)
        c = np.float32(np.sqrt(2.0 / np.pi))
        return 0.5 * x * (1.0 + np.tanh(c * (x + 0.044715 * x * x * x)))
    if name == "softmax":
        return _softmax(x)  # rowwise over the last axis (moe gate)
    if name in (None, "", "linear"):
        return x
    raise ValueError(f"unknown activation {name!r}")


def _layernorm(x: np.ndarray, scale: np.ndarray, bias: np.ndarray) -> np.ndarray:
    mean = x.mean(axis=-1, keepdims=True)
    var = x.var(axis=-1, keepdims=True)
    return (x - mean) / np.sqrt(var + _LN_EPS) * scale + bias


def _softmax(x: np.ndarray) -> np.ndarray:
    m = x.max(axis=-1, keepdims=True)
    e = np.exp(x - m)
    return e / e.sum(axis=-1, keepdims=True)


def _transformer_block(op: dict, w: dict[str, np.ndarray], x: np.ndarray
                       ) -> np.ndarray:
    """Pre-LN MHA + residual, then pre-LN gelu-MLP + residual: the
    forward of models/ft_transformer.py's block in float32."""
    b, s, d = x.shape
    h = int(op["num_heads"])
    dh = d // h
    y = _layernorm(x, w[op["ln_attn_scale"]], w[op["ln_attn_bias"]])
    qkv = y @ w[op["qkv_kernel"]] + w[op["qkv_bias"]]
    q, k, v = np.split(qkv, 3, axis=-1)
    q = q.reshape(b, s, h, dh).transpose(0, 2, 1, 3)
    k = k.reshape(b, s, h, dh).transpose(0, 2, 1, 3)
    v = v.reshape(b, s, h, dh).transpose(0, 2, 1, 3)
    scores = (q @ k.transpose(0, 1, 3, 2)) * np.float32(1.0 / np.sqrt(dh))
    attn = (_softmax(scores) @ v).transpose(0, 2, 1, 3).reshape(b, s, d)
    x = x + attn @ w[op["proj_kernel"]] + w[op["proj_bias"]]
    y = _layernorm(x, w[op["ln_mlp_scale"]], w[op["ln_mlp_bias"]])
    y = _act("gelu", y @ w[op["mlp_in_kernel"]] + w[op["mlp_in_bias"]])
    return x + y @ w[op["mlp_out_kernel"]] + w[op["mlp_out_bias"]]


def _reject_extra_inputs(sidecar: dict, tier: str) -> None:
    """Tiers that replay the single-input forward (the model rebuilt, the
    exported program, the AOT pack) cannot bind sidecar extra inputs; scoring
    without them would diverge from the numpy and native engines, so they
    refuse the artifact (the multi-input contract:
    TensorflowModel.java:74-87)."""
    extra = sidecar.get("inputnames", ["shifu_input_0"])[1:]
    if extra:
        raise ValueError(
            f"artifact declares extra named inputs {extra} (fed from "
            f"GenericModelConfig properties); the {tier!r} tier replays the "
            "single-input traced forward and cannot bind them — score with "
            "--engine numpy or native")


def extra_inputs_from_sidecar(sidecar: dict) -> dict[str, np.ndarray]:
    """Auxiliary named inputs: the sidecar's inputnames[1:] take their
    values from GenericModelConfig properties (the reference's contract,
    TensorflowModel.java:74-87).  The numpy Scorer binds them at call
    time.  A listed name with no property value fails loudly."""
    out: dict[str, np.ndarray] = {}
    props = sidecar.get("properties", {})
    for name in sidecar.get("inputnames", [])[1:]:
        if name not in props:
            raise ValueError(
                f"sidecar lists extra input {name!r} but its value is "
                "missing from GenericModelConfig properties "
                "(TensorflowModel.java:74-87 contract)")
        value = np.asarray(props[name], np.float32).ravel()
        if value.size == 0:
            raise ValueError(f"extra input {name!r} has an empty value")
        out[name] = value
    return out


def run_program(program: list[dict], weights: dict[str, np.ndarray],
                x: np.ndarray,
                extra_inputs: dict[str, np.ndarray] | None = None
                ) -> np.ndarray:
    """Execute an artifact op-list on (B, F) float32 rows.

    Handles both format v1 (implicit dense chain, no src/out fields) and the
    general v2 SSA form (export/program.py); a copy of the JAX package's
    interpreter, held to it by tests/test_torch_program.py.

    `extra_inputs` are the sidecar's auxiliary named inputs
    (TensorflowModel.java:74-87): each becomes a per-row-broadcast buffer
    `input:<name>` the program may reference.
    """
    bufs: dict[str, np.ndarray] = {"input": x}
    for name, value in (extra_inputs or {}).items():
        bufs[f"input:{name}"] = np.broadcast_to(
            np.asarray(value, np.float32).ravel()[None, :],
            (x.shape[0], np.asarray(value).size))
    cur = x
    for op in program:
        kind = op["op"]
        src = bufs[op["src"]] if "src" in op else cur
        w = weights
        if kind == "dense":
            out = src @ w[op["kernel"]] + w[op["bias"]]
            out = _act(op.get("activation"), out)
        elif kind == "gather_cols":
            out = src[:, np.asarray(op["positions"], dtype=np.int64)]
        elif kind == "embed_lookup":
            pos = np.asarray(op["positions"], dtype=np.int64)
            vocab = np.asarray(op["vocabs"], dtype=np.int32)
            ids = src[:, pos].astype(np.int32)
            ids = np.clip(ids, 0, vocab - 1)              # (B, Nc)
            table = w[op["table"]]                        # (Nc, maxV, D)
            out = table[np.arange(len(pos))[None, :], ids]  # (B, Nc, D)
        elif kind == "numeric_embed":
            out = src[:, :, None] * w[op["weight"]][None] + w[op["bias"]][None]
        elif kind == "concat":
            out = np.concatenate([bufs[s] for s in op["srcs"]], axis=1)
        elif kind == "flatten":
            out = src.reshape(src.shape[0], -1)
        elif kind == "sum_fields":
            out = src.sum(axis=1)
        elif kind == "add":
            parts = [bufs[s] for s in op["srcs"]]
            out = parts[0]
            for p in parts[1:]:
                out = out + p                              # (B,1) broadcasts
        elif kind == "fm_pair":
            sum_sq = np.square(src.sum(axis=1))
            sq_sum = np.square(src).sum(axis=1)
            out = 0.5 * (sum_sq - sq_sum).sum(axis=-1, keepdims=True)
        elif kind == "activation":
            out = _act(op.get("fn"), src)
        elif kind == "cls_prepend":
            token = np.broadcast_to(
                w[op["token"]].reshape(1, 1, -1),
                (src.shape[0], 1, src.shape[2]))
            out = np.concatenate([token, src], axis=1)
        elif kind == "layernorm":
            out = _layernorm(src, w[op["scale"]], w[op["bias"]])
        elif kind == "select_token":
            out = src[:, int(op["index"]), :]
        elif kind == "transformer_block":
            out = _transformer_block(op, w, src)
        elif kind == "expert_dense":
            kernel = w[op["kernel"]]              # (E, I, O)
            if src.ndim == 2:                     # first layer: shared input
                out = np.einsum("bi,eio->beo", src, kernel)
            else:                                 # (B, E, I) per-expert
                out = np.einsum("bei,eio->beo", src, kernel)
            out = _act(op.get("activation"), out + w[op["bias"]][None])
        elif kind == "moe_combine":
            h, gate = (bufs[s] for s in op["srcs"])  # (B,E,H), (B,E)
            out = np.einsum("beh,be->bh", h, gate)
        else:
            raise ValueError(f"unknown op {kind!r}")
        out = np.asarray(out, dtype=np.float32)
        if "out" in op:
            bufs[op["out"]] = out
        cur = out
    return cur


class BatchScorer:
    """The batch-dispatch seam the serving daemon wraps.

    Subclasses set `engine`, `num_features` and implement `_score_batch(x)`
    on a validated (N, F) float32 matrix; the seam owns input coercion,
    the width check, timing and `observe_scoring`.  `static_shapes` tells
    the daemon to pad batches up its bucket ladder."""

    engine = "base"
    static_shapes = False
    num_features: int

    def _score_batch(self, x: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def _as_batch(self, rows) -> np.ndarray:
        x = np.asarray(rows, dtype=np.float32)
        if x.ndim == 1:
            x = x[None, :]
        if x.ndim != 2 or x.shape[1] != self.num_features:
            raise ValueError(
                f"expected {self.num_features} features, got "
                f"{x.shape[-1] if x.ndim else 0}")
        return x

    def compute_batch(self, rows, n_valid: Optional[int] = None
                      ) -> np.ndarray:
        """Score (N, F) float rows -> (N, num_heads) probabilities.
        `n_valid` is the row count telemetry reports: the pad rows of the
        daemon's bucketed batches are not scored traffic."""
        x = self._as_batch(rows)
        t0 = time.perf_counter()
        out = self._score_batch(x)
        observe_scoring(self.engine,
                        out.shape[0] if n_valid is None else n_valid,
                        time.perf_counter() - t0)
        return out

    def compute(self, row: Sequence[float]) -> float:
        """Single-row score in [0, 1] (the reference's call shape)."""
        return float(self.compute_batch(
            np.asarray(row, dtype=np.float64))[0, 0])


class TorchScorer(BatchScorer):
    """Scores an artifact with the port's model on `device` (default
    `cuda:0`; raises where CUDA is absent unless `device="cpu"`)."""

    engine = "torch"
    static_shapes = True  # the daemon pads to its bucket ladder

    def __init__(self, export_dir: str, device: DeviceLike = None):
        from ..models.registry import build_model

        self.device = resolve_device(device)
        art = load_artifact(export_dir)
        _reject_extra_inputs(art.sidecar, "torch")
        self.topology = art.topology
        self.spec = art.spec
        self.num_features = int(art.topology["num_features"])
        self.model = build_model(art.spec, art.schema, self.device)
        self.model.load_state_dict(params_from_jax(art.weights, self.model))

    def _score_batch(self, x: np.ndarray) -> np.ndarray:
        if not x.flags.writeable:
            x = x.copy()  # a wire frame's buffer is read-only
        with torch.inference_mode():
            feats = torch.from_numpy(x).to(self.device)
            probs = torch.sigmoid(self.model(feats).float())
            return probs.cpu().numpy()


def load_program(path: str, device: torch.device):
    """An exported scoring program (`torch.export.save`d) as a callable
    module on `device`: the `shifu_tpu_torch::` operators are registered
    first (`torch.export.load` cannot read a program that calls an unknown
    operator), then the program's weights and constants move to `device`.
    The operators pick the kernel or its plain version from that device
    when they run."""
    from torch.export.passes import move_to_device_pass

    from ..ops import register_operators

    register_operators()
    program = torch.export.load(path)
    if device.type != "cpu":
        program = move_to_device_pass(program, device)
    return program.module()


class ExportScorer(BatchScorer):
    """Scores through the artifact's exported program (`scoring.pt2`,
    export/artifact.py) on `device` (default `cuda:0`; raises where CUDA is
    absent unless `device="cpu"`): the compiled-graph tier.  Unlike
    `TorchScorer` it does not rebuild the model from its classes; it runs
    the graph traced at export, the model's compute dtype included."""

    engine = "export"
    static_shapes = True

    def __init__(self, export_dir: str, device: DeviceLike = None):
        from .artifact import EXPORT_PROGRAM

        self.device = resolve_device(device)
        with open(os.path.join(export_dir, TOPOLOGY)) as f:
            self.topology = json.load(f)
        sidecar_path = os.path.join(export_dir, SIDE_CAR)
        if os.path.exists(sidecar_path):
            with open(sidecar_path) as f:
                _reject_extra_inputs(json.load(f), "export")
        self.num_features = int(self.topology["num_features"])
        self._module = load_program(
            os.path.join(export_dir, EXPORT_PROGRAM), self.device)

    def _score_batch(self, x: np.ndarray) -> np.ndarray:
        if not x.flags.writeable:
            x = x.copy()  # a wire frame's buffer is read-only
        with torch.inference_mode():
            return self._module(
                torch.from_numpy(x).to(self.device)).cpu().numpy()


class Scorer(BatchScorer):
    """The op-list interpreter on the host: loads an artifact directory
    and scores rows through `run_program`, binding the sidecar's extra
    named inputs.  `compute(row) -> float` for one row, `compute_batch(rows)
    -> (N, H)` for a batch.  Raises on an artifact without a program."""

    engine = "numpy"

    def __init__(self, export_dir: str):
        with open(os.path.join(export_dir, TOPOLOGY)) as f:
            self.topology = json.load(f)
        with open(os.path.join(export_dir, SIDE_CAR)) as f:
            self.sidecar = json.load(f)
        if self.topology.get("format_version") != 1:
            raise ValueError(f"unsupported artifact format: "
                             f"{self.topology.get('format_version')}")
        with np.load(os.path.join(export_dir, WEIGHTS)) as z:
            self.weights = {k: z[k].astype(np.float32) for k in z.files}
        self.num_features = int(self.topology["num_features"])
        self.program = self.topology["program"]
        if not self.program:
            raise ValueError(
                "artifact has no op-list program (model_type="
                f"{self.topology.get('model_type')!r}); score it with the "
                "torch engine")
        self.input_names = self.sidecar.get("inputnames", ["shifu_input_0"])
        self.output_name = self.sidecar.get("properties", {}).get(
            "outputnames", "shifu_output_0")
        # auxiliary named inputs: values come from the sidecar PROPERTIES,
        # exactly the reference's contract (TensorflowModel.java:74-87)
        self.extra_inputs = extra_inputs_from_sidecar(self.sidecar)

    def _score_batch(self, x: np.ndarray) -> np.ndarray:
        return run_program(self.program, self.weights, x,
                           extra_inputs=self.extra_inputs)


def load_scorer(export_dir: str, device: DeviceLike = None) -> BatchScorer:
    """The scorer for an artifact, best tier first: the op-list
    interpreter where the program exists, the AOT pack (export/aot.py)
    where one is shipped and matches this host, the exported program
    (`ExportScorer`) where `scoring.pt2` exists, and the model rebuilt from
    its classes (`TorchScorer`) last.  The torch tiers score on `device`
    (default `cuda:0`).  That is the JAX package's order on the CPU; on
    the card the interpreter, a host engine, is skipped, so that `auto`
    scores where the caller asked (JAX takes it first on any platform)."""
    from .aot import has_pack, try_load_aot
    from .artifact import EXPORT_PROGRAM

    dev = resolve_device(device)
    with open(os.path.join(export_dir, TOPOLOGY)) as f:
        topo = json.load(f)
    if dev.type == "cpu" and topo.get("program"):
        return Scorer(export_dir)
    if has_pack(export_dir):
        scorer = try_load_aot(export_dir, dev)
        if scorer is not None:
            return scorer  # a mismatch journaled aot_fallback
    if os.path.exists(os.path.join(export_dir, EXPORT_PROGRAM)):
        return ExportScorer(export_dir, dev)
    return TorchScorer(export_dir, dev)
