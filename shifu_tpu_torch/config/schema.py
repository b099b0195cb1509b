"""Typed configuration: the part of shifu_tpu's `config/schema.py` that the
serving and training paths read.

`ColumnSpec`, `DataSchema`, `ModelSpec`, `DataConfig`, `OptimizerConfig`,
`TrainConfig` and `JobConfig` are field-for-field copies of the JAX
package's dataclasses with the same defaults and checks, so an artifact's
`topology.json` and a JAX `JobConfig.to_dict()` parse unchanged
(`_from_dict`).  `ObsConfig`, `EmbedConfig`, `MeshConfig`,
`CheckpointConfig` and `RuntimeConfig` carry their fields so such a dict
loads, and the first three keep the JAX package's checks; the port acts
on them only through `embed.dedup` and by refusing a checkpoint
directory (`train/loop.train`).  `ServingConfig` keeps only the knobs the
port's daemon uses.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional


class ConfigError(ValueError):
    """Raised when a config is structurally invalid."""


@dataclass(frozen=True)
class ColumnSpec:
    """One column of the normalized tabular input."""

    index: int
    name: str
    is_target: bool = False
    is_weight: bool = False
    is_selected: bool = False
    is_categorical: bool = False
    vocab_size: int = 0


@dataclass(frozen=True)
class DataSchema:
    """Column layout of one pipe-delimited normalized row."""

    columns: tuple[ColumnSpec, ...] = ()
    target_index: int = -1
    weight_index: int = -1
    selected_indices: tuple[int, ...] = ()
    target_indices: tuple[int, ...] = ()

    @property
    def feature_count(self) -> int:
        return len(self.selected_indices)

    @property
    def categorical_indices(self) -> tuple[int, ...]:
        by_index = {c.index: c for c in self.columns}
        return tuple(i for i in self.selected_indices
                     if i in by_index and by_index[i].is_categorical)

    @property
    def all_target_indices(self) -> tuple[int, ...]:
        return (self.target_indices if self.target_indices
                else (self.target_index,))

    def validate(self) -> None:
        if self.target_index < 0 and not self.target_indices:
            raise ConfigError("DataSchema.target_index must be set (>= 0)")
        if not self.selected_indices:
            raise ConfigError("DataSchema.selected_indices must be non-empty")
        for t in self.all_target_indices:
            if t in self.selected_indices:
                raise ConfigError(
                    "target column cannot also be a selected feature")
        if (self.weight_index >= 0
                and self.weight_index in self.selected_indices):
            raise ConfigError(
                "weight column cannot also be a selected feature")


VALID_MODEL_TYPES = ("mlp", "wide_deep", "deepfm", "multitask",
                     "ft_transformer", "moe_mlp")
VALID_ACTIVATIONS = ("sigmoid", "tanh", "relu", "leakyrelu")


@dataclass(frozen=True)
class ModelSpec:
    """Model topology; every field of the JAX `ModelSpec`, same defaults.

    The port reads `model_type`, the MLP fields (with `dropout_rate` and
    `l2_scale` in training), the FT-Transformer fields (`attention_impl`
    "local" or "flash", `remat`), `fused_block`, `embedding_dim` and
    `num_heads` (Wide&Deep, DeepFM), and the dtypes.  The rest
    (ring and Ulysses attention, `pipeline_*`, `num_experts`) belong to
    model types or modes that later slices port; they are kept so that any
    artifact's `model_spec` parses.
    """

    model_type: str = "mlp"
    hidden_nodes: tuple[int, ...] = (20,)
    activations: tuple[str, ...] = ("leakyrelu",)
    xavier_bias_init: bool = True
    l2_scale: float = 0.0
    embedding_dim: int = 16
    num_heads: int = 1
    head_names: tuple[str, ...] = ("shifu_output_0",)
    num_layers: int = 3
    num_attention_heads: int = 8
    token_dim: int = 64
    mlp_ratio: int = 4
    dropout_rate: float = 0.0
    attention_impl: str = "local"
    # "auto": every block whose shape fits runs fused (the CUDA kernel on
    # the card, its plain twin on the CPU); "on" forces it; "off" keeps the
    # unfused module math (ops/ft_block.fused_block_engaged)
    fused_block: str = "auto"
    pipeline_stages: int = 1
    pipeline_microbatches: int = 0
    num_experts: int = 4
    remat: bool = False
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    def validate(self) -> None:
        if self.model_type not in VALID_MODEL_TYPES:
            raise ConfigError(f"unknown model_type {self.model_type!r}; "
                              f"expected one of {VALID_MODEL_TYPES}")
        if len(self.hidden_nodes) != len(self.activations):
            raise ConfigError(
                "hidden_nodes and activations must have equal length")
        for a in self.activations:
            if a not in VALID_ACTIVATIONS:
                raise ConfigError(f"unknown activation {a!r}")
        if self.num_heads != len(self.head_names):
            raise ConfigError("num_heads must match len(head_names)")
        if self.attention_impl not in ("local", "ring", "ulysses", "flash"):
            raise ConfigError(
                f"unknown attention_impl {self.attention_impl!r}; "
                "expected local|ring|ulysses|flash")
        if self.fused_block not in ("auto", "on", "off"):
            raise ConfigError(
                f"fused_block must be auto/on/off: {self.fused_block!r}")
        if self.model_type == "moe_mlp" and self.num_experts < 2:
            raise ConfigError("moe_mlp requires num_experts >= 2")
        if self.pipeline_stages < 1 or self.pipeline_microbatches < 0:
            raise ConfigError("pipeline_stages must be >= 1 and "
                              "pipeline_microbatches >= 0")
        if self.pipeline_stages > 1:
            if self.model_type != "ft_transformer":
                raise ConfigError("pipeline_stages > 1 requires "
                                  "model_type='ft_transformer'")
            if self.num_layers % self.pipeline_stages != 0:
                raise ConfigError(
                    f"num_layers ({self.num_layers}) must be divisible by "
                    f"pipeline_stages ({self.pipeline_stages})")
            if self.attention_impl in ("ring", "ulysses"):
                raise ConfigError(
                    "pipeline_stages > 1 composes with local/flash attention "
                    "only (sequence parallelism uses its own mesh axis)")
            if self.dropout_rate > 0:
                raise ConfigError("pipeline_stages > 1 requires dropout_rate=0")


@dataclass(frozen=True)
class ServingConfig:
    """Knobs for the port's scoring daemon (runtime/serve.py); the serving
    fields of the JAX `ServingConfig` that the daemon uses, same defaults
    except `engine`, whose one value here is "torch"."""

    engine: str = "torch"
    # a lone request is dispatched after at most this budget (ms); under
    # load batches fill to max_batch and dispatch at once
    latency_budget_ms: float = 2.0
    max_batch: int = 4096
    # smallest padded bucket: batches pad up min_batch_bucket, 2x, ...,
    # max_batch for static-shape engines
    min_batch_bucket: int = 16
    # admission bound: beyond this queue depth submit() raises ServeOverload
    queue_limit: int = 100_000
    workers: int = 1
    # warm every bucket of the ladder before a load becomes visible
    prewarm_ladder: bool = True

    def validate(self) -> None:
        if self.engine != "torch":
            raise ConfigError(f"serving.engine must be 'torch': "
                              f"{self.engine!r}")
        if self.latency_budget_ms <= 0:
            raise ConfigError("serving.latency_budget_ms must be > 0: "
                              f"{self.latency_budget_ms}")
        if self.max_batch < 1 or self.min_batch_bucket < 1:
            raise ConfigError("serving.max_batch and min_batch_bucket must "
                              "be >= 1")
        if self.min_batch_bucket > self.max_batch:
            raise ConfigError(
                f"serving.min_batch_bucket ({self.min_batch_bucket}) must "
                f"not exceed max_batch ({self.max_batch})")
        if self.queue_limit < 1:
            raise ConfigError("serving.queue_limit must be >= 1")
        if self.workers < 1:
            raise ConfigError("serving.workers must be >= 1")

    def replace(self, **kw) -> "ServingConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class DataConfig:
    """Input pipeline configuration; every field of the JAX `DataConfig`,
    same defaults and checks.

    The port's loader (`data/pipeline.load_datasets`) is single-host and
    uncached: `cache_dir`, `cache_format`, `out_of_core`, `host_shard`,
    `read_threads`/`ingest_workers` (beyond thread count), `prefetch*`,
    `overlap_epochs`, `block_batches` and `stream_first_epoch` belong to
    tiers that later slices port (ROADMAP.md queue A).  `staged` and
    `drop_remainder` gate the device-resident tier as in the JAX loop.
    """

    paths: tuple[str, ...] = ()
    delimiter: str = "|"
    valid_ratio: float = 0.1
    split_seed: int = 0
    batch_size: int = 100
    shuffle_seed: int = 0
    shuffle: bool = True
    drop_remainder: bool = True
    prefetch: int = 2
    prefetch_depth: int = 4
    overlap_epochs: bool = True
    staged: bool = True
    block_batches: int = 32
    # device-resident tier: the training partition is moved to the card
    # once when it fits in this many bytes (0 disables)
    device_resident_bytes: int = 2 << 30
    cache_dir: str | None = None
    cache_format: int = 0
    read_threads: int = 0
    ingest_workers: int = 0
    out_of_core: bool = False
    stream_first_epoch: bool = True
    # features on the host->card wire: auto (bf16 when the model computes
    # bf16 and no categorical ids ride in features), float32, bfloat16, or
    # int8 on the static per-column grid of data/pipeline.wire_params
    wire_dtype: str = "auto"
    wire_int8_clip: float = 8.0
    wire_label_dtype: str = "auto"
    wire_weight_mode: str = "auto"
    host_shard: str = "auto"
    # in-card format of the device-resident tier's features: auto/wire keep
    # the wire format, int8 forces the wire_params grid
    resident_format: str = "auto"

    def validate(self) -> None:
        if not (0.0 <= self.valid_ratio < 1.0):
            raise ConfigError(
                f"valid_ratio must be in [0,1): {self.valid_ratio}")
        if self.batch_size <= 0:
            raise ConfigError("batch_size must be positive")
        if self.prefetch_depth < 0:
            raise ConfigError(
                f"prefetch_depth must be >= 0 (0 = auto): "
                f"{self.prefetch_depth}")
        if self.cache_format not in (0, 1, 2):
            raise ConfigError(
                f"cache_format must be 0 (latest), 1, or 2: "
                f"{self.cache_format}")
        if self.ingest_workers < 0:
            raise ConfigError(
                f"ingest_workers must be >= 0 (0 = auto): "
                f"{self.ingest_workers}")
        if self.wire_dtype not in ("auto", "float32", "bfloat16", "int8"):
            raise ConfigError(
                f"wire_dtype must be auto/float32/bfloat16/int8: "
                f"{self.wire_dtype!r}")
        if self.wire_int8_clip <= 0:
            raise ConfigError(
                f"wire_int8_clip must be positive: {self.wire_int8_clip}")
        if self.wire_label_dtype not in ("auto", "uint8", "float32"):
            raise ConfigError(
                f"wire_label_dtype must be auto/uint8/float32: "
                f"{self.wire_label_dtype!r}")
        if self.wire_weight_mode not in ("auto", "elide", "float32"):
            raise ConfigError(
                f"wire_weight_mode must be auto/elide/float32: "
                f"{self.wire_weight_mode!r}")
        if self.resident_format not in ("auto", "wire", "int8"):
            raise ConfigError(
                f"resident_format must be auto/wire/int8: "
                f"{self.resident_format!r}")
        if self.host_shard not in ("auto", "static", "rotate"):
            raise ConfigError(
                f"host_shard must be auto/static/rotate: "
                f"{self.host_shard!r}")


@dataclass(frozen=True)
class OptimizerConfig:
    """Optimizer selection (reference default: Adadelta at 0.003)."""

    name: str = "adadelta"
    learning_rate: float = 0.003
    momentum: float = 0.9
    weight_decay: float = 0.0
    grad_clip_norm: float = 0.0     # 0 disables
    accumulate_steps: int = 1
    # constant | cosine | exponential | warmup_cosine, over optimizer steps
    schedule: str = "constant"
    warmup_steps: int = 0
    decay_steps: int = 0
    decay_rate: float = 0.96
    end_lr_factor: float = 0.0

    def validate(self) -> None:
        if self.learning_rate <= 0:
            raise ConfigError("learning_rate must be positive")
        if self.accumulate_steps < 1:
            raise ConfigError("accumulate_steps must be >= 1")
        if self.schedule not in ("constant", "cosine", "exponential",
                                 "warmup_cosine"):
            raise ConfigError(f"unknown schedule {self.schedule!r}; expected "
                              "constant|cosine|exponential|warmup_cosine")
        if self.schedule != "constant" and self.decay_steps <= 0:
            raise ConfigError(
                f"schedule {self.schedule!r} requires decay_steps > 0")
        if self.warmup_steps < 0:
            raise ConfigError("warmup_steps must be >= 0")
        if (self.schedule == "warmup_cosine"
                and self.decay_steps <= self.warmup_steps):
            raise ConfigError(
                f"warmup_cosine requires decay_steps ({self.decay_steps}) > "
                f"warmup_steps ({self.warmup_steps})")


@dataclass(frozen=True)
class TrainConfig:
    """Training loop settings; `local_sgd_window` and `scaling_gate` are
    parsed and checked but belong to tiers that later slices port.
    `sparse_embedding_update` selects train/sparse_embed.py's plan."""

    epochs: int = 100
    loss: str = "weighted_mse"
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    seed: int = 42
    eval_every_epochs: int = 1
    log_every_steps: int = 0
    bagging_sample_rate: float = 1.0
    # stop after this many evaluated epochs without a valid_error
    # improvement of at least early_stop_min_delta (0 disables)
    early_stop_patience: int = 0
    early_stop_min_delta: float = 0.0
    local_sgd_window: int = 0
    sparse_embedding_update: str = "auto"
    scaling_gate: float = 0.6

    def validate(self) -> None:
        if self.epochs <= 0:
            raise ConfigError("epochs must be positive")
        if not (0.0 <= self.scaling_gate <= 1.0):
            raise ConfigError(
                f"scaling_gate must be in [0, 1]: {self.scaling_gate}")
        if self.sparse_embedding_update not in ("auto", "on", "off"):
            raise ConfigError(
                f"sparse_embedding_update must be auto/on/off: "
                f"{self.sparse_embedding_update!r}")
        if self.early_stop_patience < 0 or self.early_stop_min_delta < 0:
            raise ConfigError("early_stop_patience and early_stop_min_delta "
                              "must be >= 0")
        if not (0.0 < self.bagging_sample_rate <= 1.0):
            raise ConfigError("bagging_sample_rate must be in (0, 1]: "
                              f"{self.bagging_sample_rate}")
        if self.loss not in ("weighted_mse", "bce", "weighted_bce"):
            raise ConfigError(f"unknown loss {self.loss!r}")
        if self.local_sgd_window < 0:
            raise ConfigError("local_sgd_window must be >= 0")
        if self.local_sgd_window > 0:
            if self.optimizer.name != "sgd":
                raise ConfigError(
                    "local_sgd_window requires optimizer 'sgd' (this tier "
                    "implements plain-SGD local updates; the reference "
                    "SAGN's Adam family is a documented deviation), "
                    f"got {self.optimizer.name!r}")
            if self.optimizer.accumulate_steps > 1:
                raise ConfigError("local_sgd_window and accumulate_steps "
                                  "are mutually exclusive")
            if self.optimizer.schedule != "constant":
                raise ConfigError("local_sgd_window supports only the "
                                  "constant learning-rate schedule (local "
                                  "updates use the static lr)")
            if (self.optimizer.grad_clip_norm > 0
                    or self.optimizer.weight_decay > 0):
                raise ConfigError(
                    "local_sgd_window applies plain p - lr*g local updates; "
                    "grad_clip_norm/weight_decay would be silently ignored "
                    "— unset them (the reference SAGN has neither)")
        self.optimizer.validate()


@dataclass(frozen=True)
class ObsConfig:
    """The JAX package's device-profiling knobs, carried so a JAX job dict
    parses and checked as the JAX package checks them; the port has no
    flight recorder yet."""

    trace_epochs: str = "off"
    trace_dir: str = ""
    trace_top_k: int = 16
    hbm_watermarks: bool = True
    anomaly_window: int = 32
    anomaly_zscore: float = 6.0
    anomaly_min_chunks: int = 8
    anomaly_min_ratio: float = 0.5

    def validate(self) -> None:
        from ..obs import devprof  # parse, don't duplicate the grammar
        try:
            devprof.parse_trace_epochs(self.trace_epochs)
        except ValueError as e:
            raise ConfigError(str(e))
        if self.trace_top_k < 1:
            raise ConfigError(
                f"obs.trace_top_k must be >= 1: {self.trace_top_k}")
        if self.anomaly_window < 4:
            raise ConfigError(
                f"obs.anomaly_window must be >= 4: {self.anomaly_window}")
        if self.anomaly_zscore <= 0 or self.anomaly_min_ratio < 0:
            raise ConfigError(
                "obs.anomaly_zscore must be > 0 and anomaly_min_ratio >= 0")
        if self.anomaly_min_chunks < 2:
            raise ConfigError(
                f"obs.anomaly_min_chunks must be >= 2: "
                f"{self.anomaly_min_chunks}")


@dataclass(frozen=True)
class EmbedConfig:
    """The JAX package's sparse-embedding engine knobs.  The port reads
    `dedup` ("off" turns the per-batch id compaction off); the tiering
    fields are carried so a JAX job dict parses (tiering is ROADMAP.md
    queue A item (e))."""

    dedup: str = "auto"
    tiering: str = "off"
    tier_dtype: str = "float32"
    hot_rows: int = 0
    hot_fraction: float = 0.05
    cold_dir: str = ""
    prefetch: bool = True

    def validate(self) -> None:
        if self.dedup not in ("auto", "off"):
            raise ConfigError(
                f"embed.dedup must be auto|off: {self.dedup!r}")
        if self.tiering not in ("off", "host"):
            raise ConfigError(
                f"embed.tiering must be off|host: {self.tiering!r}")
        if self.tier_dtype not in ("float32", "int8"):
            raise ConfigError(
                f"embed.tier_dtype must be float32|int8: "
                f"{self.tier_dtype!r}")
        if self.hot_rows < 0:
            raise ConfigError(f"embed.hot_rows must be >= 0: "
                              f"{self.hot_rows}")
        if not (0.0 < self.hot_fraction <= 1.0):
            raise ConfigError(
                f"embed.hot_fraction must be in (0, 1]: "
                f"{self.hot_fraction}")


@dataclass(frozen=True)
class MeshConfig:
    """The JAX package's device mesh (multi-GPU is slice (f)); carried so a
    JAX job dict parses."""

    data: int = 1
    model: int = 1
    seq: int = 1
    pipe: int = 1
    axis_order: tuple[str, ...] = ("data", "seq", "pipe", "model")

    def validate(self) -> None:
        for name in ("data", "model", "seq", "pipe"):
            if getattr(self, name) < 1:
                raise ConfigError(f"mesh axis {name} must be >= 1")
        known = {"data", "seq", "pipe", "model"}
        if (not set(self.axis_order) <= known
                or len(set(self.axis_order)) != len(self.axis_order)):
            raise ConfigError(f"axis_order must be distinct axes from "
                              f"{sorted(known)}: {self.axis_order}")
        for name in known - set(self.axis_order):
            if getattr(self, name) != 1:
                raise ConfigError(f"mesh axis {name} > 1 but missing from "
                                  "axis_order")


@dataclass(frozen=True)
class CheckpointConfig:
    """Checkpoint settings; the port refuses a non-empty `directory` until
    `train/checkpoint.py` is ported (ROADMAP.md queue A)."""

    directory: str = ""
    save_every_epochs: int = 1
    save_every_seconds: int = 0
    max_to_keep: int = 3
    resume: bool = True
    async_save: bool = False


@dataclass(frozen=True)
class RuntimeConfig:
    """Job-level runtime settings of the JAX package, carried so a JAX job
    dict parses (launcher, pod and multi-host fields wait for later
    slices)."""

    mesh: MeshConfig = field(default_factory=MeshConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    app_name: str = "shifu_tpu"
    timeout_seconds: int = 0
    max_restarts: int = 2
    liveness_seconds: float = 0.0
    min_hosts: int = 0
    final_model_path: str = ""
    tmp_model_path: str = ""
    kerberos_principal: str = ""
    kerberos_keytab: str = ""
    distributed: bool = False
    param_sharding_rules: tuple[
        tuple[str, tuple[Optional[str], ...]], ...] = ()


@dataclass(frozen=True)
class JobConfig:
    schema: DataSchema = field(default_factory=DataSchema)
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelSpec = field(default_factory=ModelSpec)
    train: TrainConfig = field(default_factory=TrainConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)
    obs: ObsConfig = field(default_factory=ObsConfig)
    embed: EmbedConfig = field(default_factory=EmbedConfig)

    def validate(self) -> "JobConfig":
        self.schema.validate()
        self.data.validate()
        self.model.validate()
        self.train.validate()
        self.runtime.mesh.validate()
        self.obs.validate()
        self.embed.validate()
        if self.train.bagging_sample_rate < 1.0 and self.data.out_of_core:
            raise ConfigError("bagging_sample_rate < 1 is not supported with "
                              "out-of-core datasets")
        if self.data.wire_dtype == "int8" and self.schema.categorical_indices:
            # integer ids cannot ride an affine quantization grid
            raise ConfigError(
                "wire_dtype=int8 requires a categorical-free feature matrix "
                f"({len(self.schema.categorical_indices)} categorical "
                "columns selected); use auto/bfloat16/float32")
        if (self.data.resident_format == "int8"
                and self.schema.categorical_indices):
            raise ConfigError(
                "resident_format=int8 requires a categorical-free feature "
                f"matrix ({len(self.schema.categorical_indices)} categorical "
                "columns selected); use auto/wire")
        return self

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "JobConfig":
        return _from_dict(cls, d)

    @classmethod
    def from_json(cls, s: str) -> "JobConfig":
        return cls.from_dict(json.loads(s))

    def replace(self, **kw: Any) -> "JobConfig":
        return dataclasses.replace(self, **kw)


def _deep_tuple(v: Any) -> Any:
    """Lists (from JSON) to tuples at every nesting level."""
    if isinstance(v, list):
        return tuple(_deep_tuple(x) for x in v)
    return v


def _from_dict(cls: type, d: Any) -> Any:
    """Recursively build a (possibly nested) dataclass from plain dicts/lists."""
    if not dataclasses.is_dataclass(cls):
        return d
    kwargs: dict[str, Any] = {}
    fields = {f.name: f for f in dataclasses.fields(cls)}
    for key, value in d.items():
        if key not in fields:
            raise ConfigError(f"unknown config key {key!r} for {cls.__name__}")
        f = fields[key]
        default = (f.default_factory()  # type: ignore[misc]
                   if f.default_factory is not dataclasses.MISSING
                   else f.default)
        if dataclasses.is_dataclass(default) and isinstance(value, dict):
            kwargs[key] = _from_dict(type(default), value)
        elif key == "columns" and isinstance(value, (list, tuple)):
            kwargs[key] = tuple(_from_dict(ColumnSpec, v)
                                if isinstance(v, dict) else v for v in value)
        elif isinstance(value, list):
            kwargs[key] = _deep_tuple(value)
        else:
            kwargs[key] = value
    return cls(**kwargs)
