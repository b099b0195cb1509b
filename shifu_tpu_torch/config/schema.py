"""Typed configuration: the part of shifu_tpu's `config/schema.py` that the
serving and training paths read.

`ColumnSpec`, `DataSchema`, `ModelSpec`, `DataConfig`, `OptimizerConfig`,
`TrainConfig` and `JobConfig` are field-for-field copies of the JAX
package's dataclasses with the same defaults and checks, so an artifact's
`topology.json` and a JAX `JobConfig.to_dict()` parse unchanged
(`_from_dict`).  `ObsConfig`, `EmbedConfig`, `MeshConfig`,
`CheckpointConfig` and `RuntimeConfig` carry their fields so such a dict
loads, and the first three keep the JAX package's checks; the port acts
on `embed.dedup` and on `runtime.checkpoint` (`train/loop.train`).
`ServingConfig` keeps only the knobs the port's daemon uses;
`FleetConfig` is whole.
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
    `num_heads` (Wide&Deep, DeepFM, multitask), `num_experts` (moe_mlp),
    and the dtypes.  The rest (ring and Ulysses attention, `pipeline_*`)
    belong to modes that later slices port; they are kept so that any
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
class DriftConfig:
    """Drift-detection knobs (`shifu.drift.*` XML keys, obs/drift.py);
    every field of the JAX `DriftConfig`, same defaults and checks.

    Nested under ServingConfig so it threads unchanged through the daemon
    and the loadtest.  Drift only engages when the served artifact carries
    a `baseline_profile.json`; `enabled` is the kill switch on top."""

    # kill switch: False silences the whole drift plane — no sketch
    # accumulation, no tick thread, zero drift events (the overhead
    # guard's contract).
    enabled: bool = True
    # fast/slow trailing windows (seconds): an alert objective must
    # violate in BOTH to fire (transient bursts don't page) and the
    # fast window alone resolves it (recovery is quick).
    fast_window_s: float = 60.0
    slow_window_s: float = 300.0
    # per-feature PSI threshold on the int8 wire grid, folded to 17
    # groups; conventional reading: < 0.1 stable, 0.1-0.25 moderate,
    # > 0.25 significant.  0 disables the feature_psi objective.
    psi_threshold: float = 0.25
    # KL(baseline || live) threshold for the score distribution;
    # 0 disables the score_kl objective.
    score_kl_threshold: float = 0.1
    # how many worst features a drift_report / drift_alert names
    top_k: int = 5
    # fast window must hold at least this many rows before any
    # judgment (quiet traffic never pages; idle unlatch below this).
    min_rows: int = 200
    # labeled-feedback path (wire FEEDBACK frame -> live AUC /
    # auc_decay); off rejects FEEDBACK frames with STATUS_ERROR.
    feedback: bool = True
    # score-bin resolution of the feedback AUC accumulator
    feedback_bins: int = 1024

    def validate(self) -> None:
        if self.fast_window_s <= 0 \
                or self.slow_window_s < self.fast_window_s:
            raise ConfigError(
                "drift windows need 0 < fast_window_s <= slow_window_s: "
                f"{self.fast_window_s}/{self.slow_window_s}")
        if self.psi_threshold < 0:
            raise ConfigError(
                f"drift.psi-threshold must be >= 0: {self.psi_threshold}")
        if self.score_kl_threshold < 0:
            raise ConfigError("drift.score-kl-threshold must be >= 0: "
                              f"{self.score_kl_threshold}")
        if self.top_k < 1:
            raise ConfigError(f"drift.top-k must be >= 1: {self.top_k}")
        if self.min_rows < 1:
            raise ConfigError(
                f"drift.min-rows must be >= 1: {self.min_rows}")
        if self.feedback_bins < 2:
            raise ConfigError("drift.feedback-bins must be >= 2: "
                              f"{self.feedback_bins}")


# the scoring engine tiers (runtime/serve.load_engine)
ENGINES = ("torch", "export", "aot", "numpy", "native", "auto")


@dataclass(frozen=True)
class ServingConfig:
    """Knobs for the port's scoring daemon (runtime/serve.py) and its wire
    server (runtime/serve_wire.py); the fields of the JAX `ServingConfig`
    with the same defaults and checks, except `engine`: the port's tiers
    are torch (the default), export, aot, numpy, native and auto, its
    "torch" and "export" standing in for the JAX package's "jax" and
    "stablehlo"."""

    # scoring engine tier (runtime/serve.load_engine's ladder, the same as
    # the `score --engine` flag's)
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
    # `serving_report` journal cadence (seconds); 0 disables the reporter
    report_every_s: float = 10.0
    # the wire server's TCP port (0 = ephemeral) and bind host
    port: int = 8571
    host: str = "127.0.0.1"
    # journal one sampled `request_trace` (the lifecycle stage chain) for
    # every Nth admitted request; 0 disables sampling
    trace_sample: int = 0
    # how many slowest sampled traces a loadtest report names
    trace_exemplars: int = 5
    # SLO objectives (0 disables each): p99 target in ms (pick a value on
    # the latency bucket grid), error rate and availability as fractions
    slo_p99_ms: float = 0.0
    slo_error_rate: float = 0.0
    slo_availability: float = 0.0
    # multiwindow burn-rate alerting: both windows must burn the budget at
    # >= slo_burn_threshold x the sustainable rate to fire one slo_alert
    slo_fast_window_s: float = 60.0
    slo_slow_window_s: float = 300.0
    slo_burn_threshold: float = 2.0
    # drift detection (`shifu.drift.*`); engages only when the artifact
    # carries a baseline_profile.json
    drift: DriftConfig = field(default_factory=DriftConfig)
    # warm every bucket of the ladder before a load becomes visible
    prewarm_ladder: bool = True
    # export-time opt-in (`shifu.serving.aot-pack` / `export --aot-pack`):
    # the AOT pack of the bucket ladder's programs and their kernels
    # inside the artifact (export/aot.py), so a new daemon starts without
    # tracing or building
    aot_pack: bool = False

    def validate(self) -> None:
        if self.engine not in ENGINES:
            raise ConfigError(
                f"serving.engine must be one of {'/'.join(ENGINES)} (the "
                "port's torch and export stand in for the JAX package's "
                f"jax and stablehlo): {self.engine!r}")
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
        if self.report_every_s < 0:
            raise ConfigError("serving.report_every_s must be >= 0")
        if not (0 <= self.port <= 65535):
            raise ConfigError(f"serving.port out of range: {self.port}")
        if self.trace_sample < 0:
            raise ConfigError("serving.trace_sample must be >= 0 "
                              f"(0 = off, N = 1-in-N): {self.trace_sample}")
        if self.trace_exemplars < 0:
            raise ConfigError("serving.trace-exemplars must be >= 0: "
                              f"{self.trace_exemplars}")
        if self.slo_p99_ms < 0:
            raise ConfigError(
                f"serving.slo.p99-ms must be >= 0: {self.slo_p99_ms}")
        if not (0 <= self.slo_error_rate < 1):
            raise ConfigError("serving.slo.error-rate must be in [0, 1): "
                              f"{self.slo_error_rate}")
        if not (0 <= self.slo_availability < 1):
            raise ConfigError("serving.slo.availability must be in [0, 1): "
                              f"{self.slo_availability}")
        if self.slo_fast_window_s <= 0 \
                or self.slo_slow_window_s < self.slo_fast_window_s:
            raise ConfigError(
                "serving SLO windows need 0 < slo_fast_window_s <= "
                f"slo_slow_window_s: {self.slo_fast_window_s}/"
                f"{self.slo_slow_window_s}")
        if self.slo_burn_threshold < 1:
            raise ConfigError("serving.slo.burn-threshold must be >= 1: "
                              f"{self.slo_burn_threshold}")
        self.drift.validate()

    def replace(self, **kw) -> "ServingConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class FleetConfig:
    """Knobs for the serving fleet (the `fleet` command, runtime/fleet.py):
    a field-for-field copy of the JAX package's `FleetConfig` with the
    same defaults and checks.

    XML spelling `shifu.fleet.*` (utils/xmlconfig.fleet_config_from_conf)
    layers under the CLI flags as ServingConfig's keys do: N scoring
    daemons and hot standbys, heartbeat membership, a routing front end,
    and burn-rate-driven scale decisions."""

    # active scoring daemons the manager keeps in rotation
    n_daemons: int = 2
    # pre-warmed hot standbys (loaded on the current artifact, wire
    # server bound, OUT of rotation) promoted on a member failure
    standbys: int = 1
    # heartbeat cadence: every member writes a lease this often; a lease
    # older than heartbeat_every_s * heartbeat_misses marks the member
    # DOWN and triggers failover
    heartbeat_every_s: float = 0.5
    heartbeat_misses: int = 3
    # router: per-request round-trip timeout before the one hedged retry
    # to a healthy peer, and the connect timeout for (re)building a
    # member connection
    route_timeout_ms: float = 1000.0
    connect_timeout_ms: float = 250.0
    # overload shedding: a primary whose fast-window slo_burn_rate is at
    # or above this routes around to the least-burned member
    shed_burn: float = 1.0
    # decorrelated-jitter reconnect backoff bounds for a member the
    # router observed failing (same shape as fsio's retry ladder)
    backoff_base_ms: float = 50.0
    backoff_cap_ms: float = 2000.0
    # scale loop: 0 disables; both burn windows must agree (fast AND
    # slow >= scale_up_burn on the worst member -> spawn; fast AND slow
    # <= scale_down_burn on every member -> retire) with a cooldown
    # between decisions
    scale_every_s: float = 0.0
    scale_up_burn: float = 2.0
    scale_down_burn: float = 0.25
    scale_cooldown_s: float = 30.0
    min_daemons: int = 1
    max_daemons: int = 8
    # consistent-ring virtual nodes per member (per-model routing)
    vnodes: int = 32
    # --- host plane (cross-host fleet) ---
    # launcher/pod.py host grammar: "" = single-host in-proc fleet (the
    # pre-host-plane behavior), "local:N" = N simulated hosts (tier-1
    # drills), "h1,h2"/"@file" = one `serve` member per slot over ssh
    hosts: str = ""
    # member spawn mode: "auto" (in-proc on local transport, process on
    # ssh), or force "inproc"/"process"
    member_mode: str = "auto"
    # first wire port for process-mode members (member i binds base+i)
    member_port_base: int = 8600
    # atomic artifact sync: each host pulls the export once, verifies it
    # against the exporter's blake2b manifest, atomically renames into
    # its cache, and only then swaps (torn/corrupt pulls quarantine the
    # member; the old version keeps serving)
    sync_artifacts: bool = True
    # split-brain guard: a DOWN member whose lease resurrects (partition
    # healed) rejoins as a STANDBY — never re-promoted into its old slot
    rejoin_standby: bool = True
    # fleet timeline (obs/timeline.py): estimate per-host clock offsets
    # from lease round-trips and merge member journals in the corrected
    # order; off = raw per-journal timestamps (debugging the estimator)
    timeline_skew_correct: bool = True
    # clamp on any single host's estimated |offset| — a lease stamped by
    # a wildly wrong clock must not fling the merged timeline
    timeline_max_offset_s: float = 300.0

    @property
    def heartbeat_ttl_s(self) -> float:
        """Lease freshness bound: miss this many beats -> DOWN."""
        return self.heartbeat_every_s * self.heartbeat_misses

    def validate(self) -> None:
        if self.n_daemons < 1:
            raise ConfigError(f"fleet.n-daemons must be >= 1: "
                              f"{self.n_daemons}")
        if self.standbys < 0:
            raise ConfigError(f"fleet.standbys must be >= 0: "
                              f"{self.standbys}")
        if self.heartbeat_every_s <= 0:
            raise ConfigError("fleet.heartbeat-every-s must be > 0: "
                              f"{self.heartbeat_every_s}")
        if self.heartbeat_misses < 1:
            raise ConfigError("fleet.heartbeat-misses must be >= 1: "
                              f"{self.heartbeat_misses}")
        if self.route_timeout_ms <= 0 or self.connect_timeout_ms <= 0:
            raise ConfigError("fleet.route-timeout-ms and "
                              "connect-timeout-ms must be > 0")
        if self.shed_burn <= 0:
            raise ConfigError(f"fleet.shed-burn must be > 0: "
                              f"{self.shed_burn}")
        if self.backoff_base_ms <= 0 \
                or self.backoff_cap_ms < self.backoff_base_ms:
            raise ConfigError(
                "fleet backoff needs 0 < backoff-base-ms <= "
                f"backoff-cap-ms: {self.backoff_base_ms}/"
                f"{self.backoff_cap_ms}")
        if self.scale_every_s < 0 or self.scale_cooldown_s < 0:
            raise ConfigError("fleet.scale-every-s and scale-cooldown-s "
                              "must be >= 0")
        if self.scale_down_burn < 0 \
                or self.scale_up_burn <= self.scale_down_burn:
            raise ConfigError(
                "fleet scale thresholds need 0 <= scale-down-burn < "
                f"scale-up-burn: {self.scale_down_burn}/"
                f"{self.scale_up_burn}")
        if not (1 <= self.min_daemons <= self.max_daemons):
            raise ConfigError(
                "fleet daemon bounds need 1 <= min-daemons <= "
                f"max-daemons: {self.min_daemons}/{self.max_daemons}")
        if not (self.min_daemons <= self.n_daemons <= self.max_daemons):
            raise ConfigError(
                f"fleet.n-daemons ({self.n_daemons}) must sit within "
                f"[min-daemons, max-daemons] = [{self.min_daemons}, "
                f"{self.max_daemons}]")
        if self.vnodes < 1:
            raise ConfigError(f"fleet.vnodes must be >= 1: {self.vnodes}")
        if self.member_mode not in ("auto", "inproc", "process"):
            raise ConfigError(
                "fleet.member-mode must be auto/inproc/process: "
                f"{self.member_mode!r}")
        if not (0 < self.member_port_base < 65536):
            raise ConfigError(
                f"fleet.member-port-base out of range: "
                f"{self.member_port_base}")
        if self.timeline_max_offset_s <= 0:
            raise ConfigError(
                "fleet.timeline-max-offset-s must be > 0: "
                f"{self.timeline_max_offset_s}")
        if self.hosts:
            # fail at config time, not at fleet start: the same grammar
            # parse_hosts uses later, minus the file read for @lists
            h = self.hosts.strip()
            if h.startswith("local:"):
                try:
                    n = int(h.split(":", 1)[1])
                except ValueError:
                    n = 0
                if n < 1:
                    raise ConfigError(
                        f"fleet.hosts {self.hosts!r}: need local:N "
                        "with N >= 1")
            elif not h.startswith("@") \
                    and not [x for x in h.split(",") if x.strip()]:
                raise ConfigError(f"fleet.hosts {self.hosts!r}: no hosts")


@dataclass(frozen=True)
class DataConfig:
    """Input pipeline configuration; every field of the JAX `DataConfig`,
    same defaults and checks.

    The port's input plane (`data/pipeline.py`, `train/loop.py`) is
    single-host.  It reads `stream_first_epoch` (a job given files streams
    its first epoch unless the projected cache is hot), `staged`,
    `drop_remainder` and `device_resident_bytes` (the resident, staged and
    per-batch tiers, by the JAX loop's rule), `block_batches` (the staged
    chunk, capped at ~32 MB of wire bytes), `overlap_epochs` (the
    cross-epoch `EpochFeeder`), `prefetch_depth` (its host queue; 0 = auto,
    which resizes its device queue per epoch), `prefetch` (its device
    queue, or the per-epoch producer's), `cache_dir` and `cache_format`
    (the parse-once cache, `data/cache.py`), `ingest_workers` and
    `read_threads` (the parse pool), and `out_of_core` (memory-mapped
    consolidated arrays, `data/outofcore.py`).  `host_shard` is a pod's
    shard-assignment mode (`data/pipeline.host_shard_assignment`).
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
    """The device flight recorder's knobs (obs/devprof.py), checked as the
    JAX package checks them."""

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
    fields are validated as the JAX package validates them and, as there,
    read by no loop: `embed/tiering.TieredTable` is built by its caller."""

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
    """The device mesh, as in the JAX package: axis sizes (`shifu.mesh.*`)
    and `axis_order`, the row-major layout of the ranks over the axes
    (`parallel/mesh.make_mesh`): data parallelism over `data`, split
    tables, experts and ruled leaves over `model`, ring and Ulysses
    attention over `seq`, a pipelined trunk over `pipe`."""

    data: int = 1
    model: int = 1
    seq: int = 1
    pipe: int = 1
    axis_order: tuple[str, ...] = ("data", "seq", "pipe", "model")

    @property
    def num_devices(self) -> int:
        return self.data * self.model * self.seq * self.pipe

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
    """Checkpoint settings, read by `train/loop.train` and
    `train/checkpoint.py` as in the JAX package; a remote `directory`
    (gs:// hdfs:// mock://) goes through `data/fsio.py`."""

    directory: str = ""
    save_every_epochs: int = 1
    save_every_seconds: int = 0
    max_to_keep: int = 3
    resume: bool = True
    async_save: bool = False


@dataclass(frozen=True)
class RuntimeConfig:
    """Job-level runtime settings of the JAX package.  The port's launcher
    (`launcher/cli.py`) reads `app_name`, `timeout_seconds`,
    `max_restarts`, `liveness_seconds`, `final_model_path`,
    `checkpoint`, the Kerberos pair and `mesh` (`train` spawns one rank
    per device of a mesh larger than one).  `distributed` is carried and
    read nowhere, as in the JAX package: a rank joins its process group
    from the environment contract (`parallel/distributed.initialize`).
    `param_sharding_rules` place leaves over the mesh's axes
    (`parallel/sharding.py`), and `min_hosts` is the floor of a pod's
    elastic reshape (`launcher/pod.supervise_pod`)."""

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
