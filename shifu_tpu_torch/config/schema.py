"""Typed configuration: the part of shifu_tpu's `config/schema.py` that the
serving path reads.

`ColumnSpec`, `DataSchema` and `ModelSpec` are field-for-field copies of the
JAX package's dataclasses, so the `schema` and `model_spec` dicts that an
artifact's `topology.json` carries parse unchanged (`_from_dict`).
`ServingConfig` keeps only the knobs the port's daemon uses.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any


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


VALID_MODEL_TYPES = ("mlp", "wide_deep", "deepfm", "multitask",
                     "ft_transformer", "moe_mlp")
VALID_ACTIVATIONS = ("sigmoid", "tanh", "relu", "leakyrelu")


@dataclass(frozen=True)
class ModelSpec:
    """Model topology; every field of the JAX `ModelSpec`, same defaults.

    The port reads `model_type`, the MLP fields, the FT-Transformer fields,
    `fused_block` and the dtypes.  The rest (`attention_impl` other than
    "local", `pipeline_*`, `num_experts`, `remat`, `dropout_rate`) belong to
    training or to model types that later slices port; they are kept so
    that any artifact's `model_spec` parses.
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
