"""Ingestion of unchanged Shifu `ModelConfig.json` / `ColumnConfig.json`
(port of shifu_tpu/config/shifu_compat.py: same mapping, same checks).

Compatibility north star: the Shifu pipeline (`init -> stats -> normalize ->
train -> eval`) keeps its JSON contracts; only the train/eval backends change.
The reference consumes these files in two places:

- the Java client ships them into every container
  (reference: yarn/client/TensorflowClient.java:356-382) and derives
  SELECTED_COLUMN_NUMS / TARGET_COLUMN_NUM / WEIGHT_COLUMN_NUM env vars
  (yarn/container/TensorflowTaskExecutor.java:200-238);
- the Python trainer reads topology + hyperparameters from
  ModelConfig.json train params NumHiddenLayers / NumHiddenNodes /
  ActivationFunc / LearningRate and train.numTrainEpochs
  (reference: resources/ssgd_monitor.py:91-107,177-183).

This module maps both files onto the typed `JobConfig` tree.
"""

from __future__ import annotations

import json
from typing import Any, Optional, Sequence

from .schema import (
    ColumnSpec,
    ConfigError,
    DataConfig,
    DataSchema,
    JobConfig,
    ModelSpec,
    OptimizerConfig,
    TrainConfig,
)


def parse_bool(value: Any) -> bool:
    """Config bools arrive string-typed from Shifu JSON params:
    'false'/'0'/'no' must read as False (bool('false') would be True)."""
    if isinstance(value, str):
        return value.strip().lower() in ("true", "1", "yes")
    return bool(value)


# Shifu columnFlag values (from Shifu's ColumnConfig model)
_FLAG_TARGET = "Target"
_FLAG_WEIGHT = "Weight"
_FLAG_META = "Meta"
_FLAG_FORCE_SELECT = "ForceSelect"
_FLAG_FORCE_REMOVE = "ForceRemove"

_ACTIVATION_ALIASES = {
    "sigmoid": "sigmoid",
    "tanh": "tanh",
    "relu": "relu",
    "leakyrelu": "leakyrelu",
    "leaky_relu": "leakyrelu",
}

# Shifu `train.algorithm` / params -> shifu_tpu model_type
_ALGORITHM_TO_MODEL_TYPE = {
    "NN": "mlp",
    "TENSORFLOW": "mlp",
    "WDL": "wide_deep",
    "WIDEDEEP": "wide_deep",
    "WIDE_DEEP": "wide_deep",
    "DEEPFM": "deepfm",
    "MTL": "multitask",
    "MULTITASK": "multitask",
    "FTTRANSFORMER": "ft_transformer",
    "FT_TRANSFORMER": "ft_transformer",
    "MOE": "moe_mlp",
    "MOE_MLP": "moe_mlp",
}


def _norm_delimiter(value: Any) -> str:
    """dataSet.dataDelimiter is a Java regex in Shifu: unescape escaped
    literal characters ("\\|" -> "|", "\\t" -> tab); empty/missing means
    the pipe default.  Regex character classes ("\\s", "\\d", ...) have no
    literal-delimiter equivalent and are rejected up front rather than
    silently splitting rows on a letter; likewise anything that unescapes
    to more than one character (e.g. "\\|\\|") is a regex pattern, not a
    delimiter, and would silently split nothing if taken literally."""
    d = str(value or "|")
    out: list[str] = []
    unescaped_meta = False
    i = 0
    while i < len(d):
        c = d[i]
        if c == "\\" and i + 1 < len(d):
            nxt = d[i + 1]
            if nxt == "t":
                out.append("\t")
            elif not nxt.isalnum():  # escaped punctuation: the literal char
                out.append(nxt)
            else:
                raise ConfigError(
                    f"dataSet.dataDelimiter {d!r} contains the regex "
                    f"character class \\{nxt}; use a literal delimiter "
                    "character instead")
            i += 2
            continue
        if c in "|.*+?()[]{}^$":
            unescaped_meta = True
        out.append(c)
        i += 1
    lit = "".join(out)
    # metachar-free multi-char strings ("::", or fully escaped "\\|\\|")
    # are literal delimiters under Java regex too — the reader's multi-char
    # split path handles them.  Multi-char strings with UNESCAPED
    # metacharacters ("||" = alternation) are genuine regex patterns with
    # no literal-delimiter equivalent: reject rather than split on the
    # wrong literal.  (A lone unescaped metachar keeps its historical
    # literal reading — "|" is the default delimiter.)
    if len(lit) > 1 and unescaped_meta:
        raise ConfigError(
            f"dataSet.dataDelimiter {d!r} is a multi-character regex "
            "pattern with unescaped metacharacters; escape them "
            "(e.g. '\\\\|\\\\|') or use a literal delimiter")
    return lit


def _norm_activation(name: Optional[str]) -> str:
    # Reference: unknown/None activation falls back to leaky_relu
    # (ssgd_monitor.py:77-90).
    if not name:
        return "leakyrelu"
    return _ACTIVATION_ALIASES.get(str(name).lower(), "leakyrelu")


def load_json(path: str) -> Any:
    with open(path, "r") as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# ColumnConfig.json -> DataSchema
# ---------------------------------------------------------------------------

def parse_column_config(
    column_config: Sequence[dict[str, Any]],
    target_column_name: Optional[str] = None,
    weight_column_name: Optional[str] = None,
    multi_target_names: Optional[Sequence[str]] = None,
) -> DataSchema:
    """Build a DataSchema from Shifu's ColumnConfig.json list.

    Selection semantics mirror the reference's env-var derivation: selected
    features are `finalSelect` columns that are not target/weight/meta; the
    target/weight columns come from flags or from ModelConfig's dataSet
    section.  A column is categorical when columnType == "C".
    """
    columns: list[ColumnSpec] = []
    target_index = -1
    weight_index = -1
    selected: list[int] = []
    multi_targets = list(multi_target_names or [])
    target_index_by_name: dict[str, int] = {}

    for entry in column_config:
        index = int(entry.get("columnNum", entry.get("index", len(columns))))
        name = str(entry.get("columnName", f"col_{index}"))
        flag = entry.get("columnFlag")
        ctype = str(entry.get("columnType", "N") or "N").upper()
        final_select = bool(entry.get("finalSelect", False))

        is_target = (flag == _FLAG_TARGET) or (
            target_column_name is not None and name == target_column_name) or (
            name in multi_targets)
        if name in multi_targets:
            target_index_by_name[name] = index
        is_weight = (flag == _FLAG_WEIGHT) or (
            weight_column_name is not None and name == weight_column_name)
        is_meta = flag == _FLAG_META
        is_categorical = ctype.startswith("C")

        vocab_size = 0
        if is_categorical:
            binning = entry.get("columnBinning") or {}
            categories = binning.get("binCategory") or entry.get("binCategory") or []
            # +1 for the unseen/missing bucket, matching Shifu's binning where
            # unknown categories land in an extra bin.
            vocab_size = len(categories) + 1 if categories else 0

        is_selected = final_select and not (is_target or is_weight or is_meta)
        spec = ColumnSpec(
            index=index,
            name=name,
            is_target=is_target,
            is_weight=is_weight,
            is_selected=is_selected,
            is_categorical=is_categorical,
            vocab_size=vocab_size,
        )
        columns.append(spec)
        if is_target:
            target_index = index
        if is_weight:
            weight_index = index
        if is_selected:
            selected.append(index)

    if not selected:
        # Reference fallback: if no columns are selected, use every column
        # except target and weight (ssgd_monitor.py:388-393).
        selected = [c.index for c in columns
                    if not (c.is_target or c.is_weight or c.index in (target_index, weight_index))]
        columns = [ColumnSpec(**{**c.__dict__, "is_selected": c.index in set(selected)})
                   for c in columns]

    target_indices = tuple(target_index_by_name[n] for n in multi_targets
                           if n in target_index_by_name)
    if target_indices and target_index < 0:
        target_index = target_indices[0]
    schema = DataSchema(
        columns=tuple(columns),
        target_index=target_index,
        weight_index=weight_index,
        selected_indices=tuple(sorted(selected)),
        target_indices=target_indices,
    )
    schema.validate()
    return schema


# ---------------------------------------------------------------------------
# ModelConfig.json -> ModelSpec / TrainConfig / DataConfig pieces
# ---------------------------------------------------------------------------

def parse_model_config(model_config: dict[str, Any]) -> tuple[ModelSpec, TrainConfig, dict[str, Any]]:
    """Parse Shifu's ModelConfig.json `train` section.

    Returns (ModelSpec, TrainConfig, dataset_section) where dataset_section is
    ModelConfig's `dataSet` dict (for target/weight column names and the data
    path).
    """
    train = model_config.get("train", {}) or {}
    params = train.get("params", {}) or {}
    dataset = model_config.get("dataSet", {}) or {}

    num_hidden_layers = int(params.get("NumHiddenLayers", 1))
    hidden_nodes = [int(s) for s in params.get("NumHiddenNodes", [20])]
    activations = [_norm_activation(s) for s in params.get("ActivationFunc", [None])]
    # Clamp lists to NumHiddenLayers the way the reference indexes them
    # (ssgd_monitor.py:95-106 iterates range(num_hidden_layer)).
    if len(hidden_nodes) < num_hidden_layers:
        raise ConfigError(
            f"NumHiddenNodes has {len(hidden_nodes)} entries < NumHiddenLayers={num_hidden_layers}")
    hidden_nodes = hidden_nodes[:num_hidden_layers]
    if len(activations) < num_hidden_layers:
        activations = activations + [activations[-1]] * (num_hidden_layers - len(activations))
    activations = activations[:num_hidden_layers]

    algorithm = str(train.get("algorithm", "NN") or "NN").upper()
    model_type = _ALGORITHM_TO_MODEL_TYPE.get(algorithm, "mlp")
    # SAGN = the reference's local-SGD trainer (resources/SAGN.py): same MLP,
    # K=5 local plain-SGD updates per global sync (update_window=5,
    # SAGN.py:110-142); params.LocalSgdWindow overrides / enables it for any
    # algorithm
    local_sgd_window = int(params.get(
        "LocalSgdWindow", 5 if algorithm == "SAGN" else 0))
    # Explicit override hook for new model families wired through the Shifu
    # train step (BASELINE configs 2-5): params.ModelType wins over algorithm.
    if "ModelType" in params:
        model_type = str(params["ModelType"]).lower()

    head_names: list[str] = ["shifu_output_0"]
    num_heads = 1
    multi_targets = dataset.get("multiTargetColumnNames") or params.get("TargetNames")
    if model_type == "multitask" and multi_targets:
        num_heads = len(multi_targets)
        head_names = [f"shifu_output_{i}" for i in range(num_heads)]

    model_spec = ModelSpec(
        model_type=model_type,
        hidden_nodes=tuple(hidden_nodes),
        activations=tuple(activations),
        embedding_dim=int(params.get("EmbeddingDim", 16)),
        num_experts=int(params.get("NumExperts", 4)),
        num_heads=num_heads,
        head_names=tuple(head_names),
        num_layers=int(params.get("NumTransformerLayers",
                                  params.get("NumLayers", 3))),
        num_attention_heads=int(params.get("NumAttentionHeads", 8)),
        token_dim=int(params.get("TokenDim", 64)),
        dropout_rate=float(params.get("DropoutRate", 0.0)),
        attention_impl=str(params.get("AttentionImpl", "local")).lower(),
        pipeline_stages=int(params.get("PipelineStages", 1)),
        pipeline_microbatches=int(params.get("PipelineMicrobatches", 0)),
        remat=parse_bool(params.get("Remat", False)),
    )

    lr = float(params.get("LearningRate", 0.003))  # reference fallback 0.003 (ssgd_monitor.py:136)
    # An explicit params.Optimizer wins; otherwise legacy Propagation codes.
    # Local-SGD mode: the reference SAGN trainer ignores Propagation and
    # uses AdamOptimizer for BOTH its local window updates and the global
    # apply (the GradientDescentOptimizer lines are commented out —
    # SAGN.py:107-108,158-159).  The TPU local-SGD tier implements
    # plain-SGD local updates instead (per-replica adaptive state on
    # diverged replicas has no reference-sound semantics; see
    # TrainConfig.validate and PARITY.md "Local SGD"), so Optimizer
    # defaults to sgd here — a KNOWN, documented deviation from the
    # reference's optimizer family.
    if local_sgd_window > 0:
        opt_name = str(params.get("Optimizer", "sgd")).lower()
        # The param-averaging formulation advances the persistent params by
        # ~K*lr per window where the reference advanced by one LearningRate
        # step of the window-mean grad (SAGN.py:137-167); dividing the
        # mapped lr by K keeps a migrated SAGN config's effective step size
        # at its LearningRate instead of silently K x larger.
        lr = lr / local_sgd_window
    else:
        opt_name = str(params.get(
            "Optimizer", params.get("Propagation", "adadelta"))).lower()
    optimizer = OptimizerConfig(
        name=opt_name,
        learning_rate=lr,
        accumulate_steps=int(params.get("AccumulateSteps", 1)),
        schedule=str(params.get("LearningRateSchedule", "constant")).lower(),
        warmup_steps=int(params.get("WarmupSteps", 0)),
        decay_steps=int(params.get("DecaySteps", 0)),
        decay_rate=float(params.get("DecayRate", 0.96)),
        end_lr_factor=float(params.get("EndLearningRateFactor", 0.0)),
    )
    # Shifu Propagation codes (Q=quick/adadelta-era encog codes) all map to the
    # reference backend's single behavior: Adadelta (ssgd_monitor.py:140).
    if optimizer.name in ("q", "b", "r", "quick", "back", "resilient"):
        import dataclasses as _dc
        optimizer = _dc.replace(optimizer, name="adadelta")

    # Shifu ModelConfigs conventionally carry Loss='squared' (which the
    # reference ignored, always using weighted MSE — ssgd_monitor.py:129) or
    # 'log'; map those onto the equivalent losses here.
    loss_name = str(params.get("Loss", "weighted_mse")).lower()
    loss_name = {"squared": "weighted_mse", "log": "weighted_bce"}.get(loss_name, loss_name)
    train_config = TrainConfig(
        epochs=int(train.get("numTrainEpochs", 100)),
        loss=loss_name,
        optimizer=optimizer,
        bagging_sample_rate=float(train.get("baggingSampleRate", 1.0)),
        early_stop_patience=int(params.get("EarlyStopPatience", 0)),
        early_stop_min_delta=float(params.get("EarlyStopMinDelta", 0.0)),
        local_sgd_window=local_sgd_window,
    )
    train_config.validate()
    model_spec.validate()
    return model_spec, train_config, dataset


# ---------------------------------------------------------------------------
# Whole-job assembly
# ---------------------------------------------------------------------------

def job_config_from_shifu(
    model_config_path: str,
    column_config_path: str,
    data_paths: Sequence[str] = (),
    **overrides: Any,
) -> JobConfig:
    """Build a complete JobConfig from unchanged Shifu JSON files.

    `overrides` are applied onto the top-level JobConfig via dataclasses.replace
    (e.g. runtime=..., data=...).
    """
    model_config = load_json(model_config_path)
    model_spec, train_config, dataset = parse_model_config(model_config)

    column_config = load_json(column_config_path)
    schema = parse_column_config(
        column_config,
        target_column_name=dataset.get("targetColumnName"),
        weight_column_name=dataset.get("weightColumnName"),
        multi_target_names=dataset.get("multiTargetColumnNames"),
    )

    valid_ratio = float((model_config.get("train") or {}).get("validSetRate", 0.1))
    paths = tuple(data_paths)
    if not paths:
        data_path = dataset.get("dataPath") or ""
        if data_path:
            paths = (str(data_path),)

    # dataSet.dataDelimiter rides into the reader (the reference hardcoded
    # '|' regardless — ssgd_monitor.py row split).  Shifu treats the field
    # as a Java regex, so configs commonly carry escaped forms ("\\|",
    # "\\t"); normalize those to the literal character.
    data_config = DataConfig(paths=paths, valid_ratio=valid_ratio,
                             delimiter=_norm_delimiter(
                                 dataset.get("dataDelimiter")))

    job = JobConfig(schema=schema, data=data_config, model=model_spec, train=train_config)
    if overrides:
        job = job.replace(**overrides)
    return job.validate()
