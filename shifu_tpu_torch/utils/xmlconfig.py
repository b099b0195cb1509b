"""Hadoop-style XML configuration ingestion (`shifu.*` key namespace):
the port's copy of shifu_tpu/utils/xmlconfig.py.

The same XML files parse into a flat dict (`parse_configuration_xml`) and
map onto the port's typed JobConfig (`apply_to_job`) key for key, with the
JAX package's names, defaults and messages; `configuration_xml_bytes` /
`write_configuration_xml` serialize the merged view (the job dir's
`global-final.xml`).  Unknown keys are kept for forward compatibility.

The serving keys (`shifu.serving.*`, with the wire server's, the SLO
engine's and tracing's) and the drift keys (`shifu.drift.*`) map onto the
port's `ServingConfig` and `DriftConfig` (`serving_config_from_conf`,
`drift_config_from_conf`) as the JAX overlay's do.  The fleet keys
(`shifu.fleet.*`, ROADMAP.md queue A item (e)7) belong to a config the
port does not have yet, and `shifu.serving.aot-pack` to the AOT pack
((e)4): such a key raises NotImplementedError, never silently does
nothing.
"""

from __future__ import annotations

import dataclasses
import io
import xml.etree.ElementTree as ET
from typing import Any, Mapping


def parse_bool(value: Any) -> bool:
    """Config bools arrive string-typed from XML and Shifu JSON params:
    'false'/'0'/'no' must read as False (bool('false') would be True)."""
    if isinstance(value, str):
        return value.strip().lower() in ("true", "1", "yes")
    return bool(value)

# reference key namespace (GlobalConfigurationKeys.java)
KEY_EPOCHS = "shifu.application.epochs"
KEY_TIMEOUT = "shifu.application.timeout"
KEY_TRAINING_DATA_PATH = "shifu.application.training-data-path"
KEY_TMP_MODEL_PATH = "shifu.application.tmp-model-path"
KEY_FINAL_MODEL_PATH = "shifu.application.final-model-path"
KEY_APP_NAME = "shifu.application.name"
KEY_WORKER_INSTANCES = "shifu.worker.instances"
KEY_PS_INSTANCES = "shifu.ps.instances"
KEY_BACKUP_INSTANCES = "shifu.worker.instances.backup"
KEY_BATCH_SIZE = "shifu.application.batch-size"
KEY_MAX_RESTARTS = "shifu.application.max-restarts"
# time-based checkpoint cadence (reference parity: Supervisor
# save_model_secs — ssgd.py:124-128)
KEY_CKPT_SAVE_SECONDS = "shifu.checkpoint.save-seconds"
KEY_HEARTBEAT_INTERVAL = "shifu.task.heartbeat-interval-ms"
KEY_MAX_MISSED_HEARTBEATS = "shifu.task.max-missed-heartbeats"
# supervisor hang detection: board-progress window in seconds (successor of
# the AM heartbeat monitor, TensorflowApplicationMaster.java:63-112).  The
# reference heartbeat pair above is deliberately NOT mapped here: its
# semantics (1s task heartbeat x misses) don't transfer to a per-epoch
# board heartbeat — a migrated config carrying the reference defaults
# (1000ms x 25) would false-kill any epoch longer than 25s
KEY_LIVENESS_SECONDS = "shifu.liveness.seconds"
# elastic reshape floor: drop a permanently failing pod host and restart
# the gang smaller, down to this many hosts (RuntimeConfig.min_hosts;
# successor of the reference's >=95%-of-workers degraded start,
# TensorflowApplicationMaster.java:230-338)
KEY_MIN_HOSTS = "shifu.pod.min-hosts"
# device mesh topology (successor of shifu.{ps,worker}.instances container
# counts: the logical axes the one SPMD program shards over)
KEY_MESH_DATA = "shifu.mesh.data"
KEY_MESH_MODEL = "shifu.mesh.model"
KEY_MESH_SEQ = "shifu.mesh.seq"
KEY_MESH_PIPE = "shifu.mesh.pipe"
# input-pipeline knobs (no reference analog: its loader was fixed-function)
# secured-HDFS auth (successor of the reference's Kerberos delegation
# tokens, TensorflowClient.java:481-502)
KEY_KERBEROS_PRINCIPAL = "shifu.security.kerberos.principal"
KEY_KERBEROS_KEYTAB = "shifu.security.kerberos.keytab"
# custom parameter sharding (tensor parallelism from config):
# "path-regex=axis[,axis...]" entries joined by ";"; axis "none"/"" = that
# dim unsharded.  Example: ".*hidden_layer0.*kernel.*=none,model"
KEY_SHARDING_RULES = "shifu.sharding.rules"
KEY_DATA_CACHE_DIR = "shifu.data.cache-dir"
# cache entry format generation (DataConfig.cache_format): 0 = latest
# (v2 wire-format entries), 1 pins the legacy v1 layout for mixed-version
# cache dirs (data/cache.py)
KEY_DATA_CACHE_FORMAT = "shifu.data.cache-format"
KEY_DATA_OUT_OF_CORE = "shifu.data.out-of-core"
KEY_DATA_STAGED = "shifu.data.staged"
KEY_DATA_READ_THREADS = "shifu.data.read-threads"
# cold-ingest parse pool width (DataConfig.ingest_workers; 0 = auto —
# one worker per file capped at cpu_count)
KEY_DATA_INGEST_WORKERS = "shifu.data.ingest-workers"
# HBM budget for the device-resident input tier (bytes); datasets above it
# use the staged-blocks tier
KEY_DATA_RESIDENT_BYTES = "shifu.data.device-resident-bytes"
# features-on-the-wire dtype: auto / float32 / bfloat16 / int8 (int8 = the
# quantized wire, data/pipeline.wire_params; clip in normalized units)
KEY_DATA_WIRE_DTYPE = "shifu.data.wire-dtype"
KEY_DATA_WIRE_INT8_CLIP = "shifu.data.wire-int8-clip"
# compact target/weight wire: label auto/uint8/float32, weight
# auto/elide/float32 (DataConfig.wire_label_dtype / wire_weight_mode)
KEY_DATA_WIRE_LABEL_DTYPE = "shifu.data.wire-label-dtype"
KEY_DATA_WIRE_WEIGHT_MODE = "shifu.data.wire-weight-mode"
# in-HBM format of the device-resident tier: auto / wire / int8
# (DataConfig.resident_format; int8 quantizes resident feature blocks to
# the wire_params grid — ops/pallas_int8_matmul fuses the dequant)
KEY_DATA_RESIDENT_FORMAT = "shifu.data.resident-format"
# fused transformer block for ft_transformer: auto / on / off
# (ModelSpec.fused_block, ops/pallas_ft_block)
KEY_MODEL_FUSED_BLOCK = "shifu.model.fused-block"
# host-side input-feeder queue depth (DataConfig.prefetch_depth; 0 = auto —
# resized per epoch from the goodput ledger's exposed-input measurement)
KEY_DATA_PREFETCH_DEPTH = "shifu.data.prefetch-depth"
# cross-epoch overlap engine on/off (DataConfig.overlap_epochs)
KEY_DATA_OVERLAP_EPOCHS = "shifu.data.overlap-epochs"
# rows-touched-only embedding optimizer updates: auto / on / off
# (TrainConfig.sparse_embedding_update, train/sparse_embed.py)
KEY_TRAIN_SPARSE_EMBED = "shifu.train.sparse-embedding-update"
# pod data plane: host shard-assignment mode auto / static / rotate
# (DataConfig.host_shard, data/pipeline.host_shard_assignment)
KEY_DATA_HOST_SHARD = "shifu.data.host-shard"
# minimum train_scaling_efficiency accepted by the pod scaling sweep
# (TrainConfig.scaling_gate; 0 disables)
KEY_TRAIN_SCALING_GATE = "shifu.train.scaling-gate"
# device flight recorder (ObsConfig — obs/devprof.py, docs/OBSERVABILITY.md
# "Device flight recorder"): trace-window schedule
# (off/first/every:N/comma-list), capture dir, rollup size, HBM watermark
# polling, and the anomaly detector's ring/threshold
KEY_EMBED_DEDUP = "shifu.embed.dedup"
KEY_EMBED_TIERING = "shifu.embed.tiering"
KEY_EMBED_TIER_DTYPE = "shifu.embed.tier-dtype"
KEY_EMBED_HOT_ROWS = "shifu.embed.hot-rows"
KEY_EMBED_HOT_FRACTION = "shifu.embed.hot-fraction"
KEY_EMBED_COLD_DIR = "shifu.embed.cold-dir"
KEY_EMBED_PREFETCH = "shifu.embed.prefetch"
KEY_OBS_TRACE_EPOCHS = "shifu.obs.trace-epochs"
KEY_OBS_TRACE_DIR = "shifu.obs.trace-dir"
KEY_OBS_TRACE_TOP_K = "shifu.obs.trace-top-k"
KEY_OBS_HBM_WATERMARKS = "shifu.obs.hbm-watermarks"
KEY_OBS_ANOMALY_WINDOW = "shifu.obs.anomaly-window"
KEY_OBS_ANOMALY_ZSCORE = "shifu.obs.anomaly-zscore"
# serving plane (ServingConfig — runtime/serve.py, docs/SERVING.md):
# the scoring daemon's engine tier, micro-batcher knobs (latency budget /
# batch bounds / padded-bucket floor), admission limit, worker count,
# report cadence, and the wire server's bind address.  Standalone config
# (serving_config_from_conf), not a JobConfig overlay: serving is driven
# from an export artifact, not a training job.
KEY_SERVING_ENGINE = "shifu.serving.engine"
KEY_SERVING_LATENCY_BUDGET_MS = "shifu.serving.latency-budget-ms"
KEY_SERVING_MAX_BATCH = "shifu.serving.max-batch"
KEY_SERVING_MIN_BATCH_BUCKET = "shifu.serving.min-batch-bucket"
KEY_SERVING_QUEUE_LIMIT = "shifu.serving.queue-limit"
KEY_SERVING_WORKERS = "shifu.serving.workers"
KEY_SERVING_REPORT_EVERY_S = "shifu.serving.report-every-s"
KEY_SERVING_PORT = "shifu.serving.port"
KEY_SERVING_HOST = "shifu.serving.host"
# serving SLO engine (obs/slo.py, docs/OBSERVABILITY.md "Serving SLO
# engine"): request_trace sampling stride (1-in-N, 0 off), the three
# objectives (p99 ms / error-rate fraction / availability fraction, 0
# disables each), and the multiwindow burn-rate knobs
KEY_SERVING_TRACE_SAMPLE = "shifu.serving.trace-sample"
# distributed tracing (obs/tracing.py): p99-exemplar count the loadtest
# report carries (trace_ids of the N slowest requests)
KEY_SERVING_TRACE_EXEMPLARS = "shifu.serving.trace-exemplars"
KEY_SERVING_SLO_P99_MS = "shifu.serving.slo.p99-ms"
KEY_SERVING_SLO_ERROR_RATE = "shifu.serving.slo.error-rate"
KEY_SERVING_SLO_AVAILABILITY = "shifu.serving.slo.availability"
KEY_SERVING_SLO_FAST_WINDOW_S = "shifu.serving.slo.fast-window-s"
KEY_SERVING_SLO_SLOW_WINDOW_S = "shifu.serving.slo.slow-window-s"
KEY_SERVING_SLO_BURN_THRESHOLD = "shifu.serving.slo.burn-threshold"
# cold-start plane (export/aot.py, docs/SERVING.md "Cold start & AOT
# pack"): export-time AOT executable packing opt-in, and the
# full-ladder pre-warm a load/swap runs before its pointer flips
KEY_SERVING_AOT_PACK = "shifu.serving.aot-pack"
KEY_SERVING_PREWARM_LADDER = "shifu.serving.prewarm-ladder"
# drift observatory (DriftConfig nested under ServingConfig —
# obs/drift.py, docs/OBSERVABILITY.md "Drift observatory"): kill
# switch, fast/slow trailing windows, per-feature PSI + score-KL
# thresholds, worst-feature fan-out, minimum-rows gate, and the
# labeled-feedback (live AUC) path
KEY_DRIFT_ENABLED = "shifu.drift.enabled"
KEY_DRIFT_FAST_WINDOW_S = "shifu.drift.fast-window-s"
KEY_DRIFT_SLOW_WINDOW_S = "shifu.drift.slow-window-s"
KEY_DRIFT_PSI_THRESHOLD = "shifu.drift.psi-threshold"
KEY_DRIFT_SCORE_KL_THRESHOLD = "shifu.drift.score-kl-threshold"
KEY_DRIFT_TOP_K = "shifu.drift.top-k"
KEY_DRIFT_MIN_ROWS = "shifu.drift.min-rows"
KEY_DRIFT_FEEDBACK = "shifu.drift.feedback"
KEY_DRIFT_FEEDBACK_BINS = "shifu.drift.feedback-bins"
# serving fleet (FleetConfig — runtime/fleet.py, docs/SERVING.md "Fleet"):
# member/standby counts, heartbeat lease cadence + miss tolerance, the
# router's per-request/connect timeouts + reconnect backoff + overload
# shed threshold, and the burn-rate scale loop's windows and bounds
KEY_FLEET_N_DAEMONS = "shifu.fleet.n-daemons"
KEY_FLEET_STANDBYS = "shifu.fleet.standbys"
KEY_FLEET_HEARTBEAT_EVERY_S = "shifu.fleet.heartbeat-every-s"
KEY_FLEET_HEARTBEAT_MISSES = "shifu.fleet.heartbeat-misses"
KEY_FLEET_ROUTE_TIMEOUT_MS = "shifu.fleet.route-timeout-ms"
KEY_FLEET_CONNECT_TIMEOUT_MS = "shifu.fleet.connect-timeout-ms"
KEY_FLEET_SHED_BURN = "shifu.fleet.shed-burn"
KEY_FLEET_BACKOFF_BASE_MS = "shifu.fleet.backoff-base-ms"
KEY_FLEET_BACKOFF_CAP_MS = "shifu.fleet.backoff-cap-ms"
KEY_FLEET_SCALE_EVERY_S = "shifu.fleet.scale-every-s"
KEY_FLEET_SCALE_UP_BURN = "shifu.fleet.scale-up-burn"
KEY_FLEET_SCALE_DOWN_BURN = "shifu.fleet.scale-down-burn"
KEY_FLEET_SCALE_COOLDOWN_S = "shifu.fleet.scale-cooldown-s"
KEY_FLEET_MIN_DAEMONS = "shifu.fleet.min-daemons"
KEY_FLEET_MAX_DAEMONS = "shifu.fleet.max-daemons"
KEY_FLEET_VNODES = "shifu.fleet.vnodes"
KEY_FLEET_HOSTS = "shifu.fleet.hosts"
KEY_FLEET_MEMBER_MODE = "shifu.fleet.member-mode"
KEY_FLEET_MEMBER_PORT_BASE = "shifu.fleet.member-port-base"
KEY_FLEET_SYNC_ARTIFACTS = "shifu.fleet.sync-artifacts"
KEY_FLEET_REJOIN_STANDBY = "shifu.fleet.rejoin-standby"
# fleet timeline (obs/timeline.py): skew-corrected journal merge on/off
# and the clamp on any single host's estimated clock offset
KEY_FLEET_TIMELINE_SKEW_CORRECT = "shifu.fleet.timeline-skew-correct"
KEY_FLEET_TIMELINE_MAX_OFFSET_S = "shifu.fleet.timeline-max-offset-s"


def parse_sharding_rules(value: str) -> tuple:
    """Parse KEY_SHARDING_RULES: ';'-joined "regex=axis[,axis...]" entries
    into ((regex, (axis|None, ...)), ...) for RuntimeConfig.param_sharding_rules.

    '=' may appear inside the regex — the LAST '=' splits pattern from axes.
    Axis 'none' (any case) or '' means that dimension stays unsharded.
    """
    rules = []
    for entry in value.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        if "=" not in entry:
            raise ValueError(
                f"sharding rule {entry!r}: expected 'regex=axis[,axis...]'")
        pattern, _, axes_s = entry.rpartition("=")
        axes = tuple(None if a.strip().lower() in ("", "none") else a.strip()
                     for a in axes_s.split(","))
        rules.append((pattern.strip(), axes))
    return tuple(rules)


def parse_configuration_xml(path: str) -> dict[str, str]:
    """Parse one Hadoop `<configuration><property><name/><value/>` file.

    Tolerates the reference's quirk of concatenated XML documents in one file
    (global-default-bk.xml:183-188 contains two) by parsing only the first
    document and ignoring trailing garbage.
    """
    with open(path, "r") as f:
        text = f.read()
    # first <configuration>...</configuration> document only
    start = text.find("<configuration")
    if start < 0:
        raise ValueError(f"{path}: no <configuration> element")
    end = text.find("</configuration>", start)
    if end < 0:
        raise ValueError(f"{path}: unterminated <configuration>")
    doc = text[start:end + len("</configuration>")]
    root = ET.fromstring(doc)
    out: dict[str, str] = {}
    for prop in root.iter("property"):
        name = prop.findtext("name")
        value = prop.findtext("value")
        if name is not None and value is not None:
            out[name.strip()] = value.strip()
    return out


def layer_configs(*dicts: Mapping[str, str]) -> dict[str, str]:
    """Later dicts win — the reference's default <- user <- programmatic order."""
    merged: dict[str, str] = {}
    for d in dicts:
        merged.update(d)
    return merged


def configuration_xml_bytes(config: Mapping[str, str]) -> bytes:
    """The serialized XML as bytes — for remote (fsio) job dirs."""
    root = ET.Element("configuration")
    for name in sorted(config):
        prop = ET.SubElement(root, "property")
        ET.SubElement(prop, "name").text = name
        ET.SubElement(prop, "value").text = str(config[name])
    tree = ET.ElementTree(root)
    ET.indent(tree)
    buf = io.BytesIO()
    tree.write(buf, encoding="utf-8", xml_declaration=True)
    return buf.getvalue()


def write_configuration_xml(config: Mapping[str, str], path: str) -> None:
    """Serialize the merged config (the `global-final.xml` the reference wrote
    and localized into every container, TensorflowClient.java:389-403)."""
    with open(path, "wb") as f:
        f.write(configuration_xml_bytes(config))


_NOT_PORTED_PREFIXES = (("shifu.fleet.", "queue A item (e)7, with the "
                                         "serving fleet"),)

# serving keys whose ServingConfig field the port lacks
_SERVING_NOT_PORTED = {
    KEY_SERVING_AOT_PACK: "queue A item (e)4 (the AOT pack)",
}


def check_ported(conf: Mapping[str, str]) -> None:
    """Raise NotImplementedError for a fleet key: its config is not
    ported yet, and a key the port cannot honour must not be dropped
    without a word."""
    for key in sorted(conf):
        for prefix, item in _NOT_PORTED_PREFIXES:
            if key.startswith(prefix):
                raise NotImplementedError(
                    f"config key {key!r} is not ported yet (ROADMAP.md, "
                    f"{item})")


def serving_config_from_conf(conf: Mapping[str, str], base: Any = None) -> Any:
    """ServingConfig from `shifu.serving.*` and `shifu.drift.*` keys over
    `base` (default: the dataclass defaults), the serving-plane sibling of
    apply_to_job.  A fleet key, or `shifu.serving.aot-pack`, raises
    NotImplementedError."""

    from ..config.schema import ServingConfig

    check_ported(conf)
    for key in sorted(conf):
        if key in _SERVING_NOT_PORTED:
            raise NotImplementedError(
                f"config key {key!r} is not ported yet (ROADMAP.md, "
                f"{_SERVING_NOT_PORTED[key]})")
    base = base or ServingConfig()
    kw: dict[str, Any] = {}
    if KEY_SERVING_ENGINE in conf:
        kw["engine"] = conf[KEY_SERVING_ENGINE].strip().lower()
    if KEY_SERVING_LATENCY_BUDGET_MS in conf:
        kw["latency_budget_ms"] = float(conf[KEY_SERVING_LATENCY_BUDGET_MS])
    if KEY_SERVING_MAX_BATCH in conf:
        kw["max_batch"] = int(conf[KEY_SERVING_MAX_BATCH])
    if KEY_SERVING_MIN_BATCH_BUCKET in conf:
        kw["min_batch_bucket"] = int(conf[KEY_SERVING_MIN_BATCH_BUCKET])
    if KEY_SERVING_QUEUE_LIMIT in conf:
        kw["queue_limit"] = int(conf[KEY_SERVING_QUEUE_LIMIT])
    if KEY_SERVING_WORKERS in conf:
        kw["workers"] = int(conf[KEY_SERVING_WORKERS])
    if KEY_SERVING_REPORT_EVERY_S in conf:
        kw["report_every_s"] = float(conf[KEY_SERVING_REPORT_EVERY_S])
    if KEY_SERVING_PORT in conf:
        kw["port"] = int(conf[KEY_SERVING_PORT])
    if KEY_SERVING_HOST in conf:
        kw["host"] = conf[KEY_SERVING_HOST].strip()
    if KEY_SERVING_TRACE_SAMPLE in conf:
        kw["trace_sample"] = int(conf[KEY_SERVING_TRACE_SAMPLE])
    if KEY_SERVING_TRACE_EXEMPLARS in conf:
        kw["trace_exemplars"] = int(conf[KEY_SERVING_TRACE_EXEMPLARS])
    if KEY_SERVING_SLO_P99_MS in conf:
        kw["slo_p99_ms"] = float(conf[KEY_SERVING_SLO_P99_MS])
    if KEY_SERVING_SLO_ERROR_RATE in conf:
        kw["slo_error_rate"] = float(conf[KEY_SERVING_SLO_ERROR_RATE])
    if KEY_SERVING_SLO_AVAILABILITY in conf:
        kw["slo_availability"] = float(conf[KEY_SERVING_SLO_AVAILABILITY])
    if KEY_SERVING_SLO_FAST_WINDOW_S in conf:
        kw["slo_fast_window_s"] = float(conf[KEY_SERVING_SLO_FAST_WINDOW_S])
    if KEY_SERVING_SLO_SLOW_WINDOW_S in conf:
        kw["slo_slow_window_s"] = float(conf[KEY_SERVING_SLO_SLOW_WINDOW_S])
    if KEY_SERVING_SLO_BURN_THRESHOLD in conf:
        kw["slo_burn_threshold"] = float(
            conf[KEY_SERVING_SLO_BURN_THRESHOLD])
    if KEY_SERVING_PREWARM_LADDER in conf:
        kw["prewarm_ladder"] = parse_bool(conf[KEY_SERVING_PREWARM_LADDER])
    drift = drift_config_from_conf(conf, base.drift)
    if drift is not base.drift:
        kw["drift"] = drift
    return dataclasses.replace(base, **kw) if kw else base


def drift_config_from_conf(conf: Mapping[str, str], base: Any = None) -> Any:
    """DriftConfig from `shifu.drift.*` keys over `base` (default: the
    dataclass defaults); serving_config_from_conf calls it, so the daemon
    and the loadtest see the same drift knobs."""
    from ..config.schema import DriftConfig

    base = base or DriftConfig()
    kw: dict[str, Any] = {}
    _float_keys = {KEY_DRIFT_FAST_WINDOW_S: "fast_window_s",
                   KEY_DRIFT_SLOW_WINDOW_S: "slow_window_s",
                   KEY_DRIFT_PSI_THRESHOLD: "psi_threshold",
                   KEY_DRIFT_SCORE_KL_THRESHOLD: "score_kl_threshold"}
    _int_keys = {KEY_DRIFT_TOP_K: "top_k",
                 KEY_DRIFT_MIN_ROWS: "min_rows",
                 KEY_DRIFT_FEEDBACK_BINS: "feedback_bins"}
    _bool_keys = {KEY_DRIFT_ENABLED: "enabled",
                  KEY_DRIFT_FEEDBACK: "feedback"}
    for key, name in _float_keys.items():
        if key in conf:
            kw[name] = float(conf[key])
    for key, name in _int_keys.items():
        if key in conf:
            kw[name] = int(conf[key])
    for key, name in _bool_keys.items():
        if key in conf:
            kw[name] = parse_bool(conf[key])
    return dataclasses.replace(base, **kw) if kw else base


def apply_to_job(job: Any, conf: Mapping[str, str]) -> Any:
    """Overlay `shifu.*` keys onto a JobConfig (returns a new JobConfig).
    Serving and drift keys are the daemon's (`serving_config_from_conf`)
    and leave the job alone, as in the JAX overlay; a fleet key raises
    NotImplementedError (`check_ported`)."""
    check_ported(conf)
    train = job.train
    data = job.data
    runtime = job.runtime

    if KEY_EPOCHS in conf:
        # replace, not field-by-field reconstruction: an explicit list here
        # silently dropped newer TrainConfig fields (early stopping) when
        # the epochs key was set
        train = dataclasses.replace(train, epochs=int(conf[KEY_EPOCHS]))
    if KEY_BATCH_SIZE in conf:
        data = dataclasses.replace(data, batch_size=int(conf[KEY_BATCH_SIZE]))
    if KEY_TRAINING_DATA_PATH in conf and not data.paths:
        data = dataclasses.replace(
            data, paths=tuple(conf[KEY_TRAINING_DATA_PATH].split(",")))
    if KEY_DATA_CACHE_DIR in conf:
        data = dataclasses.replace(data, cache_dir=conf[KEY_DATA_CACHE_DIR])
    if KEY_DATA_CACHE_FORMAT in conf:
        data = dataclasses.replace(
            data, cache_format=int(conf[KEY_DATA_CACHE_FORMAT]))
    if KEY_DATA_INGEST_WORKERS in conf:
        data = dataclasses.replace(
            data, ingest_workers=int(conf[KEY_DATA_INGEST_WORKERS]))
    if KEY_DATA_OUT_OF_CORE in conf:
        data = dataclasses.replace(
            data, out_of_core=parse_bool(conf[KEY_DATA_OUT_OF_CORE]))
    if KEY_DATA_RESIDENT_BYTES in conf:
        data = dataclasses.replace(
            data, device_resident_bytes=int(conf[KEY_DATA_RESIDENT_BYTES]))
    if KEY_DATA_STAGED in conf:
        data = dataclasses.replace(
            data, staged=parse_bool(conf[KEY_DATA_STAGED]))
    if KEY_DATA_READ_THREADS in conf:
        data = dataclasses.replace(
            data, read_threads=int(conf[KEY_DATA_READ_THREADS]))
    if KEY_DATA_WIRE_DTYPE in conf:
        data = dataclasses.replace(
            data, wire_dtype=conf[KEY_DATA_WIRE_DTYPE].strip().lower())
    if KEY_DATA_WIRE_INT8_CLIP in conf:
        data = dataclasses.replace(
            data, wire_int8_clip=float(conf[KEY_DATA_WIRE_INT8_CLIP]))
    if KEY_DATA_WIRE_LABEL_DTYPE in conf:
        data = dataclasses.replace(
            data,
            wire_label_dtype=conf[KEY_DATA_WIRE_LABEL_DTYPE].strip().lower())
    if KEY_DATA_WIRE_WEIGHT_MODE in conf:
        data = dataclasses.replace(
            data,
            wire_weight_mode=conf[KEY_DATA_WIRE_WEIGHT_MODE].strip().lower())
    if KEY_DATA_RESIDENT_FORMAT in conf:
        data = dataclasses.replace(
            data,
            resident_format=conf[KEY_DATA_RESIDENT_FORMAT].strip().lower())
    if KEY_DATA_PREFETCH_DEPTH in conf:
        data = dataclasses.replace(
            data, prefetch_depth=int(conf[KEY_DATA_PREFETCH_DEPTH]))
    if KEY_DATA_OVERLAP_EPOCHS in conf:
        data = dataclasses.replace(
            data, overlap_epochs=parse_bool(conf[KEY_DATA_OVERLAP_EPOCHS]))
    if KEY_TRAIN_SPARSE_EMBED in conf:
        train = dataclasses.replace(
            train, sparse_embedding_update=(
                conf[KEY_TRAIN_SPARSE_EMBED].strip().lower()))
    if KEY_DATA_HOST_SHARD in conf:
        data = dataclasses.replace(
            data, host_shard=conf[KEY_DATA_HOST_SHARD].strip().lower())
    if KEY_TRAIN_SCALING_GATE in conf:
        train = dataclasses.replace(
            train, scaling_gate=float(conf[KEY_TRAIN_SCALING_GATE]))

    obs_kw: dict[str, Any] = {}
    if KEY_OBS_TRACE_EPOCHS in conf:
        obs_kw["trace_epochs"] = conf[KEY_OBS_TRACE_EPOCHS].strip().lower()
    if KEY_OBS_TRACE_DIR in conf:
        obs_kw["trace_dir"] = conf[KEY_OBS_TRACE_DIR]
    if KEY_OBS_TRACE_TOP_K in conf:
        obs_kw["trace_top_k"] = int(conf[KEY_OBS_TRACE_TOP_K])
    if KEY_OBS_HBM_WATERMARKS in conf:
        obs_kw["hbm_watermarks"] = parse_bool(conf[KEY_OBS_HBM_WATERMARKS])
    if KEY_OBS_ANOMALY_WINDOW in conf:
        obs_kw["anomaly_window"] = int(conf[KEY_OBS_ANOMALY_WINDOW])
    if KEY_OBS_ANOMALY_ZSCORE in conf:
        obs_kw["anomaly_zscore"] = float(conf[KEY_OBS_ANOMALY_ZSCORE])
    embed_kw: dict[str, Any] = {}
    if KEY_EMBED_DEDUP in conf:
        embed_kw["dedup"] = conf[KEY_EMBED_DEDUP].strip().lower()
    if KEY_EMBED_TIERING in conf:
        embed_kw["tiering"] = conf[KEY_EMBED_TIERING].strip().lower()
    if KEY_EMBED_TIER_DTYPE in conf:
        embed_kw["tier_dtype"] = conf[KEY_EMBED_TIER_DTYPE].strip().lower()
    if KEY_EMBED_HOT_ROWS in conf:
        embed_kw["hot_rows"] = int(conf[KEY_EMBED_HOT_ROWS])
    if KEY_EMBED_HOT_FRACTION in conf:
        embed_kw["hot_fraction"] = float(conf[KEY_EMBED_HOT_FRACTION])
    if KEY_EMBED_COLD_DIR in conf:
        embed_kw["cold_dir"] = conf[KEY_EMBED_COLD_DIR]
    if KEY_EMBED_PREFETCH in conf:
        embed_kw["prefetch"] = parse_bool(conf[KEY_EMBED_PREFETCH])
    rt_kw: dict[str, Any] = {}
    if KEY_TIMEOUT in conf:
        # reference timeout is milliseconds (client-side kill,
        # TensorflowClient.java:625-658)
        rt_kw["timeout_seconds"] = int(int(conf[KEY_TIMEOUT]) / 1000)
    if KEY_APP_NAME in conf:
        rt_kw["app_name"] = conf[KEY_APP_NAME]
    if KEY_FINAL_MODEL_PATH in conf:
        rt_kw["final_model_path"] = conf[KEY_FINAL_MODEL_PATH]
    if KEY_TMP_MODEL_PATH in conf:
        rt_kw["tmp_model_path"] = conf[KEY_TMP_MODEL_PATH]
        ck = dataclasses.replace(runtime.checkpoint,
                                 directory=conf[KEY_TMP_MODEL_PATH])
        rt_kw["checkpoint"] = ck
    if KEY_MAX_RESTARTS in conf:
        rt_kw["max_restarts"] = int(conf[KEY_MAX_RESTARTS])
    if KEY_MIN_HOSTS in conf:
        rt_kw["min_hosts"] = int(conf[KEY_MIN_HOSTS])
    if KEY_LIVENESS_SECONDS in conf:
        rt_kw["liveness_seconds"] = float(conf[KEY_LIVENESS_SECONDS])
    if KEY_CKPT_SAVE_SECONDS in conf:
        ck = rt_kw.get("checkpoint", runtime.checkpoint)
        rt_kw["checkpoint"] = dataclasses.replace(
            ck, save_every_seconds=int(conf[KEY_CKPT_SAVE_SECONDS]))
    if KEY_KERBEROS_PRINCIPAL in conf:
        rt_kw["kerberos_principal"] = conf[KEY_KERBEROS_PRINCIPAL]
    if KEY_KERBEROS_KEYTAB in conf:
        rt_kw["kerberos_keytab"] = conf[KEY_KERBEROS_KEYTAB]
    if KEY_SHARDING_RULES in conf:
        rt_kw["param_sharding_rules"] = parse_sharding_rules(
            conf[KEY_SHARDING_RULES])
    if (KEY_MESH_DATA in conf or KEY_MESH_MODEL in conf
            or KEY_MESH_SEQ in conf or KEY_MESH_PIPE in conf):
        rt_kw["mesh"] = dataclasses.replace(
            runtime.mesh,
            data=int(conf.get(KEY_MESH_DATA, runtime.mesh.data)),
            model=int(conf.get(KEY_MESH_MODEL, runtime.mesh.model)),
            seq=int(conf.get(KEY_MESH_SEQ, runtime.mesh.seq)),
            pipe=int(conf.get(KEY_MESH_PIPE, runtime.mesh.pipe)))
    if rt_kw:
        runtime = dataclasses.replace(runtime, **rt_kw)

    extra_kw: dict[str, Any] = {}
    if KEY_MODEL_FUSED_BLOCK in conf:
        extra_kw["model"] = dataclasses.replace(
            job.model,
            fused_block=conf[KEY_MODEL_FUSED_BLOCK].strip().lower())
    if obs_kw:
        # only touch `obs` when an obs key is actually set: job-shaped
        # stubs (and older serialized configs) without the field keep
        # working through the no-obs path
        from ..config.schema import ObsConfig
        base = getattr(job, "obs", None)
        extra_kw["obs"] = (dataclasses.replace(base, **obs_kw)
                           if base is not None else ObsConfig(**obs_kw))
    if embed_kw:
        # same pattern for the sparse embedding engine's group
        from ..config.schema import EmbedConfig
        base = getattr(job, "embed", None)
        extra_kw["embed"] = (dataclasses.replace(base, **embed_kw)
                             if base is not None else EmbedConfig(**embed_kw))
    return job.replace(train=train, data=data, runtime=runtime, **extra_kw)
