"""The port's Shifu XML overlay (shifu_tpu_torch/utils/xmlconfig.py)
against the JAX package's: the same XML through both packages'
`apply_to_job` gives equal job fields on every key the port carries, the
same errors, the same serialized `global-final.xml`; a drift or fleet key
raises NotImplementedError in the port."""

import json

import pytest

from shifu_tpu.config import schema as jax_schema
from shifu_tpu.utils import xmlconfig as jax_xml
from shifu_tpu_torch.config import schema as port_schema
from shifu_tpu_torch.utils import xmlconfig as xml

# every job key the port carries, with a non-default value
JOB_KEYS = {
    xml.KEY_EPOCHS: "7",
    xml.KEY_TIMEOUT: "90000",
    xml.KEY_TRAINING_DATA_PATH: "/data/a,/data/b",
    xml.KEY_TMP_MODEL_PATH: "/jobs/tmp_model",
    xml.KEY_FINAL_MODEL_PATH: "/jobs/final_model",
    xml.KEY_APP_NAME: "wdbc",
    xml.KEY_BATCH_SIZE: "512",
    xml.KEY_MAX_RESTARTS: "5",
    xml.KEY_CKPT_SAVE_SECONDS: "30",
    xml.KEY_LIVENESS_SECONDS: "600",
    xml.KEY_MIN_HOSTS: "2",
    xml.KEY_MESH_DATA: "1",
    xml.KEY_MESH_MODEL: "1",
    xml.KEY_KERBEROS_PRINCIPAL: "svc@EXAMPLE.COM",
    xml.KEY_KERBEROS_KEYTAB: "/etc/svc.keytab",
    xml.KEY_SHARDING_RULES: ".*kernel.*=none,model; .*bias=",
    xml.KEY_DATA_CACHE_DIR: "/cache",
    xml.KEY_DATA_CACHE_FORMAT: "1",
    xml.KEY_DATA_OUT_OF_CORE: "true",
    xml.KEY_DATA_STAGED: "false",
    xml.KEY_DATA_READ_THREADS: "3",
    xml.KEY_DATA_INGEST_WORKERS: "4",
    xml.KEY_DATA_RESIDENT_BYTES: "0",
    xml.KEY_DATA_WIRE_DTYPE: "INT8",
    xml.KEY_DATA_WIRE_INT8_CLIP: "6.5",
    xml.KEY_DATA_WIRE_LABEL_DTYPE: "uint8",
    xml.KEY_DATA_WIRE_WEIGHT_MODE: "elide",
    xml.KEY_DATA_RESIDENT_FORMAT: "int8",
    xml.KEY_MODEL_FUSED_BLOCK: "off",
    xml.KEY_DATA_PREFETCH_DEPTH: "0",
    xml.KEY_DATA_OVERLAP_EPOCHS: "no",
    xml.KEY_TRAIN_SPARSE_EMBED: "on",
    xml.KEY_DATA_HOST_SHARD: "rotate",
    xml.KEY_TRAIN_SCALING_GATE: "0.75",
    xml.KEY_EMBED_DEDUP: "off",
    xml.KEY_EMBED_TIERING: "host",
    xml.KEY_EMBED_TIER_DTYPE: "int8",
    xml.KEY_EMBED_HOT_ROWS: "1000",
    xml.KEY_EMBED_HOT_FRACTION: "0.25",
    xml.KEY_EMBED_COLD_DIR: "/cold",
    xml.KEY_EMBED_PREFETCH: "0",
    xml.KEY_OBS_TRACE_EPOCHS: "every:2",
    xml.KEY_OBS_TRACE_DIR: "/traces",
    xml.KEY_OBS_TRACE_TOP_K: "8",
    xml.KEY_OBS_HBM_WATERMARKS: "false",
    xml.KEY_OBS_ANOMALY_WINDOW: "16",
    xml.KEY_OBS_ANOMALY_ZSCORE: "4.5",
    # serving keys are the serving config's, ignored by apply_to_job
    xml.KEY_SERVING_MAX_BATCH: "2048",
    "shifu.unknown.key": "kept",
}

SERVING_KEYS = {
    xml.KEY_SERVING_ENGINE: "Torch",
    xml.KEY_SERVING_LATENCY_BUDGET_MS: "3.5",
    xml.KEY_SERVING_MAX_BATCH: "2048",
    xml.KEY_SERVING_MIN_BATCH_BUCKET: "32",
    xml.KEY_SERVING_QUEUE_LIMIT: "5000",
    xml.KEY_SERVING_WORKERS: "2",
    xml.KEY_SERVING_PREWARM_LADDER: "false",
}


def _jobs():
    return jax_schema.JobConfig(), port_schema.JobConfig()


def _write(tmp_path, conf, name="g.xml"):
    path = str(tmp_path / name)
    jax_xml.write_configuration_xml(conf, path)
    return path


def test_every_job_key_the_port_carries_matches_jax(tmp_path):
    path = _write(tmp_path, JOB_KEYS)
    conf = xml.parse_configuration_xml(path)
    assert conf == jax_xml.parse_configuration_xml(path) == JOB_KEYS
    jjob, pjob = _jobs()
    jd = jax_xml.apply_to_job(jjob, conf).to_dict()
    pd = xml.apply_to_job(pjob, conf).to_dict()
    assert json.loads(json.dumps(pd)) == json.loads(json.dumps(jd))
    assert pd["data"]["cache_dir"] == "/cache"
    assert pd["data"]["out_of_core"] is True
    assert pd["runtime"]["checkpoint"]["save_every_seconds"] == 30


@pytest.mark.parametrize("key", sorted(k for k in JOB_KEYS
                                       if k.startswith("shifu.")))
def test_each_key_alone_matches_jax(key):
    conf = {key: JOB_KEYS[key]}
    jjob, pjob = _jobs()
    assert (xml.apply_to_job(pjob, conf).to_dict()
            == jax_xml.apply_to_job(jjob, conf).to_dict())


@pytest.mark.parametrize("conf", [
    {xml.KEY_EPOCHS: "seven"},
    {xml.KEY_DATA_WIRE_INT8_CLIP: "wide"},
    {xml.KEY_SHARDING_RULES: "no-equals-sign"},
])
def test_a_bad_value_raises_the_same_error(conf):
    jjob, pjob = _jobs()
    with pytest.raises(ValueError) as want:
        jax_xml.apply_to_job(jjob, conf)
    with pytest.raises(ValueError) as got:
        xml.apply_to_job(pjob, conf)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("conf", [
    {xml.KEY_DATA_WIRE_DTYPE: "float16"},
    {xml.KEY_DATA_CACHE_FORMAT: "3"},
    {xml.KEY_EMBED_DEDUP: "always"},
    {xml.KEY_OBS_TRACE_EPOCHS: "sometimes"},
    {xml.KEY_TRAIN_SCALING_GATE: "1.5"},
])
def test_validation_rejects_alike(conf):
    schema = jax_schema.DataSchema(
        columns=(), target_index=0, selected_indices=(1, 2))
    pschema = port_schema.DataSchema(target_index=0, selected_indices=(1, 2))
    jjob = jax_xml.apply_to_job(jax_schema.JobConfig(schema=schema), conf)
    pjob = xml.apply_to_job(port_schema.JobConfig(schema=pschema), conf)
    with pytest.raises(jax_schema.ConfigError) as want:
        jjob.validate()
    with pytest.raises(port_schema.ConfigError) as got:
        pjob.validate()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("key,item", [
    (jax_xml.KEY_FLEET_N_DAEMONS, "(e)7"),
    (jax_xml.KEY_FLEET_HOSTS, "(e)7"),
])
def test_a_drift_or_fleet_key_raises_not_ported(key, item):
    """The fleet keys still raise; the drift keys apply
    (`test_drift_and_serving_keys_apply_like_jax`)."""
    conf = {xml.KEY_EPOCHS: "3", key: "1"}
    jjob, pjob = _jobs()
    jax_xml.apply_to_job(jjob, conf)  # the JAX overlay has no such field
    with pytest.raises(NotImplementedError, match=r"not ported yet.*"
                       + item.replace("(", r"\(").replace(")", r"\)")):
        xml.apply_to_job(pjob, conf)
    with pytest.raises(NotImplementedError):
        xml.serving_config_from_conf(conf)


def test_serving_keys_match_jax_where_the_port_has_the_field():
    from shifu_tpu.config.schema import ServingConfig as JaxServing
    got = xml.serving_config_from_conf(SERVING_KEYS)
    want = jax_xml.serving_config_from_conf(SERVING_KEYS,
                                            JaxServing(engine="torch"))
    for f in ("engine", "latency_budget_ms", "max_batch", "min_batch_bucket",
              "queue_limit", "workers", "prewarm_ladder"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.engine == "torch"


@pytest.mark.parametrize("key", [xml.KEY_SERVING_AOT_PACK])
def test_a_serving_key_without_a_port_field_raises(key):
    with pytest.raises(NotImplementedError, match=r"not ported yet.*\(e\)4"):
        xml.serving_config_from_conf({key: "1"})


# the keys of the wire server, tracing, the reporter, the SLO engine and
# drift, each set away from its default
WIRE_SLO_DRIFT_KEYS = {
    xml.KEY_SERVING_ENGINE: "numpy",
    xml.KEY_SERVING_REPORT_EVERY_S: "2.5",
    xml.KEY_SERVING_PORT: "0",
    xml.KEY_SERVING_HOST: " 0.0.0.0 ",
    xml.KEY_SERVING_TRACE_SAMPLE: "16",
    xml.KEY_SERVING_TRACE_EXEMPLARS: "3",
    xml.KEY_SERVING_SLO_P99_MS: "5",
    xml.KEY_SERVING_SLO_ERROR_RATE: "0.001",
    xml.KEY_SERVING_SLO_AVAILABILITY: "0.999",
    xml.KEY_SERVING_SLO_FAST_WINDOW_S: "1.5",
    xml.KEY_SERVING_SLO_SLOW_WINDOW_S: "600",
    xml.KEY_SERVING_SLO_BURN_THRESHOLD: "3",
    xml.KEY_DRIFT_ENABLED: "false",
    xml.KEY_DRIFT_FAST_WINDOW_S: "2",
    xml.KEY_DRIFT_SLOW_WINDOW_S: "600",
    xml.KEY_DRIFT_PSI_THRESHOLD: "0.2",
    xml.KEY_DRIFT_SCORE_KL_THRESHOLD: "0.05",
    xml.KEY_DRIFT_TOP_K: "3",
    xml.KEY_DRIFT_MIN_ROWS: "50",
    xml.KEY_DRIFT_FEEDBACK: "no",
    xml.KEY_DRIFT_FEEDBACK_BINS: "256",
}


@pytest.mark.parametrize("key", sorted(WIRE_SLO_DRIFT_KEYS))
def test_drift_and_serving_keys_apply_like_jax(key):
    """Each wire, tracing, SLO and drift key gives the JAX overlay's
    ServingConfig (and DriftConfig) field for field; the job overlay
    leaves the job alone in both packages."""
    import dataclasses as dc
    from shifu_tpu.config.schema import ServingConfig as JaxServing
    conf = {key: WIRE_SLO_DRIFT_KEYS[key]}
    got = xml.serving_config_from_conf(conf)
    # the port's default engine is "torch", the JAX package's "auto"
    want = jax_xml.serving_config_from_conf(conf, JaxServing(engine="torch"))
    want_d = dc.asdict(want)
    want_d.pop("aot_pack")
    assert dc.asdict(got) == want_d
    assert got != port_schema.ServingConfig()
    got.validate()
    jjob, pjob = _jobs()
    assert xml.apply_to_job(pjob, conf) == pjob
    assert jax_xml.apply_to_job(jjob, conf) == jjob


def test_all_serving_and_drift_keys_together_validate_alike():
    import dataclasses as dc
    got = xml.serving_config_from_conf(WIRE_SLO_DRIFT_KEYS)
    want = jax_xml.serving_config_from_conf(WIRE_SLO_DRIFT_KEYS)
    assert got.engine == want.engine == "numpy"
    want_d = dc.asdict(want)
    want_d.pop("aot_pack")
    assert dc.asdict(got) == want_d
    got.validate()
    want.validate()
    bad = {xml.KEY_DRIFT_FAST_WINDOW_S: "9", xml.KEY_DRIFT_SLOW_WINDOW_S: "3"}
    with pytest.raises(port_schema.ConfigError) as err:
        xml.serving_config_from_conf(bad).validate()
    with pytest.raises(jax_schema.ConfigError) as jerr:
        jax_xml.serving_config_from_conf(bad).validate()
    assert str(err.value) == str(jerr.value)


def test_serialization_is_byte_identical(tmp_path):
    conf = {**JOB_KEYS, "shifu.application.name": "a&b<c>"}
    assert (xml.configuration_xml_bytes(conf)
            == jax_xml.configuration_xml_bytes(conf))
    xml.write_configuration_xml(conf, str(tmp_path / "p.xml"))
    jax_xml.write_configuration_xml(conf, str(tmp_path / "j.xml"))
    assert ((tmp_path / "p.xml").read_bytes()
            == (tmp_path / "j.xml").read_bytes())


def test_concatenated_documents_parse_the_first_alike(tmp_path):
    text = ("<?xml version='1.0'?>\n<configuration><property><name>"
            "shifu.application.epochs</name><value> 4 </value></property>"
            "</configuration>\n<configuration><property><name>x</name>"
            "<value>y</value></property></configuration>\n")
    path = tmp_path / "two.xml"
    path.write_text(text)
    got = xml.parse_configuration_xml(str(path))
    assert got == jax_xml.parse_configuration_xml(str(path))
    assert got == {"shifu.application.epochs": "4"}
    (tmp_path / "none.xml").write_text("<x/>")
    for mod in (xml, jax_xml):
        with pytest.raises(ValueError, match="no <configuration>"):
            mod.parse_configuration_xml(str(tmp_path / "none.xml"))


def test_parse_bool_and_layering_match_jax():
    for v in ("true", "TRUE", " yes ", "1", "false", "no", "0", "", True, 0):
        assert xml.parse_bool(v) == jax_xml.parse_bool(v)
    a, b = {"k": "1", "x": "a"}, {"k": "2"}
    assert xml.layer_configs(a, b) == jax_xml.layer_configs(a, b)
    assert xml.parse_sharding_rules("a=b,none;c=d") \
        == jax_xml.parse_sharding_rules("a=b,none;c=d")
