from .schema import (CheckpointConfig, ColumnSpec, ConfigError, DataConfig,
                     DataSchema, JobConfig, ModelSpec, OptimizerConfig,
                     RuntimeConfig, ServingConfig, TrainConfig)
from .shifu_compat import (job_config_from_shifu, parse_column_config,
                           parse_model_config)

__all__ = ["CheckpointConfig", "ColumnSpec", "ConfigError", "DataConfig",
           "DataSchema", "JobConfig", "ModelSpec", "OptimizerConfig",
           "RuntimeConfig", "ServingConfig", "TrainConfig",
           "job_config_from_shifu", "parse_column_config",
           "parse_model_config"]
