from .schema import (ColumnSpec, ConfigError, DataSchema, ModelSpec,
                     ServingConfig)

__all__ = ["ColumnSpec", "ConfigError", "DataSchema", "ModelSpec",
           "ServingConfig"]
