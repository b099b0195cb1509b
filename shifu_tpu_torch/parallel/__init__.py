"""Multi-device training on torch.distributed (port of shifu_tpu/parallel):
the mesh of ranks and its process groups (`mesh`), batch and parameter
placement (`sharding`), process-group bring-up and the collectives
(`distributed`, with the collectives that carry a gradient), GPipe over
the `pipe` axis (`pipeline`), and the local rank spawner of `train
--devices N` and of a pod's host with several cards (`launch`)."""

from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    SEQ_AXIS,
    data_parallel_mesh,
    host_shard_info,
    make_mesh,
)
from .pipeline import pipeline_apply, pipeline_reference
from .sharding import (
    DEFAULT_RULES,
    batch_sharding,
    batch_spec,
    param_shardings,
    param_specs,
    place_opt_state,
    place_params,
    replicated,
    shard_batch,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "PIPE_AXIS",
    "SEQ_AXIS",
    "pipeline_apply",
    "pipeline_reference",
    "data_parallel_mesh",
    "host_shard_info",
    "make_mesh",
    "DEFAULT_RULES",
    "batch_sharding",
    "batch_spec",
    "param_shardings",
    "param_specs",
    "place_opt_state",
    "place_params",
    "replicated",
    "shard_batch",
]
