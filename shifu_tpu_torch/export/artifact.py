"""The scoring artifact (port of shifu_tpu/export/artifact.py, the parts the
serving path needs).

An artifact is plain files, written and read the same way by both packages:

    <export_dir>/
      GenericModelConfig.json   # the Shifu sidecar
      topology.json             # format v1: model_spec, schema, metadata
      weights.npz               # params under `/`-joined Flax key names

The port writes `"program": null`: porting the op-list program
(shifu_tpu/export/program.py) waits for a later slice, so the JAX package's
numpy and native scorers cannot score an artifact the port wrote yet.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from ..config.schema import DataSchema, ModelSpec, _from_dict

FORMAT_VERSION = 1
SIDE_CAR = "GenericModelConfig.json"
TOPOLOGY = "topology.json"
WEIGHTS = "weights.npz"


@dataclasses.dataclass
class Artifact:
    spec: ModelSpec
    schema: DataSchema
    weights: dict[str, np.ndarray]   # Flax key -> array
    topology: dict[str, Any]
    sidecar: dict[str, Any]


def load_artifact(export_dir: str) -> Artifact:
    """Read `topology.json`, `weights.npz` and the sidecar."""
    with open(os.path.join(export_dir, TOPOLOGY)) as f:
        topology = json.load(f)
    if topology.get("format_version") != FORMAT_VERSION:
        raise ValueError(f"unsupported artifact format: "
                         f"{topology.get('format_version')}")
    with open(os.path.join(export_dir, SIDE_CAR)) as f:
        sidecar = json.load(f)
    with np.load(os.path.join(export_dir, WEIGHTS)) as z:
        weights = {k: z[k] for k in z.files}
    return Artifact(spec=_from_dict(ModelSpec, topology["model_spec"]),
                    schema=_from_dict(DataSchema, topology["schema"]),
                    weights=weights, topology=topology, sidecar=sidecar)


def params_from_jax(flat: dict[str, np.ndarray],
                    model: nn.Module) -> dict[str, torch.Tensor]:
    """Map `/`-joined Flax keys (`block_0/qkv/kernel`,
    `shifu_output_0/Dense_0/kernel`, ...) onto `model`'s state_dict.

    The port names its parameters after the Flax tree and keeps its layouts,
    so a key maps by `/` -> `.` with no transpose.  Raises on a missing or
    an extra key and on a shape mismatch."""
    want = model.state_dict()
    got = {k.replace("/", "."): v for k, v in flat.items()}
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    if missing or extra:
        raise KeyError(f"artifact weights do not match the model: missing "
                       f"{missing}, unexpected {extra}")
    out = {}
    for key, ref in want.items():
        arr = np.asarray(got[key])
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"weight {key!r} has shape {arr.shape}, model "
                             f"expects {tuple(ref.shape)}")
        if arr.dtype.kind == "V":
            # a bfloat16 array of JAX's numpy extension: widened exactly
            arr = arr.astype(np.float32)
        out[key] = torch.tensor(arr, dtype=ref.dtype)
    return out


def flat_params(model: nn.Module) -> dict[str, np.ndarray]:
    """The model's parameters under `/`-joined Flax key names; bfloat16
    parameters are written as float32 (exact), since numpy has no
    bfloat16."""
    return {k.replace(".", "/"): (v.float() if v.dtype == torch.bfloat16
                                  else v).detach().cpu().numpy()
            for k, v in model.state_dict().items()}


def save_artifact(model: nn.Module, spec: ModelSpec, schema: DataSchema,
                  export_dir: str, algorithm: str = "tensorflow") -> str:
    """Write the scoring artifact in the JAX package's format (with
    `"program": null`); returns export_dir."""
    os.makedirs(export_dir, exist_ok=True)
    np.savez(os.path.join(export_dir, WEIGHTS), **flat_params(model))
    topology = {
        "format_version": FORMAT_VERSION,
        "program_version": None,
        "model_type": spec.model_type,
        "num_features": schema.feature_count,
        "num_heads": spec.num_heads,
        "head_names": list(spec.head_names),
        "selected_indices": list(schema.selected_indices),
        "program": None,
        "model_spec": dataclasses.asdict(spec),
        "schema": dataclasses.asdict(schema),
    }
    with open(os.path.join(export_dir, TOPOLOGY), "w") as f:
        json.dump(topology, f, indent=2)
    sidecar = {
        "inputnames": ["shifu_input_0"],
        "properties": {
            "algorithm": algorithm,
            "tags": ["serve"],
            "outputnames": "shifu_output_0",
            "normtype": "ZSCALE",
        },
    }
    with open(os.path.join(export_dir, SIDE_CAR), "w") as f:
        json.dump(sidecar, f, indent=4)
    return export_dir
