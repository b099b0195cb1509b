"""The scoring artifact (port of shifu_tpu/export/artifact.py, the parts the
serving path needs).

An artifact is plain files, written and read the same way by both packages:

    <export_dir>/
      GenericModelConfig.json   # the Shifu sidecar
      topology.json             # format v1: the op-list program (v2),
                                # model_spec, schema, metadata
      weights.npz               # params under `/`-joined Flax key names
      baseline_profile.json     # the frozen drift baseline, when given
      scoring.pt2               # the torch.export scoring program
      aot/                      # the AOT pack, when asked (export/aot.py)
      sync_manifest.json        # blake2b digests of the files above

The program (export/program.py) is the JAX package's for the same spec and
schema, so the numpy `Scorer` and the native C++ scorer of either package
score the port's artifacts.  `scoring.pt2` is the port's counterpart of
the JAX package's StableHLO files (`scoring.mlir`, `scoring.jaxexport`):
the model rebuilt from the written files, in eval mode, then the sigmoid
(JAX `make_forward_fn`), traced by `torch.export` on the CPU with a
symbolic batch.  The hand-written kernels sit in it as `shifu_tpu_torch::`
operators, so the dispatcher picks the kernel or its plain version from
the device the program runs on (`export/scorer.ExportScorer`).  Where the
JAX export is best-effort, a failed `scoring.pt2` raises.  `model.bin`,
the native engine's packing of the program, comes from
`runtime/native_scorer.pack_native` (the train command's export sequence
packs it).
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
BASELINE_PROFILE = "baseline_profile.json"
EXPORT_PROGRAM = "scoring.pt2"


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
    so a key maps by `/` -> `.` with no transpose; a stacked trunk's
    `blocks/<name>` (L, ...) leaves map onto the port's `blocks.<name>`.
    Raises on a missing or an extra key and on a shape mismatch."""
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


class _Scoring(nn.Module):
    """The scoring function: the model, then the sigmoid on its f32
    logits (JAX `make_forward_fn`)."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.model(features).float())


def scoring_module(export_dir: str) -> nn.Module:
    """The artifact's model rebuilt on the CPU from its own files (spec,
    schema, weights), in eval mode, wrapped with the sigmoid: what the
    torch engine scores, as one module."""
    from ..models.registry import build_model

    art = load_artifact(export_dir)
    model = build_model(art.spec, art.schema, "cpu")
    model.load_state_dict(params_from_jax(art.weights, model))
    return _Scoring(model).eval().requires_grad_(False)


def device_literals(program) -> list[str]:
    """The nodes of an exported program's graph that name a device (a
    `device=` argument or a torch.device operand): a program must carry
    none, or it would pin the device it was traced on."""
    found = []
    for node in program.graph.nodes:
        vals = list(node.args) + list(node.kwargs.values())
        if any(isinstance(v, torch.device) for v in vals):
            found.append(f"{node.name}: {node.target}")
    return found


def export_program(export_dir: str):
    """`torch.export` the artifact's scoring function (`scoring_module`),
    traced on the CPU with a symbolic batch dimension (traced at 2 rows:
    export specialises sizes 0 and 1).  Raises if the graph names a
    device."""
    module = scoring_module(export_dir)
    n_feat = int(load_artifact(export_dir).topology["num_features"])
    example = torch.zeros((2, n_feat), dtype=torch.float32)
    with torch.no_grad():
        program = torch.export.export(
            module, (example,),
            dynamic_shapes=({0: torch.export.Dim("batch")},))
    return finish_program(program)


def finish_program(program):
    """Drop the trace's own checks that a tensor has the dtype and device
    it had while tracing (one per `.to(dtype)`): they compute nothing, and
    their device would pin the program to the CPU it was traced on.  Then
    raise if any other node names a device."""
    graph = program.graph_module.graph
    for node in list(graph.nodes):
        if node.target is torch.ops.aten._assert_tensor_metadata.default:
            graph.erase_node(node)
    program.graph_module.recompile()
    bad = device_literals(program)
    if bad:
        raise ValueError(f"the exported scoring program names a device, "
                         f"which would pin it there: {bad}")
    return program


def program_operators(program) -> set[str]:
    """The `shifu_tpu_torch::` operators a program calls, by their
    overload names (`shifu_tpu_torch.ft_block.default`, ...)."""
    return {str(n.target) for n in program.graph.nodes
            if str(n.target).startswith("shifu_tpu_torch.")}


def write_export_program(export_dir: str) -> str:
    """Export the scoring program into `<export_dir>/scoring.pt2`; returns
    its path."""
    path = os.path.join(export_dir, EXPORT_PROGRAM)
    torch.export.save(export_program(export_dir), path)
    return path


def build_program(spec: ModelSpec, schema: Optional[DataSchema] = None
                  ) -> Optional[list[dict[str, Any]]]:
    """The artifact's op-list program (format v2, export/program.py) for
    every ladder model type, ending in the scoring sigmoid; None for a
    type the lowering does not know, and for a layout-dependent model
    without its schema."""
    from .program import build_program_v2
    return build_program_v2(spec, schema)


def save_artifact(model: nn.Module, spec: ModelSpec, schema: DataSchema,
                  export_dir: str, algorithm: str = "tensorflow",
                  baseline_profile: Optional[dict] = None,
                  aot_pack: bool = False,
                  aot_buckets: Optional[tuple] = None,
                  aot_device=None) -> str:
    """Write the scoring artifact in the JAX package's format; returns
    export_dir.  `baseline_profile` (obs/sketch.build_profile, the train
    loop's frozen stats epoch) is validated and written as
    `baseline_profile.json`.  Then `scoring.pt2` (`write_export_program`)
    and, with `aot_pack` (the `shifu.serving.aot-pack` key, the export
    command's `--aot-pack`), the AOT pack for `aot_device` (default
    `cuda:0`) at `aot_buckets` (default: the ServingConfig-default
    ladder), best-effort as in JAX (export/aot.py).
    `sync_manifest.json` comes last, so its digests cover every other
    file; a failure to write it raises.  A pipelined FT-Transformer
    (`pipeline_stages > 1`, a training-time layout) ships the canonical
    per-block artifact, as in JAX: the same weights, program and
    `scoring.pt2` as a one-device model."""
    from ..runtime.fleet import write_sync_manifest
    from .program import PROGRAM_VERSION, weight_keys

    os.makedirs(export_dir, exist_ok=True)
    flat = flat_params(model)
    if spec.model_type == "ft_transformer" and spec.pipeline_stages > 1:
        from ..models.ft_transformer import canonicalize_params
        flat = {k.replace(".", "/"): v for k, v in canonicalize_params(
            {k.replace("/", "."): v for k, v in flat.items()},
            spec).items()}
        spec = dataclasses.replace(spec, pipeline_stages=1,
                                   pipeline_microbatches=0)
    program = build_program(spec, schema)
    if program is not None:
        missing = [k for k in weight_keys(program) if k not in flat]
        if missing:
            raise ValueError(f"program references missing weights: "
                             f"{missing}; have {sorted(flat)}")
    np.savez(os.path.join(export_dir, WEIGHTS), **flat)
    topology = {
        "format_version": FORMAT_VERSION,
        "program_version": PROGRAM_VERSION if program is not None else None,
        "model_type": spec.model_type,
        "num_features": schema.feature_count,
        "num_heads": spec.num_heads,
        "head_names": list(spec.head_names),
        "selected_indices": list(schema.selected_indices),
        "program": program,
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
    if baseline_profile is not None:
        from ..obs import sketch
        sketch.validate_profile(baseline_profile)
        with open(os.path.join(export_dir, BASELINE_PROFILE), "w") as f:
            json.dump(baseline_profile, f)
    write_export_program(export_dir)
    if aot_pack:
        from .aot import build_aot_pack, default_buckets
        build_aot_pack(export_dir, aot_buckets or default_buckets(),
                       device=aot_device)
    write_sync_manifest(export_dir)
    return export_dir
