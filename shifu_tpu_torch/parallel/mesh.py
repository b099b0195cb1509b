"""The mesh of ranks (port of shifu_tpu/parallel/mesh.py on
torch.distributed).

A mesh lays the ranks of the process group out over the axes `data`,
`seq`, `pipe` and `model`, row-major in `MeshConfig.axis_order` (rank 0
at the origin), as the JAX package reshapes its device list.  Each rank
knows its coordinates and holds one process group per axis: the ranks
that differ from it only along that axis (its "line").  `data` is the
data-parallel axis (each data coordinate trains its rows of every global
batch, train/step.py); `model` splits embedding tables (by vocab or by
field), MoE experts and the leaves of `shifu.sharding.rules`
(parallel/sharding.py); `seq` splits the attention's tokens (ring and
Ulysses attention, ops/attention.py); `pipe` holds the stages of a
pipelined trunk (parallel/pipeline.py).

`dist.new_group` is collective over the whole world: every rank creates
every line's group, in the same order, including the lines it is not on
(a rank that skipped one would leave the others waiting).  A world of
more than one rank also gets a gloo group over all ranks, `control`, for
the host-side agreements of the loop (the SIGTERM drain, timed saves).
A process that trains alone (no process group) gets a mesh of size 1
with no groups, whose collectives are no-ops.

The JAX package's multi-slice hybrid mesh has no counterpart on one host
(ROADMAP.md section C).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch.distributed as dist

from ..config.schema import ConfigError, MeshConfig
from . import distributed

DATA_AXIS = "data"
SEQ_AXIS = "seq"
PIPE_AXIS = "pipe"
MODEL_AXIS = "model"


class Mesh:
    """This rank's place on the mesh: `shape` (axis -> size, in
    `axis_names` order), `size`, `rank`, `coords` (axis -> index) and
    `group(axis)`, the process group of its line along the axis (None
    without a process group)."""

    def __init__(self, cfg: MeshConfig, rank: int, groups: dict,
                 control=None):
        self.config = cfg
        self.axis_names = tuple(cfg.axis_order)
        self.shape = {a: int(getattr(cfg, a)) for a in self.axis_names}
        self.size = int(np.prod(list(self.shape.values()), dtype=np.int64))
        self.rank = int(rank)
        dims = tuple(self.shape[a] for a in self.axis_names)
        self.coords = dict(zip(self.axis_names,
                               (int(i) for i in
                                np.unravel_index(self.rank, dims))))
        self._groups = groups
        self.control = control

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def axis_index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        return self._groups.get(axis)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def _lines(shape: dict, axis: str) -> list[list[int]]:
    """Every line of the mesh along `axis`: rank lists, each in axis
    order, the lines ordered by their first rank."""
    names = list(shape)
    dims = tuple(shape[a] for a in names)
    ranks = np.arange(int(np.prod(dims, dtype=np.int64))).reshape(dims)
    k = names.index(axis)
    moved = np.moveaxis(ranks, k, -1).reshape(-1, dims[k])
    return sorted(moved.tolist(), key=lambda line: line[0])


def make_mesh(cfg: Optional[MeshConfig] = None,
              devices: Optional[int] = None) -> Mesh:
    """The mesh over `devices` ranks (default: the process group's world,
    1 without one).  With no config every rank goes on the data axis.
    The axis sizes must multiply to the rank count."""
    n = distributed.process_count() if devices is None else int(devices)
    if cfg is None:
        cfg = MeshConfig(data=n)
    cfg.validate()
    if cfg.num_devices != n:
        raise ConfigError(
            f"mesh {cfg.data}x{cfg.seq}x{cfg.pipe}x{cfg.model} needs "
            f"{cfg.num_devices} devices, have {n}")
    if not dist.is_initialized():
        if n != 1:
            raise ConfigError(f"a mesh of {n} devices needs a process group "
                              "of as many ranks (parallel.distributed."
                              "initialize)")
        return Mesh(cfg, 0, {})
    if n != dist.get_world_size():
        raise ConfigError(f"mesh of {n} devices over a world of "
                          f"{dist.get_world_size()} ranks")
    rank = dist.get_rank()
    shape = {a: int(getattr(cfg, a)) for a in cfg.axis_order}
    groups = {}
    for axis in cfg.axis_order:
        for line in _lines(shape, axis):
            g = dist.new_group(line)  # collective: every rank, every line
            if rank in line:
                groups[axis] = g
    control = None
    if n > 1:
        control = (dist.group.WORLD if dist.get_backend() == "gloo"
                   else dist.new_group(list(range(n)), backend="gloo"))
    return Mesh(cfg, rank, groups, control)


def data_parallel_mesh(num_devices: Optional[int] = None) -> Mesh:
    """Every rank on the data axis (`num_devices`, when given, must be
    the rank count)."""
    n = distributed.process_count() if num_devices is None else num_devices
    return make_mesh(MeshConfig(data=n), n)


def host_shard_info(mesh: Mesh) -> tuple[int, int]:
    """(host_index, num_hosts) for input-file sharding.  The ranks of one
    host share its files and each trains its rows of every global batch,
    as the JAX package's single-host mesh does, so a one-host mesh is
    (0, 1) whatever its ranks (file sharding belongs to the pod launcher,
    ROADMAP.md queue A item (f))."""
    del mesh
    return 0, 1


def dcn_topology(mesh: Optional[Mesh] = None) -> dict:
    """The process and slice summary of the JAX package's `dcn_placement`
    row: a rank is a process with one device; one host is one slice."""
    return {"processes": distributed.process_count(),
            "process_index": distributed.process_index(),
            "devices": mesh.size if mesh is not None else 1,
            "local_devices": 1,
            "slices": 1}
