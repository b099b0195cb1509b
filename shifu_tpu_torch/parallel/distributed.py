"""Process-group initialization, the chief, barriers and the collectives
(port of shifu_tpu/parallel/distributed.py on torch.distributed).

The JAX package drives every device of a host from one process and
brings up `jax.distributed` only across hosts.  The port follows torch's
idiom instead: one process (a rank) per device, so a mesh of N devices is
N ranks in one process group, even on one host (ROADMAP.md section C).

Environment contract, as in the JAX package (first match wins): explicit
arguments, else SHIFU_TPU_COORDINATOR + SHIFU_TPU_NUM_PROCESSES +
SHIFU_TPU_PROCESS_ID; without a coordinator `initialize` is a no-op and
the process trains alone.  The coordinator is `host:port` (a TCP store on
that address; rank 0 listens) or a `tcp://` / `file://` init method.  The
backend is NCCL when the rank's device is CUDA and gloo on the CPU; a
caller may name it, as two ranks that share one card must (NCCL refuses
two ranks of one communicator on one device; gloo carries every
collective used here on CUDA tensors).  The JAX package's TPU pod
autodetection (TPU_WORKER_HOSTNAMES) has no counterpart.

The collectives take a group of the mesh (`parallel/mesh.py`) and are
no-ops on `None`, the group of a process that trains alone.  `all_reduce`
with "avg" is NCCL's native average (a pre-multiplied sum; on one rank
NCCL still launches its one-rank reduce kernel, where it elides an
in-place sum) and, on gloo, which has no average, a sum divided by the
group's size.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device

log = logging.getLogger(__name__)

ENV_COORDINATOR = "SHIFU_TPU_COORDINATOR"
ENV_NUM_PROCESSES = "SHIFU_TPU_NUM_PROCESSES"
ENV_PROCESS_ID = "SHIFU_TPU_PROCESS_ID"


def _init_method(coordinator: str) -> str:
    if coordinator.startswith(("tcp://", "file://", "env://")):
        return coordinator
    return f"tcp://{coordinator}"


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               device: DeviceLike = None) -> bool:
    """Join the process group; True when one is (now) up.

    Safe to call unconditionally: without a coordinator (argument or
    environment) it does nothing and returns False.  Idempotent.  The
    backend defaults to NCCL for a CUDA `device` (default `cuda:0`) and
    gloo for the CPU; a CUDA rank is bound to its device first."""
    if dist.is_initialized():
        return True
    coordinator = coordinator or os.environ.get(ENV_COORDINATOR)
    if not coordinator:
        return False
    if num_processes is None:
        num_processes = int(os.environ.get(ENV_NUM_PROCESSES, "1"))
    if process_id is None:
        process_id = int(os.environ.get(ENV_PROCESS_ID, "0"))
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kwargs = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kwargs["device_id"] = dev
    dist.init_process_group(backend, init_method=_init_method(coordinator),
                            world_size=int(num_processes),
                            rank=int(process_id), **kwargs)
    log.info("torch.distributed initialized: rank %d/%d via %s (%s)",
             dist.get_rank(), dist.get_world_size(), coordinator, backend)
    return True


def shutdown() -> None:
    """Leave the process group (a no-op when none is up)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_chief() -> bool:
    """The rank that writes the journal, the board, checkpoints and the
    artifact (the reference's chief worker, worker:0)."""
    return process_index() == 0


def barrier(name: str = "barrier") -> None:
    """Wait for every rank; a no-op alone."""
    if process_count() == 1:
        return
    log.debug("barrier %s", name)
    dist.barrier()


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """In-place "sum", "max" or "avg" of `t` over `group`; returns `t`."""
    if group is None:
        return t
    if op == "max":
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    elif op == "avg" and dist.get_backend(group) == "nccl":
        dist.all_reduce(t, op=dist.ReduceOp.AVG, group=group)
    elif op in ("sum", "avg"):
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        if op == "avg":
            t.div_(dist.get_world_size(group))
    else:
        raise ValueError(f"all_reduce: unknown op {op!r}")
    return t


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along `dim`, in rank order of the
    group; `t` itself alone."""
    if group is None:
        return t
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _SumForward(torch.autograd.Function):
    """Sum over a group in the forward, identity in the backward: the
    reduction of partial results that every rank of the group then uses
    alike (each rank's upstream gradient is the whole gradient of its
    partial)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group, "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_forward(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable all-reduce sum whose backward is the identity."""
    if group is None:
        return x
    return _SumForward.apply(x, group)
